"""Training-set source-list compilation (ZTFIDs) (port of
btsbot_tpu.data.query.ztfid).

BTS Sample Explorer queries for trues / vars / dims, Fritz API pagination
for rejects, BTS save-time queries, the external-Ia list, cross-set dedup
and the hand-curated exclusion list.  Every function takes an injectable
``session`` (any requests-compatible object; ``requests`` is imported only
when none is given), so the logic runs offline in tests.  Credentials come
from FRITZ_API_KEY and BTSSE_USER / BTSSE_PASS.  Source lists are dicts of
numpy columns, read and written with ``data.dataset``'s CSV reader and
writer.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..dataset import read_candidates, take_rows, write_candidates

FRITZ_HOST = "https://fritz.science"
BTSSE_EXPLORER = "http://sites.astro.caltech.edu/ztf/rcf/explorer.php"

# Predefined BTS Sample Explorer queries: saved sources before 2025-01-01;
# trues = transients peaking ≤ 18.5 mag, vars = variables, dims =
# everything peaking > 18.5.
_COMMON = {
    "f": "s", "coverage": "any", "samprcf": "y", "sampdeep": "y",
    "refok": "y", "ztflink": "fritz", "endsavedate": "2025-01-01",
    "sort": "peakmag", "format": "csv",
}
BTSSE_QUERY_PARAMS = {
    "trues": {**_COMMON, "subsample": "trans", "purity": "y", "endpeakmag": "18.5"},
    "vars": {**_COMMON, "subsample": "var"},
    "dims": {**_COMMON, "subsample": "all", "purity": "y", "covok": "y",
             "startpeakmag": "18.5"},
}

# Hand-curated exclusions: mixed labels or transient-in-reference.
OBJS_TO_REMOVE = [
    "ZTF18abdiasx", "ZTF21abyazip", "ZTF18aaadqua", "ZTF18aarrwmi",
    "ZTF18aazijke", "ZTF18abncsdn", "ZTF18aaslhxt", "ZTF18aamigmk",
    "ZTF18abdpvnd", "ZTF18aaqffyp",
]

RCF_GROUP_ID = "41"
RCF_JUNK_GROUP_ID = "255"


def _session(session=None):
    if session is not None:
        return session
    import requests
    return requests


def iso_to_jd(iso: str) -> float:
    """ISO-8601 UTC timestamp → Julian Date."""
    from datetime import datetime, timezone

    dt = datetime.fromisoformat(iso.replace("Z", "+00:00"))
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt.timestamp() / 86400.0 + 2440587.5


def fritz_headers():
    key = os.environ.get("FRITZ_API_KEY")
    return {"Authorization": f"token {key}"} if key else None


def query_btsse(query_name: str, out_path: str, session=None, auth=None) -> None:
    """Fetch one explorer CSV."""
    auth = auth or (os.environ.get("BTSSE_USER"), os.environ.get("BTSSE_PASS"))
    r = _session(session).get(BTSSE_EXPLORER, params=BTSSE_QUERY_PARAMS[query_name],
                              auth=auth)
    with open(out_path, "w") as f:
        f.write(r.text)


def query_rejects(session=None, headers=None, start_date: str = "2021-01-01",
                  end_date: str = "2023-01-01", sleep: float = 2.0) -> list[str]:
    """Paginated Fritz candidates query for BTS candidates never saved to
    RCF / RCFJunk, halving the page size on an out-of-range response."""
    session = _session(session)
    headers = headers or fritz_headers()
    endpoint = FRITZ_HOST + "/api/candidates"

    objids: list[str] = []
    page_num = 1
    num_per_page = 250
    while True:
        r = session.get(endpoint, headers=headers, params={
            "savedStatus": "notSavedToAnySelected",
            "startDate": start_date,
            "endDate": end_date,
            "groupIDs": f"{RCF_GROUP_ID},{RCF_JUNK_GROUP_ID}",
            "numPerPage": num_per_page,
            "pageNumber": page_num,
        })
        if "out of range" in r.text:
            if num_per_page == 1:
                break
            num_per_page //= 2
            continue
        candidates = r.json()["data"]["candidates"]
        new = [c["id"] for c in candidates if c["id"] not in objids]
        if not new:
            break
        objids += new
        page_num += 1
        if sleep:
            time.sleep(sleep)
    return objids


def query_bts_save_times(trues: dict, session=None, headers=None,
                         sleep: float = 0.2) -> dict:
    """Fill the RCF_save_time column (JD of the save to the RCF group) of
    each true that has none yet; returns the table."""
    session = _session(session)
    headers = headers or fritz_headers()
    n = len(trues["ZTFID"])
    save = np.asarray(trues.get("RCF_save_time", np.full(n, -1.0)), dtype=np.float64).copy()

    for i, objid in enumerate(np.asarray(trues["ZTFID"]).tolist()):
        if save[i] > 0:
            continue
        r = session.get(f"{FRITZ_HOST}/api/sources/{objid}", headers=headers, params={})
        if not r.ok:
            continue
        for group in r.json()["data"]["groups"]:
            if group["name"] == "Redshift Completeness Factor":
                save[i] = iso_to_jd(group["saved_at"])
        if sleep:
            time.sleep(sleep)
    trues["RCF_save_time"] = save
    return trues


def load_external_ias(path: str, all_ztfids: np.ndarray):
    """External Type-Ia list (column ztfname → ZTFID), deduped against the
    ids already listed; returns (table, all ids)."""
    ext = {("ZTFID" if k == "ztfname" else k): v for k, v in read_candidates(path).items()}
    ids = np.asarray(ext["ZTFID"]).astype(str)
    ext = take_rows(ext, (np.char.find(ids, "ZTF") >= 0) & ~np.isin(ids, all_ztfids))
    return ext, np.concatenate([all_ztfids, np.asarray(ext["ZTFID"])])


def compile_ztfids(base_dir: str = "data/base_data", overwrite: bool = False,
                   session=None) -> None:
    """Build the training-set object lists: trues / vars / dims from BTSSE,
    rejects from Fritz, deduped across sets, the exclusion list applied,
    written as ``{name}.csv``."""
    os.makedirs(base_dir, exist_ok=True)
    all_ztfids = np.array((), dtype=object)
    frames = {}

    for name in ("trues", "vars", "dims"):
        path = os.path.join(base_dir, f"{name}.csv")
        if overwrite or not os.path.exists(path):
            query_btsse(name, path, session=session)
        df = read_candidates(path)
        df = take_rows(df, ~np.isin(df["type"], ["duplicate", "duplicate?"]))
        df = take_rows(df, ~np.isin(df["ZTFID"], all_ztfids))
        all_ztfids = np.concatenate([all_ztfids, np.asarray(df["ZTFID"], dtype=object)])
        frames[name] = df

    rej_path = os.path.join(base_dir, "rejects.csv")
    if overwrite or not os.path.exists(rej_path):
        write_candidates({"ZTFID": np.asarray(query_rejects(session=session), dtype=object)},
                         rej_path)
    rejects = read_candidates(rej_path)
    rejects = take_rows(rejects, ~np.isin(rejects["ZTFID"], all_ztfids))
    all_ztfids = np.concatenate([all_ztfids, np.asarray(rejects["ZTFID"], dtype=object)])
    frames["rejects"] = rejects

    for name in list(frames):
        # keep the filtered table: trues.csv is rewritten below from
        # frames["trues"], which must not bring the excluded objects back
        frames[name] = take_rows(frames[name],
                                 ~np.isin(frames[name]["ZTFID"], OBJS_TO_REMOVE))
        write_candidates(frames[name], os.path.join(base_dir, f"{name}.csv"))

    if "RCF_save_time" not in frames["trues"] or overwrite:
        trues = query_bts_save_times(frames["trues"], session=session)
        write_candidates(trues, os.path.join(base_dir, "trues.csv"))
