"""Kowalski (ZTF alert archive) acquisition layer (port of
btsbot_tpu.data.query.kowalski).

Per-object alert queries with cutouts, a raw-result disk cache, corrupt
cutouts dropped, labels, and the triplets + candidates files of one source
list.  As in the JAX package:

* the client is injected (any object with ``.query(dict)``: penquins'
  Kowalski, or a fake in tests); ``client_from_env()`` builds penquins'
  client from KOWALSKI_USER / KOWALSKI_PASS (penquins imported there);
* the cutouts' NaN-clean / normalise / corrupt-drop runs batched on the
  card (``ops.preprocess.preprocess_triplets``, float32) unless
  ``device="cpu"``; triplets come back in float64 as in JAX;
* ``drb_fn`` is the hook for re-scoring the triplets (the reference's
  ``rerun_braai``); without it no ``new_drb`` column is written.

Candidate tables are dicts of numpy columns (``data.dataset``).
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np

from ..alerts import prep_alerts, triplet_from_packet
from ..dataset import sort_order, write_candidates

# Projection of candidate/classification fields requested per alert — the
# ZTF avro schema subset BTSbot trains on.
CANDIDATE_FIELDS = (
    "candid", "programid", "fid", "isdiffpos", "ndethist", "ncovhist", "sky",
    "fwhm", "seeratio", "mindtoedge", "nneg", "nbad", "scorr", "dsnrms",
    "ssnrms", "exptime", "field", "jd", "ra", "dec", "magpsf", "sigmapsf",
    "diffmaglim", "magap", "sigmagap", "magapbig", "sigmagapbig", "magdiff",
    "magzpsci", "magzpsciunc", "magzpscirms", "distnr", "magnr", "sigmanr",
    "chinr", "sharpnr", "neargaia", "neargaiabright", "maggaia",
    "maggaiabright", "drb", "classtar", "sgscore1", "distpsnr1", "sgscore2",
    "distpsnr2", "sgscore3", "distpsnr3", "jdstarthist", "jdstartref",
    "sgmag1", "srmag1", "simag1", "szmag1", "sgmag2", "srmag2", "simag2",
    "szmag2", "sgmag3", "srmag3", "simag3", "szmag3", "nmtchps", "clrcoeff",
    "clrcounc", "chipsf",
)
CLASSIFICATION_FIELDS = ("acai_h", "acai_v", "acai_o", "acai_n", "acai_b", "bts")
CUTOUT_FIELDS = ("cutoutScience", "cutoutTemplate", "cutoutDifference")


def alert_projection(include_cutouts: bool = True) -> dict:
    proj: dict[str, int] = {"_id": 0, "objectId": 1}
    proj.update({f"candidate.{f}": 1 for f in CANDIDATE_FIELDS})
    proj.update({f"classifications.{f}": 1 for f in CLASSIFICATION_FIELDS})
    if include_cutouts:
        proj.update({f: 1 for f in CUTOUT_FIELDS})
    return proj


def alerts_query(ztfid: str, programid: int, include_cutouts: bool = True) -> dict:
    """MongoDB-style find on the ZTF_alerts catalog for one object."""
    return {
        "query_type": "find",
        "query": {
            "catalog": "ZTF_alerts",
            "filter": {"objectId": ztfid, "candidate.programid": programid},
            "projection": alert_projection(include_cutouts),
        },
    }


def client_from_env():
    """penquins Kowalski client from KOWALSKI_USER / KOWALSKI_PASS; None when
    the credentials or penquins are absent."""
    user = os.environ.get("KOWALSKI_USER")
    password = os.environ.get("KOWALSKI_PASS")
    if user is None or password is None:
        return None
    try:
        from penquins import Kowalski
    except ImportError:
        return None
    return Kowalski(instances={"kowalski": {
        "protocol": "https", "port": 443, "host": "kowalski.caltech.edu",
        "username": user, "password": password}})


def query_alerts(ztfids: str | Sequence[str], client, programid: int,
                 include_cutouts: bool = True, normalize: bool = True,
                 save_raw: str | None = None, load_raw: str | None = None,
                 verbose: bool = False, device=None) -> list[dict]:
    """Alert packets per object × programid, with an optional raw cache
    (``{ZTFID}_prog{programid}.npy``), each with its cutouts decoded into a
    ``triplet`` entry; corrupt alerts dropped.  The ingest runs on
    ``device`` (default the card)."""
    import torch

    from ...core.device import resolve_device
    from ...ops.preprocess import preprocess_triplets

    dev = resolve_device(device) if include_cutouts else None
    if isinstance(ztfids, str):
        ztfids = [ztfids]

    alerts: list[dict] = []
    for ztfid in ztfids:
        object_alerts = None
        cache_file = None
        if load_raw:
            cache_file = os.path.join(load_raw, f"{ztfid}_prog{programid}.npy")
            if os.path.exists(cache_file):
                object_alerts = list(np.load(cache_file, allow_pickle=True))
            else:
                cache_file = None

        if object_alerts is None:
            r = client.query(alerts_query(ztfid, programid, include_cutouts))
            object_alerts = r["kowalski"]["data"]
            if not object_alerts:
                if verbose:
                    print(f"  No programid={programid} data for {ztfid}")
                continue
            if save_raw and cache_file is None:
                os.makedirs(save_raw, exist_ok=True)
                np.save(os.path.join(save_raw, f"{ztfid}_prog{programid}"), object_alerts)

        if include_cutouts:
            raw = np.stack([triplet_from_packet(a) for a in object_alerts])
            trips, drop = preprocess_triplets(torch.from_numpy(raw).to(dev),
                                              normalize=normalize)
            trips = trips.cpu().numpy().astype(np.float64)
            drop = drop.cpu().numpy()
            object_alerts = [a for a, d in zip(object_alerts, drop) if not d]
            for alert, triplet in zip(object_alerts, trips[~drop]):
                alert["triplet"] = triplet

        alerts.extend(object_alerts)
        if verbose:
            print(f"  Finished {ztfid} (prog {programid})")
    return alerts


def extract_triplets(alerts: list[dict]):
    """Split the ``triplet`` arrays out of the alert dicts (float64)."""
    triplets = np.empty((len(alerts), 63, 63, 3))
    for i, alert in enumerate(alerts):
        triplets[i] = alert.pop("triplet")
        for key in CUTOUT_FIELDS:
            alert.pop(key, None)
    return alerts, triplets


def compute_labels(alerts: list[dict], label) -> np.ndarray:
    """Label policy: int → constant; array → verbatim; "compute" → 1 for
    objects with any alert brighter than 18.5."""
    n = len(alerts)
    if isinstance(label, (int, np.integer)):
        return np.full(n, int(label), dtype=int)
    if isinstance(label, (list, np.ndarray)):
        label = np.asarray(label, dtype=int)
        if len(label) != n:
            raise ValueError(f"{len(label)} labels for {n} alerts")
        return label
    if label == "compute":
        true_objs = {a["objectId"] for a in alerts if a["candidate"]["magpsf"] < 18.5}
        return np.asarray([1 if a["objectId"] in true_objs else 0 for a in alerts])
    raise ValueError(f"Could not understand label: {label}")


def _float(v) -> float:
    return np.nan if v is None else float(v)


def query_nondet(client, objid: str, first_alert_jd: float):
    """Last non-detection before the first detection → (jd, diffmaglim), or
    (nan, nan).  A non-detection is a previous candidate without magpsf;
    ties in jd fall as pandas' descending sort leaves them."""
    if client is None:
        return np.nan, np.nan
    r = client.query({
        "query_type": "find",
        "query": {
            "catalog": "ZTF_alerts_aux",
            "filter": {"_id": objid},
            "projection": {"_id": 0, "prv_candidates.jd": 1,
                           "prv_candidates.diffmaglim": 1,
                           "prv_candidates.magpsf": 1},
        },
    })
    data = r["kowalski"]["data"]
    if not data:
        return np.nan, np.nan
    prv = data[0]["prv_candidates"]
    if not any("jd" in p for p in prv):
        return np.nan, np.nan
    jd = np.asarray([_float(p.get("jd")) for p in prv])
    mag = np.asarray([_float(p.get("magpsf")) for p in prv])
    lim = np.asarray([_float(p.get("diffmaglim")) for p in prv])
    leading = np.flatnonzero(np.isnan(mag) & (jd < first_alert_jd))
    if len(leading) == 0:
        return np.nan, np.nan
    last = leading[sort_order(jd[leading], ascending=False)[0]]
    return jd[last], lim[last]


def download_training_data(query_df, query_name: str, label, client=None,
                           out_dir: str = "data/base_data", include_cutouts: bool = True,
                           normalize_cutouts: bool = True, cutout_size: int = 63,
                           drb_fn: Callable[[np.ndarray], np.ndarray] | None = None,
                           save_raw: str | None = None, load_raw: str | None = None,
                           verbose: bool = False, device=None) -> None:
    """Full acquisition for one source list (``query_df["ZTFID"]``): query
    programid 1 + 2 alerts, build triplets + candidate table, save
    ``{query_name}_triplets.npy`` and ``{query_name}_candidates.csv``.  The
    ingest (and the crop, for ``cutout_size`` < 63) runs on ``device``."""
    client = client or client_from_env()
    if client is None:
        raise RuntimeError("Kowalski credentials not found (KOWALSKI_USER/KOWALSKI_PASS) "
                           "and no client provided.")

    ztfids = np.asarray(query_df["ZTFID"]).tolist()
    alerts = []
    for programid in (1, 2):
        alerts += query_alerts(ztfids, client, programid, include_cutouts=include_cutouts,
                               normalize=normalize_cutouts, save_raw=save_raw,
                               load_raw=load_raw, verbose=verbose, device=device)

    labels = compute_labels(alerts, label)
    os.makedirs(out_dir, exist_ok=True)

    new_drb = None
    if include_cutouts:
        alerts, triplets = extract_triplets(alerts)
        if drb_fn is not None:
            new_drb = drb_fn(triplets)
        if cutout_size != 63:
            import torch

            from ...core.device import resolve_device
            from ...ops.preprocess import crop_triplets
            triplets = crop_triplets(
                torch.from_numpy(triplets.astype(np.float32)).to(resolve_device(device)),
                cutout_size).cpu().numpy()
        suffix = str(cutout_size) if cutout_size != 63 else ""
        np.save(os.path.join(out_dir, f"{query_name}_triplets{suffix}.npy"), triplets)
        del triplets

    cand = prep_alerts(alerts, labels, new_drb,
                       nondet_fn=lambda oid, jd: query_nondet(client, oid, jd))
    write_candidates(cand, os.path.join(out_dir, f"{query_name}_candidates.csv"))
