"""Archival color-image acquisition, PanSTARRS / Legacy Survey (port of
btsbot_tpu.data.query.cutouts).

The alternative image modality, where each object's ZTF triplet is replaced
by an archival color cutout: Legacy Survey 63 px jpeg cutouts, or PanSTARRS
252 px jpegs 4×4-binned to 63 px and max-normalised.  Downloads fan out over
a process pool (spawned, so the workers start from a fresh import);
``requests`` and ``PIL`` are imported only when an image is fetched, and
every function takes an injectable ``session`` (picklable, for the pool)
so the logic runs offline in tests.

File outputs keep the reference naming:
``{split}_{cand,triplets}_{version}{PS63|LS63}[nd]_N100.{csv,npy}`` (the
"nd" variant drops objects with a missing or empty archival image).
"""

from __future__ import annotations

import io
import multiprocessing
import os
from functools import partial

import numpy as np

from ..dataset import read_candidates, take_rows, write_candidates

PS_FILENAME_SERVICE = "https://ps1images.stsci.edu/cgi-bin/ps1filenames.py"
PS_CUTOUT_SERVICE = "https://ps1images.stsci.edu/cgi-bin/fitscut.cgi"
LS_CUTOUT_SERVICE = "https://www.legacysurvey.org/viewer/jpeg-cutout"


def _session(session=None):
    if session is not None:
        return session
    import requests
    return requests


def _parse_ascii_table(text: str) -> dict:
    """Whitespace-delimited ASCII table (header line + rows) → dict of
    column → list (the ps1filenames.py response format)."""
    lines = [ln for ln in text.strip().splitlines() if ln.strip()]
    cols = lines[0].split()
    rows = [ln.split() for ln in lines[1:]]
    return {c: [r[i] for r in rows] for i, c in enumerate(cols)}


def get_ps_image_table(ra: float, dec: float, filters: str = "grizy",
                       session=None) -> dict:
    """PS1 stack images covering a position, as {column: list}."""
    r = _session(session).get(PS_FILENAME_SERVICE,
                              params={"ra": ra, "dec": dec, "filters": filters})
    return _parse_ascii_table(r.text)


def get_ps_url(ra: float, dec: float, size: int = 252, im_format: str = "jpeg",
               output_size: int | None = None, session=None) -> str | None:
    """PS1 color-cutout URL with i/r/g mapped to red/green/blue; None when a
    band is missing."""
    table = get_ps_image_table(ra, dec, session=session)
    filt = np.asarray(table["filter"])
    if not all(f in filt for f in ("g", "r", "i")):
        return None
    files = np.asarray(table["filename"])
    order = np.argsort(["irgzy".find(x) for x in filt])
    filt, files = filt[order], files[order]
    files = files[np.isin(filt, ["g", "r", "i"])]
    url = (f"{PS_CUTOUT_SERVICE}?ra={ra}&dec={dec}&size={size}"
           f"&format={im_format}&output_size={output_size or size}")
    for i, param in enumerate(("red", "green", "blue")):
        url += f"&{param}={files[i]}"
    return url


def fetch_ls_image(ra: float, dec: float, session=None):
    """(63, 63, 3) float16 Legacy Survey jpeg cutout + empty flag (an all-32
    image means no coverage)."""
    from PIL import Image

    r = _session(session).get(LS_CUTOUT_SERVICE, params={
        "ra": ra, "dec": dec, "size": 63, "layer": "ls-dr10", "pixscale": 1,
        "bands": "griy"})
    arr = np.array(Image.open(io.BytesIO(r.content)), dtype=np.float16)
    return arr, bool(np.all(arr.flatten() == 32))


def fetch_ps_image(ra: float, dec: float, session=None):
    """(63, 63, 3) float32 PanSTARRS color image: 252 px jpeg → 4×4
    mean-binned to 63 px → divided by its max."""
    from PIL import Image

    session = _session(session)
    url = get_ps_url(ra, dec, size=252, im_format="jpeg", session=session)
    if url is None:
        return None, True
    r = session.get(url)
    arr = np.array(Image.open(io.BytesIO(r.content)).convert("RGB"))
    arr = arr.reshape(63, 4, 63, 4, 3).mean(axis=(1, 3)).astype(np.float32)
    return arr / arr.max(), False


def download_image_batch(batch: list[dict], survey: str, session=None):
    """(objectId, image or None, missing) per source."""
    results = []
    for source in batch:
        try:
            if survey == "LS":
                img, empty = fetch_ls_image(source["ra"], source["dec"], session)
            elif survey == "PS":
                img, empty = fetch_ps_image(source["ra"], source["dec"], session)
            else:
                raise ValueError(f"Unknown survey: {survey}")
            results.append((source["objectId"], img, empty))
        except Exception as e:  # noqa: BLE001 — one source's failure marks it missing
            print(f"Error downloading image for {source['objectId']}: {e!r}")
            results.append((source["objectId"], None, True))
    return results


def query_images(cand: dict, survey: str, max_workers: int | None = None, session=None):
    """Per-object downloads over a spawned process pool; returns (cand with a
    ``missing_{SURVEY}`` column, {objectId: image})."""
    missing_col = f"missing_{survey.upper()}"
    cand = dict(cand)
    ids = np.asarray(cand["objectId"])
    cand[missing_col] = np.zeros(len(ids), dtype=bool)

    # each object's first row, in order of first appearance
    at = np.sort(np.unique(ids, return_index=True)[1])
    sources = [{"objectId": o, "ra": float(cand["ra"][i]), "dec": float(cand["dec"][i])}
               for o, i in zip(ids[at].tolist(), at)]
    max_workers = max_workers or min(os.cpu_count() or 1, max(1, len(sources)))
    batch_size = max(1, len(sources) // (3 * max_workers))
    batches = [sources[i:i + batch_size] for i in range(0, len(sources), batch_size)]

    img_cache: dict[str, np.ndarray] = {}
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(processes=max_workers) as pool:
        for result in pool.imap(partial(download_image_batch, survey=survey,
                                        session=session), batches):
            for object_id, image, missing in result:
                if image is not None:
                    img_cache[object_id] = image
                # a failed or absent download must still be flagged, or the
                # 'nd' variant keeps the all-zero placeholder for that object
                if missing:
                    cand[missing_col][ids == object_id] = True
    return cand, img_cache


def process_dataset(survey: str, split_to_process: str, version: str, workers: int,
                    data_dir: str = "data", session=None) -> None:
    """Per-split pipeline writing the PS63 / LS63 [nd] dataset variants."""
    splits = ["train", "val", "test"] if split_to_process == "all" else [split_to_process]
    for split in splits:
        cand = read_candidates(os.path.join(data_dir, f"{split}_cand_{version}_N100.csv"))
        cand, img_cache = query_images(cand, survey, max_workers=workers, session=session)
        missing_col = f"missing_{survey.upper()}"
        suffix = f"{survey.upper()}63"

        ids = np.asarray(cand["objectId"]).tolist()
        imgs = np.zeros((len(ids), 63, 63, 3), dtype=np.float16)
        for i, oid in enumerate(ids):
            if oid in img_cache:
                imgs[i] = img_cache[oid]

        write_candidates(cand, os.path.join(data_dir, f"{split}_cand_{version}{suffix}_N100.csv"))
        np.save(os.path.join(data_dir, f"{split}_triplets_{version}{suffix}_N100.npy"), imgs)

        keep = ~cand[missing_col]
        write_candidates(take_rows(cand, keep), os.path.join(
            data_dir, f"{split}_cand_{version}{suffix}nd_N100.csv"))
        np.save(os.path.join(data_dir, f"{split}_triplets_{version}{suffix}nd_N100.npy"),
                imgs[keep])
