"""Alert-packet decoding and feature engineering (port of
btsbot_tpu.data.alerts).

* ``decode_stamp`` / ``pad_stamp`` / ``triplet_from_packet`` — gunzip +
  FITS-parse the three cutouts of a ZTF alert packet (the bson ``$binary``
  form too) and pad undersized stamps to 63×63 with 1e-9; ``decode_stamp``
  is also the pure-Python fallback of ``native.decode_stamps``;
* ``make_triplet`` — one packet through the port's batched ingest
  (``ops.preprocess.preprocess_triplets``) on the card unless
  ``device="cpu"``: computed in float32, returned in float64 as in JAX;
* ``engineered_features`` / ``prep_alerts`` — the candidate table (a dict of
  numpy columns) with the per-object time-series features (peakmag, maxmag,
  *_so_far, age, days_since_peak, days_to_peak, nnotdet): pandas'
  groupby / cummin of the JAX package rewritten as a ``np.lexsort`` by
  (objectId, jd) and per-object segment reductions;
* ``plot_triplet`` — the three-panel cutout figure (matplotlib imported to
  draw).
"""

from __future__ import annotations

import base64
import gzip
import io

import numpy as np

from .fits import read_fits_image

CUTOUT_KEYS = ("science", "template", "difference")
STAMP_SIZE = 63
PAD_VALUE = 1e-9


def decode_stamp(stamp_data: bytes) -> np.ndarray:
    """Gunzip + FITS-parse one cutout's ``stampData`` blob → 2-D float32
    (``data.fits``, the stamps' subset of FITS; the JAX package's astropy
    fallback for other files is not ported)."""
    with gzip.open(io.BytesIO(stamp_data), "rb") as f:
        buf = f.read()
    return read_fits_image(buf).astype(np.float32)


def pad_stamp(stamp: np.ndarray, size: int = STAMP_SIZE) -> np.ndarray:
    """Pad an undersized stamp to size×size with 1e-9 on the bottom/right
    edges."""
    h, w = stamp.shape
    if (h, w) == (size, size):
        return stamp
    return np.pad(stamp, [(0, size - h), (0, size - w)], mode="constant",
                  constant_values=PAD_VALUE)


def triplet_from_packet(alert: dict) -> np.ndarray:
    """Raw (un-normalised) float32 63×63×3 stack (science, template,
    difference) from an alert packet's cutout blobs."""
    planes = []
    for key in CUTOUT_KEYS:
        blob = alert[f"cutout{key.capitalize()}"]["stampData"]
        if isinstance(blob, dict) and "$binary" in blob:  # bson json form
            b = blob["$binary"]
            blob = base64.b64decode(b["base64"] if isinstance(b, dict) else b)
        planes.append(pad_stamp(decode_stamp(blob)))
    return np.stack(planes, axis=-1)


def make_triplet(alert: dict, normalize: bool = True, device=None):
    """(float64 triplet, drop flag) of one packet, the reference's
    ``make_triplet`` contract; the ingest runs on ``device`` (default the
    card).  Batch pipelines use ``triplet_from_packet`` + the batched op."""
    import torch

    from ..core.device import resolve_device
    from ..ops.preprocess import preprocess_triplets

    raw = torch.from_numpy(triplet_from_packet(alert)[None]).to(resolve_device(device))
    out, drop = preprocess_triplets(raw, normalize=normalize)
    return out[0].cpu().numpy().astype(np.float64), bool(drop[0])


def _segments(sorted_codes: np.ndarray) -> np.ndarray:
    """Start of each run of equal codes, and the end."""
    starts = np.flatnonzero(np.r_[True, sorted_codes[1:] != sorted_codes[:-1]])
    return np.r_[starts, len(sorted_codes)]


def engineered_features(cand: dict) -> dict:
    """The table with the per-object time-series features added, rows in
    their original order.  Needs objectId, jd, magpsf, jdstarthist,
    ncovhist, ndethist.  The jd of the peak so far is that of the earliest
    alert (by jd, then row) with the running-minimum magnitude; a row
    without a magnitude gets NaN for the features that depend on it."""
    out = dict(cand)
    out["nnotdet"] = np.asarray(cand["ncovhist"]) - np.asarray(cand["ndethist"])
    n = len(out["nnotdet"])
    jd = np.asarray(cand["jd"], dtype=np.float64)
    mag = np.asarray(cand["magpsf"], dtype=np.float64)
    _, codes = np.unique(np.asarray(cand["objectId"]), return_inverse=True)
    order = np.lexsort((jd, codes))          # stable: ties by row
    s_jd, s_mag = jd[order], mag[order]
    feats = {k: np.empty(n) for k in ("peakmag", "maxmag", "peakmag_so_far",
                                      "maxmag_so_far", "jd_peak", "jd_min")}
    bounds = _segments(codes[order])
    for a, b in zip(bounds[:-1], bounds[1:]):
        m, j = s_mag[a:b], s_jd[a:b]
        run_min, run_max = np.fmin.accumulate(m), np.fmax.accumulate(m)
        feats["peakmag"][a:b] = run_min[-1]
        feats["maxmag"][a:b] = run_max[-1]
        feats["peakmag_so_far"][a:b] = np.where(np.isnan(m), np.nan, run_min)
        feats["maxmag_so_far"][a:b] = np.where(np.isnan(m), np.nan, run_max)
        # the run's minimum changes only where a strictly lower value first
        # appears, so the last change is the first alert with that value
        new = np.r_[True, run_min[1:] != run_min[:-1]]
        first = np.maximum.accumulate(np.where(new, np.arange(b - a), 0))
        feats["jd_peak"][a:b] = np.where(np.isnan(m), np.nan, j[first])
        feats["jd_min"][a:b] = np.fmin.reduce(j)
    jd_first = np.minimum(np.asarray(cand["jdstarthist"], dtype=np.float64)[order],
                          feats["jd_min"])
    derived = {
        "age": s_jd - jd_first,
        "days_since_peak": s_jd - feats["jd_peak"],
        "days_to_peak": feats["jd_peak"] - jd_first,
    }
    for name in ("peakmag", "maxmag", "peakmag_so_far", "maxmag_so_far"):
        derived[name] = feats[name]
    for name in ("peakmag", "maxmag", "peakmag_so_far", "maxmag_so_far", "age",
                 "days_since_peak", "days_to_peak"):
        col = np.empty(n)
        col[order] = derived[name]
        out[name] = col
    return out


def _column(values: list) -> np.ndarray:
    """One column of records, typed as pandas types a column of a frame
    built from dicts (bool, int64, float64 with NaN for a missing number,
    else objects)."""
    present = [v for v in values if v is not None]
    if present and len(present) == len(values) and all(
            isinstance(v, (bool, np.bool_)) for v in present):
        return np.asarray(values, dtype=bool)
    if present and all(isinstance(v, (int, float, np.integer, np.floating))
                       and not isinstance(v, (bool, np.bool_)) for v in present):
        if len(present) == len(values) and all(
                isinstance(v, (int, np.integer)) for v in present):
            return np.asarray(values, dtype=np.int64)
        return np.asarray([np.nan if v is None else v for v in values], dtype=np.float64)
    return np.asarray([np.nan if v is None else v for v in values], dtype=object)


def prep_alerts(alerts: list[dict], label, new_drb=None, nondet_fn=None) -> dict:
    """Candidate table of alert packets: candidate | classifications fields
    (columns in order of first appearance), objectId first, the label at
    position 2, new_drb, the engineered features and, with ``nondet_fn(objectId,
    first_jd) -> (jd, diffmaglim)``, each object's last non-detection."""
    rows = [dict(a["candidate"]) | dict(a.get("classifications", {})) for a in alerts]
    names: dict[str, None] = {}
    for r in rows:
        names.update(dict.fromkeys(r))
    items = [("objectId", np.asarray([a["objectId"] for a in alerts]))]
    items += [(k, _column([r.get(k) for r in rows])) for k in names]

    if isinstance(label, (list, np.ndarray)):
        if len(label) != len(alerts):
            raise ValueError(f"{len(label)} labels for {len(alerts)} alerts")
        items.insert(2, ("label", np.asarray(label, dtype=int)))
    elif isinstance(label, (int, np.integer)):
        items.insert(2, ("label", np.full(len(alerts), label, dtype=int)))
    cand = dict(items)
    if new_drb is not None:
        cand["new_drb"] = np.asarray(new_drb)

    cand = engineered_features(cand)

    if nondet_fn is not None and len(alerts):
        ids, jd = cand["objectId"], np.asarray(cand["jd"], dtype=np.float64)
        cand["last_nondet_jd"] = np.full(len(ids), np.nan)
        cand["last_nondet_diffmaglim"] = np.full(len(ids), np.nan)
        for objid in np.unique(ids):
            sel = ids == objid
            nd_jd, lim = nondet_fn(objid, np.fmin.reduce(jd[sel]))
            cand["last_nondet_jd"][sel] = nd_jd
            cand["last_nondet_diffmaglim"][sel] = lim
    return cand


def plot_triplet(trip: np.ndarray):
    """Science / reference / difference three-panel figure."""
    import matplotlib.pyplot as plt
    from matplotlib.colors import LogNorm

    fig, axes = plt.subplots(1, 3, figsize=(8, 2), dpi=120)
    for i, (ax, title) in enumerate(zip(axes, ("Science", "Reference", "Difference"))):
        ax.axis("off")
        ax.imshow(trip[:, :, i], origin="upper", cmap=plt.cm.bone,
                  norm=LogNorm() if i < 2 else None)
        ax.set_title(title)
    return fig
