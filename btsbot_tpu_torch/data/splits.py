"""Dataset construction: cuts, per-object splits, merges, subsets (port of
btsbot_tpu.data.splits).

Candidate tables are dicts of numpy columns (``data.dataset.read_candidates``),
not pandas frames; the file pipeline writes them back with
``data.dataset.write_candidates``.  The semantics are the JAX package's (and
the reference's ``query_data/train_val_test_split.py``):

* band/quality cuts ``only_pd_gr`` / ``only_pd_gr_ps``;
* per-OBJECT random 81/9/10 train/val/test assignment, objects taken in
  order of first appearance (``pd.unique``: ``np.unique`` would sort them
  and reassign every object's split);
* per-object random alert ordinals N;
* rise-phase labeling jd ≤ jd_peak; is_SN / near_threshold flags;
* the dims label-noise cut (peakmag ≤ 18.5 dropped from the dims set);
* subset capping by source_set (trues ≤ N_max_p in train; dims/rejects ≤
  N_max_n; vars/junk the latest N_max_n by jd) and the cuts-string naming
  ``_N100/_Np../_sne/_nnt/_rt``;
* object-level percentage subsampling.

Randomness: the JAX package reseeds numpy's global generator before each
draw; ``np.random.RandomState(seed)`` gives the same numbers without global
state.  "Latest by jd" orders an object's alerts as pandas' ``sort_values``
does (``data.dataset.sort_order``: numpy's quicksort, NaN last), so alerts
with equal jd at the cut fall as they fall in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np

from .dataset import (
    concat_rows,
    group_rows,
    n_rows,
    read_candidates,
    sort_order,
    take_rows,
    write_candidates,
)

NON_SN_TYPES = [
    "AGN", "AGN?", "bogus", "bogus?", "duplicate", "nova", "rock", "star",
    "varstar", "QSO", "CV", "CV?", "CLAGN", "Blazar",
]
_TRUE_ISDIFFPOS = {"t", "T", "1", True, 1}


def _isdiffpos(cand) -> np.ndarray:
    col = np.asarray(cand["isdiffpos"])
    if col.dtype == bool:
        return col
    return np.asarray([v in _TRUE_ISDIFFPOS for v in col.tolist()], dtype=bool)


def only_pd_gr(trips, cand):
    """Positive differences in g or r band."""
    keep = _isdiffpos(cand) & np.isin(cand["fid"], [1, 2])
    return _keep(trips, cand, keep)


def only_pd_gr_ps(trips, cand):
    """only_pd_gr + a valid PanSTARRS crossmatch."""
    keep = (_isdiffpos(cand) & np.isin(cand["fid"], [1, 2])
            & ((np.asarray(cand["sgscore1"]) >= 0) | (np.asarray(cand["sgscore2"]) >= 0)))
    return _keep(trips, cand, keep)


def _keep(trips, cand, keep):
    cand = take_rows(cand, keep)
    if "isdiffpos" in cand:
        cand["isdiffpos"] = _isdiffpos(cand)
    return trips[keep], cand


def create_cuts_str(N_max_p: int, N_max_n: int, sne_only: bool,
                    keep_near_threshold: bool, rise_only: bool) -> str:
    cuts = ""
    if N_max_p:
        if N_max_p == N_max_n:
            cuts += f"_N{N_max_p}"
        else:
            cuts += f"_Np{N_max_p}"
            if N_max_n:
                cuts += f"n{N_max_n}"
    if sne_only:
        cuts += "_sne"
    if not keep_near_threshold:
        cuts += "_nnt"
    if rise_only:
        cuts += "_rt"
    return cuts


def assign_splits(trips: np.ndarray, cand: dict, set_name: str, cuts=None,
                  seed: int = 2, dims_types: dict | None = None):
    """Apply cuts, assign per-object splits / N ordinals / flags.  Returns
    (trips, cand) with columns source_set, N, split, is_SN, near_threshold,
    is_rise added.  ``dims_types``: the dims source list (columns ZTFID,
    type), whose non-SN types keep is_SN False."""
    if cuts is not None:
        trips, cand = cuts(trips, cand)
    cand = dict(cand)
    n = n_rows(cand)
    peakmag = np.asarray(cand["peakmag"], dtype=np.float64)
    cand["source_set"] = np.full(n, set_name)
    cand["N"] = np.zeros(n, dtype=np.int64)
    cand["split"] = np.full(n, "", dtype="<U5")
    cand["is_SN"] = np.full(n, set_name in ("trues", "extIas"))
    cand["near_threshold"] = (peakmag > 18.4) & (peakmag < 18.6)
    cand["is_rise"] = np.zeros(n, dtype=bool)

    objs, rows = group_rows(cand["objectId"])
    splits = np.random.RandomState(seed).choice(
        ["train", "val", "test"], size=len(objs), p=[0.81, 0.09, 0.10])
    jd, magpsf = np.asarray(cand["jd"]), np.asarray(cand["magpsf"])
    for i, idx in enumerate(rows):
        # rise alerts: everything at or before the global peak (min magpsf)
        jd_peak = jd[idx][int(np.argmin(magpsf[idx]))]
        cand["is_rise"][idx[jd[idx] <= jd_peak]] = True
        # seeded per-object random alert ordinals 1..N_tot
        cand["N"][idx] = np.random.RandomState(seed).choice(
            np.arange(1, len(idx) + 1), size=len(idx), replace=False)
        cand["split"][idx] = splits[i]

    if set_name == "dims":
        if dims_types is not None:
            sn_ids = np.asarray(dims_types["ZTFID"])[
                ~np.isin(dims_types["type"], NON_SN_TYPES)]
            cand["is_SN"][np.isin(cand["objectId"], sn_ids)] = True
        # label-noise cut: keep only genuinely dim sources
        keep = peakmag > 18.5
        trips, cand = trips[keep], take_rows(cand, keep)
    return trips, cand


def split_apart(trips, cand) -> dict:
    """{'train'|'val'|'test': (trips, cand)} by the split column."""
    out = {}
    for split in ("train", "val", "test"):
        idx = np.nonzero(np.asarray(cand["split"]) == split)[0]
        out[split] = (trips[idx], take_rows(cand, idx))
    return out


def merge_sets(parts, seed: int = 2):
    """Concatenate (trips, cand) pairs and shuffle rows together."""
    trips = np.concatenate([t for t, _ in parts], axis=0)
    cand = concat_rows([c for _, c in parts])
    n = n_rows(cand)
    order = np.random.RandomState(seed).choice(np.arange(n), size=n, replace=False)
    return trips[order], take_rows(cand, order)


def create_subset(trips: np.ndarray, cand: dict, split_name: str, N_max_p: int,
                  N_max_n: int = 0, sne_only: bool = False,
                  keep_near_threshold: bool = True, rise_only: bool = False):
    """Cap alerts per object by source_set and apply flag cuts.  Returns
    (trips, cand, cuts_str)."""
    if N_max_p and not N_max_n:
        N_max_n = N_max_p
    cuts_str = create_cuts_str(N_max_p, N_max_n, sne_only, keep_near_threshold,
                               rise_only)

    if N_max_p:
        mask = np.zeros(n_rows(cand), dtype=bool)
        source, N, jd = (np.asarray(cand[k]) for k in ("source_set", "N", "jd"))
        for idx in group_rows(cand["objectId"])[1]:
            source_set = source[idx[0]]
            if split_name == "train":
                if source_set == "trues":
                    mask[idx] = N[idx] <= N_max_p
                elif source_set in ("dims", "rejects"):
                    mask[idx] = N[idx] <= N_max_n
            elif source_set in ("trues", "dims", "rejects"):
                mask[idx] = True
            if source_set in ("vars", "junk"):
                mask[idx[sort_order(jd[idx])][-N_max_n:]] = True
        trips, cand = trips[mask], take_rows(cand, mask)

    for flag, wanted in (("is_SN", sne_only), ("near_threshold", not keep_near_threshold),
                         ("is_rise", rise_only)):
        if wanted:
            sel = np.asarray(cand[flag], dtype=bool)
            if flag == "near_threshold":
                sel = ~sel
            trips, cand = trips[sel], take_rows(cand, sel)
    return trips, cand, cuts_str


def subsample_objects(trips, cand, perc_to_keep: float = 10, seed: int = 2):
    """Random object-level subsample."""
    objs = group_rows(cand["objectId"])[0]
    keep_objs = np.random.RandomState(seed).choice(
        objs, size=int(len(objs) * perc_to_keep / 100), replace=False)
    sel = np.isin(cand["objectId"], keep_objs)
    return trips[sel], take_rows(cand, sel)


# ------------------------- file-based wrappers ----------------------------

def build_dataset_files(base_dir: str, out_dir: str, set_names, version_name: str,
                        cuts=only_pd_gr_ps, seed: int = 2, N_max_p: int = 100,
                        N_max_n: int = 100) -> None:
    """Per-set split assignment → per-split merge → N-capped subsets, with
    the reference's file naming
    (``{split}_{cand,triplets}_{version}{cuts}.{csv,npy}``)."""
    per_split: dict[str, list] = {"train": [], "val": [], "test": []}
    for set_name in set_names:
        trips = np.load(os.path.join(base_dir, f"{set_name}_triplets.npy"))
        cand = read_candidates(os.path.join(base_dir, f"{set_name}_candidates.csv"))
        dims_types = None
        dims_csv = os.path.join(base_dir, "dims.csv")
        if set_name == "dims" and os.path.exists(dims_csv):
            dims_types = read_candidates(dims_csv)
        trips, cand = assign_splits(trips, cand, set_name, cuts=cuts, seed=seed,
                                    dims_types=dims_types)
        for split, pair in split_apart(trips, cand).items():
            per_split[split].append(pair)

    os.makedirs(out_dir, exist_ok=True)
    for split, parts in per_split.items():
        trips, cand = merge_sets(parts, seed=seed)
        np.save(os.path.join(out_dir, f"{split}_triplets_{version_name}.npy"), trips)
        write_candidates(cand, os.path.join(out_dir, f"{split}_cand_{version_name}.csv"))
        s_trips, s_cand, cuts_str = create_subset(trips, cand, split, N_max_p=N_max_p,
                                                  N_max_n=N_max_n)
        np.save(os.path.join(out_dir, f"{split}_triplets_{version_name}{cuts_str}.npy"),
                s_trips)
        write_candidates(s_cand, os.path.join(
            out_dir, f"{split}_cand_{version_name}{cuts_str}.csv"))
