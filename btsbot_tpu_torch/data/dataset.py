"""In-memory alert dataset + batch pipeline (port of btsbot_tpu.data.dataset).

The reference's on-disk convention (``{split}_cand_{version}_N{N}.csv`` +
``{split}_triplets_{version}_N{N}.npy``) is read with the ``csv`` module and
numpy: ``candidates`` is a dict of numpy columns (bool for True / False,
int64 where every value is an integer, float64 where every value is a
number or empty, strings otherwise), not a pandas DataFrame.  As in the JAX
package:

* triplets stay NHWC as stored;
* NaN-triplet rows are dropped with their candidate rows for "train";
  NaN metadata is an error;
* ``iterate_batches`` shuffles with ``np.random.default_rng(seed)``, so the
  two packages see the same batches for the same seed.

``write_candidates`` writes such a table back in pandas' ``to_csv(index=False)``
format (floats as numpy's shortest repr, NaN as an empty field, bools as
True / False, ``\n`` line ends), so the JAX package's ``pd.read_csv`` and
``read_candidates`` read it back alike.  ``take_rows``, ``concat_rows``,
``group_rows`` and ``sort_order`` are the row
operations the data layer (``data.splits``, ``data.alerts``,
``data.query``) needs of such a table.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Iterator

import numpy as np

from ..utils.profiling import annotate


@dataclasses.dataclass
class AlertDataset:
    labels: np.ndarray                      # (N,) float32 0/1
    images: np.ndarray | None = None        # (N, H, W, 3) float32 NHWC
    metadata: np.ndarray | None = None      # (N, M) float32
    candidates: dict | None = None          # column name -> (N,) numpy array

    def __post_init__(self):
        n = len(self.labels)
        for name in ("images", "metadata"):
            arr = getattr(self, name)
            if arr is not None and len(arr) != n:
                raise ValueError(f"{name} has {len(arr)} rows for {n} labels")

    def __len__(self) -> int:
        return len(self.labels)

    @property
    def num_pos(self) -> int:
        return int(np.sum(self.labels == 1))

    @property
    def num_neg(self) -> int:
        return int(np.sum(self.labels == 0))

    @property
    def pos_weight(self) -> float:
        """num_notbts / num_bts (reference train.py:211)."""
        return self.num_neg / max(1, self.num_pos)


def split_paths(data_dir: str, split: str, version: str, n_max: int = 100):
    n_str = f"_N{n_max}"
    cand = os.path.join(data_dir, f"{split}_cand_{version}{n_str}.csv")
    trip = os.path.join(data_dir, f"{split}_triplets_{version}{n_str}.npy")
    return cand, trip


def _column(values: list[str]) -> np.ndarray:
    if values and set(values) <= {"True", "False"}:
        return np.asarray([v == "True" for v in values])
    try:
        return np.asarray([int(v) for v in values], dtype=np.int64)
    except ValueError:
        pass
    try:
        return np.asarray([float(v) if v != "" else np.nan for v in values],
                          dtype=np.float64)
    except ValueError:
        return np.asarray(values)


def read_candidates(path: str) -> dict[str, np.ndarray]:
    """A candidate CSV as a dict of numpy columns; an unnamed column gets
    pandas' name for it (``Unnamed: i``)."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    names = [h or f"Unnamed: {i}" for i, h in enumerate(header)]
    cols = list(zip(*rows)) if rows else [()] * len(names)
    return {name: _column(list(col)) for name, col in zip(names, cols)}


def n_rows(cand: dict) -> int:
    return len(next(iter(cand.values()))) if cand else 0


def take_rows(cand: dict, index) -> dict:
    """The rows ``index`` (a mask or positions) of every column."""
    return {k: np.asarray(v)[index] for k, v in cand.items()}


def concat_rows(parts: list[dict]) -> dict:
    """Tables stacked row-wise (``pd.concat``): the union of their columns
    in order of first appearance; a column a part lacks is NaN there, which
    makes a numeric column float64 and any other an object column, as in
    pandas."""
    names: list[str] = []
    for part in parts:
        names += [k for k in part if k not in names]
    out = {}
    for name in names:
        cols = [np.asarray(part[name]) if name in part else None for part in parts]
        if all(c is not None for c in cols):
            out[name] = np.concatenate(cols)
            continue
        dtype = np.float64 if all(c.dtype.kind in "iuf" for c in cols if c is not None) \
            else object
        out[name] = np.concatenate([
            c.astype(dtype) if c is not None else np.full(n_rows(part), np.nan, dtype=dtype)
            for c, part in zip(cols, parts)])
    return out


def group_rows(values) -> tuple[np.ndarray, list[np.ndarray]]:
    """(distinct values in order of first appearance, each one's row
    positions in row order)."""
    values = np.asarray(values)
    uniq, first, inverse = np.unique(values, return_index=True, return_inverse=True)
    rows = np.argsort(inverse, kind="stable")
    groups = np.split(rows, np.cumsum(np.bincount(inverse, minlength=len(uniq)))[:-1])
    order = np.argsort(first)
    return uniq[order], [groups[g] for g in order]


def sort_order(values, ascending: bool = True) -> np.ndarray:
    """Row order of pandas' ``sort_values`` on one float column: numpy's
    default (quicksort) argsort of the non-NaN values, NaNs last.  Ties fall
    as numpy's quicksort leaves them, exactly as in the JAX package on the
    same numpy."""
    values = np.asarray(values, dtype=np.float64)
    nan = np.isnan(values)
    idx, keep = np.arange(len(values)), values[~nan]
    idx_keep = idx[~nan]
    if not ascending:
        keep, idx_keep = keep[::-1], idx_keep[::-1]
    order = idx_keep[keep.argsort(kind="quicksort")]
    if not ascending:
        order = order[::-1]
    return np.concatenate([order, idx[nan]])


def _csv_field(col: np.ndarray) -> list[str]:
    if col.dtype.kind == "f":
        text = col.astype(str)
        text[np.isnan(col)] = ""
        return text.tolist()
    if col.dtype.kind in "biuU":
        return col.astype(str).tolist()
    return ["" if v is None or (isinstance(v, float) and np.isnan(v)) else str(v)
            for v in col.tolist()]


def write_candidates(cand: dict, path: str) -> None:
    """Write a candidate table as pandas' ``to_csv(path, index=False)``
    would."""
    names = list(cand)
    cols = [_csv_field(np.asarray(cand[k])) for k in names]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(names)
        writer.writerows(zip(*cols))


def load_split(
    config,
    split: str,
    data_dir: str,
    drop_nan_triplets: bool | None = None,
) -> AlertDataset:
    """Load one split per the reference's conventions.  NaN-row filtering
    defaults to on for "train" (reference train.py:143-153) and off
    otherwise."""
    cand_path, trip_path = split_paths(
        data_dir, split, config["train_data_version"], config.get("N_max", 100))
    cand = read_candidates(cand_path)
    images = None
    if config.need_triplets:
        images = np.load(trip_path).astype(np.float32)
        if drop_nan_triplets is None:
            drop_nan_triplets = split == "train"
        if drop_nan_triplets and np.any(np.isnan(images)):
            good = ~np.isnan(images).any(axis=(1, 2, 3))
            images = images[good]
            cand = take_rows(cand, good)
    labels = cand["label"].astype(np.float32)

    metadata = None
    if config.need_metadata:
        cols = config.get("metadata_cols")
        if not cols:
            raise ValueError("Metadata columns not found in config.")
        metadata = np.stack([cand[c] for c in cols], axis=1).astype(np.float32)
        if np.isnan(metadata).any():
            counts = np.isnan(metadata).sum(axis=0)
            raise ValueError(
                "NaNs found in metadata columns: "
                f"{ {c: int(n) for c, n in zip(cols, counts) if n} }")

    return AlertDataset(labels=labels, images=images, metadata=metadata,
                        candidates=cand)


def filter_dataset(dataset: AlertDataset, mask: np.ndarray) -> AlertDataset:
    """Row-subset an AlertDataset (mask: (N,) bool), keeping cand aligned."""
    mask = np.asarray(mask, dtype=bool)
    cand = dataset.candidates
    return AlertDataset(
        labels=dataset.labels[mask],
        images=None if dataset.images is None else dataset.images[mask],
        metadata=None if dataset.metadata is None else dataset.metadata[mask],
        candidates=None if cand is None else take_rows(cand, mask),
    )


def apply_val_cuts(dataset: AlertDataset, config) -> AlertDataset:
    """Honor the ``val_sne_only`` / ``val_keep_near_threshold`` /
    ``val_rise_only`` config flags; flags naming absent columns are
    ignored."""
    cand = dataset.candidates
    if cand is None:
        return dataset
    mask = np.ones(len(dataset), dtype=bool)
    if config.get("val_sne_only") and "is_SN" in cand:
        mask &= cand["is_SN"].astype(bool)
    if not config.get("val_keep_near_threshold", True) and "near_threshold" in cand:
        mask &= ~cand["near_threshold"].astype(bool)
    if config.get("val_rise_only") and "is_rise" in cand:
        mask &= cand["is_rise"].astype(bool)
    if mask.all():
        return dataset
    return filter_dataset(dataset, mask)


def epoch_order(n: int, seed: int | None) -> np.ndarray:
    """The JAX package's shuffled order of an epoch (data/dataset.py:154-156)."""
    order = np.arange(n)
    np.random.default_rng(seed).shuffle(order)
    return order


def iterate_batches(
    dataset: AlertDataset,
    batch_size: int,
    *,
    shuffle: bool = False,
    drop_last: bool = False,
    seed: int | None = None,
) -> Iterator[tuple[np.ndarray | None, np.ndarray | None, np.ndarray]]:
    """Yield (images, metadata, labels) numpy batches."""
    n = len(dataset)
    order = epoch_order(n, seed) if shuffle else np.arange(n)
    end = (n // batch_size) * batch_size if drop_last else n
    for start in range(0, end, batch_size):
        idx = order[start:start + batch_size]
        with annotate("feed.gather"):  # closed before the consumer's code runs
            batch = (
                None if dataset.images is None else dataset.images[idx],
                None if dataset.metadata is None else dataset.metadata[idx],
                dataset.labels[idx],
            )
        yield batch


def num_batches(dataset: AlertDataset, batch_size: int,
                drop_last: bool = False) -> int:
    n = len(dataset)
    return n // batch_size if drop_last else -(-n // batch_size)
