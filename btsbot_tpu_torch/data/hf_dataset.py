"""HuggingFace ``datasets`` export of a training split (port of
btsbot_tpu.data.hf_dataset).

Bundles a split's triplets and candidate table (a dict of numpy columns)
into a ``datasets.Dataset`` with an Array3D(63, 63, 3) triplet feature and
one feature per column, typed from the column's numpy dtype (the JAX
package reads pandas' dtypes for the same mapping), saved to disk.
``datasets`` is imported only here.
"""

from __future__ import annotations

import os

import numpy as np

from .dataset import read_candidates


def _feature(name: str, col: np.ndarray):
    from datasets import Value

    kind = col.dtype.kind
    if name == "candid" or kind in "USO":
        return Value("string")
    if kind == "b":
        return Value("bool")
    if kind in "iu":
        return Value("int32")
    if kind == "f":
        return Value("float32")
    raise ValueError(f"Unknown dtype for column {name}: {col.dtype}")


def dataset_from_arrays(triplets: np.ndarray, cand: dict):
    """The datasets.Dataset (columns from cand + 'triplet')."""
    from datasets import Array3D, Dataset, Features

    features = {"triplet": Array3D(dtype="float32", shape=(63, 63, 3))}
    data = {}
    for name, col in cand.items():
        col = np.asarray(col)
        features[name] = _feature(name, col)
        data[name] = col.tolist()
    if "candid" in data:
        data["candid"] = [str(x) for x in data["candid"]]
    data["triplet"] = [np.asarray(t, dtype=np.float32) for t in triplets]
    return Dataset.from_dict(data, features=Features(features))


def convert_to_hf(split: str, version: str, data_dir: str = "data",
                  n_max: int = 100, out_dir: str | None = None):
    """File-based wrapper with the reference's naming."""
    triplets = np.load(os.path.join(data_dir, f"{split}_triplets_{version}_N{n_max}.npy"))
    cand = read_candidates(os.path.join(data_dir, f"{split}_cand_{version}_N{n_max}.csv"))
    ds = dataset_from_arrays(triplets, cand)
    ds.save_to_disk(out_dir or os.path.join(data_dir, f"{split}_{version}_N{n_max}"))
    return ds
