"""Dataset loaders mirroring the reference's two ingestion paths.

* NPY directory: pre-split X_{train,test,val}.npy / y_*.npy with a label
  axis appended (reference: nsga_penalty.py:57-83).
* HDF5: single mel_spec.h5 with X_train/y_train/classes datasets, rebuilt
  label encoder, stratified 50/25/25 split with random_state=42
  (reference: sa_nsga_penalty.py:42-92).

Both return the same structure: dict with x_train/y_train/x_val/y_val/
x_test/y_test as float32/int32 numpy arrays, y as 1-D class indices (the
reference's trailing label axis is an implementation detail of Keras
sparse-CE; we keep labels 1-D and document the equivalence).

The stratified splits are ``stratified_split``, sklearn's
``train_test_split(..., stratify=y)`` in numpy, index for index, so neither
the HDF5 loader nor the extraction CLI needs sklearn.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Sequence, Tuple

import numpy as np


def _approximate_mode(
    class_counts: np.ndarray, n_draws: int, rng: np.random.RandomState
) -> np.ndarray:
    """sklearn.utils.extmath._approximate_mode: per-class draw counts near
    the multivariate hypergeometric's mode, ties broken with ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_split(
    y: Sequence, test_size: float, seed: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(train, test) indices of a stratified shuffle split: the indices
    ``sklearn.model_selection.train_test_split(x, y, test_size=test_size,
    random_state=seed, stratify=y)`` takes, in its order
    (StratifiedShuffleSplit._iter_indices)."""
    y = np.asarray(y)
    n = len(y)
    if not 0.0 < test_size < 1.0:
        raise ValueError(f"test_size={test_size} should be in (0, 1)")
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    classes, y_indices, class_counts = np.unique(
        y, return_inverse=True, return_counts=True
    )
    if class_counts.min() < 2:
        raise ValueError(
            "the least populated classes have only 1 member: "
            f"{classes[class_counts < 2].tolist()}"
        )
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(
            f"train ({n_train}) and test ({n_test}) sizes must each be at "
            f"least the number of classes ({len(classes)})"
        )
    class_indices = np.split(
        np.argsort(y_indices, kind="mergesort"), np.cumsum(class_counts)[:-1]
    )
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[: n_i[i]])
        test.extend(perm[n_i[i] : n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def three_way_split(
    y: Sequence, holdout: float, test_of_holdout: float, seed: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(train, val, test) indices: a stratified split of ``holdout`` of the
    samples off the training set, then of ``test_of_holdout`` of those into
    the test set, both with ``seed`` (the reference's two chained
    ``train_test_split`` calls, sa_nsga_penalty.py:71-85)."""
    y = np.asarray(y)
    train, rest = stratified_split(y, holdout, seed)
    val, test = stratified_split(y[rest], test_of_holdout, seed)
    return train, rest[val], rest[test]


def load_npy_dir(data_path: str) -> Dict[str, np.ndarray]:
    """Load the reference's .npy layout (nsga_penalty.py:57-83)."""
    def rd(name):
        return np.load(os.path.join(data_path, name))

    return {
        "x_train": rd("X_train.npy").astype(np.float32),
        "x_val": rd("X_val.npy").astype(np.float32),
        "x_test": rd("X_test.npy").astype(np.float32),
        "y_train": rd("y_train.npy").astype(np.int32).reshape(-1),
        "y_val": rd("y_val.npy").astype(np.int32).reshape(-1),
        "y_test": rd("y_test.npy").astype(np.int32).reshape(-1),
    }


def load_hdf5(
    filepath: str, test_size: float = 0.5, random_state: int = 42
) -> Dict[str, np.ndarray]:
    """Load an HDF5 dataset and produce the stratified 50/25/25 split
    (sa_nsga_penalty.py:71-85): first split X into train/temp with
    ``test_size``, then temp into val/test 50/50, both stratified with
    random_state=42."""
    import h5py

    with h5py.File(filepath, "r") as hf:
        data = {name: hf[name][:] for name in hf.keys()}

    x = data["X_train"].astype(np.float32)
    y = data["y_train"].astype(np.int32).reshape(-1)
    classes = None
    if "classes" in data:
        classes = [
            c.decode() if isinstance(c, bytes) else str(c) for c in data["classes"]
        ]

    train, val, test = three_way_split(y, test_size, 0.5, random_state)
    out = {
        "x_train": x[train],
        "y_train": y[train],
        "x_val": x[val],
        "y_val": y[val],
        "x_test": x[test],
        "y_test": y[test],
    }
    if classes is not None:
        out["classes"] = classes
    return out


def save_npy_dir(data: Dict[str, np.ndarray], data_path: str) -> None:
    """Write the reference's .npy layout (for fixtures / interchange)."""
    os.makedirs(data_path, exist_ok=True)
    names = {
        "x_train": "X_train.npy",
        "x_val": "X_val.npy",
        "x_test": "X_test.npy",
        "y_train": "y_train.npy",
        "y_val": "y_val.npy",
        "y_test": "y_test.npy",
    }
    for key, fname in names.items():
        np.save(os.path.join(data_path, fname), data[key])
