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
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


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
    from sklearn.model_selection import train_test_split

    with h5py.File(filepath, "r") as hf:
        data = {name: hf[name][:] for name in hf.keys()}

    x = data["X_train"].astype(np.float32)
    y = data["y_train"].astype(np.int32).reshape(-1)
    classes = None
    if "classes" in data:
        classes = [
            c.decode() if isinstance(c, bytes) else str(c) for c in data["classes"]
        ]

    x_train, x_temp, y_train, y_temp = train_test_split(
        x, y, test_size=test_size, random_state=random_state, stratify=y
    )
    x_val, x_test, y_val, y_test = train_test_split(
        x_temp, y_temp, test_size=0.5, random_state=random_state, stratify=y_temp
    )
    out = {
        "x_train": x_train,
        "y_train": y_train,
        "x_val": x_val,
        "y_val": y_val,
        "x_test": x_test,
        "y_test": y_test,
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
