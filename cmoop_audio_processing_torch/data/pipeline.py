"""Feature standardization + dataset preparation.

The reference standardizes per-frequency-bin (flatten (N, T, F) -> (N*T, F),
StandardScaler over rows, reshape back) and appends a channel axis. Two
variants exist:

* "train_only" (correct): fit on train, transform val/test
  (acc_size_nsga_1.py:73-107, mobo_penalty.py:57-82).
* "leaky": fit_transform on every split independently
  (nsga_penalty.py:85-155) — kept available behind a flag for behavioral
  studies, NOT the default (SURVEY.md §7 behavioral-fidelity note).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..core.config import DataConfig
from .loaders import load_hdf5, load_npy_dir
from .synthetic import make_synthetic


class Standardizer:
    """Per-feature (last-axis) standardizer over flattened (N*T, F) rows,
    equivalent to sklearn StandardScaler on the reference's reshaped data."""

    def __init__(self):
        self.mean_: np.ndarray | None = None
        self.std_: np.ndarray | None = None

    def fit(self, x: np.ndarray) -> "Standardizer":
        flat = x.reshape(-1, x.shape[-1]).astype(np.float64)
        self.mean_ = flat.mean(axis=0)
        # sklearn uses the biased (ddof=0) std and maps zero-variance
        # features to scale 1.0
        std = flat.std(axis=0)
        self.std_ = np.where(std == 0.0, 1.0, std)
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        flat = x.reshape(-1, x.shape[-1]).astype(np.float64)
        out = (flat - self.mean_) / self.std_
        return out.reshape(x.shape).astype(np.float32)

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)


def standardize_splits(
    data: Dict[str, np.ndarray], variant: str = "train_only"
) -> Dict[str, np.ndarray]:
    out = dict(data)
    scaler = Standardizer()
    if variant == "train_only":
        out["x_train"] = scaler.fit_transform(data["x_train"])
        out["x_val"] = scaler.transform(data["x_val"])
        out["x_test"] = scaler.transform(data["x_test"])
    elif variant == "leaky":
        out["x_train"] = Standardizer().fit_transform(data["x_train"])
        out["x_val"] = Standardizer().fit_transform(data["x_val"])
        out["x_test"] = Standardizer().fit_transform(data["x_test"])
    else:
        raise ValueError(f"unknown scaler variant {variant!r}")
    out["scaler"] = scaler
    return out


def add_channel_axis(data: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = dict(data)
    for k in ("x_train", "x_val", "x_test"):
        if out[k].ndim == 3:
            out[k] = out[k][..., np.newaxis]
    return out


def prepare_dataset(cfg: DataConfig) -> Dict[str, np.ndarray]:
    """Full L1 pipeline: load -> standardize -> channel axis
    (reference: prepare_dataset, nsga_penalty.py:85-155)."""
    if cfg.source == "npy":
        if not cfg.path:
            raise ValueError("DataConfig.path required for source='npy'")
        data = load_npy_dir(cfg.path)
    elif cfg.source == "hdf5":
        if not cfg.path:
            raise ValueError("DataConfig.path required for source='hdf5'")
        data = load_hdf5(cfg.path, test_size=cfg.hdf5_test_size)
    elif cfg.source == "synthetic":
        data = make_synthetic(
            num_classes=cfg.num_classes,
            n_train=cfg.synthetic_train,
            n_eval=cfg.synthetic_eval,
            time_steps=cfg.time_steps,
            features=cfg.features,
            seed=cfg.seed,
        )
    else:
        raise ValueError(f"unknown data source {cfg.source!r}")
    data = standardize_splits(data, cfg.scaler)
    return add_channel_axis(data)
