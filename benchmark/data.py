"""The feature maps a cell trains on, made from the run's seed.

A frozen copy of ``cmoop_audio_processing_torch/data/synthetic.make_synthetic``
(class templates of Gabor-like ridges, colored noise, per-sample gain),
with the noise smoothing written as one vectorized 3-tap filter instead of
``np.apply_along_axis``: the same numbers up to the last bit of the float64
sums. Then the preset's data path: the per-feature standardizer fit on the
train split (``data/pipeline.Standardizer``, "train_only") and a channel
axis. Only the train and validation splits are made.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _class_template(k: int, t: int, f: int) -> np.ndarray:
    tpl = np.zeros((t, f), np.float64)
    tt = np.arange(t)[:, None]
    ff = np.arange(f)[None, :]
    for ridge in range(3):
        f0 = ((k * 2.3 + ridge * 3.1) % f)
        t0 = ((k * 5.7 + ridge * 11.3) % t)
        bw = 1.0 + (k % 3)
        tw = 4.0 + (ridge % 2) * 4.0
        slope = ((k + ridge) % 5 - 2) * 0.15
        ridge_f = f0 + slope * (tt - t0)
        tpl += np.exp(-((ff - ridge_f) ** 2) / (2 * bw ** 2)
                      - ((tt - t0) ** 2) / (2 * tw ** 2))
    return tpl


def _split(templates, n, seed, split_seed, noise):
    num_classes, t, f = templates.shape
    r = np.random.default_rng(seed * 7919 + split_seed)
    y = r.integers(0, num_classes, n).astype(np.int32)
    white = r.standard_normal((n, t, f))
    # np.convolve(v, [0.25, 0.5, 0.25], mode="same") along time
    smooth = 0.5 * white
    smooth[:, 1:] += 0.25 * white[:, :-1]
    smooth[:, :-1] += 0.25 * white[:, 1:]
    amp = 0.8 + 0.4 * r.random((n, 1, 1))
    x = (templates[y] * amp + noise * smooth).astype(np.float32)
    return x, y


def make_synthetic(num_classes: int, n_train: int, n_val: int,
                   time_steps: int, features: int, seed: int,
                   noise: float = 0.9) -> Dict[str, np.ndarray]:
    templates = np.stack([_class_template(k, time_steps, features)
                          for k in range(num_classes)])
    x_train, y_train = _split(templates, n_train, seed, 1, noise)
    x_val, y_val = _split(templates, n_val, seed, 2, noise)
    return {"x_train": x_train, "y_train": y_train,
            "x_val": x_val, "y_val": y_val}


def standardize(data: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Per-feature standardization fit on train (biased std, zero variance
    mapped to 1), applied to both splits; then a channel axis."""
    flat = data["x_train"].reshape(-1, data["x_train"].shape[-1])
    flat = flat.astype(np.float64)
    mean = flat.mean(axis=0)
    std = flat.std(axis=0)
    std = np.where(std == 0.0, 1.0, std)
    out = dict(data)
    for k in ("x_train", "x_val"):
        x = data[k]
        z = (x.reshape(-1, x.shape[-1]).astype(np.float64) - mean) / std
        out[k] = z.reshape(x.shape).astype(np.float32)[..., np.newaxis]
    return out


def cell_data(config: Dict, seed: int) -> Dict[str, np.ndarray]:
    """The standardized splits of a configuration file, from ``seed``."""
    d = config["data"]
    return standardize(make_synthetic(
        num_classes=config["train"]["num_classes"], n_train=d["n_train"],
        n_val=d["n_val"], time_steps=d["time_steps"],
        features=d["features"], seed=seed))
