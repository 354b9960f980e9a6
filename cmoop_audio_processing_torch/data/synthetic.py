"""Deterministic synthetic spectrogram-like dataset.

The reference consumes private precomputed feature directories
(KWS_10_log_mel_3000, nsga_penalty.py:157; BirdCLEF mel_spec.h5,
sa_nsga_penalty.py:58) that are not in the repo. For tests, benchmarks and
CI we generate a class-separable log-mel-like dataset with the same shapes:
(N, time_steps, features) float arrays, integer labels.

Each class k gets a characteristic time-frequency template (a few Gabor-like
ridges at class-dependent frequencies/onsets); samples are template + colored
noise, so small CNNs reach high-but-not-trivial accuracy and architecture
choices measurably matter — giving search algorithms real signal.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _class_template(k: int, t: int, f: int, rng: np.random.Generator) -> np.ndarray:
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
        tpl += np.exp(
            -((ff - ridge_f) ** 2) / (2 * bw ** 2)
            - ((tt - t0) ** 2) / (2 * tw ** 2)
        )
    return tpl


def make_synthetic(
    num_classes: int = 10,
    n_train: int = 2000,
    n_eval: int = 500,
    time_steps: int = 44,
    features: int = 13,
    seed: int = 1234,
    noise: float = 0.9,
) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    templates = np.stack(
        [_class_template(k, time_steps, features, rng) for k in range(num_classes)]
    )

    def gen(n, split_seed):
        r = np.random.default_rng(seed * 7919 + split_seed)
        y = r.integers(0, num_classes, n).astype(np.int32)
        base = templates[y]
        # colored noise: smooth white noise along time
        white = r.standard_normal((n, time_steps, features))
        kernel = np.array([0.25, 0.5, 0.25])
        smooth = np.apply_along_axis(
            lambda v: np.convolve(v, kernel, mode="same"), 1, white
        )
        amp = 0.8 + 0.4 * r.random((n, 1, 1))
        x = (base * amp + noise * smooth).astype(np.float32)
        return x, y

    x_train, y_train = gen(n_train, 1)
    x_val, y_val = gen(n_eval, 2)
    x_test, y_test = gen(n_eval, 3)
    return {
        "x_train": x_train,
        "y_train": y_train,
        "x_val": x_val,
        "y_val": y_val,
        "x_test": x_test,
        "y_test": y_test,
    }
