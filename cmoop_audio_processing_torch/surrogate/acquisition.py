"""MOBO surrogate stack and acquisition functions.

Reference semantics (mobo_penalty.py:252-287):

* One GP per output column: Matern(nu=2.5), normalize_y=True, default
  single-start hyperparameter optimization over length_scale only.
* penalized_acquisition over candidate vectors in [0,1]^6:
  -sum_i(mu_f_i + lam * mu_CV) — maximize the negative penalized sum.

Host/device split, as in cmoop_audio_processing_tpu/surrogate/
acquisition.py: the GP FITS are one batched computation on the run's device
(gp.fit_gp_multi); candidate SCORING is one vectorized float64 host pass
with the candidate<->archive distance matrix shared across all models
(gp.predict_gps_shared_x): at 500 x archive scale a device launch would
cost more than the matmul it performs.

LCB (mu - k*sigma) used by the Lamarckian local search
(sa_nsga_local.py:368-371) also lives here.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..core.rng import fold_in, seed_key
from .gp import GPConfig, GPState, fit_gp_multi, predict_gps_shared_x

MOBO_GP_CONFIG = GPConfig(
    nu=2.5,
    with_constant=False,
    with_noise=False,
    n_restarts=1,  # sklearn default: single start from length_scale=1.0
    steps=150,
)


def train_gps(
    x: np.ndarray,
    y: np.ndarray,
    seed: int = 0,
    device="cuda",
) -> List[GPState]:
    """One GP per column of y (mobo_penalty.py:252-263); all columns' fits
    run as one batched computation on ``device``. Column ``d``'s restart
    draws are seeded with ``fold_in(seed_key(seed), d)``."""
    y = np.atleast_2d(np.asarray(y, np.float64))
    if not (y.shape[0] == np.asarray(x).shape[0] and y.ndim == 2):
        y = y.T
    cols = y.shape[1]
    seeds = [fold_in(seed_key(seed), d) for d in range(cols)]
    return fit_gp_multi(
        x, [y[:, d] for d in range(cols)], MOBO_GP_CONFIG, seeds,
        normalize_y=True, device=device,
    )


def predict_gps(models: Sequence[GPState], x: np.ndarray) -> np.ndarray:
    """(n_samples, n_models) predicted means (mobo_penalty.py:265-273).
    All models share the archive's feature matrix, so the distance matrix is
    computed once."""
    return predict_gps_shared_x(list(models), x, MOBO_GP_CONFIG)


def penalized_acquisition(
    x_candidates: np.ndarray,
    obj_gps: Sequence[GPState],
    cv_gp: GPState,
    lam: float,
) -> np.ndarray:
    """Negative penalized sum (maximize) over candidates
    (mobo_penalty.py:275-287). One shared-distance scoring pass covers the
    objective GPs and the CV GP together."""
    mu = predict_gps(list(obj_gps) + [cv_gp], x_candidates)  # (n, n_obj+1)
    obj_mu, cv_mu = mu[:, :-1], mu[:, -1]
    penalized = obj_mu + lam * cv_mu.reshape(-1, 1)
    return -np.sum(penalized, axis=1)


def lcb(means: np.ndarray, stds: np.ndarray, k: float = 1.0) -> np.ndarray:
    """Lower confidence bound mu - k*sigma (sa_nsga_local.py:368-371)."""
    return np.asarray(means) - k * np.asarray(stds)
