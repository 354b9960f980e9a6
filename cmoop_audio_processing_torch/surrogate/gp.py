"""Gaussian-process regression (Kriging) with the hyperparameter fits on
the device.

Replaces sklearn's GaussianProcessRegressor (the reference's surrogate core,
sa_nsga_penalty.py:282-286), as cmoop_audio_processing_tpu/surrogate/gp.py
does in JAX:

* Marginal-likelihood hyperparameter fitting via Cholesky NLL, optimized
  with Adam on log-hyperparameters. sklearn restarts L-BFGS-B serially
  (n_restarts_optimizer=10); here every target x restart fit is one batched
  torch computation in f32 on the run's device: a (targets, restarts, N, N)
  stack of Gram matrices, factorized together each step.
* Training sets are padded to the next power of two and padded rows carry
  huge per-point noise (PAD_NOISE), making them statistically inert. The
  padding and the relative jitter are part of the objective being
  minimised, so they are kept as the JAX package has them.
* A restart whose Gram fails to factor gets NLL 1e10 (``cholesky_ex``
  reports the failure instead of raising); its gradients stay in its own
  batch entry.
* float32 conditioning: sklearn factorizes in float64 with alpha=1e-10; at
  float32 a noise-free smooth-kernel Gram needs jitter scaled to the kernel
  diagonal (1e-6 relative), and the final posterior factorization and every
  prediction run in float64 numpy on the host (tiny matrices).

Restart initial points come from an explicit ``torch.Generator`` per fit
(drawn on the CPU, so the CPU and CUDA draw the same points), or from the
caller (``inits``), so a test can feed this module and the JAX package the
same starting points.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.rng import fold_in, seed_key
from .kernels import matern_from_dist, sqdist

JITTER = 1e-10  # sklearn GaussianProcessRegressor default alpha
PAD_NOISE = 1e6  # virtual noise carried by padding rows
PARAMS = ("log_c", "log_l", "log_n")
# optax.adam's defaults (the JAX package's optimizer)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class GPConfig:
    nu: float = 1.5
    # which hyperparameters exist (MOBO's bare Matern has no constant/noise)
    with_constant: bool = True
    with_noise: bool = True
    n_restarts: int = 10
    steps: int = 200
    lr: float = 0.08
    log_bounds: Tuple[float, float] = (float(np.log(1e-5)), float(np.log(1e5)))
    # Restart initials are drawn from this narrower practical band: Adam
    # (unlike sklearn's L-BFGS-B) moves O(lr*steps) in log-space, so seeding
    # across the full +-11.5 bound range would strand restarts in degenerate
    # basins. Best-so-far tracking along the trajectory guards overshoot.
    init_bounds: Tuple[float, float] = (float(np.log(1e-2)), float(np.log(1e2)))
    init_log_constant: float = 0.0  # C(1.0)
    init_log_length: float = 0.0  # Matern(length_scale=1.0)
    init_log_noise: float = float(np.log(0.1))  # WhiteKernel(0.1)


class GPState(NamedTuple):
    """Fitted posterior: kernel hyperparams + float64 Cholesky cache."""

    log_c: float
    log_l: float
    log_n: float
    x: np.ndarray  # (N, D) training inputs (float64)
    point_noise: np.ndarray  # (N,) zeros: the posterior has no padding
    chol: np.ndarray  # (N, N) lower Cholesky of K (float64)
    alpha: np.ndarray  # (N,) K^-1 y (float64)
    y_mean: float  # normalize_y shift
    y_std: float  # normalize_y scale


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _nll(params: Dict[str, torch.Tensor], dist, y, point_noise, cfg: GPConfig):
    """(T, R) negative log marginal likelihoods: params (T, R) each, dist
    (N, N) shared, y (T, N)."""
    log_l = params["log_l"][..., None, None]
    k = matern_from_dist(dist, torch.exp(log_l), cfg.nu)
    if cfg.with_constant:
        k = torch.exp(params["log_c"])[..., None, None] * k
    diag = point_noise + JITTER
    if cfg.with_noise:
        diag = diag + torch.exp(params["log_n"])[..., None]
    # relative jitter keeps float32 Cholesky finite for smooth kernels
    diag = diag + 1e-6 * torch.diagonal(k, dim1=-2, dim2=-1).mean(-1, keepdim=True)
    chol, info = torch.linalg.cholesky_ex(k + torch.diag_embed(diag))
    yb = y[:, None, :, None].expand(*chol.shape[:-1], 1)
    alpha = torch.cholesky_solve(yb, chol)[..., 0]
    n = dist.shape[0]
    nll = (
        0.5 * (yb[..., 0] * alpha).sum(-1)
        + torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
        + 0.5 * n * math.log(2 * math.pi)
    )
    return torch.where(torch.isfinite(nll) & (info == 0), nll,
                       torch.full_like(nll, 1e10))


def _fit_restarts(dist, ys, point_noise, inits, cfg: GPConfig):
    """Adam on every (target, restart) at once, keeping each restart's best
    point along its trajectory and checking the final point (the JAX
    package's scan, gp.py:121-160). Returns {name: (T,)} of the best
    restart per target."""
    lo, hi = cfg.log_bounds
    params = {k: inits[k].clone().requires_grad_(True) for k in PARAMS}
    m = {k: torch.zeros_like(v) for k, v in inits.items()}
    v2 = {k: torch.zeros_like(v) for k, v in inits.items()}
    with torch.no_grad():
        best_l = _nll(params, dist, ys, point_noise, cfg)
    best_p = {k: inits[k].clone() for k in PARAMS}
    for step in range(1, cfg.steps + 1):
        loss = _nll(params, dist, ys, point_noise, cfg)
        grads = torch.autograd.grad(loss.sum(), [params[k] for k in PARAMS],
                                    allow_unused=True)
        with torch.no_grad():
            better = loss < best_l
            for k in PARAMS:
                best_p[k] = torch.where(better, params[k], best_p[k])
            best_l = torch.where(better, loss, best_l)
            c1, c2 = 1 - ADAM_B1 ** step, 1 - ADAM_B2 ** step
            for k, g in zip(PARAMS, grads):
                if g is None:  # a hyperparameter the kernel does not use
                    g = torch.zeros_like(params[k])
                m[k] = (1 - ADAM_B1) * g + ADAM_B1 * m[k]
                v2[k] = (1 - ADAM_B2) * g * g + ADAM_B2 * v2[k]
                upd = (m[k] / c1) / (torch.sqrt(v2[k] / c2) + ADAM_EPS)
                params[k].add_(-cfg.lr * upd).clamp_(lo, hi)
    with torch.no_grad():
        final_l = _nll(params, dist, ys, point_noise, cfg)
        better = final_l < best_l
        for k in PARAMS:
            best_p[k] = torch.where(better, params[k], best_p[k])
        best_l = torch.minimum(best_l, final_l)
        pick = torch.argmin(best_l, dim=1, keepdim=True)
        return {k: best_p[k].gather(1, pick)[:, 0] for k in PARAMS}


def _scale_target(y, normalize_y: bool):
    y_raw = np.asarray(y, np.float32).reshape(-1)
    if normalize_y:
        y_mean = float(y_raw.mean())
        y_std = float(max(y_raw.std(), 1e-12))
    else:
        y_mean, y_std = 0.0, 1.0
    return (y_raw - y_mean) / y_std, y_mean, y_std


def _pad_training(x: np.ndarray, y_n: np.ndarray):
    """Pad to a power of two with inert (huge-noise) rows."""
    n, d = x.shape
    np_pad = _next_pow2(max(n, 1))
    x_p = np.zeros((np_pad, d), np.float32)
    x_p[:n] = x
    y_p = np.zeros((np_pad,), np.float32)
    y_p[:n] = y_n
    noise_p = np.full((np_pad,), PAD_NOISE, np.float32)
    noise_p[:n] = 0.0
    return x_p, y_p, noise_p


def make_inits(cfg: GPConfig, seed: int) -> Dict[str, np.ndarray]:
    """Restart initial points, (n_restarts + 1,) each: the configured
    initial point first, then uniform draws in ``init_bounds`` from a
    ``torch.Generator`` seeded with ``seed``."""
    ilo, ihi = cfg.init_bounds
    gen = torch.Generator().manual_seed(int(seed))
    first = {"log_c": cfg.init_log_constant, "log_l": cfg.init_log_length,
             "log_n": cfg.init_log_noise}
    out = {}
    for k in PARAMS:
        rand = torch.rand(max(cfg.n_restarts, 1), generator=gen) * (ihi - ilo) + ilo
        out[k] = np.concatenate([[np.float32(first[k])], rand.numpy()]).astype(np.float32)
    return out


def _params_to_logs(params, t: int, cfg: GPConfig):
    log_c = float(params["log_c"][t]) if cfg.with_constant else 0.0
    log_n = float(params["log_n"][t]) if cfg.with_noise else float(np.log(JITTER))
    return log_c, float(params["log_l"][t]), log_n


def fit_gp_multi(
    x: np.ndarray,
    ys: Sequence,
    cfg: GPConfig = GPConfig(),
    seeds: Optional[Sequence[int]] = None,
    normalize_y: bool = False,
    device="cuda",
    inits: Optional[Dict[str, np.ndarray]] = None,
) -> List[GPState]:
    """Fit one GP per target over a SHARED input matrix, every target x
    restart fit in one batched computation on ``device``. ``seeds`` seed
    each target's restart draws (default: ``fold_in(seed_key(0), i)``);
    ``inits`` ({name: (targets, restarts)} numpy) replaces the draws."""
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    ys = [np.asarray(y, np.float32).reshape(-1) for y in ys]
    if inits is None:
        if seeds is None:
            seeds = [fold_in(seed_key(0), i) for i in range(len(ys))]
        per_target = [make_inits(cfg, s) for s in seeds]
        inits = {k: np.stack([p[k] for p in per_target]) for k in PARAMS}

    scaled = [_scale_target(y, normalize_y) for y in ys]
    padded = [_pad_training(x, y_n) for (y_n, _, _) in scaled]
    x_p, _, noise_p = padded[0]

    def put(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    x_d = put(x_p)
    dist = torch.sqrt(sqdist(x_d, x_d) + 1e-30)
    params = _fit_restarts(
        dist, put(np.stack([p[1] for p in padded])), put(noise_p),
        {k: put(inits[k]) for k in PARAMS}, cfg,
    )
    params = {k: v.cpu().numpy() for k, v in params.items()}
    return [
        _host_posterior(x, y_n, cfg, *_params_to_logs(params, t, cfg),
                        y_mean, y_std)
        for t, (y_n, y_mean, y_std) in enumerate(scaled)
    ]


def fit_gp(
    x: np.ndarray,
    y: np.ndarray,
    cfg: GPConfig = GPConfig(),
    seed: int = 0,
    normalize_y: bool = False,
    device="cuda",
) -> GPState:
    """Fit kernel hyperparameters by parallel multi-restart NLL minimization
    and cache the float64 posterior Cholesky."""
    return fit_gp_multi(x, [y], cfg, [seed], normalize_y, device)[0]


def _host_posterior(x, y_n, cfg, log_c, log_l, log_n, y_mean, y_std) -> GPState:
    from scipy.linalg import cho_solve

    n = x.shape[0]
    k = _np_kernel(x, x, log_c, log_l, cfg.nu)
    diag = np.full(n, JITTER)
    if cfg.with_noise:
        diag = diag + np.exp(log_n)
    k = k + np.diag(diag)
    chol = np.linalg.cholesky(k)
    alpha = cho_solve((chol, True), y_n.astype(np.float64))
    return GPState(
        log_c=log_c,
        log_l=log_l,
        log_n=log_n,
        x=x.astype(np.float64),
        point_noise=np.zeros(n),
        chol=chol,
        alpha=alpha,
        y_mean=y_mean,
        y_std=y_std,
    )


def _np_pdist(x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """(N, M) float64 pairwise Euclidean distances."""
    x1 = np.asarray(x1, np.float64)
    x2 = np.asarray(x2, np.float64)
    d2 = (
        (x1 ** 2).sum(1)[:, None]
        + (x2 ** 2).sum(1)[None, :]
        - 2.0 * x1 @ x2.T
    )
    return np.sqrt(np.maximum(d2, 0.0))


def _np_kernel_from_dist(dist: np.ndarray, log_c, log_l, nu) -> np.ndarray:
    d = dist / np.exp(log_l)
    if nu == 0.5:
        k = np.exp(-d)
    elif nu == 1.5:
        s = np.sqrt(3.0) * d
        k = (1.0 + s) * np.exp(-s)
    elif nu == 2.5:
        s = np.sqrt(5.0) * d
        k = (1.0 + s + s ** 2 / 3.0) * np.exp(-s)
    else:
        raise ValueError(f"unsupported nu={nu}")
    return np.exp(log_c) * k


def _np_kernel(x1: np.ndarray, x2: np.ndarray, log_c, log_l, nu) -> np.ndarray:
    """float64 host kernel, same closed forms as kernels.matern."""
    return _np_kernel_from_dist(_np_pdist(x1, x2), log_c, log_l, nu)


def predict_gp(
    state: GPState,
    xq: np.ndarray,
    cfg: GPConfig = GPConfig(),
    return_std: bool = False,
):
    """Posterior mean (and std) at query points; host float64."""
    from scipy.linalg import solve_triangular

    xq = np.asarray(xq, np.float64)
    ks = _np_kernel(state.x, xq, state.log_c, state.log_l, cfg.nu)  # (N, M)
    mean = ks.T @ state.alpha
    mean = mean * float(state.y_std) + float(state.y_mean)
    if not return_std:
        return mean
    v = solve_triangular(state.chol, ks, lower=True)
    prior_diag = np.exp(state.log_c) * np.ones(xq.shape[0])
    if cfg.with_noise:
        prior_diag = prior_diag + np.exp(state.log_n)
    var = prior_diag - (v ** 2).sum(axis=0)
    std = np.sqrt(np.maximum(var, 0.0)) * float(state.y_std)
    return mean, std


def predict_gps_shared_x(
    states, xq: np.ndarray, cfg: GPConfig = GPConfig()
) -> np.ndarray:
    """(M, n_models) posterior means for GPs fit on the SAME training inputs.

    The per-model kernel differs only through (log_c, log_l), so the
    candidate<->archive distance matrix, the dominant cost, is computed
    once and shared across models (host float64: tiny matrices).
    """
    xq = np.asarray(xq, np.float64)
    x0 = np.asarray(states[0].x)
    dist = _np_pdist(x0, xq)  # (N, M), shared
    cols = []
    for st in states:
        if st.x.shape != x0.shape or not np.array_equal(st.x, x0):
            # different training sets: no sharing possible
            cols.append(predict_gp(st, xq, cfg))
            continue
        ks = _np_kernel_from_dist(dist, st.log_c, st.log_l, cfg.nu)
        cols.append(ks.T @ st.alpha * float(st.y_std) + float(st.y_mean))
    return np.stack(cols, axis=1)
