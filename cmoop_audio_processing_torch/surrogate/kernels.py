"""GP covariance kernels on torch tensors.

The reference uses sklearn's GaussianProcessRegressor with
``C(1.0) * Matern(length_scale=1.0, nu=1.5) + WhiteKernel(noise_level=0.1)``
for the SA-NSGA-II surrogates (sa_nsga_penalty.py:278). The same kernel
family, with log-parameterized hyperparameters so marginal-likelihood
optimization is unconstrained and runs on the device, batched over targets
and restarts (surrogate/gp.py). The closed forms are those of
cmoop_audio_processing_tpu/surrogate/kernels.py.

Kernels take (N, D) and (M, D) feature matrices and return (N, M) Gram
matrices; ``matern`` broadcasts a batch of length scales over a shared
distance matrix.
"""

from __future__ import annotations

import math

import torch


def sqdist(xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distances, (N, M), by the expansion
    |a|^2 + |b|^2 - 2 a.b (one matrix product)."""
    na = (xa ** 2).sum(dim=1)[:, None]
    nb = (xb ** 2).sum(dim=1)[None, :]
    return torch.clamp(na + nb - 2.0 * (xa @ xb.T), min=0.0)


def matern_from_dist(dist: torch.Tensor, length_scale, nu: float = 1.5):
    """Matern kernel for nu in {0.5, 1.5, 2.5} (sklearn's closed forms) of
    a distance matrix scaled by ``length_scale``."""
    d = dist / length_scale
    if nu == 0.5:
        return torch.exp(-d)
    if nu == 1.5:
        s = math.sqrt(3.0) * d
        return (1.0 + s) * torch.exp(-s)
    if nu == 2.5:
        s = math.sqrt(5.0) * d
        return (1.0 + s + s ** 2 / 3.0) * torch.exp(-s)
    raise ValueError(f"unsupported nu={nu}")


def matern(xa, xb, length_scale, nu: float = 1.5):
    """Matern kernel of two feature matrices. The ``+1e-30`` inside the
    square root keeps the gradient finite at zero distance (the diagonal)."""
    return matern_from_dist(torch.sqrt(sqdist(xa, xb) + 1e-30), length_scale, nu)
