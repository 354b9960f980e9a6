"""Pareto-front quality metrics: GD, IGD, Spread, Coverage, true-front union.

Semantics are exactly those of the reference's offline analysis notebook
(compare.ipynb cell 1):

* to_min_space: fronts are stored as (Accuracy, Size_MB, FPR) rows; metrics
  operate on (-Accuracy, Size_MB, FPR) minimization space.
* true front: nondominated subset of the union of all fronts.
* GD  = sqrt(mean(min-dist(front -> true)^2))   (convergence)
* IGD = sqrt(mean(min-dist(true -> front)^2))   (convergence + diversity)
* Spread: (df + dl + sum|d_i - dmean|) / (df + dl + (N-1)*dmean), where
  d_i are min-distances front->true, and df/dl are distances from the front
  to the per-axis min / per-axis max corner points of the true front — the
  notebook's (unusual) variant, reproduced verbatim.
* Coverage C(A,B): fraction of B dominated by some point of A.

A copy of cmoop_audio_processing_tpu/metrics/quality.py.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
from scipy.spatial.distance import cdist

from ..algorithms.ea import nondominated_mask


def to_min_space(front_acc_size_fpr: np.ndarray) -> np.ndarray:
    """(Accuracy, Size_MB, FPR) rows -> (-Accuracy, Size_MB, FPR)."""
    arr = np.asarray(front_acc_size_fpr, dtype=np.float64)
    out = arr.copy()
    out[:, 0] = -out[:, 0]
    return out


def true_front(min_fronts: Sequence[np.ndarray]) -> np.ndarray:
    combined = np.vstack([np.asarray(f, dtype=np.float64) for f in min_fronts])
    return combined[nondominated_mask(combined)]


def generational_distance(obtained: np.ndarray, true: np.ndarray) -> float:
    d = cdist(obtained, true).min(axis=1)
    return float(np.sqrt(np.mean(d ** 2)))


def inverted_gd(obtained: np.ndarray, true: np.ndarray) -> float:
    d = cdist(true, obtained).min(axis=1)
    return float(np.sqrt(np.mean(d ** 2)))


def spread_metric(front: np.ndarray, true: np.ndarray) -> float:
    if len(front) < 2:
        return float("nan")
    d = cdist(front, true).min(axis=1)
    d_mean = d.mean()
    df = cdist(front, true.min(axis=0).reshape(1, -1)).min()
    dl = cdist(front, true.max(axis=0).reshape(1, -1)).min()
    num = df + dl + np.sum(np.abs(d - d_mean))
    den = df + dl + (len(front) - 1) * d_mean
    return float(num / den) if den != 0 else float("nan")


def coverage_metric(a: np.ndarray, b: np.ndarray) -> float:
    """C(A, B): fraction of B weakly dominated (dominated in the strict
    Pareto sense) by at least one point of A."""
    if len(b) == 0:
        return 0.0
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    le = np.all(a[:, None, :] <= b[None, :, :], axis=-1)
    lt = np.any(a[:, None, :] < b[None, :, :], axis=-1)
    dominated = np.any(le & lt, axis=0)
    return float(dominated.sum() / len(b))


def compare_fronts(fronts: Dict[str, np.ndarray], eps: float = 1e-3) -> Dict:
    """Full compare.ipynb report over named (Accuracy, Size_MB, FPR) fronts:
    HV (shared reference point), GD, IGD, Spread, pairwise Coverage."""
    from .hypervolume import hypervolume, reference_point

    min_fronts = {k: to_min_space(v) for k, v in fronts.items()}
    ref = reference_point(list(min_fronts.values()), eps)
    tf = true_front(list(min_fronts.values()))
    report: Dict = {
        "reference_point": ref.tolist(),
        "true_front_size": int(len(tf)),
        "hypervolume": {},
        "gd": {},
        "igd": {},
        "spread": {},
        "coverage": {},
    }
    for name, mf in min_fronts.items():
        report["hypervolume"][name] = hypervolume(mf, ref)
        report["gd"][name] = generational_distance(mf, tf)
        report["igd"][name] = inverted_gd(mf, tf)
        report["spread"][name] = spread_metric(mf, tf)
    for na, fa in min_fronts.items():
        for nb, fb in min_fronts.items():
            if na != nb:
                report["coverage"][f"C({na} covers {nb})"] = coverage_metric(fa, fb)
    return report
