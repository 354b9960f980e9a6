"""Tchebycheff scalarization ranking of a Pareto front.

Reproduces the reference notebook ("Tchebycheff s_rank.ipynb" cell 1):
objectives in minimization form (1-Accuracy, Size_MB, FPR); ideal point z* is
the per-column min; equal weights normalized to 1/3; score is the max weighted
|f - z*|; rank is ascending with ties sharing the min rank (pandas
rank(method='min')).

cmoop_audio_processing_tpu/metrics/tchebycheff.py ranks a DataFrame; this
module ranks a list of row dicts, with the same values and the same order.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def tchebycheff_score(
    fx: np.ndarray, z_star: np.ndarray, weights: np.ndarray
) -> np.ndarray:
    diff = np.abs(fx - z_star)
    return np.max(weights * diff, axis=1)


def rank_front(rows: Sequence[Dict]) -> List[Dict]:
    """Input: row dicts with Accuracy, Size_MB, FPR keys (plus genome keys).
    Output: copies with 1-Accuracy, Tchebycheff Score and Rank appended,
    sorted by Rank ascending (numpy's quicksort, as DataFrame.sort_values
    orders ties)."""
    out = [dict(r, **{"1-Accuracy": 1.0 - r["Accuracy"]}) for r in rows]
    fx = np.array([[r["1-Accuracy"], r["Size_MB"], r["FPR"]] for r in out],
                  np.float64).reshape(-1, 3)
    z_star = fx.min(axis=0)
    weights = np.array([1.0, 1.0, 1.0])
    weights = weights / weights.sum()
    scores = tchebycheff_score(fx, z_star, weights)
    ranks = np.searchsorted(np.sort(scores), scores, side="left") + 1
    for r, score, rank in zip(out, scores, ranks):
        r["Tchebycheff Score"] = float(score)
        r["Rank"] = int(rank)
    return [out[i] for i in np.argsort(ranks, kind="quicksort")]
