"""Lamarckian LCB local search over surrogate predictions.

Reference flow (sa_nsga_local.py:351-433):

1. LCB = mu - k*sigma per objective for every predicted offspring (k=1.0).
2. Elite set = LCB-nondominated offspring.
3. 5 rounds x per-elite: single-gene perturbation, surrogate-predict the
   neighbor, accept iff the neighbor's LCB dominates the incumbent's —
   Lamarckian: the genome itself is replaced in the offspring list.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..core.genome import Genome, perturb
from ..surrogate.manager import SurrogateManager

OBJ_KEYS = ("neg_acc", "size", "fpr")


def lcb_dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """Strict Pareto dominance on LCB vectors (sa_nsga_local.py:366-369)."""
    return all(x <= y for x, y in zip(a, b)) and any(x < y for x, y in zip(a, b))


def perform_local_search(
    offspring: Sequence[Genome],
    surrogate: SurrogateManager,
    rng,
    k_lcb: float = 1.0,
    rounds: int = 5,
) -> List[Genome]:
    """Returns the (possibly improved) offspring genome list, same order."""
    preds, stds = surrogate.predict(list(offspring), return_std=True)
    sols: List[Dict] = []
    for i, g in enumerate(offspring):
        means = np.array([preds[k][i] for k in OBJ_KEYS])
        sigma = np.array([stds[k][i] for k in OBJ_KEYS])
        sols.append(
            {"genome": dict(g), "lcb": (means - k_lcb * sigma).tolist()}
        )

    # LCB-nondominated elites (simplified front-0 scan,
    # sa_nsga_local.py:385-397)
    elite_idx = [
        i
        for i in range(len(sols))
        if not any(
            lcb_dominates(sols[j]["lcb"], sols[i]["lcb"])
            for j in range(len(sols))
            if j != i
        )
    ]

    for _ in range(rounds):
        for idx in elite_idx:
            neighbor = perturb(sols[idx]["genome"], rng)
            mu_n, sd_n = surrogate.predict([neighbor], return_std=True)
            lcb_n = [
                float(mu_n[k][0] - k_lcb * sd_n[k][0]) for k in OBJ_KEYS
            ]
            if lcb_dominates(lcb_n, sols[idx]["lcb"]):
                sols[idx]["genome"] = neighbor
                sols[idx]["lcb"] = lcb_n

    return [s["genome"] for s in sols]
