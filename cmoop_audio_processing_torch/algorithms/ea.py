"""NSGA-II core machinery: penalized dominance, fast non-dominated sort,
crowding distance, tournament selection, crossover, mutation, environmental
selection.

These are host-side pure functions over lists of individual records — the
population is tiny (tens of dicts), so this bookkeeping is deliberately NOT a
device program (SURVEY.md §2.3 host/device split); the device does the heavy
fitness work. Semantics follow the canonical copies in the reference
(sa_nsga_penalty.py:382-470 and nsga_penalty.py:448-603), bit-for-bit where
observable:

* Dominance is penalized: P_i = f_i + lam * CV per objective; a dominates b
  iff all P_a <= P_b and one strictly < (sa_nsga_penalty.py:382-390).
* The sort is Deb's fast NDS with S/n bookkeeping, returning only non-empty
  fronts (sa_nsga_penalty.py:392-419).
* Crowding distance assigns inf to per-objective boundary points and sums
  normalized gaps, skipping objectives whose range is <= EPSILON
  (sa_nsga_penalty.py:421-442).
* Tournament is a binary tournament under penalized dominance where the
  FIRST sampled index wins ties (sa_nsga_penalty.py:444-451).
* Crossover swaps each gene independently with p=0.5
  (sa_nsga_penalty.py:453-459); mutation resets each gene with p=MUTATION_PROB,
  flipping booleans (sa_nsga_penalty.py:461-470).

A vectorized numpy non-dominated sort is also provided for large fronts
(metrics post-processing); the list-based version remains the EA-loop
implementation for exact tie/order parity.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.genome import GENE_ORDER, HPARAM_SPACE, Genome
from ..core.records import Individual

EPSILON = 1e-6


def penalized_objectives(ind: Individual, lam: float) -> List[float]:
    return [f + lam * ind["CV"] for f in ind["objs"]]


def dominates(a: Individual, b: Individual, lam: float) -> bool:
    pa = penalized_objectives(a, lam)
    pb = penalized_objectives(b, lam)
    better_all = all(x <= y for x, y in zip(pa, pb))
    strictly = any(x < y for x, y in zip(pa, pb))
    return better_all and strictly


def fast_non_dominated_sort(results: Sequence[Individual], lam: float) -> List[List[int]]:
    """Deb's fast non-dominated sort under penalized dominance. Returns a list
    of fronts, each a list of indices into ``results``; empty input -> []."""
    n_pop = len(results)
    if n_pop == 0:
        return []
    fronts: List[List[int]] = [[]]
    S: List[List[int]] = [[] for _ in range(n_pop)]
    n = [0] * n_pop

    for p in range(n_pop):
        for q in range(n_pop):
            if p == q:
                continue
            if dominates(results[p], results[q], lam):
                S[p].append(q)
            elif dominates(results[q], results[p], lam):
                n[p] += 1
        if n[p] == 0:
            fronts[0].append(p)

    i = 0
    while fronts[i]:
        nxt: List[int] = []
        for p in fronts[i]:
            for q in S[p]:
                n[q] -= 1
                if n[q] == 0:
                    nxt.append(q)
        i += 1
        fronts.append(nxt)
    return [f for f in fronts if f]


def crowding_distance(
    front: Sequence[int], results: Sequence[Individual], epsilon: float = EPSILON
) -> Dict[int, float]:
    """Crowding distance over raw (unpenalized) objectives; boundary points get
    inf; interior points sum normalized neighbor gaps."""
    if not front:
        return {}
    distance = {idx: 0.0 for idx in front}
    num_objs = len(results[front[0]]["objs"])
    for m in range(num_objs):
        fs = sorted(front, key=lambda idx: results[idx]["objs"][m])
        distance[fs[0]] = float("inf")
        distance[fs[-1]] = float("inf")
        f_min = results[fs[0]]["objs"][m]
        f_max = results[fs[-1]]["objs"][m]
        if f_max - f_min > epsilon:
            for i in range(1, len(fs) - 1):
                prev_obj = results[fs[i - 1]]["objs"][m]
                next_obj = results[fs[i + 1]]["objs"][m]
                distance[fs[i]] += (next_obj - prev_obj) / (f_max - f_min)
    return distance


def tournament_selection(results: Sequence[Individual], lam: float, rng, k: int = 2) -> int:
    """Binary tournament; the first drawn index wins unless a later one
    dominates it (sa_nsga_penalty.py:444-451)."""
    idxs = rng.sample(range(len(results)), k)
    best = idxs[0]
    for idx in idxs[1:]:
        if dominates(results[idx], results[best], lam):
            best = idx
    return best


def crossover(p1: Genome, p2: Genome, rng) -> Tuple[Genome, Genome]:
    """Uniform per-gene swap with p=0.5. Gene visit order is GENE_ORDER, which
    matches both the dict-iteration variant (sa_nsga_penalty.py:453-459, dicts
    preserve insertion order) and the unrolled variant (nsga_penalty.py:541-577)."""
    c1, c2 = deepcopy(p1), deepcopy(p2)
    for gene in GENE_ORDER:
        if rng.random() < 0.5:
            c1[gene], c2[gene] = c2[gene], c1[gene]
    return c1, c2


def mutate(genome: Genome, rng, mutation_prob: float = 0.2) -> Genome:
    """Per-gene reset with probability ``mutation_prob``; boolean genes flip,
    others resample uniformly from the full option list (so they may stay
    unchanged), matching sa_nsga_penalty.py:461-470."""
    ind = deepcopy(genome)
    for gene in GENE_ORDER:
        if rng.random() < mutation_prob:
            opts = HPARAM_SPACE[gene]
            if isinstance(opts[0], bool):
                ind[gene] = not ind[gene]
            else:
                ind[gene] = rng.choice(opts)
    return ind


def make_offspring(
    pop_data: Sequence[Individual],
    parents_idx: Sequence[int],
    rng,
    crossover_prob: float = 0.9,
    mutation_prob: float = 0.2,
    pairing: str = "resample",
    pop_size: int | None = None,
) -> List[Genome]:
    """Produce exactly ``pop_size`` offspring genomes from tournament winners.

    pairing="adjacent": pair winners (0,1), (2,3), ... and clone-mutate the
    lonely last winner when pop_size is odd (nsga_penalty.py:639-663).
    pairing="resample": repeatedly draw 2 distinct winners at random until
    enough offspring exist (sa_nsga_penalty.py:552-559).
    """
    pop_size = pop_size if pop_size is not None else len(parents_idx)
    parent_genomes = [pop_data[i]["hparams"] for i in parents_idx]
    offspring: List[Genome] = []

    if pairing == "adjacent":
        for g1, g2 in zip(parent_genomes[0::2], parent_genomes[1::2]):
            if rng.random() < crossover_prob:
                c1, c2 = crossover(g1, g2, rng)
            else:
                c1, c2 = deepcopy(g1), deepcopy(g2)
            offspring.append(mutate(c1, rng, mutation_prob))
            offspring.append(mutate(c2, rng, mutation_prob))
        if pop_size % 2 == 1:
            offspring.append(mutate(deepcopy(parent_genomes[-1]), rng, mutation_prob))
    elif pairing == "resample":
        while len(offspring) < pop_size:
            g1, g2 = rng.sample(parent_genomes, 2)
            if rng.random() < crossover_prob:
                c1, c2 = crossover(g1, g2, rng)
            else:
                c1, c2 = deepcopy(g1), deepcopy(g2)
            offspring.extend([mutate(c1, rng, mutation_prob), mutate(c2, rng, mutation_prob)])
    else:
        raise ValueError(f"unknown pairing {pairing!r}")
    return offspring[:pop_size]


def environmental_selection(
    combined: Sequence[Individual], pop_size: int, lam: float
) -> List[Individual]:
    """(mu+lambda) truncation: fill whole fronts; crowding-truncate the last
    partially-fitting front, highest distance first (sa_nsga_penalty.py:584-599).
    Missing distances default to 0 via dict.get, as in the reference."""
    fronts = fast_non_dominated_sort(combined, lam)
    new_pop: List[Individual] = []
    for front in fronts:
        if len(new_pop) + len(front) <= pop_size:
            new_pop.extend(combined[i] for i in front)
        else:
            remaining = pop_size - len(new_pop)
            dist = crowding_distance(front, combined)
            sorted_front = sorted(front, key=lambda idx: dist.get(idx, 0), reverse=True)
            new_pop.extend(combined[i] for i in sorted_front[:remaining])
            break
    return new_pop


def extract_final_pareto(
    pop_data: Sequence[Individual], final_lambda: float
) -> List[Individual]:
    """Final Pareto extraction: keep strictly-feasible (CV == 0) individuals,
    re-sort with the large final lambda, return front 0
    (nsga_penalty.py:766-776)."""
    feasibles = [ind for ind in pop_data if ind["CV"] == 0]
    if not feasibles:
        return []
    fronts = fast_non_dominated_sort(feasibles, final_lambda)
    if not fronts:
        return []
    return [feasibles[i] for i in fronts[0]]


# ---------------------------------------------------------------------------
# Vectorized variants (numpy) for large point sets. Used by metrics/reporting,
# not by the EA loop (which must keep list-order parity).
# ---------------------------------------------------------------------------

def nondominated_mask(points: np.ndarray) -> np.ndarray:
    """Boolean mask of non-dominated rows of an (N, M) minimization array.
    Matches the O(N^2) filters in mobo_penalty.py:478-485 and compare.ipynb."""
    pts = np.asarray(points, dtype=np.float64)
    n = pts.shape[0]
    if n == 0:
        return np.zeros(0, dtype=bool)
    # dominated[i] = exists j: all(pts[j] <= pts[i]) and any(pts[j] < pts[i])
    le = np.all(pts[None, :, :] <= pts[:, None, :], axis=-1)  # le[i,j]: j <= i
    lt = np.any(pts[None, :, :] < pts[:, None, :], axis=-1)
    dominated = np.any(le & lt, axis=1)
    return ~dominated
