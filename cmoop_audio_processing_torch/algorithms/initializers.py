"""Population initialization strategies.

* random: uniform per gene (sa_nsga_penalty.py:367-380).
* lhs: maximin Latin hypercube over [0,1]^6 floor-scaled into option indices
  (sa_nsga_init.py:372-396 uses pyDOE's lhs(criterion='maximin'); we
  implement our own maximin LHS — repeated random LHS draws keeping the one
  with the largest minimum pairwise distance, pyDOE's own strategy).
* psi: two-stage "PSI" seeding from a merged stage-1 Pareto file, rebuilding
  individuals from stored (Accuracy, Size_MB, FPR) without re-training and
  recomputing CV against the current constraints
  (psi_init_sa_nsga.py:365-379).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..core.config import Constraints
from ..core.genome import GENE_ORDER, HPARAM_SPACE, Genome, random_genome
from ..core.records import Individual, make_individual

# the stage-1 Pareto columns a PSI seed file must carry
REQUIRED = ["Accuracy", "Size_MB", "FPR", *GENE_ORDER]


def random_init(pop_size: int, rng) -> List[Genome]:
    return [random_genome(rng) for _ in range(pop_size)]


def _lhs_unit(n: int, d: int, np_rng) -> np.ndarray:
    """One random Latin hypercube sample in [0,1]^d: each column is a random
    permutation of n strata with uniform jitter inside each stratum."""
    u = np.empty((n, d))
    for j in range(d):
        perm = np_rng.permutation(n)
        u[:, j] = (perm + np_rng.random(n)) / n
    return u


def lhs_unit_maximin(n: int, d: int, np_rng, iterations: int = 100) -> np.ndarray:
    """Maximin LHS: keep the candidate hypercube with the largest minimum
    pairwise distance (pyDOE lhs(criterion='maximin') strategy)."""
    best = None
    best_score = -np.inf
    for _ in range(max(iterations, 1)):
        u = _lhs_unit(n, d, np_rng)
        diff = u[:, None, :] - u[None, :, :]
        dist = np.sqrt((diff ** 2).sum(-1))
        np.fill_diagonal(dist, np.inf)
        score = dist.min()
        if score > best_score:
            best, best_score = u, score
    return best


def lhs_init(pop_size: int, np_rng) -> List[Genome]:
    """LHS sample -> discrete genomes via floor-scaling
    (sa_nsga_init.py:383-391: idx = min(int(u * n_options), n_options-1))."""
    unit = lhs_unit_maximin(pop_size, len(GENE_ORDER), np_rng)
    population = []
    for row in unit:
        g: Genome = {}
        for i, gene in enumerate(GENE_ORDER):
            opts = HPARAM_SPACE[gene]
            idx = min(int(row[i] * len(opts)), len(opts) - 1)
            g[gene] = opts[idx]
        population.append(g)
    return population


def psi_init(
    seed_file: str,
    constraints: Constraints,
    objectives: Sequence[str] = ("acc", "size", "fpr"),
    limit: Optional[int] = None,
) -> List[Individual]:
    """Load stage-1 Pareto rows (Excel or CSV) as pre-evaluated individuals:
    genome columns + Accuracy/Size_MB/FPR, CV recomputed, no retraining
    (psi_init_sa_nsga.py:365-379).

    A missing seed file is reported and yields an EMPTY population instead of
    raising, reproducing the reference's clean-exit handling of a missing
    Final.xlsx (psi_mobo_2.py:365-369: print the error, return empty
    results); the drivers treat an empty PSI init as a no-op run. A
    zero-byte or corrupt workbook (torn stage-1 export) is handled the same
    way — all parse failures arrive normalized as UnreadableTableError
    (utils/xlsx.read_rows, which reads without pandas). Schema is validated
    up front against the same REQUIRED column set psi_merge enforces; after
    that, a malformed VALUE in one row (e.g. NaN in a gene column) skips
    that row with a warning instead of discarding the whole partial
    population."""
    import sys

    from ..utils.xlsx import UnreadableTableError, read_rows

    try:
        columns, rows = read_rows(seed_file)
    except FileNotFoundError:
        print(f"Error: The file '{seed_file}' was not found.", file=sys.stderr)
        return []
    except UnreadableTableError as exc:
        print(
            f"Error: The file '{seed_file}' could not be read ({exc}).",
            file=sys.stderr,
        )
        return []

    missing = [c for c in REQUIRED if c not in columns]
    if missing:
        # readable table, wrong schema (e.g. a ranked_MOBO.xlsx with no
        # genome columns): same clean no-op as an unreadable file
        print(
            f"Error: The file '{seed_file}' is not a stage-1 Pareto export "
            f"(missing columns {missing}).",
            file=sys.stderr,
        )
        return []

    pop: List[Individual] = []
    for ridx, cells in enumerate(rows):
        r = dict(zip(columns, cells))
        try:
            g: Genome = {}
            for gene in GENE_ORDER:
                opts = HPARAM_SPACE[gene]
                if isinstance(opts[0], bool):
                    g[gene] = bool(r[gene])
                else:
                    g[gene] = int(r[gene])
            ind = make_individual(
                g,
                float(r["Accuracy"]),
                float(r["Size_MB"]),
                float(r["FPR"]),
                constraints,
                objectives,
            )
        except (KeyError, ValueError, TypeError) as exc:
            print(
                f"Warning: skipping malformed row {ridx} of '{seed_file}' "
                f"({exc}).",
                file=sys.stderr,
            )
            continue
        pop.append(ind)
        if limit is not None and len(pop) >= limit:
            break
    return pop
