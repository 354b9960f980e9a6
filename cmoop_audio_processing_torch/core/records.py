"""Result records and the reference-compatible reporting schemas.

An evaluated individual is a dict with keys ``hparams`` (genome dict),
``objs`` (list of minimized objectives) and ``CV`` (total constraint
violation) — exactly the structure the reference threads through its EA
machinery (reference: sa_nsga_penalty.py:252). We keep it a plain dict so the
EA core stays structurally faithful, but provide typed constructors and the
canonical DataFrame row schemas here.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .config import Constraints
from .genome import GENE_ORDER, Genome

Individual = Dict  # {'hparams': Genome, 'objs': [float], 'CV': float, ...}

OBJECTIVE_SIGNS = {"acc": -1.0, "size": 1.0, "fpr": 1.0}


def make_individual(
    genome: Genome,
    acc: float,
    size_mb: float,
    fpr: float,
    constraints: Constraints,
    objectives: Sequence[str] = ("acc", "size", "fpr"),
) -> Individual:
    """Build the canonical record from raw metrics.

    Objectives are all minimized: acc enters as -acc
    (reference: sa_nsga_penalty.py:241-250). Metrics not in ``objectives``
    are tracked but excluded from ``objs`` (acc_size_nsga_1.py:284-311).
    """
    metrics = {"acc": acc, "size": size_mb, "fpr": fpr}
    objs = [OBJECTIVE_SIGNS[name] * metrics[name] for name in objectives]
    cv = constraints.violation(acc, size_mb, fpr)
    return {
        "hparams": dict(genome),
        "objs": objs,
        "CV": cv,
        "metrics": metrics,
        "objective_names": tuple(objectives),
    }


def metrics_of(ind: Individual) -> Dict[str, float]:
    """Recover (acc, size, fpr) from a record. Falls back to decoding
    ``objs`` for 3-objective records lacking the ``metrics`` field."""
    if "metrics" in ind:
        return ind["metrics"]
    f1, f2, f3 = ind["objs"]
    return {"acc": -f1, "size": f2, "fpr": f3}


def generation_row(ind: Individual, gen: int) -> Dict:
    """Per-generation record schema {Generation, Accuracy, Size_MB, FPR, CV,
    **hparams} (reference: sa_nsga_penalty.py:606-612)."""
    m = metrics_of(ind)
    return {
        "Generation": gen,
        "Accuracy": m["acc"],
        "Size_MB": m["size"],
        "FPR": m["fpr"],
        "CV": ind["CV"],
        **{g: ind["hparams"][g] for g in GENE_ORDER},
    }


def pareto_row(ind: Individual, include_cv: bool = False) -> Dict:
    """Final-Pareto record schema {Accuracy, Size_MB, FPR, **hparams}
    (reference: nsga_penalty.py:747-758; MOBO adds CV, mobo_penalty.py:518-524)."""
    m = metrics_of(ind)
    row = {"Accuracy": m["acc"], "Size_MB": m["size"], "FPR": m["fpr"]}
    if include_cv:
        row["CV"] = ind["CV"]
    row.update({g: ind["hparams"][g] for g in GENE_ORDER})
    return row


def front_metrics_array(individuals: List[Individual]):
    """(N, 3) array of (Accuracy, Size_MB, FPR) in maximization/real space,
    the layout compare.ipynb loads from the exported fronts."""
    import numpy as np

    rows = []
    for ind in individuals:
        m = metrics_of(ind)
        rows.append([m["acc"], m["size"], m["fpr"]])
    return np.asarray(rows, dtype=np.float64)
