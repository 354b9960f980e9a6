"""The one generator of traffic: a mix file (``traffic/<mix>.json``) to the
population a call evaluates and the launch plan it runs under.

A mix file holds:

* ``genomes``: ``{"grid": {gene: [values]}}``, the product of the listed
  values in ``frozen.GENE_ORDER`` order, optionally with ``"sample":
  {"count": n, "draw_seed": s}``, a fixed draw of n of them without
  replacement (the same set for every run seed);
* ``compaction_chunk``: the evaluator's launch plan (0 fused one-shot
  launches, -1 the presets' adaptive plan).

The epoch cap of a training is the configuration's (``train.epochs``).
"""

from __future__ import annotations

import itertools
from typing import Dict, List

import numpy as np

from . import frozen


def genomes(mix: Dict) -> List[Dict]:
    spec = mix["genomes"]
    values = [spec["grid"][g] for g in frozen.GENE_ORDER]
    out = [dict(zip(frozen.GENE_ORDER, c)) for c in itertools.product(*values)]
    for g in out:
        for gene in frozen.GENE_ORDER:
            if g[gene] not in frozen.HPARAM_SPACE[gene]:
                raise ValueError(f"{gene}={g[gene]!r} is outside the space")
    if "sample" in spec:
        rng = np.random.default_rng(spec["sample"]["draw_seed"])
        pick = rng.choice(len(out), spec["sample"]["count"], replace=False)
        out = [out[i] for i in sorted(pick)]
    return out


def eval_seed(run_seed: int, call: int) -> int:
    """The eval seed of the window's call ``call``: a 32-bit key of the
    run seed and the call's index."""
    return frozen.fold_in(frozen.seed_key(run_seed), call)
