"""Genome definition and codecs for the CNN architecture search space.

The search space is the 6-gene discrete genome of the reference
(reference: nsga_penalty.py:186-196):

    filters          in {16, 32, 64}
    kernel_size      in {3, 5}
    use_bn           in {True, False}
    residual_blocks  in {1, 2, 3}
    fc_layers        in {1, 2, 3, 4}
    use_dropout      in {True, False}

for a total of 3*2*2*3*4*2 = 288 configurations.

Codecs provided (all pure, host-side):
  * dict  <-> index vector (one int per gene)
  * dict  <-> continuous [0,1]^6 vector, exactly matching the MOBO
    encode/decode contract (reference: mobo_penalty.py:305-338): encoding
    divides the option index by (n_options - 1); decoding uses
    ``int(round(v * (n_options - 1)))``.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence

import numpy as np

# Gene order is significant: it is the canonical order used by the
# vector codecs and the surrogate feature map.
GENE_ORDER = (
    "filters",
    "kernel_size",
    "use_bn",
    "residual_blocks",
    "fc_layers",
    "use_dropout",
)

HPARAM_SPACE: Dict[str, tuple] = {
    "filters": (16, 32, 64),
    "kernel_size": (3, 5),
    "use_bn": (True, False),
    "residual_blocks": (1, 2, 3),
    "fc_layers": (1, 2, 3, 4),
    "use_dropout": (True, False),
}

NUM_GENES = len(GENE_ORDER)
SPACE_SIZE = int(np.prod([len(HPARAM_SPACE[g]) for g in GENE_ORDER]))  # 288

# FC stack widths per fc_layers choice (reference: nsga_penalty.py:311-316).
# Note the configs are suffixes of [512, 256, 128, 64]: every genome's FC
# stack ends in a 64-wide layer feeding the softmax.
FC_CONFIGS = {1: (64,), 2: (128, 64), 3: (256, 128, 64), 4: (512, 256, 128, 64)}

Genome = Dict[str, object]


def validate(genome: Genome) -> None:
    for gene in GENE_ORDER:
        if gene not in genome:
            raise KeyError(f"genome missing gene {gene!r}")
        if genome[gene] not in HPARAM_SPACE[gene]:
            raise ValueError(
                f"genome[{gene!r}]={genome[gene]!r} not in {HPARAM_SPACE[gene]}"
            )


def to_indices(genome: Genome) -> np.ndarray:
    """dict -> int index vector (one option-index per gene, GENE_ORDER order)."""
    return np.array(
        [HPARAM_SPACE[g].index(genome[g]) for g in GENE_ORDER], dtype=np.int32
    )


def from_indices(idx: Sequence[int]) -> Genome:
    return {g: HPARAM_SPACE[g][int(i)] for g, i in zip(GENE_ORDER, idx)}


def to_vector(genome: Genome) -> np.ndarray:
    """dict -> continuous [0,1]^6 vector (MOBO codec, mobo_penalty.py:305-318)."""
    v = np.zeros(NUM_GENES, dtype=np.float64)
    for i, g in enumerate(GENE_ORDER):
        opts = HPARAM_SPACE[g]
        v[i] = opts.index(genome[g]) / (len(opts) - 1)
    return v


def from_vector(vec: Sequence[float]) -> Genome:
    """[0,1]^6 vector -> dict (MOBO codec, mobo_penalty.py:320-338)."""
    out: Genome = {}
    for i, g in enumerate(GENE_ORDER):
        opts = HPARAM_SPACE[g]
        idx = int(round(float(vec[i]) * (len(opts) - 1)))
        idx = min(max(idx, 0), len(opts) - 1)
        out[g] = opts[idx]
    return out


def genome_key(genome: Genome) -> tuple:
    """Hashable identity of a genome (dedup key, matches the surrogate
    archive's drop_duplicates subset, sa_nsga_penalty.py:325-327)."""
    return tuple(genome[g] for g in GENE_ORDER)


def all_genomes() -> List[Genome]:
    """Enumerate the full 288-point space in GENE_ORDER-major order."""
    spaces = [HPARAM_SPACE[g] for g in GENE_ORDER]
    return [dict(zip(GENE_ORDER, combo)) for combo in itertools.product(*spaces)]


def random_genome(rng) -> Genome:
    """One uniform-random genome. ``rng`` is a ``random.Random`` or module."""
    return {g: rng.choice(HPARAM_SPACE[g]) for g in GENE_ORDER}


def perturb(genome: Genome, rng) -> Genome:
    """Single-gene neighborhood move used by the Lamarckian local search
    (reference: sa_nsga_local.py:351-364): pick one gene uniformly; booleans
    flip, other genes resample from the *other* options."""
    out = dict(genome)
    gene = rng.choice(GENE_ORDER)
    opts = HPARAM_SPACE[gene]
    if isinstance(opts[0], bool):
        out[gene] = not out[gene]
    else:
        others = [v for v in opts if v != out[gene]]
        out[gene] = rng.choice(others)
    return out
