"""Frozen copies of the program's architecture-free definitions that the
yardstick needs.

The benchmark holds the program against these copies and never imports
the program for them: a later change to the program cannot move the
yardstick. Each function is a copy, by value, of its original in
``cmoop_audio_processing_torch`` (named beside it); ``benchmark/tests``
holds every copy equal to its original over the whole search space.

* the counter hash of the port's random streams (``core/rng.py``);
* the genome space and its identity (``core/genome.py``,
  ``models/supernet.genome_uid``);
* the dropout stream and the epoch shuffle (``models/supernet.
  dropout_mask``, ``engine/trainer.PopulationTrainer.permutation``,
  ``train_key_of``, ``pad_dataset``).

What belongs to one architecture (its genome-keyed initialization, its
analytic parameter and FLOP counts, its plain forward pass) is in the
module that the configuration's ``"reference"`` key names,
``benchmark/reference/<module>.py``.
"""

from __future__ import annotations

import itertools
import math
import zlib
from typing import Dict, List

import numpy as np
import torch

# -- core/genome.py ------------------------------------------------------------

GENE_ORDER = ("filters", "kernel_size", "use_bn", "residual_blocks",
              "fc_layers", "use_dropout")
HPARAM_SPACE = {
    "filters": (16, 32, 64),
    "kernel_size": (3, 5),
    "use_bn": (True, False),
    "residual_blocks": (1, 2, 3),
    "fc_layers": (1, 2, 3, 4),
    "use_dropout": (True, False),
}
FC_CONFIGS = {1: (64,), 2: (128, 64), 3: (256, 128, 64),
              4: (512, 256, 128, 64)}


def all_genomes() -> List[Dict]:
    spaces = [HPARAM_SPACE[g] for g in GENE_ORDER]
    return [dict(zip(GENE_ORDER, c)) for c in itertools.product(*spaces)]


def genome_key(genome: Dict) -> tuple:
    return tuple(genome[g] for g in GENE_ORDER)


def genome_uid(genome: Dict) -> int:
    return zlib.crc32(str(genome_key(genome)).encode())


# -- core/rng.py ---------------------------------------------------------------

MASK32 = 0xFFFFFFFF


def _mul32(x, c: int):
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK32


def mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def seed_key(seed: int) -> int:
    return mix32(int(seed) & MASK32)


def fold_in(key, data):
    return mix32(_mul32(key, 0x9E3779B1) ^ mix32(data & MASK32))


def train_key_of(seed: int) -> int:
    return fold_in(seed_key(seed), 1)


# -- engine/trainer.py ---------------------------------------------------------

def pad_dataset(x: np.ndarray, y: np.ndarray, batch_size: int):
    n = x.shape[0]
    n_pad = (-n) % batch_size
    w = np.ones(n, np.float32)
    if n_pad:
        x = np.concatenate([x, np.zeros((n_pad,) + x.shape[1:], x.dtype)])
        y = np.concatenate([y, np.zeros((n_pad,), y.dtype)])
        w = np.concatenate([w, np.zeros(n_pad, np.float32)])
    return x, y, w


def permutation(epoch_key: int, n_train: int) -> torch.Tensor:
    gen = torch.Generator()
    gen.manual_seed(epoch_key)
    return torch.randperm(n_train, generator=gen)


# -- models/supernet.py --------------------------------------------------------

def dropout_mask(key, uids: torch.Tensor, layer: int, shape, keep: float):
    lane = fold_in(key, uids)
    lk = fold_in(lane, layer)
    n = math.prod(shape)
    counter = torch.arange(n, device=uids.device, dtype=torch.int64).view(shape)
    bits = fold_in(lk.view((-1,) + (1,) * len(shape)), counter)
    return (bits < int(keep * 2 ** 32)).float() / keep
