"""RNG discipline.

The reference uses the global ``random``/``np.random`` with no seeds, so its
runs are irreproducible (SURVEY.md §7 "RNG discipline"). Here every run owns a
single ``RunRng`` that derives named, independent streams:

* ``host``   — ``random.Random`` for the EA bookkeeping (selection, crossover,
  mutation, infill ordering), keeping call-for-call parity with the
  reference's use of the ``random`` module.
* ``numpy``  — ``np.random.Generator`` for candidate batches / LHS.
* ``torch(name)`` — a seeded ``torch.Generator`` per call, derived from
  (seed, name, call order), for device-side randomness.

Checkpointable: ``state_dict``/``load_state_dict`` round-trip the host and
numpy stream states so a resumed run continues the same sequence.
"""

from __future__ import annotations

import random
import zlib
from typing import Dict

import numpy as np


def _stable_hash(name: str) -> int:
    return zlib.crc32(name.encode("utf-8"))


# ---------------------------------------------------------------------------
# Counter-based 32-bit hashing: the port's stand-in for jax.random.fold_in.
# Works on Python ints and on int64 tensors alike (every product is split
# into 16-bit halves so no intermediate leaves int64), so the CPU and CUDA
# draw bitwise-identical streams.
# ---------------------------------------------------------------------------

MASK32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2**32 for 0 <= x < 2**32, without int64 overflow."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK32


def mix32(x):
    """murmur3's 32-bit finalizer: a bijection with full avalanche."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def seed_key(seed: int) -> int:
    """The root 32-bit key of a run seed."""
    return mix32(int(seed) & MASK32)


def fold_in(key, data):
    """A new key from (key, data): the fold_in of this port's streams."""
    return mix32(_mul32(key, 0x9E3779B1) ^ mix32(data & MASK32))


class RunRng:
    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.host = random.Random(self.seed)
        self.numpy = np.random.default_rng(self.seed + 1)
        self._torch_counter = 0

    def torch(self, name: str = "", device="cpu"):
        """A fresh seeded ``torch.Generator``; unique per call, stable per
        (seed, name, order)."""
        import torch

        self._torch_counter += 1
        gen = torch.Generator(device=device)
        gen.manual_seed(
            fold_in(fold_in(seed_key(self.seed), _stable_hash(name)),
                    self._torch_counter)
        )
        return gen

    def spawn(self, name: str) -> "RunRng":
        """Independent child RNG (e.g. one per generation for device work)."""
        return RunRng(self.seed ^ _stable_hash(name))

    def state_dict(self) -> Dict:
        return {
            "seed": self.seed,
            "host": self.host.getstate(),
            "numpy": self.numpy.bit_generator.state,
            "torch_counter": self._torch_counter,
        }

    def load_state_dict(self, state: Dict) -> None:
        self.seed = state["seed"]
        host_state = state["host"]
        # Tuples survive pickle but JSON round-trips produce lists.
        if isinstance(host_state, list):
            host_state = tuple(
                tuple(s) if isinstance(s, list) else s for s in host_state
            )
        self.host.setstate(host_state)
        self.numpy.bit_generator.state = state["numpy"]
        self._torch_counter = state["torch_counter"]
