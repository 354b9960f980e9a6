"""Frozen copies of the program's definitions that the yardstick needs.

The benchmark holds the program against these copies and never imports
the program for them: a later change to the program cannot move the
yardstick. Each function is a copy, by value, of its original in
``cmoop_audio_processing_torch`` (named beside it); ``benchmark/tests``
holds every copy equal to its original over the whole search space.

* the counter hash of the port's random streams (``core/rng.py``);
* the genome space and its identity (``core/genome.py``,
  ``models/supernet.genome_uid``);
* the genome-keyed initialization, the dropout stream and the epoch
  shuffle (``models/supernet.init_params``, ``dropout_mask``,
  ``engine/trainer.PopulationTrainer.permutation``, ``train_key_of``,
  ``pad_dataset``);
* the analytic parameter and FLOP counts (``models/genome_arch.py``).
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
FC_WIDTHS = (512, 256, 128, 64)


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

def _uniform(gen, shape, limit: float) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32).uniform_(
        -limit, limit, generator=gen)


def _glorot(gen, shape, fan_in: int, fan_out: int) -> torch.Tensor:
    return _uniform(gen, shape, math.sqrt(6.0 / (fan_in + fan_out)))


def _conv_init(gen, k, c_in, c_out):
    return {"w": _glorot(gen, (c_out, c_in, k, k), k * k * c_in,
                         k * k * c_out),
            "b": torch.zeros(c_out)}


def init_params(seed: int, template: str, filters: int, kernel: int,
                num_classes: int, max_blocks: int, genome: Dict):
    """Parameters and BN state of one genome, as the program's
    ``init_params`` draws them for a bucket of ``max_blocks`` (CPU, f32)."""
    f, k = filters, kernel
    n_blocks = int(genome["residual_blocks"])
    fc_entry = 5 - int(genome["fc_layers"])
    lane_key = fold_in(seed_key(seed), genome_uid(genome))
    slots = itertools.count()

    def gen():
        g = torch.Generator()
        g.manual_seed(fold_in(lane_key, next(slots)))
        return g

    def bn(c):
        return {"gamma": torch.ones(c), "beta": torch.zeros(c)}

    def bn_state(c):
        return {"mean": torch.zeros(c), "var": torch.ones(c)}

    params: Dict = {"stem1": _conv_init(gen(), k, 1, f), "stem1_bn": bn(f)}
    state: Dict = {"stem1_bn": bn_state(f)}
    if template == "A":
        params["stem2"] = _conv_init(gen(), k, f, f)
        params["stem2_bn"] = bn(f)
        state["stem2_bn"] = bn_state(f)
    for i in range(3):
        g_skip, g_conv1 = gen(), gen()
        g_conv2 = gen() if template == "A" else None
        if i >= max_blocks:
            continue
        c_in, c_out = f * 2 ** i, f * 2 ** (i + 1)
        blk = {"skip": _conv_init(g_skip, 1, c_in, c_out),
               "conv1": _conv_init(g_conv1, k, c_in, c_out),
               "conv1_bn": bn(c_out)}
        state[f"block{i}_conv1_bn"] = bn_state(c_out)
        if template == "A":
            blk["conv2"] = _conv_init(g_conv2, k, c_out, c_out)
            blk["conv2_bn"] = bn(c_out)
            state[f"block{i}_conv2_bn"] = bn_state(c_out)
        params[f"block{i}"] = blk
    gap_w = f * 2 ** max_blocks
    active_gap = f * 2 ** n_blocks
    fc: Dict = {}
    for li, units in enumerate(FC_WIDTHS, start=1):
        layer: Dict = {"b": torch.zeros(units)}
        limit = math.sqrt(6.0 / (active_gap + units))
        u = _uniform(gen(), (f * 8, units), 1.0)[:gap_w]
        wg = torch.zeros(gap_w, units)
        if li == fc_entry:
            wg[:active_gap] = u[:active_gap] * limit
        layer["wg"] = wg
        if li > 1:
            prev = FC_WIDTHS[li - 2]
            wp = _glorot(gen(), (prev, units), prev, units)
            layer["wp"] = wp if li > fc_entry else torch.zeros_like(wp)
        fc[f"fc{li}"] = layer
    params["fc"] = fc
    params["out"] = {
        "w": _glorot(gen(), (FC_WIDTHS[-1], num_classes), FC_WIDTHS[-1],
                     num_classes),
        "b": torch.zeros(num_classes),
    }
    return params, state


def dropout_mask(key, uids: torch.Tensor, layer: int, shape, keep: float):
    lane = fold_in(key, uids)
    lk = fold_in(lane, layer)
    n = math.prod(shape)
    counter = torch.arange(n, device=uids.device, dtype=torch.int64).view(shape)
    bits = fold_in(lk.view((-1,) + (1,) * len(shape)), counter)
    return (bits < int(keep * 2 ** 32)).float() / keep


# -- models/genome_arch.py -----------------------------------------------------

BN_PARAMS_PER_CHANNEL = 4


def count_params(genome: Dict, num_classes: int, template: str) -> int:
    f = int(genome["filters"])
    k = int(genome["kernel_size"])
    use_bn = bool(genome["use_bn"])

    def conv(kk, c_in, c_out):
        return kk * kk * c_in * c_out + c_out

    bn = BN_PARAMS_PER_CHANNEL if use_bn else 0
    total = conv(k, 1, f) + bn * f
    if template == "A":
        total += conv(k, f, f) + bn * f
    elif template != "B":
        raise ValueError(f"unknown template {template!r}")
    c = f
    for _ in range(int(genome["residual_blocks"])):
        c2 = 2 * c
        total += conv(1, c, c2) + conv(k, c, c2) + bn * c2
        if template == "A":
            total += conv(k, c2, c2) + bn * c2
        c = c2
    d = c
    for units in FC_CONFIGS[int(genome["fc_layers"])]:
        total += d * units + units
        d = units
    return total + d * num_classes + num_classes


def model_size_mb(genome: Dict, num_classes: int, template: str) -> float:
    return count_params(genome, num_classes, template) * 4 / (1024 ** 2)


def count_fwd_flops(genome: Dict, input_hw, num_classes: int,
                    template: str) -> int:
    """Conv and dense FLOPs (2 x MACs) of one forward pass of one sample."""
    f = int(genome["filters"])
    k = int(genome["kernel_size"])
    h, w = int(input_hw[0]), int(input_hw[1])

    def half(n):
        return (n + 1) // 2

    def conv(kk, cin, cout, hh, ww):
        return 2 * kk * kk * cin * cout * hh * ww

    total = conv(k, 1, f, h, w)
    if template == "A":
        total += conv(k, f, f, h, w)
    h, w = half(h), half(w)
    c = f
    for _ in range(int(genome["residual_blocks"])):
        c2 = 2 * c
        h2, w2 = half(h), half(w)
        total += conv(1, c, c2, h2, w2) + conv(k, c, c2, h, w)
        if template == "A":
            total += conv(k, c2, c2, h, w)
        c, h, w = c2, h2, w2
    d = c
    for units in FC_CONFIGS[int(genome["fc_layers"])]:
        total += 2 * d * units
        d = units
    return total + 2 * d * num_classes
