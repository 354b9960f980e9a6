"""Templates A and B, the Keras CNNs of the reference scripts: the
architecture module of the ``kws_nsga_penalty`` and ``bird_sa_nsga_penalty``
configurations (their ``"reference": "keras_cnn"``).

Template A has a two-conv stem and two k x k convs a block
(nsga_penalty.py:225-334); template B a one-conv stem and one conv a block
(sa_nsga_penalty.py:137-177). Both: SAME convolutions, Keras
BatchNormalization (batch statistics, biased variance, eps 1e-3, momentum
0.99 on the old moving value), 2x2 max-pools with SAME padding, a 1x1
stride-2 skip projection a block, filters doubling each block, global
average pooling, the genome's FC stack (a suffix of 512-256-128-64) with
inverted dropout and a softmax output. The model holds only the genome's
own layers; no population, no masking, no grouping.

Everything the harness needs of the architecture is here, and every
function raises on a template it does not know:

* ``init_params``: a frozen copy, by value, of the program's genome-keyed
  initialization (``models/supernet.init_params``);
* ``count_params``, ``model_size_mb``, ``count_fwd_flops``: frozen copies
  of the program's analytic counts (``models/genome_arch.py``);
* ``reference_params`` and ``forward``: the plain float32 model, whose loss,
  Adam, step loop and validation are ``training``'s.

``benchmark/tests`` holds the frozen copies equal to the program's
originals over the whole search space. Imports nothing of the program and
nothing of JAX.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .. import frozen
from . import training

TEMPLATES = ("A", "B")
BN_EPS = 1e-3
BN_MOMENTUM = 0.99
FC_WIDTHS = (512, 256, 128, 64)
BN_PARAMS_PER_CHANNEL = 4


def _two_convs(template: str) -> bool:
    """True for template A (two convs in the stem and in each block),
    False for B; raises on any other template."""
    if template not in TEMPLATES:
        raise ValueError(f"unknown template {template!r}")
    return template == "A"


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
    two = _two_convs(template)
    f, k = filters, kernel
    n_blocks = int(genome["residual_blocks"])
    fc_entry = 5 - int(genome["fc_layers"])
    lane_key = frozen.fold_in(frozen.seed_key(seed), frozen.genome_uid(genome))
    slots = itertools.count()

    def gen():
        g = torch.Generator()
        g.manual_seed(frozen.fold_in(lane_key, next(slots)))
        return g

    def bn(c):
        return {"gamma": torch.ones(c), "beta": torch.zeros(c)}

    def bn_state(c):
        return {"mean": torch.zeros(c), "var": torch.ones(c)}

    params: Dict = {"stem1": _conv_init(gen(), k, 1, f), "stem1_bn": bn(f)}
    state: Dict = {"stem1_bn": bn_state(f)}
    if two:
        params["stem2"] = _conv_init(gen(), k, f, f)
        params["stem2_bn"] = bn(f)
        state["stem2_bn"] = bn_state(f)
    for i in range(3):
        g_skip, g_conv1 = gen(), gen()
        g_conv2 = gen() if two else None
        if i >= max_blocks:
            continue
        c_in, c_out = f * 2 ** i, f * 2 ** (i + 1)
        blk = {"skip": _conv_init(g_skip, 1, c_in, c_out),
               "conv1": _conv_init(g_conv1, k, c_in, c_out),
               "conv1_bn": bn(c_out)}
        state[f"block{i}_conv1_bn"] = bn_state(c_out)
        if two:
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


# -- models/genome_arch.py -----------------------------------------------------

def count_params(genome: Dict, num_classes: int, template: str) -> int:
    two = _two_convs(template)
    f = int(genome["filters"])
    k = int(genome["kernel_size"])
    use_bn = bool(genome["use_bn"])

    def conv(kk, c_in, c_out):
        return kk * kk * c_in * c_out + c_out

    bn = BN_PARAMS_PER_CHANNEL if use_bn else 0
    total = conv(k, 1, f) + bn * f
    if two:
        total += conv(k, f, f) + bn * f
    c = f
    for _ in range(int(genome["residual_blocks"])):
        c2 = 2 * c
        total += conv(1, c, c2) + conv(k, c, c2) + bn * c2
        if two:
            total += conv(k, c2, c2) + bn * c2
        c = c2
    d = c
    for units in frozen.FC_CONFIGS[int(genome["fc_layers"])]:
        total += d * units + units
        d = units
    return total + d * num_classes + num_classes


def model_size_mb(genome: Dict, num_classes: int, template: str) -> float:
    return count_params(genome, num_classes, template) * 4 / (1024 ** 2)


def count_fwd_flops(genome: Dict, input_hw, num_classes: int,
                    template: str) -> int:
    """Conv and dense FLOPs (2 x MACs) of one forward pass of one sample."""
    two = _two_convs(template)
    f = int(genome["filters"])
    k = int(genome["kernel_size"])
    h, w = int(input_hw[0]), int(input_hw[1])

    def half(n):
        return (n + 1) // 2

    def conv(kk, cin, cout, hh, ww):
        return 2 * kk * kk * cin * cout * hh * ww

    total = conv(k, 1, f, h, w)
    if two:
        total += conv(k, f, f, h, w)
    h, w = half(h), half(w)
    c = f
    for _ in range(int(genome["residual_blocks"])):
        c2 = 2 * c
        h2, w2 = half(h), half(w)
        total += conv(1, c, c2, h2, w2) + conv(k, c, c2, h, w)
        if two:
            total += conv(k, c2, c2, h, w)
        c, h, w = c2, h2, w2
    d = c
    for units in frozen.FC_CONFIGS[int(genome["fc_layers"])]:
        total += 2 * d * units
        d = units
    return total + 2 * d * num_classes


# -- the plain model -----------------------------------------------------------

def reference_params(params: Dict, state: Dict, genome: Dict,
                     template: str) -> Tuple[Dict, Dict]:
    """The genome's own layers out of a frozen init (``init_params``): its
    blocks, its BN layers if it uses BN, and its FC stack, the entry
    layer's weights cut to the genome's GAP width. Same key paths."""
    two = _two_convs(template)
    use_bn = bool(genome["use_bn"])
    n_blocks = int(genome["residual_blocks"])
    entry = 5 - int(genome["fc_layers"])
    gap = int(genome["filters"]) * 2 ** n_blocks
    p: Dict = {"stem1": params["stem1"]}
    s: Dict = {}
    stems = ("stem1", "stem2") if two else ("stem1",)
    for name in stems:
        p[name] = params[name]
        if use_bn:
            p[f"{name}_bn"] = params[f"{name}_bn"]
            s[f"{name}_bn"] = state[f"{name}_bn"]
    convs = ("conv1", "conv2") if two else ("conv1",)
    for i in range(n_blocks):
        blk = params[f"block{i}"]
        q = {"skip": blk["skip"]}
        for c in convs:
            q[c] = blk[c]
            if use_bn:
                q[f"{c}_bn"] = blk[f"{c}_bn"]
                s[f"block{i}_{c}_bn"] = state[f"block{i}_{c}_bn"]
        p[f"block{i}"] = q
    fc = {}
    for li in range(entry, 5):
        layer = params["fc"][f"fc{li}"]
        if li == entry:
            fc[f"fc{li}"] = {"wg": layer["wg"][:gap], "b": layer["b"]}
        else:
            fc[f"fc{li}"] = {"wp": layer["wp"], "b": layer["b"]}
    p["fc"] = fc
    p["out"] = params["out"]
    return training.clone(p), training.clone(s)


def forward(params: Dict, state: Dict, genome: Dict, template: str,
            x: torch.Tensor, *, train: bool, dropout_key=None,
            dropout_rate: float = 0.3, precision: str = "f32"):
    """Logits (B, classes) and the new BN state of one genome's model on
    ``x`` (B, H, W, 1)."""
    two = _two_convs(template)
    qc, qd = training.rounding(precision)
    new_state: Dict = {}

    def conv(h, p, stride=1):
        k = p["w"].shape[-1]
        y = F.conv2d(qc(h), qc(p["w"]), stride=stride,
                     padding=k // 2 if stride == 1 else 0)
        return y + p["b"][None, :, None, None]

    def bn(h, name, p):
        if name not in state:
            return h
        st = state[name]
        if train:
            mean = h.mean(dim=(0, 2, 3))
            var = h.var(dim=(0, 2, 3), unbiased=False)
            new_state[name] = {
                "mean": BN_MOMENTUM * st["mean"] + (1 - BN_MOMENTUM) * mean,
                "var": BN_MOMENTUM * st["var"] + (1 - BN_MOMENTUM) * var}
        else:
            mean, var = st["mean"], st["var"]
            new_state[name] = st
        inv = torch.rsqrt(var + BN_EPS)
        return ((h - mean[None, :, None, None]) * (inv * p["gamma"])[
            None, :, None, None] + p["beta"][None, :, None, None])

    def pool(h):
        return F.max_pool2d(h, 2, 2, ceil_mode=True)

    h = x.reshape(x.shape[0], 1, x.shape[1], x.shape[2])
    h = conv(h, params["stem1"])
    if two:
        h = F.relu(bn(h, "stem1_bn", params.get("stem1_bn")))
        h = conv(h, params["stem2"])
        h = F.relu(bn(h, "stem2_bn", params.get("stem2_bn")))
    else:
        h = bn(F.relu(h), "stem1_bn", params.get("stem1_bn"))
    h = pool(h)
    for i in range(int(genome["residual_blocks"])):
        blk = params[f"block{i}"]
        skip = conv(h, blk["skip"], stride=2)
        y = conv(h, blk["conv1"])
        if two:
            y = F.relu(bn(y, f"block{i}_conv1_bn", blk.get("conv1_bn")))
            y = bn(conv(y, blk["conv2"]), f"block{i}_conv2_bn",
                   blk.get("conv2_bn"))
        else:
            y = bn(F.relu(y), f"block{i}_conv1_bn", blk.get("conv1_bn"))
        h = F.relu(pool(y) + skip)
    act = h.mean(dim=(2, 3))
    entry = 5 - int(genome["fc_layers"])
    uid = torch.tensor([frozen.genome_uid(genome)], dtype=torch.int64,
                       device=x.device)
    for li in range(entry, 5):
        layer = params["fc"][f"fc{li}"]
        w = layer["wg"] if li == entry else layer["wp"]
        act = F.relu(qd(act) @ qd(w) + layer["b"])
        if train and genome["use_dropout"] and dropout_rate > 0.0:
            keep = 1.0 - dropout_rate
            mask = frozen.dropout_mask(dropout_key, uid, li - 1,
                                       act.shape, keep)[0]
            act = act * mask
    logits = qd(act) @ qd(params["out"]["w"]) + params["out"]["b"]
    return logits, new_state
