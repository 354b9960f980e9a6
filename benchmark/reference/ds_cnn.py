"""Template D, DS-CNN's depthwise-separable block in the reference's residual
frame: the architecture module of the ``bird_dscnn_sa_nsga_penalty``
configuration (its ``"reference": "ds_cnn"``).

DS-CNN is the depthwise-separable CNN of "Hello Edge: Keyword Spotting on
Microcontrollers" (Zhang et al., arXiv:1711.07128), MLPerf Tiny's
keyword-spotting reference: a strided full conv, then blocks of depthwise
3x3 -> BN -> ReLU -> pointwise 1x1 -> BN -> ReLU, global average pooling
and a dense layer. Template D, with k the kernel size, f the filters, BN
only where ``use_bn``, every conv with a bias, SAME padding as TF/Keras
defines it (at stride 2: ``total = max((ceil(n/2) - 1) * 2 + k - n, 0)``,
``total // 2`` before, the rest after):

* stem: ``h = ReLU(BN(Conv_kxk,stride 2(x; 1 -> f)))``, no pool;
* block i, c -> 2c:
  ``u = ReLU(BN(DW_kxk(h; c)))`` (depthwise, depth multiplier 1),
  ``y = BN(PW_1x1(u; c -> 2c))``,
  ``h' = ReLU(MaxPool2_SAME(y) + Skip_1x1,stride 2(h; c -> 2c))``;
* head: templates A's and B's global average pooling, the genome's FC
  stack (a suffix of 512-256-128-64) with inverted dropout, softmax output.

Departures from the published DS-CNN: the stem's kernel is k x k, not
10 x 4; the depthwise kernel is k x k with k in {3, 5}, not 3 x 3; widths
double each block over 1-3 blocks, not one width over 4-5 layers; the
residual frame (skip projection, max-pool, ReLU after the add) and the FC
head are the reference repo's; dropout is in the FC head only.

Keras semantics it keeps: ``DepthwiseConv2D`` draws glorot-uniform over
its (k, k, c, 1) kernel (fan_in k*k*c, fan_out k*k), biases zero;
``count_params`` counts a depthwise conv as k*k*c + c and a BN layer as 4
a channel. BN, pooling and the FC head are ``keras_cnn``'s.

Like ``keras_cnn``: ``init_params`` is a frozen copy, by value, of the
program's genome-keyed initialization (``models/supernet.init_params``),
the counts frozen copies of ``models/genome_arch.py``'s, and
``reference_params`` and ``forward`` the plain float32 model.
``depthwise_work`` counts the depthwise convs' operations and bytes for
the ``grouped.depthwise_roofline`` reader. Every function raises on a
template other than "D". Imports nothing of the program and nothing of
JAX.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .. import frozen
from . import training
from .keras_cnn import (
    BN_EPS,
    BN_MOMENTUM,
    BN_PARAMS_PER_CHANNEL,
    FC_WIDTHS,
    _conv_init,
    _glorot,
    _uniform,
)

TEMPLATES = ("D",)
PASSES = ("fwd", "dgrad", "wgrad")
BYTES = 2  # a bfloat16 activation or weight


def _check(template: str):
    if template not in TEMPLATES:
        raise ValueError(f"unknown template {template!r}")


def _half(n: int) -> int:
    return (n + 1) // 2


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """TF/Keras SAME padding of an axis of length ``n``: (before, after)."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


# -- models/supernet.py --------------------------------------------------------

def init_params(seed: int, template: str, filters: int, kernel: int,
                num_classes: int, max_blocks: int, genome: Dict):
    """Parameters and BN state of one genome, as the program's
    ``init_params`` draws them for a bucket of ``max_blocks`` (CPU, f32):
    one slot for the stem, three a block (skip, depthwise, pointwise),
    taken for every block, then the FC head's."""
    _check(template)
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
    for i in range(3):
        g_skip, g_dw, g_pw = gen(), gen(), gen()
        if i >= max_blocks:
            continue
        c_in, c_out = f * 2 ** i, f * 2 ** (i + 1)
        params[f"block{i}"] = {
            "skip": _conv_init(g_skip, 1, c_in, c_out),
            "dw": {"w": _glorot(g_dw, (c_in, 1, k, k), k * k * c_in, k * k),
                   "b": torch.zeros(c_in)},
            "dw_bn": bn(c_in),
            "pw": _conv_init(g_pw, 1, c_in, c_out),
            "pw_bn": bn(c_out),
        }
        state[f"block{i}_dw_bn"] = bn_state(c_in)
        state[f"block{i}_pw_bn"] = bn_state(c_out)
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
    _check(template)
    f = int(genome["filters"])
    k = int(genome["kernel_size"])
    bn = BN_PARAMS_PER_CHANNEL if bool(genome["use_bn"]) else 0

    def conv(kk, c_in, c_out):
        return kk * kk * c_in * c_out + c_out

    total = conv(k, 1, f) + bn * f
    c = f
    for _ in range(int(genome["residual_blocks"])):
        c2 = 2 * c
        total += (conv(1, c, c2) + k * k * c + c + conv(1, c, c2)
                  + bn * (c + c2))
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
    """Conv and dense FLOPs (2 x MACs) of one forward pass of one sample;
    a depthwise conv 2 k^2 an output element."""
    _check(template)
    f = int(genome["filters"])
    k = int(genome["kernel_size"])
    h, w = _half(int(input_hw[0])), _half(int(input_hw[1]))
    total = 2 * k * k * f * h * w
    c = f
    for _ in range(int(genome["residual_blocks"])):
        c2 = 2 * c
        h2, w2 = _half(h), _half(w)
        total += 2 * c * c2 * h2 * w2 + 2 * k * k * c * h * w \
            + 2 * c * c2 * h * w
        c, h, w = c2, h2, w2
    d = c
    for units in frozen.FC_CONFIGS[int(genome["fc_layers"])]:
        total += 2 * d * units
        d = units
    return total + 2 * d * num_classes


def depthwise_work(genome: Dict, input_hw, rows: int,
                   passes=PASSES) -> Tuple[int, int]:
    """(FLOPs, bytes) of one lane's depthwise convs over ``rows`` rows, in
    each of ``passes`` (forward, input gradient, weight gradient): 2 k^2
    FLOPs an output element a pass; a pass reads one bfloat16 map and
    writes another (the forward x -> y, the input gradient dy -> dx; the
    weight gradient reads x and dy) and touches the k^2 c weights once."""
    unknown = set(passes) - set(PASSES)
    if unknown:
        raise ValueError(f"unknown passes {sorted(unknown)}")
    f = int(genome["filters"])
    k = int(genome["kernel_size"])
    h, w = _half(int(input_hw[0])), _half(int(input_hw[1]))
    elems = weights = 0
    c = f
    for _ in range(int(genome["residual_blocks"])):
        elems += c * h * w
        weights += k * k * c
        c, h, w = 2 * c, _half(h), _half(w)
    n = len(passes)
    flops = n * 2 * k * k * elems * rows
    nbytes = n * (2 * elems * rows + weights) * BYTES
    return flops, nbytes


# -- the plain model -----------------------------------------------------------

def reference_params(params: Dict, state: Dict, genome: Dict,
                     template: str) -> Tuple[Dict, Dict]:
    """The genome's own layers out of a frozen init (``init_params``): its
    blocks, its BN layers if it uses BN, and its FC stack, the entry
    layer's weights cut to the genome's GAP width. Same key paths."""
    _check(template)
    use_bn = bool(genome["use_bn"])
    n_blocks = int(genome["residual_blocks"])
    entry = 5 - int(genome["fc_layers"])
    gap = int(genome["filters"]) * 2 ** n_blocks
    p: Dict = {"stem1": params["stem1"]}
    s: Dict = {}
    if use_bn:
        p["stem1_bn"] = params["stem1_bn"]
        s["stem1_bn"] = state["stem1_bn"]
    for i in range(n_blocks):
        blk = params[f"block{i}"]
        q = {"skip": blk["skip"], "dw": blk["dw"], "pw": blk["pw"]}
        if use_bn:
            for name in ("dw", "pw"):
                q[f"{name}_bn"] = blk[f"{name}_bn"]
                s[f"block{i}_{name}_bn"] = state[f"block{i}_{name}_bn"]
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
    _check(template)
    qc, qd = training.rounding(precision)
    new_state: Dict = {}

    def conv(h, p, stride=1, groups=1):
        k = p["w"].shape[-1]
        h = qc(h)
        if stride == 1:
            y = F.conv2d(h, qc(p["w"]), padding=k // 2, groups=groups)
        else:
            (t, b), (le, r) = (same_pads(n, k, stride) for n in h.shape[2:])
            y = F.conv2d(F.pad(h, (le, r, t, b)), qc(p["w"]), stride=stride)
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

    h = x.reshape(x.shape[0], 1, x.shape[1], x.shape[2])
    h = F.relu(bn(conv(h, params["stem1"], stride=2), "stem1_bn",
                  params.get("stem1_bn")))
    for i in range(int(genome["residual_blocks"])):
        blk = params[f"block{i}"]
        skip = conv(h, blk["skip"], stride=2)
        u = conv(h, blk["dw"], groups=h.shape[1])
        u = F.relu(bn(u, f"block{i}_dw_bn", blk.get("dw_bn")))
        y = bn(conv(u, blk["pw"]), f"block{i}_pw_bn", blk.get("pw_bn"))
        h = F.relu(F.max_pool2d(y, 2, 2, ceil_mode=True) + skip)
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
