"""Masked supernet: one population program per (filters, kernel) bucket
serves every genome in that bucket.

Genes that change tensor shapes quadratically (``filters``,
``kernel_size``) select the bucket; the remaining genes become per-model
flags (cmoop_audio_processing_tpu/models/supernet.py has the full design):

* ``residual_blocks`` — the model runs the bucket's ``max_blocks``; a
  multi-exit GlobalAveragePool reads after block ``n_blocks`` and zero-pads
  to the bucket's widest GAP width. Zero-padded lanes feed zero-initialized
  FC rows, so they contribute nothing and receive no gradient.
* ``fc_layers`` — the FC stacks are suffixes of [512, 256, 128, 64]
  (nsga_penalty.py:311-316), so a genome with n_fc layers *enters* the fixed
  4-layer chain at layer ``5 - n_fc``.
* ``use_bn`` / ``use_dropout`` — ``torch.where`` selects between the
  normalized/raw (masked/unmasked) activations.

Layouts: parameters are dicts with the JAX package's key names; conv
kernels are stored OIHW, (C_out, C_in, k, k), the layout ``F.conv2d``
takes. ``params_from_jax``/``params_to_jax`` carry weights across the
boundary, transposing the JAX package's HWIO. Public forwards take inputs
in the JAX layout, (B, H, W, 1).

Initialization follows Keras defaults (Glorot-uniform kernels, zero bias,
BN gamma=1 beta=0, moving mean 0 / var 1). Each parameter draws from its
own ``torch.Generator`` seeded from (run seed, genome uid, slot): slots are
numbered in a fixed order that does not depend on ``max_blocks`` (a skipped
block still takes its slot numbers) and the FC entry weights are drawn at
the canonical width ``filters*8`` and sliced, so a genome's parameters are
the same at every specialization level. Draws run on the CPU generator, so
a genome gets the same parameters on every device.

BatchNormalization is written out: Keras semantics (momentum 0.99 applied
to the OLD moving value, biased batch variance, eps 1e-3), which
``F.batch_norm`` does not give (its momentum weights the new sample and its
running variance is unbiased).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import zlib
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.genome import Genome, genome_key
from ..core.rng import fold_in, seed_key

FC_WIDTHS = (512, 256, 128, 64)  # fixed chain; genomes enter at 5 - n_fc
BN_MOMENTUM = 0.99  # keras BatchNormalization defaults
BN_EPS = 1e-3
CONV_LAYERS = ("stem1", "stem2", "skip", "conv1", "conv2")


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Static shape information for one bucket. ``max_blocks`` specializes
    the program to the deepest genome present (engine/evaluator.py sets it
    per launch)."""

    template: str  # "A" | "B"
    filters: int
    kernel: int
    num_classes: int
    dropout_rate: float = 0.3
    compute_dtype: str = "float32"
    max_blocks: int = 3

    @property
    def gap_width(self) -> int:
        return self.filters * 2 ** self.max_blocks

    @property
    def block_channels(self) -> Tuple[Tuple[int, int], ...]:
        f = self.filters
        return tuple(
            (f * 2 ** i, f * 2 ** (i + 1)) for i in range(self.max_blocks)
        )

    @property
    def dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            self.compute_dtype
        ]


FLAG_NAMES = ("n_blocks", "fc_entry", "use_bn", "use_dropout", "uid")


def genome_uid(genome: Genome) -> int:
    """crc32 of the canonical genome key: the identity that keys a genome's
    init and dropout streams (the same value as the JAX package's uid)."""
    return zlib.crc32(str(genome_key(genome)).encode())


def flags_from_genome(genome: Genome) -> Dict[str, np.ndarray]:
    """Per-individual dynamic flags (everything not in the bucket key)."""
    return {
        "n_blocks": np.int64(genome["residual_blocks"]),
        "fc_entry": np.int64(5 - genome["fc_layers"]),
        "use_bn": np.bool_(genome["use_bn"]),
        "use_dropout": np.bool_(genome["use_dropout"]),
        "uid": np.int64(genome_uid(genome)),
    }


def stack_flags(genomes, device="cpu") -> Dict[str, torch.Tensor]:
    """Stacked per-lane flag tensors for a (padded) population — the single
    source of truth for the flag layout (FLAG_NAMES)."""
    per = [flags_from_genome(g) for g in genomes]
    return {
        name: torch.as_tensor(np.stack([f[name] for f in per]), device=device)
        for name in FLAG_NAMES
    }


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def _uniform(gen: torch.Generator, shape, limit: float) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32).uniform_(
        -limit, limit, generator=gen
    )


def _glorot(gen, shape, fan_in: int, fan_out: int) -> torch.Tensor:
    return _uniform(gen, shape, math.sqrt(6.0 / (fan_in + fan_out)))


def _conv_init(gen, k: int, c_in: int, c_out: int) -> Dict[str, torch.Tensor]:
    return {
        "w": _glorot(gen, (c_out, c_in, k, k), k * k * c_in, k * k * c_out),
        "b": torch.zeros(c_out),
    }


def _bn_init(c: int):
    return {"gamma": torch.ones(c), "beta": torch.zeros(c)}


def _bn_state_init(c: int):
    return {"mean": torch.zeros(c), "var": torch.ones(c)}


def init_params(seed: int, spec: BucketSpec, genome: Genome):
    """Parameters + BN state of ONE genome in this bucket (CPU tensors), a
    deterministic function of (seed, genome, spec) that does not depend on
    ``spec.max_blocks`` beyond which blocks exist."""
    f, k = spec.filters, spec.kernel
    n_blocks = int(genome["residual_blocks"])
    fc_entry = 5 - int(genome["fc_layers"])
    lane_key = fold_in(seed_key(seed), genome_uid(genome))
    slots = itertools.count()

    def gen() -> torch.Generator:
        g = torch.Generator()
        g.manual_seed(fold_in(lane_key, next(slots)))
        return g

    params: Dict = {}
    state: Dict = {}
    params["stem1"] = _conv_init(gen(), k, 1, f)
    params["stem1_bn"] = _bn_init(f)
    state["stem1_bn"] = _bn_state_init(f)
    if spec.template == "A":
        params["stem2"] = _conv_init(gen(), k, f, f)
        params["stem2_bn"] = _bn_init(f)
        state["stem2_bn"] = _bn_state_init(f)

    for i in range(3):
        # always TAKE this block's slots, even past max_blocks, so the
        # slot numbering is the same at every specialization level
        g_skip, g_conv1 = gen(), gen()
        g_conv2 = gen() if spec.template == "A" else None
        if i >= spec.max_blocks:
            continue
        c_in, c_out = spec.block_channels[i]
        blk: Dict = {
            "skip": _conv_init(g_skip, 1, c_in, c_out),
            "conv1": _conv_init(g_conv1, k, c_in, c_out),
            "conv1_bn": _bn_init(c_out),
        }
        state[f"block{i}_conv1_bn"] = _bn_state_init(c_out)
        if spec.template == "A":
            blk["conv2"] = _conv_init(g_conv2, k, c_out, c_out)
            blk["conv2_bn"] = _bn_init(c_out)
            state[f"block{i}_conv2_bn"] = _bn_state_init(c_out)
        params[f"block{i}"] = blk

    gap_w = spec.gap_width
    active_gap = f * 2 ** n_blocks
    fc: Dict = {}
    for li, units in enumerate(FC_WIDTHS, start=1):
        layer: Dict = {"b": torch.zeros(units)}
        # entry layer: Glorot with the genome's true fan-in on the active
        # rows, zeros elsewhere; drawn at the canonical width f*8 and sliced
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
        "w": _glorot(gen(), (FC_WIDTHS[-1], spec.num_classes), FC_WIDTHS[-1],
                     spec.num_classes),
        "b": torch.zeros(spec.num_classes),
    }
    return params, state


def tree_map(fn, *trees):
    """Map ``fn`` over the leaves of nested dicts of equal structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure over ``leaves`` in ``tree_leaves``
    order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def init_population(seed: int, spec: BucketSpec, genomes, device="cpu"):
    """Stacked params/state (leading pop axis on every leaf) + flags for a
    (padded) population, on ``device``."""
    if max(int(g["residual_blocks"]) for g in genomes) > spec.max_blocks:
        raise ValueError(
            f"population has a genome deeper than the bucket's "
            f"max_blocks={spec.max_blocks}"
        )
    per = [init_params(seed, spec, g) for g in genomes]

    def stack(*xs):
        return torch.stack(xs).to(device)

    params = tree_map(stack, *[p for p, _ in per])
    state = tree_map(stack, *[s for _, s in per])
    return params, state, stack_flags(genomes, device)


# ---------------------------------------------------------------------------
# Weight carry-over to and from the JAX package's layout
# ---------------------------------------------------------------------------

def _carry(tree, to_torch: bool, device, parent: str = ""):
    """``parent`` names the dict holding ``tree``: a conv layer's kernel is
    the >= 4-dim leaf of a CONV_LAYERS dict."""
    if isinstance(tree, dict):
        return {
            k: _carry(v, to_torch, device, k if isinstance(v, dict) else parent)
            for k, v in tree.items()
        }
    if to_torch:
        a = torch.tensor(np.asarray(tree, np.float32), device=device)
        if parent in CONV_LAYERS and a.dim() >= 4:
            # HWIO (k, k, C_in, C_out) -> OIHW, with or without a pop axis
            a = a.permute(0, 4, 3, 1, 2) if a.dim() == 5 else a.permute(3, 2, 0, 1)
        return a.contiguous()
    a = tree.detach().cpu()
    if parent in CONV_LAYERS and a.dim() >= 4:
        a = a.permute(0, 3, 4, 2, 1) if a.dim() == 5 else a.permute(2, 3, 1, 0)
    return a.contiguous().numpy()


def params_from_jax(params, state, device="cpu"):
    """JAX package params/state (nested dicts of numpy arrays, stacked or
    single-model) -> this package's layout on ``device``: conv kernels go
    HWIO -> OIHW, everything else keeps its shape and key."""
    return _carry(params, True, device), _carry(state, True, device)


def params_to_jax(params, state):
    """Inverse of ``params_from_jax``: numpy arrays in the JAX layout."""
    return _carry(params, False, None), _carry(state, False, None)


# ---------------------------------------------------------------------------
# Forward pass (single model)
# ---------------------------------------------------------------------------

def nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1) -> (B, 1, H, W) in the standard layout (a permute would
    leave channels-last strides, which the convs would carry on, and oneDNN
    then reduces BN statistics in an order that depends on the channel
    count, so a lane's results would depend on the lanes beside it)."""
    return x.reshape(x.shape[0], 1, x.shape[1], x.shape[2])


def conv2d(x, w, b, stride: int, dtype: torch.dtype, groups: int = 1):
    """SAME-padded conv in the compute dtype (parameters live in f32; the
    activations stay in the compute dtype, as in the JAX package). The
    stride-2 convs are 1x1, for which SAME needs no padding."""
    k = w.shape[-1]
    y = F.conv2d(x.to(dtype), w.to(dtype), stride=stride,
                 padding=k // 2 if stride == 1 else 0, groups=groups)
    return y + b.to(dtype)[None, :, None, None]


def lane_conv1x1(h, w, b, stride: int, dtype: torch.dtype):
    """1x1 conv of each lane's channels as one batched matmul over the
    lanes: h (B, pop*C_in, H, W) with channels in (pop, C) order, w (pop,
    C_out, C_in, 1, 1), b (pop, C_out) -> (B, pop*C_out, H', W'), in the
    compute dtype. The skip projections run here rather than as a (grouped)
    conv: oneDNN picks a 1x1 conv's algorithm by its shape and group count,
    so a lane's sums would round differently at another lane count."""
    pop, c_out, c_in = w.shape[:3]
    hs = h[:, :, ::stride, ::stride].to(dtype)
    n, _, hh, ww = hs.shape
    a = hs.reshape(n, pop, c_in, hh * ww).permute(1, 0, 3, 2).reshape(
        pop, n * hh * ww, c_in)
    y = torch.bmm(a, w.reshape(pop, c_out, c_in).transpose(1, 2).to(dtype))
    y = y.reshape(pop, n, hh * ww, c_out).permute(1, 0, 3, 2).reshape(
        n, pop * c_out, hh, ww)
    return y + b.reshape(-1).to(dtype)[None, :, None, None]


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 SAME max-pool: on an odd size the last window covers
    the last row/column alone (-inf padding at the bottom/right), so
    45x13 -> 23x7. ceil_mode gives exactly that; the default floor mode
    would give 22x6."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def batch_norm(x, gamma, beta, mean_st, var_st, use_bn, train: bool):
    """Masked Keras BatchNormalization over (N, H, W) per channel of
    x (B, C, H, W). Statistics are f32 whatever the activation dtype; the
    normalization runs in the activation dtype. ``use_bn`` is a per-channel
    (or scalar) bool selecting normalized vs raw. Returns (x', mean', var')."""
    if train:
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = xf.var(dim=(0, 2, 3), unbiased=False)
        new_mean, new_var = bn_moving(mean_st, var_st, mean, var)
    else:
        mean, var = mean_st, var_st
        new_mean, new_var = mean_st, var_st
    return bn_normalize(x, gamma, beta, mean, var, use_bn), new_mean, new_var


def bn_moving(mean_st, var_st, mean, var):
    """Keras's moving statistics: momentum on the OLD value."""
    return (BN_MOMENTUM * mean_st + (1 - BN_MOMENTUM) * mean,
            BN_MOMENTUM * var_st + (1 - BN_MOMENTUM) * var)


def bn_normalize(x, gamma, beta, mean, var, use_bn):
    """Normalize x (B, C, H, W) with per-channel statistics, in the
    activation dtype; ``use_bn`` selects normalized vs raw."""
    dtype = x.dtype
    inv = torch.rsqrt(var + BN_EPS)
    scale = (inv * gamma).to(dtype)[None, :, None, None]
    shift = (beta - mean * inv * gamma).to(dtype)[None, :, None, None]
    xn = x * scale + shift
    mask = use_bn if use_bn.dim() == 0 else use_bn[None, :, None, None]
    return torch.where(mask, xn, x)


def dropout_mask(key, uids: torch.Tensor, layer: int, shape, keep: float):
    """Inverted-dropout multipliers, (len(uids),) + shape, float32: lane p
    keeps element e iff hash(key, uid_p, layer, e) < keep * 2**32. A
    counter-based stream in plain integer ops: the same bits on CPU and
    CUDA, keyed by genome identity, not by lane position."""
    lane = fold_in(key, uids)
    lk = fold_in(lane, layer)
    n = math.prod(shape)
    counter = torch.arange(n, device=uids.device, dtype=torch.int64).view(shape)
    bits = fold_in(lk.view((-1,) + (1,) * len(shape)), counter)
    return (bits < int(keep * 2 ** 32)).float() / keep


def apply_model(
    spec: BucketSpec,
    params: Dict,
    state: Dict,
    flags: Dict,
    x: torch.Tensor,
    *,
    train: bool,
    dropout_key=None,
):
    """Forward pass for one model; x (B, H, W, 1). ``flags`` holds the
    genome's flags as 0-dim tensors. ``dropout_key`` is the step key: the
    model folds its own uid in, exactly as ``grouped.apply_population``
    does per lane. Returns (logits (B, classes), new_bn_state)."""
    dtype = spec.dtype
    use_bn = flags["use_bn"]
    new_state: Dict = {}

    def conv(h, p, stride=1):
        if p["w"].shape[-1] == 1:  # as grouped.group_conv does
            return lane_conv1x1(h, p["w"][None], p["b"][None], stride, dtype)
        return conv2d(h, p["w"], p["b"], stride, dtype)

    def bn(h, name, p):
        st = state[name]
        h, m, v = batch_norm(h, p["gamma"], p["beta"], st["mean"], st["var"],
                             use_bn, train)
        new_state[name] = {"mean": m, "var": v}
        return h

    h = conv(nchw(x), params["stem1"])
    if spec.template == "A":
        # Template A: conv -> BN? -> ReLU, twice (nsga_penalty.py:255-263)
        h = F.relu(bn(h, "stem1_bn", params["stem1_bn"]))
        h = conv(h, params["stem2"])
        h = F.relu(bn(h, "stem2_bn", params["stem2_bn"]))
    else:
        # Template B: conv(relu) -> BN? (sa_nsga_penalty.py:151-152)
        h = bn(F.relu(h), "stem1_bn", params["stem1_bn"])
    h = maxpool2(h)

    exits = []
    for i in range(spec.max_blocks):
        blk = params[f"block{i}"]
        skip = conv(h, blk["skip"], stride=2)
        y = conv(h, blk["conv1"])
        if spec.template == "A":
            # conv -> BN? -> ReLU -> conv -> BN? -> pool -> add -> ReLU
            y = F.relu(bn(y, f"block{i}_conv1_bn", blk["conv1_bn"]))
            y = bn(conv(y, blk["conv2"]), f"block{i}_conv2_bn", blk["conv2_bn"])
        else:
            # conv(relu) -> BN? -> pool -> add -> ReLU
            y = bn(F.relu(y), f"block{i}_conv1_bn", blk["conv1_bn"])
        h = F.relu(maxpool2(y) + skip)
        # GAP accumulates in f32; the FC head is tiny and stays f32
        exits.append(h.float().mean(dim=(2, 3)))

    gap_w = spec.gap_width
    gap = torch.zeros(x.shape[0], gap_w, device=x.device)
    for i, e in enumerate(exits):
        gap = torch.where(flags["n_blocks"] == i + 1,
                          F.pad(e, (0, gap_w - e.shape[1])), gap)

    entry = flags["fc_entry"]
    key = 0 if dropout_key is None else dropout_key
    act = torch.zeros(x.shape[0], FC_WIDTHS[0], device=x.device)
    for li in range(1, len(FC_WIDTHS) + 1):
        layer = params["fc"][f"fc{li}"]
        from_gap = gap @ layer["wg"]
        other = torch.zeros_like(from_gap) if li == 1 else act @ layer["wp"]
        act = F.relu(torch.where(entry == li, from_gap, other) + layer["b"])
        if train and spec.dropout_rate > 0.0:
            keep = 1.0 - spec.dropout_rate
            mask = dropout_mask(key, flags["uid"].view(1), li - 1, act.shape, keep)[0]
            act = torch.where(flags["use_dropout"], act * mask, act)
    logits = act @ params["out"]["w"] + params["out"]["b"]
    return logits, new_state
