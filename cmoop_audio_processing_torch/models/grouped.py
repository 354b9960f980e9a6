"""Population forward pass as ONE grouped-convolution network.

The whole (padded) population is evaluated as a single network
(cmoop_audio_processing_tpu/models/grouped.py, contract at lines 109-231):

* conv: activations carry channels (pop * C) in (pop, C) order; the stacked
  (pop, C_out, C_in, k, k) kernels reshape to (pop * C_out, C_in, k, k) and
  run as ONE ``F.conv2d(groups=pop)`` per layer (``group_conv``); template
  D's depthwise kernels (pop, C, 1, k, k) run as one conv of pop * C
  groups, one a lane's channel (``supernet.depthwise_conv2d``).
* batchnorm: per merged channel == per-model per-channel, so the batch
  statistics are exactly each model's own; ``use_bn`` selects per lane
  (``group_bn``).
* pooling / GAP / residual adds: channel-wise, unchanged semantics.
* FC: (pop, B, D) x (pop, D, U) batched matmuls, entered at each lane's
  ``fc_entry``.

Parameters keep the stacked layout of models/supernet.py (leading pop axis
on every leaf); the per-model loss sums over the population — parameters
are disjoint across models, so the gradient of the sum IS each model's own
gradient.

Numerical contract: equal (up to f32 reassociation) to a loop of
``supernet.apply_model`` over the lanes, dropout included (both draw lane
masks from the step key folded with the lane's genome uid).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from .supernet import (
    FC_WIDTHS,
    BucketSpec,
    batch_norm,
    bn_moving,
    bn_normalize,
    conv2d,
    depthwise_conv2d,
    dropout_mask,
    lane_conv1x1,
    maxpool2,
    nchw,
    tree_map,
)


# ---------------------------------------------------------------------------
# Grouped layers: one call per layer for a whole population
# ---------------------------------------------------------------------------

def group_conv(h, w, b, stride: int, dtype: torch.dtype):
    """A population's conv layer as ONE grouped conv: h (B, pop*C_in, H, W)
    with channels in (pop, C) order, w (pop, C_out, C_in, k, k), b (pop,
    C_out) -> (B, pop*C_out, H', W'). A 1x1 conv (the stride-2 skip
    projections, template D's pointwise convs) runs as one batched matmul
    (``supernet.lane_conv1x1``)."""
    if w.shape[-1] == 1:
        return lane_conv1x1(h, w, b, stride, dtype)
    pop = w.shape[0]
    w = w.reshape((pop * w.shape[1],) + tuple(w.shape[2:]))
    return conv2d(h, w, b.reshape(-1), stride, dtype, groups=pop)


def group_bn(h, gamma, beta, mean_st, var_st, use_bn, train: bool):
    """A population's BN layer over h (B, pop*C, H, W): a merged channel is
    one lane's channel, so the statistics are each lane's own. gamma, beta
    and the state are (pop, C), use_bn (pop,). Returns (h', mean', var')
    with the state as (pop, C)."""
    pop, c = gamma.shape
    h, m, v = batch_norm(
        h, gamma.reshape(-1), beta.reshape(-1), mean_st.reshape(-1),
        var_st.reshape(-1), use_bn.repeat_interleave(c), train,
    )
    return h, m.view(pop, c), v.view(pop, c)


def group_bn_shards(hs, gamma, beta, mean_st, var_st, use_bn, train: bool):
    """``group_bn`` over a batch whose rows are split into shards ``hs`` on
    several devices (one pop shard's data devices). In training the
    statistics are the global batch's: f32 sums of every shard, moved to
    the device of ``gamma`` and added there, then the biased variance from
    the global mean in a second pass, as ``batch_norm`` takes it. One
    shard is ``group_bn`` itself. Returns (shards', mean', var')."""
    if len(hs) == 1:
        h, m, v = group_bn(hs[0], gamma, beta, mean_st, var_st, use_bn, train)
        return [h], m, v
    pop, c = gamma.shape
    dev = gamma.device
    g, b, ub = gamma.reshape(-1), beta.reshape(-1), use_bn.repeat_interleave(c)
    mean_st, var_st = mean_st.reshape(-1), var_st.reshape(-1)
    if train:
        n = sum(h.shape[0] * h.shape[2] * h.shape[3] for h in hs)
        mean = sum(h.float().sum(dim=(0, 2, 3)).to(dev) for h in hs) / n

        def sq(h):
            d = h.float() - mean.to(h.device)[None, :, None, None]
            return (d * d).sum(dim=(0, 2, 3)).to(dev)

        var = sum(sq(h) for h in hs) / n
        new_mean, new_var = bn_moving(mean_st, var_st, mean, var)
    else:
        mean, var = mean_st, var_st
        new_mean, new_var = mean_st, var_st
    out = [bn_normalize(h, *(t.to(h.device) for t in (g, b, mean, var, ub)))
           for h in hs]
    return out, new_mean.view(pop, c), new_var.view(pop, c)


def group_gap(h: torch.Tensor, pop: int) -> torch.Tensor:
    """Global average pool in f32 of h (B, pop*C, H, W) -> (pop, B, C)."""
    return h.float().mean(dim=(2, 3)).view(h.shape[0], pop, -1).transpose(0, 1)


def apply_population(
    spec: BucketSpec,
    params: Dict,
    state: Dict,
    flags: Dict,
    x: torch.Tensor,
    *,
    train: bool,
    dropout_key=None,
):
    """Stacked-population forward: params/state with a leading pop axis,
    x shared (B, H, W, 1). Returns (logits (pop, B, classes), new_bn_state).

    In bf16 mode the casts sit where the JAX package puts them: convs and
    activations in bf16; parameters, BN statistics, GAP and the FC head in
    f32."""
    logits, new_state = apply_population_shards(
        spec, params, state, flags, [x], train=train, dropout_key=dropout_key)
    return logits[0], new_state


def apply_population_shards(
    spec: BucketSpec,
    params: Dict,
    state: Dict,
    flags: Dict,
    xs: List[torch.Tensor],
    *,
    train: bool,
    dropout_key=None,
):
    """``apply_population`` over a batch whose rows are split into shards
    ``xs`` (each (b_j, H, W, 1)) on a pop shard's data devices: every layer
    runs on each shard on its own device with the parameters moved there
    (differentiably), the BN statistics in training are the global batch's
    (``supernet.group_bn_shards``) and each shard's dropout masks are its
    rows of the global batch's masks. One shard is the plain forward.
    Returns (per-shard logits (pop, b_j, classes), new BN state on the
    parameters' device)."""
    pop = flags["n_blocks"].shape[0]
    dtype = spec.dtype
    new_state: Dict = {}
    here = {x.device: tuple(tree_map(lambda t: t.to(x.device), tree)
                            for tree in (params, flags)) for x in xs}

    def p_of(h):
        return here[h.device][0]

    def f_of(h):
        return here[h.device][1]

    def conv(hs, path, stride=1):
        return [group_conv(h, path(p_of(h))["w"], path(p_of(h))["b"], stride,
                           dtype) for h in hs]

    def bn(hs, name, p):
        st = state[name]
        hs, m, v = group_bn_shards(hs, p["gamma"], p["beta"], st["mean"],
                                   st["var"], flags["use_bn"], train)
        new_state[name] = {"mean": m, "var": v}
        return hs

    def each(fn, hs):
        return [fn(h) for h in hs]

    def depthwise(hs, blk):
        # w (pop, C, 1, k, k) -> one conv of pop*C groups, one a channel
        out = []
        for h in hs:
            w, b = p_of(h)[blk]["dw"]["w"], p_of(h)[blk]["dw"]["b"]
            out.append(depthwise_conv2d(h, w.flatten(0, 1), b.reshape(-1),
                                        dtype, lanes=w.shape[0]))
        return out

    # Every lane reads the same one-channel input, so the first conv is ONE
    # ungrouped conv from it to all lanes' channels, (B, pop*C, H, W): the
    # conv apply_model runs, at every lane count (a grouped conv over the
    # input broadcast into pop groups rounds differently at pop 1).
    # Template D's is at stride 2, its maps at the size the others' pool
    # gives
    stem_stride = 2 if spec.template == "D" else 1
    hs = [conv2d(nchw(x), p_of(x)["stem1"]["w"].flatten(0, 1),
                 p_of(x)["stem1"]["b"].reshape(-1), stem_stride, dtype)
          for x in xs]
    if spec.template == "D":
        hs = each(F.relu, bn(hs, "stem1_bn", params["stem1_bn"]))
    else:
        if spec.template == "A":
            hs = each(F.relu, bn(hs, "stem1_bn", params["stem1_bn"]))
            hs = conv(hs, lambda q: q["stem2"])
            hs = each(F.relu, bn(hs, "stem2_bn", params["stem2_bn"]))
        else:
            hs = bn(each(F.relu, hs), "stem1_bn", params["stem1_bn"])
        hs = each(maxpool2, hs)

    gap_w = spec.gap_width
    gaps = [torch.zeros(pop, x.shape[0], gap_w, device=x.device) for x in xs]
    for i in range(spec.max_blocks):
        blk = f"block{i}"
        skip = conv(hs, lambda q: q[blk]["skip"], stride=2)
        if spec.template == "D":
            ys = depthwise(hs, blk)
            ys = each(F.relu, bn(ys, f"{blk}_dw_bn", params[blk]["dw_bn"]))
            # contiguous at every lane count, as apply_model's
            ys = each(torch.Tensor.contiguous,
                      conv(ys, lambda q: q[blk]["pw"]))
            ys = bn(ys, f"{blk}_pw_bn", params[blk]["pw_bn"])
        elif spec.template == "A":
            ys = conv(hs, lambda q: q[blk]["conv1"])
            ys = each(F.relu, bn(ys, f"{blk}_conv1_bn", params[blk]["conv1_bn"]))
            ys = bn(conv(ys, lambda q: q[blk]["conv2"]), f"{blk}_conv2_bn",
                    params[blk]["conv2_bn"])
        else:
            ys = conv(hs, lambda q: q[blk]["conv1"])
            ys = bn(each(F.relu, ys), f"{blk}_conv1_bn", params[blk]["conv1_bn"])
        hs = [F.relu(maxpool2(y) + s) for y, s in zip(ys, skip)]
        # multi-exit GAP in f32, zero-padded to the widest width, selected
        # per lane: (pop, B, C)
        for j, h in enumerate(hs):
            e = group_gap(h, pop)
            sel = (f_of(h)["n_blocks"] == i + 1)[:, None, None]
            gaps[j] = torch.where(sel, F.pad(e, (0, gap_w - e.shape[2])),
                                  gaps[j])

    key = 0 if dropout_key is None else dropout_key
    rows = [0]
    for x in xs:
        rows.append(rows[-1] + x.shape[0])
    acts = [None] * len(xs)
    for li in range(1, len(FC_WIDTHS) + 1):
        masks = None
        if train and spec.dropout_rate > 0.0:
            # the global batch's masks (B, units), each shard its rows
            keep = 1.0 - spec.dropout_rate
            masks = dropout_mask(key, flags["uid"], li - 1,
                                 (rows[-1], FC_WIDTHS[li - 1]), keep)
        for j, gap in enumerate(gaps):
            layer = p_of(gap)["fc"][f"fc{li}"]
            fl = f_of(gap)
            from_gap = torch.bmm(gap, layer["wg"])
            other = (torch.zeros_like(from_gap) if li == 1
                     else torch.bmm(acts[j], layer["wp"]))
            sel = (fl["fc_entry"] == li)[:, None, None]
            act = F.relu(torch.where(sel, from_gap, other)
                         + layer["b"][:, None, :])
            if masks is not None:
                mask = masks[:, rows[j]:rows[j + 1]].to(gap.device)
                act = torch.where(fl["use_dropout"][:, None, None],
                                  act * mask, act)
            acts[j] = act

    logits = [torch.bmm(act, p_of(act)["out"]["w"])
              + p_of(act)["out"]["b"][:, None, :] for act in acts]
    return logits, new_state
