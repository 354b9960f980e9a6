"""Population forward pass as ONE grouped-convolution network.

The whole (padded) population is evaluated as a single network
(cmoop_audio_processing_tpu/models/grouped.py, contract at lines 109-231):

* conv: activations carry channels (pop * C) in (pop, C) order; the stacked
  (pop, C_out, C_in, k, k) kernels reshape to (pop * C_out, C_in, k, k) and
  run as ONE ``F.conv2d(groups=pop)`` per layer.
* batchnorm: per merged channel == per-model per-channel, so the batch
  statistics are exactly each model's own; ``use_bn`` selects per lane.
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

from typing import Dict

import torch
import torch.nn.functional as F

from .supernet import (
    FC_WIDTHS,
    BucketSpec,
    batch_norm,
    conv2d,
    dropout_mask,
    maxpool2,
    nchw,
)


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
    pop = flags["n_blocks"].shape[0]
    dtype = spec.dtype
    use_bn = flags["use_bn"]
    new_state: Dict = {}
    b_sz = x.shape[0]

    def conv(h, p, stride=1):
        w = p["w"]
        w = w.reshape((pop * w.shape[1],) + tuple(w.shape[2:]))
        return conv2d(h, w, p["b"].reshape(-1), stride, dtype, groups=pop)

    def bn(h, name, p):
        st = state[name]
        c = p["gamma"].shape[1]
        h, m, v = batch_norm(
            h, p["gamma"].reshape(-1), p["beta"].reshape(-1),
            st["mean"].reshape(-1), st["var"].reshape(-1),
            use_bn.repeat_interleave(c), train,
        )
        new_state[name] = {"mean": m.view(pop, c), "var": v.view(pop, c)}
        return h

    # the shared input broadcast into pop groups: (B, pop*1, H, W)
    h = nchw(x).expand(-1, pop, -1, -1)
    h = conv(h, params["stem1"])
    if spec.template == "A":
        h = F.relu(bn(h, "stem1_bn", params["stem1_bn"]))
        h = conv(h, params["stem2"])
        h = F.relu(bn(h, "stem2_bn", params["stem2_bn"]))
    else:
        h = bn(F.relu(h), "stem1_bn", params["stem1_bn"])
    h = maxpool2(h)

    gap_w = spec.gap_width
    gap = torch.zeros(pop, b_sz, gap_w, device=x.device)
    for i in range(spec.max_blocks):
        blk = params[f"block{i}"]
        skip = conv(h, blk["skip"], stride=2)
        y = conv(h, blk["conv1"])
        if spec.template == "A":
            y = F.relu(bn(y, f"block{i}_conv1_bn", blk["conv1_bn"]))
            y = bn(conv(y, blk["conv2"]), f"block{i}_conv2_bn", blk["conv2_bn"])
        else:
            y = bn(F.relu(y), f"block{i}_conv1_bn", blk["conv1_bn"])
        h = F.relu(maxpool2(y) + skip)
        c_out = spec.block_channels[i][1]
        # multi-exit GAP in f32, zero-padded to the widest width, selected
        # per lane: (B, pop*C) -> (pop, B, C)
        e = h.float().mean(dim=(2, 3)).view(b_sz, pop, c_out).transpose(0, 1)
        sel = (flags["n_blocks"] == i + 1)[:, None, None]
        gap = torch.where(sel, F.pad(e, (0, gap_w - c_out)), gap)

    entry = flags["fc_entry"]
    use_do = flags["use_dropout"][:, None, None]
    key = 0 if dropout_key is None else dropout_key
    act = None
    for li in range(1, len(FC_WIDTHS) + 1):
        layer = params["fc"][f"fc{li}"]
        from_gap = torch.bmm(gap, layer["wg"])
        other = torch.zeros_like(from_gap) if li == 1 else torch.bmm(act, layer["wp"])
        sel = (entry == li)[:, None, None]
        act = F.relu(torch.where(sel, from_gap, other) + layer["b"][:, None, :])
        if train and spec.dropout_rate > 0.0:
            keep = 1.0 - spec.dropout_rate
            mask = dropout_mask(key, flags["uid"], li - 1, act.shape[1:], keep)
            act = torch.where(use_do, act * mask, act)

    logits = torch.bmm(act, params["out"]["w"]) + params["out"]["b"][:, None, :]
    return logits, new_state
