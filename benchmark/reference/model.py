"""The plain reference: one candidate CNN at a time, in plain PyTorch.

Templates A (two-conv stem, two convs a block) and B (one-conv stem, one
conv a block), as the reference scripts build them (nsga_penalty.py:225-334,
sa_nsga_penalty.py:137-177): SAME convolutions, Keras BatchNormalization
(batch statistics, biased variance, eps 1e-3, momentum 0.99 on the old
moving value), 2x2 max-pools with SAME padding, a 1x1 stride-2 skip
projection a block, global average pooling, the genome's FC stack (a
suffix of 512-256-128-64) with inverted dropout, a softmax output,
weighted cross-entropy, and Adam as optax writes it. The model holds only
the genome's own layers; no population, no masking, no grouping.

It runs in float32 with TF32 off (``precision="f32"``). ``precision=
"control"`` is the check's lower-precision control: conv operands rounded
to float8 e4m3 with a per-tensor scale (the step below the bfloat16 the
configurations state for convs), dense operands rounded to TF32 (the step
below their float32), through a straight-through rounding so that the
backward pass sees the rounded operands too.

Imports nothing of the program and nothing of JAX; the genome-keyed init,
the dropout stream and the shuffle come from ``benchmark.frozen``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from .. import frozen

BN_EPS = 1e-3
BN_MOMENTUM = 0.99
ADAM_B1, ADAM_B2 = 0.9, 0.999
E4M3_MAX = 448.0


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t.detach())


def _tf32(t: torch.Tensor) -> torch.Tensor:
    bits = t.detach().contiguous().view(torch.int32)
    q = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (q - t.detach())


def rounding(precision: str) -> Tuple[Callable, Callable]:
    """(conv operand rounding, dense operand rounding) of a precision."""
    if precision == "f32":
        return _same, _same
    if precision == "control":
        return _fp8, _tf32
    raise ValueError(f"unknown precision {precision!r}")


def reference_params(params: Dict, state: Dict, genome: Dict,
                     template: str) -> Tuple[Dict, Dict]:
    """The genome's own layers out of a frozen init (``frozen.init_params``):
    its blocks, its BN layers if it uses BN, and its FC stack, the entry
    layer's weights cut to the genome's GAP width. Same key paths."""
    use_bn = bool(genome["use_bn"])
    n_blocks = int(genome["residual_blocks"])
    entry = 5 - int(genome["fc_layers"])
    gap = int(genome["filters"]) * 2 ** n_blocks
    p: Dict = {"stem1": params["stem1"]}
    s: Dict = {}
    stems = ("stem1", "stem2") if template == "A" else ("stem1",)
    for name in stems:
        p[name] = params[name]
        if use_bn:
            p[f"{name}_bn"] = params[f"{name}_bn"]
            s[f"{name}_bn"] = state[f"{name}_bn"]
    convs = ("conv1", "conv2") if template == "A" else ("conv1",)
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
    return _clone(p), _clone(s)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def leaves(tree: Dict, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs, paths joined with '/'."""
    out = []
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.extend(leaves(v, path + "/"))
        else:
            out.append((path, v))
    return out


def count_params(params: Dict, state: Dict) -> int:
    """Keras ``count_params``: every weight, plus each BN layer's moving
    mean and variance."""
    return (sum(t.numel() for _, t in leaves(params))
            + sum(t.numel() for _, t in leaves(state)))


def size_mb(params: Dict, state: Dict) -> float:
    return count_params(params, state) * 4 / (1024 ** 2)


def forward(params: Dict, state: Dict, genome: Dict, template: str,
            x: torch.Tensor, *, train: bool, dropout_key=None,
            dropout_rate: float = 0.3, precision: str = "f32"):
    """Logits (B, classes) and the new BN state of one genome's model on
    ``x`` (B, H, W, 1)."""
    qc, qd = rounding(precision)
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
    if template == "A":
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
        if template == "A":
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


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-row softmax cross-entropy with integer labels."""
    return torch.logsumexp(logits, dim=-1) - (logits * one_hot(
        y, logits.shape[-1])).sum(dim=-1)


def one_hot(y: torch.Tensor, num_classes: int) -> torch.Tensor:
    return (y.long()[:, None] == torch.arange(num_classes,
                                              device=y.device)).float()


def weighted_loss(logits, y, w) -> torch.Tensor:
    return (cross_entropy(logits, y) * w).sum() / torch.clamp(w.sum(), min=1.0)


def adam_update(params: Dict, grads: Dict, opt: Dict, lr: float,
                eps: float) -> Tuple[Dict, Dict]:
    """One optax-style Adam step (bias correction on the moments)."""
    count = opt["count"] + 1
    bc1 = 1.0 - ADAM_B1 ** count
    bc2 = 1.0 - ADAM_B2 ** count

    def walk(p, g, m, v):
        if isinstance(p, dict):
            out = {k: walk(p[k], g[k], m[k], v[k]) for k in p}
            return ({k: o[0] for k, o in out.items()},
                    {k: o[1] for k, o in out.items()},
                    {k: o[2] for k, o in out.items()})
        m2 = ADAM_B1 * m + (1.0 - ADAM_B1) * g
        v2 = ADAM_B2 * v + (1.0 - ADAM_B2) * g * g
        step = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
        return p - lr * step, m2, v2

    new_p, mu, nu = walk(params, grads, opt["mu"], opt["nu"])
    return new_p, {"mu": mu, "nu": nu, "count": count}


def zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: zeros_like_tree(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def grad_tree(loss, params: Dict) -> Dict:
    named = leaves(params)
    gs = torch.autograd.grad(loss, [t for _, t in named], allow_unused=True)
    out: Dict = {}
    for (path, t), g in zip(named, gs):
        node = out
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = torch.zeros_like(t) if g is None else g
    return out


def train_steps(params: Dict, state: Dict, genome: Dict, template: str,
                batches, *, lr: float, eps: float, dropout_rate: float,
                precision: str = "f32", half_batch: bool = False):
    """Adam steps from (params, state) over ``batches`` of (x, y, w,
    dropout key). Returns one record a step: the step's logits and loss,
    the gradient, and the parameters, Adam state and BN state after it.
    ``half_batch`` plants a fault: the loss over the first half of each
    batch's rows, the mean taken over those."""
    opt = {"mu": zeros_like_tree(params), "nu": zeros_like_tree(params),
           "count": 0}
    records = []
    # cuDNN's float32 weight-gradient algorithms leave round-off of about
    # 1e-7 in taps that see only padding (a 5x5 kernel on a map 2 wide),
    # whose gradient is exactly 0, and Adam turns it into whole steps;
    # PyTorch's own convolution sums the taps' products, exactly 0 there
    with torch.backends.cudnn.flags(enabled=False):
        for batch in batches:
            params, opt, state, rec = _step(params, opt, state, genome,
                                            template, batch, lr, eps,
                                            dropout_rate, precision,
                                            half_batch)
            records.append(rec)
    return records


def _step(params, opt, state, genome, template, batch, lr, eps,
          dropout_rate, precision, half_batch):
    """One step of ``train_steps``: (params, opt, state, record)."""
    x, y, w, key = batch
    p = _require_grad(params)
    logits, new_state = forward(p, state, genome, template, x, train=True,
                                dropout_key=key, dropout_rate=dropout_rate,
                                precision=precision)
    if half_batch:
        n = x.shape[0] // 2
        loss = weighted_loss(logits[:n], y[:n], w[:n])
    else:
        loss = weighted_loss(logits, y, w)
    grads = grad_tree(loss, p)
    with torch.no_grad():
        params, opt = adam_update(_detach(p), grads, opt, lr, eps)
    state = {k: {kk: vv.detach() for kk, vv in v.items()}
             for k, v in new_state.items()}
    return params, opt, state, {
        "logits": logits.detach(), "loss": float(loss.detach()),
        "grads": grads, "params": params, "opt": opt, "state": state}


def _require_grad(tree):
    if isinstance(tree, dict):
        return {k: _require_grad(v) for k, v in tree.items()}
    return tree.detach().requires_grad_(True)


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach()


def fpr_from_confusion(cm: torch.Tensor) -> torch.Tensor:
    """Macro false-positive rate of a (true x predicted) confusion matrix
    (nsga_penalty.py:351-364)."""
    total = cm.sum()
    col = cm.sum(dim=0)
    row = cm.sum(dim=1)
    diag = torch.diagonal(cm)
    fp = col - diag
    tn = total - (row + col - diag)
    denom = fp + tn
    fpr = torch.where(denom > 0, fp / torch.clamp(denom, min=1.0),
                      torch.zeros_like(fp))
    return fpr.mean()


@torch.no_grad()
def validate(params: Dict, state: Dict, genome: Dict, template: str,
             x: torch.Tensor, y: torch.Tensor, num_classes: int, *,
             rows: int = 256, precision: str = "f32"):
    """Eval-mode loss, accuracy and macro FPR over (x, y), ``rows`` at a
    time."""
    loss = torch.zeros((), dtype=torch.float64, device=x.device)
    correct = 0
    cm = torch.zeros(num_classes, num_classes, dtype=torch.float64,
                     device=x.device)
    for start in range(0, x.shape[0], rows):
        xb, yb = x[start:start + rows], y[start:start + rows]
        logits, _ = forward(params, state, genome, template, xb,
                            train=False, precision=precision)
        loss += cross_entropy(logits, yb).double().sum()
        pred = logits.argmax(dim=-1)
        correct += int((pred == yb).sum())
        cm += (one_hot(yb, num_classes).T
               @ one_hot(pred, num_classes)).double()
    n = x.shape[0]
    return float(loss) / n, correct / n, float(fpr_from_confusion(cm))
