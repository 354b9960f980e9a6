"""The architecture-free half of the plain reference: weighted
cross-entropy, Adam as optax writes it, the step loop, validation with its
macro FPR, and the control's operand rounding.

The step loop and validation take the forward pass of the configuration's
own architecture module (``benchmark/reference/<module>.py``, named by the
configuration's ``"reference"`` key), whose signature is

    forward(params, state, genome, template, x, *, train, dropout_key=None,
            dropout_rate=0.3, precision="f32") -> (logits, new BN state)

It runs in float32 with TF32 off (``precision="f32"``). ``precision=
"control"`` is the check's lower-precision control: conv operands rounded
to float8 e4m3 with a per-tensor scale (the step below the bfloat16 the
configurations state for convs), dense operands rounded to TF32 (the step
below their float32), through a straight-through rounding so that the
backward pass sees the rounded operands too.

Imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

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


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
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


def train_steps(forward: Callable, params: Dict, state: Dict, genome: Dict,
                template: str, batches, *, lr: float, eps: float,
                dropout_rate: float, precision: str = "f32",
                half_batch: bool = False):
    """Adam steps of the model ``forward`` computes, from (params, state)
    over ``batches`` of (x, y, w, dropout key). Returns one record a step:
    the step's logits and loss, the gradient, and the parameters, Adam
    state and BN state after it. ``half_batch`` plants a fault: the loss
    over the first half of each batch's rows, the mean taken over those."""
    opt = {"mu": zeros_like_tree(params), "nu": zeros_like_tree(params),
           "count": 0}
    records = []
    # cuDNN's float32 weight-gradient algorithms leave round-off of about
    # 1e-7 in taps that see only padding (a 5x5 kernel on a map 2 wide),
    # whose gradient is exactly 0, and Adam turns it into whole steps;
    # PyTorch's own convolution sums the taps' products, exactly 0 there
    with torch.backends.cudnn.flags(enabled=False):
        for batch in batches:
            params, opt, state, rec = _step(forward, params, opt, state,
                                            genome, template, batch, lr, eps,
                                            dropout_rate, precision,
                                            half_batch)
            records.append(rec)
    return records


def _step(forward, params, opt, state, genome, template, batch, lr, eps,
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
def validate(forward: Callable, params: Dict, state: Dict, genome: Dict,
             template: str, x: torch.Tensor, y: torch.Tensor,
             num_classes: int, *, rows: int = 256, precision: str = "f32"):
    """Eval-mode loss, accuracy and macro FPR of the model ``forward``
    computes over (x, y), ``rows`` at a time."""
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
