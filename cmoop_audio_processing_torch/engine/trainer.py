"""Population trainer: trains, early-stops and scores a whole (padded)
population of candidate CNNs in lockstep on one device.

Reference behavior reproduced per individual (sa_nsga_penalty.py:205-229;
nsga_penalty.py:368-395):

    compile(adam, sparse_categorical_crossentropy)
    fit(X_train, y_train, validation_data=(X_val, y_val),
        epochs=300, batch_size=64,
        callbacks=[EarlyStopping(monitor='val_loss', patience=5,
                                 restore_best_weights=?)])
    -> validation accuracy, macro FPR from argmax predictions

Shape of the loop (cmoop_audio_processing_tpu/engine/trainer.py):

* each epoch walks the shuffled train set in mini-batches; one forward of
  the grouped population network (models/grouped.py) and one backward
  serve every lane, since the summed per-lane losses have disjoint
  parameters;
* Adam runs per lane with a per-lane step count. Early stopping is
  per-lane masking: a stopped lane keeps its parameters, BN state and Adam
  moments frozen (a stock ``torch.optim.Adam`` would still advance them);
* ``restore_best_weights`` keeps a best-params snapshot per lane (selected
  on val-loss improvement);
* validation, argmax predictions, confusion matrices and macro FPR run on
  the device; the host reads one small fitness record per population.

Keras-faithful details: Adam(lr=1e-3, eps=1e-7, optax's bias correction),
per-epoch reshuffling, strict-improvement early stopping with patience
counted in consecutive non-improving epochs, BN momentum 0.99 / eps 1e-3,
inverted dropout. As in the JAX package, all lanes share one shuffle per
epoch and padded batches use weighted-mean losses (padding rows weigh 0).

Randomness: the epoch permutation comes from a CPU ``torch.Generator``
seeded from (train key, epoch); the dropout step key is the epoch key
folded with the batch's first sample index; every key is a 32-bit value of
core/rng.py's counter hash, so CPU and CUDA runs draw the same streams.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..core.rng import fold_in, seed_key
from ..models.grouped import apply_population_shards
from ..models.supernet import (
    BucketSpec,
    init_population,
    tree_leaves,
    tree_map,
)
from ..parallel.mesh import SplitData, as_parts

ADAM_B1 = 0.9
ADAM_B2 = 0.999
MAX_ACTIVATION_ELEMENTS = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    epochs: int = 300
    batch_size: int = 64
    patience: int = 5
    learning_rate: float = 1e-3
    adam_eps: float = 1e-7  # keras Adam default epsilon
    restore_best_weights: bool = True
    eval_batch_size: int = 256
    # The JAX package's choice of population forward ("grouped" | "vmap").
    # Both names run the grouped network (models/grouped.py) here:
    # torch.func.vmap's own batching of conv and BN sums in other orders,
    # and Adam turns that rounding into whole steps on the biases that BN
    # cancels, so a mapped forward drifted from the grouped one over whole
    # runs. The name stays for the configs, the CLI and the fitness-cache
    # fingerprint.
    parallel_impl: str = "grouped"
    # Epochs per ``run_chunk`` call before the evaluator may compact
    # early-stopped lanes into a smaller population; 0 = one-shot.
    compaction_chunk: int = 0


def pad_dataset(x: np.ndarray, y: np.ndarray, batch_size: int):
    """Pad (x, y) to a multiple of batch_size; returns (x, y, w) with w=0 on
    padding rows."""
    n = x.shape[0]
    n_pad = (-n) % batch_size
    w = np.ones(n, np.float32)
    if n_pad:
        x = np.concatenate([x, np.zeros((n_pad,) + x.shape[1:], x.dtype)])
        y = np.concatenate([y, np.zeros((n_pad,), y.dtype)])
        w = np.concatenate([w, np.zeros(n_pad, np.float32)])
    return x, y, w


def _fpr_from_confusion(cm: torch.Tensor) -> torch.Tensor:
    """Macro FPR of confusion matrices (..., C, C) (true x predicted)."""
    total = cm.sum(dim=(-2, -1))
    col = cm.sum(dim=-2)
    row = cm.sum(dim=-1)
    diag = torch.diagonal(cm, dim1=-2, dim2=-1)
    fp = col - diag
    tn = total[..., None] - (row + col - diag)
    denom = fp + tn
    fpr_i = torch.where(denom > 0, fp / torch.clamp(denom, min=1.0),
                        torch.zeros_like(fp))
    return fpr_i.mean(dim=-1)


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """f32 one-hot by comparison (no scatter, so deterministic on CUDA)."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None] == classes).float()


def macro_fpr(y_true: torch.Tensor, y_pred: torch.Tensor, w: torch.Tensor,
              num_classes: int) -> torch.Tensor:
    """Macro-averaged FPR from a weighted confusion matrix
    (reference: nsga_penalty.py:351-364), built as one-hot^T @ one-hot."""
    t = one_hot(y_true, num_classes) * w[:, None]
    return _fpr_from_confusion(t.T @ one_hot(y_pred, num_classes))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy with integer labels, (P, B, C) -> (P, B).
    Written with a one-hot product: ``F.cross_entropy``'s CUDA kernel has
    no deterministic mode."""
    picked = (logits * one_hot(labels, logits.shape[-1])).sum(dim=-1)
    return torch.logsumexp(logits, dim=-1) - picked


def _lane_where(mask: torch.Tensor, a: Dict, b: Dict) -> Dict:
    """Per-lane selection over stacked trees; mask shape (P,)."""
    def sel(x, y):
        return torch.where(mask.view((-1,) + (1,) * (x.dim() - 1)), x, y)

    return tree_map(sel, a, b)


def gather_lanes(carry: Dict, lane_idx) -> Dict:
    """Compact a training carry to the given lanes: every tensor leaf
    (params, BN state, Adam moments and step counts, flags, the best-params
    snapshot, best loss, wait, stopped, the last-epoch metrics) carries a
    leading pop axis; the epoch counter is a Python int and stays."""
    def take(x):
        if not isinstance(x, torch.Tensor):
            return x
        return x.index_select(0, torch.as_tensor(lane_idx, device=x.device))

    return tree_map(take, carry)


class PopulationTrainer:
    """Population training for one bucket spec.

    ``run_full`` is the evaluator's one-shot path: genome-keyed population
    init, the epoch loop to the cap (or until every lane stopped) and the
    final metrics. ``init_carry``/``run_chunk``/``finalize`` are the
    pieces, which the evaluator also drives chunk by chunk to compact
    early-stopped lanes away (``gather_lanes``); nothing here depends on
    the lane count. ``train`` is the params-in convenience the
    trainer-level tests use."""

    def __init__(self, spec: BucketSpec, settings: TrainSettings,
                 num_classes: int):
        self.spec = spec
        self.settings = settings
        self.num_classes = num_classes

    # -- pieces ---------------------------------------------------------------

    def forward(self, params, state, flags, x, *, train: bool,
                dropout_key=None):
        """(P, B, C) logits and the new BN state of the whole population
        (``grouped.apply_population_shards``). ``x`` is a batch tensor, or
        a list of its row parts on a pop shard's data devices
        (``SplitData.take``), with the BN statistics over the whole batch;
        the logits come back in the same form."""
        parts = as_parts(x)
        logits, new_state = apply_population_shards(
            self.spec, params, state, flags, parts, train=train,
            dropout_key=dropout_key)
        return (logits if parts is x else logits[0]), new_state

    def pop_loss(self, params, state, flags, xb, yb, wb, dkey):
        """Summed per-model weighted CE (the gradient of the sum is each
        model's own gradient) and the new BN state. The batch is tensors
        or lists of row parts (``forward``): each part's weighted CE sums,
        added on the parameters' device, over the whole batch's weight
        sum."""
        xs, ys, ws = (as_parts(t) for t in (xb, yb, wb))
        logits, new_state = self.forward(params, state, flags, xs, train=True,
                                         dropout_key=dkey)
        dev = flags["n_blocks"].device
        wsum = torch.clamp(sum(w.sum().to(dev) for w in ws), min=1.0)
        ce = sum((cross_entropy(lg, y.expand(lg.shape[:-1])) * w)
                 .sum(dim=1).to(dev) for lg, y, w in zip(logits, ys, ws))
        return (ce / wsum).sum(), new_state

    def adam_step(self, params, grads, opt, active):
        """One optax-style Adam update per lane; lanes not ``active`` keep
        params and moments. Returns (new params, new opt state)."""
        s = self.settings
        count = opt["count"] + active.to(opt["count"].dtype)
        # optax bias correction: moment / (1 - decay**count), in f32
        cnt = torch.clamp(count, min=1).float()
        bc1 = 1.0 - torch.pow(ADAM_B1, cnt)
        bc2 = 1.0 - torch.pow(ADAM_B2, cnt)

        def lanes(v, x):
            return v.view((-1,) + (1,) * (x.dim() - 1))

        def upd(p, g, m, v):
            m2 = ADAM_B1 * m + (1.0 - ADAM_B1) * g
            v2 = ADAM_B2 * v + (1.0 - ADAM_B2) * g * g
            step = (m2 / lanes(bc1, m2)) / (
                torch.sqrt(v2 / lanes(bc2, v2)) + s.adam_eps
            )
            keep = lanes(active, p)
            return (torch.where(keep, p - s.learning_rate * step, p),
                    torch.where(keep, m2, m), torch.where(keep, v2, v))

        new = tree_map(upd, params, grads, opt["mu"], opt["nu"])  # 3-tuples

        def pick(i):
            return tree_map(lambda t: t[i], new)

        return pick(0), {"mu": pick(1), "nu": pick(2), "count": count}

    def init_carry(self, params, state, flags):
        p = flags["n_blocks"].shape[0]
        dev = flags["n_blocks"].device
        return {
            "params": params,
            "state": state,
            "opt": {
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params),
                "count": torch.zeros(p, dtype=torch.int32, device=dev),
            },
            "flags": flags,
            "best_params": params,
            "best_state": state,
            "best_val_loss": torch.full((p,), float("inf"), device=dev),
            "wait": torch.zeros(p, dtype=torch.int32, device=dev),
            "stopped": torch.zeros(p, dtype=torch.bool, device=dev),
            "last_val_acc": torch.zeros(p, device=dev),
            "last_val_loss": torch.full((p,), float("inf"), device=dev),
            "epochs_ran": torch.zeros(p, dtype=torch.int32, device=dev),
            "epoch": 0,
        }

    def _eval_rows(self, pop: int, val: SplitData) -> int:
        """Rows per eval batch: ``eval_batch_size``, or fewer where the
        batch's largest activation, the stem's (pop * filters * H * W a
        row), would pass cuDNN's 32-bit indexing (256 BirdCLEF maps
        through 8 lanes of 64 filters); a multiple of the data parts."""
        h, w = val.copies[0][0].shape[1:3]
        fit = MAX_ACTIVATION_ELEMENTS // (pop * self.spec.filters * h * w)
        n = len(val.copies)
        return max(min(self.settings.eval_batch_size, fit) // n * n, n)

    @torch.no_grad()
    def evaluate(self, params, state, flags, val):
        """Eval-mode pass over the (padded) val set in eval batches;
        returns per-lane (loss, acc, fpr). ``val`` is an (x, y, w) triple
        or a ``SplitData`` (the sums taken on the parameters' device)."""
        val = SplitData.of(val)
        p = flags["n_blocks"].shape[0]
        eb = self._eval_rows(p, val)
        dev = flags["n_blocks"].device
        loss_sum = torch.zeros(p, device=dev)
        correct_sum = torch.zeros(p, device=dev)
        w_sum = torch.zeros((), device=dev)
        cms = torch.zeros(p, self.num_classes, self.num_classes, device=dev)
        for start in range(0, val.rows, eb):
            xs, ys, ws = val.take(slice(start, start + eb))
            logits, _ = self.forward(params, state, flags, xs, train=False)
            for lg, y, w in zip(logits, ys, ws):
                ce = cross_entropy(lg, y.expand(lg.shape[:-1]))
                preds = torch.argmax(lg, dim=-1)
                loss_sum += (ce * w).sum(dim=1).to(dev)
                correct_sum += ((preds == y).float() * w).sum(dim=1).to(dev)
                w_sum += w.sum().to(dev)
                t = one_hot(y, self.num_classes) * w[:, None]
                cms += torch.einsum("bc,pbk->pck", t,
                                    one_hot(preds, self.num_classes)).to(dev)
        return loss_sum / w_sum, correct_sum / w_sum, _fpr_from_confusion(cms)

    def permutation(self, epoch_key: int, n_train: int) -> torch.Tensor:
        """The epoch's shuffle of the (padded) train rows, from a CPU
        ``torch.Generator`` seeded with the epoch key. A test may override
        it to feed the JAX package's ``jax.random.permutation`` stream."""
        gen = torch.Generator()
        gen.manual_seed(epoch_key)
        return torch.randperm(n_train, generator=gen)

    def train_epoch(self, carry, train, epoch_key):
        b = self.settings.batch_size
        train = SplitData.of(train)
        n_train = train.rows
        perm = self.permutation(epoch_key, n_train).to(train.device)
        params, state, opt = carry["params"], carry["state"], carry["opt"]
        active = ~carry["stopped"]
        for start in range(0, n_train, b):
            idx = perm[start:start + b]
            params, state, opt = self.batch_step(
                params, state, opt, carry["flags"], *train.take(idx),
                fold_in(epoch_key, idx[0]), active,
            )
        return params, state, opt

    def batch_step(self, params, state, opt, flags, xb, yb, wb, dkey, active):
        """One gradient + per-lane Adam step; lanes not ``active`` keep
        params, BN state and optimizer state bit for bit."""
        leaves_in = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, new_state = self.pop_loss(leaves_in, state, flags, xb, yb, wb,
                                        dkey)
        grads = _unflatten(
            params, torch.autograd.grad(loss, tree_leaves(leaves_in))
        )
        with torch.no_grad():
            params, opt = self.adam_step(params, grads, opt, active)
            new_state = tree_map(torch.Tensor.detach, new_state)
            return params, _lane_where(active, new_state, state), opt

    def run_chunk(self, carry, train, val, train_key: int, epoch_end: int):
        """Advance training until every lane stopped or the epoch reaches
        ``epoch_end``. Keys are derived from the global epoch index."""
        s = self.settings
        while carry["epoch"] < epoch_end and not bool(carry["stopped"].all()):
            epoch = carry["epoch"]
            params, state, opt = self.train_epoch(
                carry, train, fold_in(train_key, epoch)
            )
            val_loss, val_acc, _ = self.evaluate(params, state,
                                                 carry["flags"], val)
            active = ~carry["stopped"]
            improved = val_loss < carry["best_val_loss"]
            take_best = active & improved
            wait = torch.where(
                active,
                torch.where(improved, torch.zeros_like(carry["wait"]),
                            carry["wait"] + 1),
                carry["wait"],
            )
            carry = dict(
                carry,
                params=params,
                state=state,
                opt=opt,
                best_params=_lane_where(take_best, params, carry["best_params"]),
                best_state=_lane_where(take_best, state, carry["best_state"]),
                best_val_loss=torch.where(take_best, val_loss,
                                          carry["best_val_loss"]),
                wait=wait,
                stopped=carry["stopped"] | (active & (wait >= s.patience)),
                # metrics at each model's final executed epoch (history[-1])
                last_val_acc=torch.where(active, val_acc, carry["last_val_acc"]),
                last_val_loss=torch.where(active, val_loss,
                                          carry["last_val_loss"]),
                epochs_ran=torch.where(
                    active, torch.full_like(carry["epochs_ran"], epoch + 1),
                    carry["epochs_ran"],
                ),
                epoch=epoch + 1,
            )
        return carry

    def finalize(self, carry, val):
        """Final metrics for every lane: restore-best selection,
        model.evaluate accuracy, macro FPR."""
        if self.settings.restore_best_weights:
            params, state = carry["best_params"], carry["best_state"]
        else:
            params, state = carry["params"], carry["state"]
        val_loss, val_acc, fpr = self.evaluate(params, state, carry["flags"], val)
        return {
            "acc_eval": val_acc,  # model.evaluate(X_val) accuracy
            "acc_last": carry["last_val_acc"],  # history['val_accuracy'][-1]
            "fpr": fpr,
            "val_loss": val_loss,
            "best_val_loss": carry["best_val_loss"],
            "epochs_ran": carry["epochs_ran"],
        }

    # -- whole runs -----------------------------------------------------------

    def train(self, params, state, flags, train, val, train_key: int):
        """Params-in one-shot run to the epoch cap, then metrics."""
        carry = self.init_carry(params, state, flags)
        carry = self.run_chunk(carry, train, val, train_key, self.settings.epochs)
        return self.finalize(carry, val)

    def run_full(self, genomes, train, val, seed: int, epoch_end: int):
        """Genome-keyed population init (models/supernet.init_population)
        + the epoch loop + final metrics for one (padded) population.
        Returns (final metrics, trained carry): the search reads the
        metrics, the export also keeps the carry's weights."""
        dev = SplitData.of(train).device
        params, state, flags = init_population(seed, self.spec, genomes, dev)
        carry = self.init_carry(params, state, flags)
        carry = self.run_chunk(carry, train, val, train_key_of(seed), epoch_end)
        return self.finalize(carry, val), carry


def train_key_of(seed: int) -> int:
    """The shuffle/dropout stream key of a run seed (shared by a bucket's
    lanes; it depends on the seed alone, keeping re-evaluations
    idempotent)."""
    return fold_in(seed_key(seed), 1)


def _unflatten(like: Dict, leaves) -> Dict:
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
