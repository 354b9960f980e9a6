"""The PyTorch port's ``parallel_impl="vmap"`` setting against the
grouped network (``grouped.apply_population``), which it runs too (a
forward mapped with ``torch.func.vmap`` summed in other orders and drifted
over whole runs), the single-model forward ``supernet.apply_model``
against a grouped population of one, and the port's trainer over whole
epochs against the JAX package's. f32 on the CPU.

The workload is tests/test_grouped.py's
``test_grouped_trainer_matches_vmap_trainer``: ``BucketSpec("A", 16, 3)``,
5 classes, its first two genomes (one with BN, one without), 96 rows of
16 x 8 with the class signal added, the first 64 as validation, 3 epochs,
batch 32, patience 2, eval batch 32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmoop_audio_processing_torch.core.rng import fold_in
from cmoop_audio_processing_torch.engine import trainer as tt
from cmoop_audio_processing_torch.models import supernet as ts
from cmoop_audio_processing_tpu.engine import trainer as jt
from cmoop_audio_processing_tpu.models import supernet as js

# the test workers share the CPU's cores: one intra-op thread per worker
# keeps PyTorch's thread pool from oversubscribing them
torch.set_num_threads(1)

GENOMES = [
    dict(filters=16, kernel_size=3, use_bn=True, residual_blocks=3,
         fc_layers=4, use_dropout=False),
    dict(filters=16, kernel_size=3, use_bn=False, residual_blocks=1,
         fc_layers=1, use_dropout=False),
]
SETTINGS = dict(epochs=3, batch_size=32, patience=2, eval_batch_size=32)


def _spec(mod):
    return mod.BucketSpec("A", 16, 3, num_classes=5, compute_dtype="float32")


def _rows():
    """tests/test_grouped.py's rows, padded: (train, val) numpy triples."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((96, 16, 8, 1)).astype(np.float32)
    y = rng.integers(0, 5, 96).astype(np.int32)
    for c in range(5):
        x[y == c, c % 16, :, 0] += 2.0
    return (tt.pad_dataset(x, y, 32),
            tt.pad_dataset(x[:64].copy(), y[:64].copy(), 32))


def _torch_rows(rows):
    return tuple(
        (torch.as_tensor(x), torch.as_tensor(y, dtype=torch.int64),
         torch.as_tensor(w)) for x, y, w in rows)


@pytest.mark.parametrize("init_seed, train_seed",
                         [(3, 4), (0, 1), (1, 2), (5, 6), (7, 8), (11, 12)])
def test_vmap_trainer_matches_grouped_trainer(init_seed, train_seed):
    """Whole training runs through both forwards agree within the JAX
    test's bounds: acc_eval, fpr and val_loss within rtol/atol 2e-3 and
    equal ``epochs_ran``, at each of six seed pairs."""
    train, val = _torch_rows(_rows())
    out = {}
    for impl in ("vmap", "grouped"):
        params, state, flags = ts.init_population(init_seed, _spec(ts),
                                                  GENOMES)
        trainer = tt.PopulationTrainer(
            _spec(ts), tt.TrainSettings(parallel_impl=impl, **SETTINGS), 5)
        out[impl] = trainer.train(params, state, flags, train, val,
                                  train_seed)
    for key in ("acc_eval", "fpr", "val_loss"):
        np.testing.assert_allclose(out["grouped"][key].numpy(),
                                   out["vmap"][key].numpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=key)
    np.testing.assert_array_equal(out["grouped"]["epochs_ran"].numpy(),
                                  out["vmap"]["epochs_ran"].numpy())


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_vmap_forward_equals_grouped_bit_for_bit(train):
    """From the same params and 32 rows, both settings give the same
    logits and BN state bit for bit, and in train mode the same gradients
    of every leaf, the conv biases that BN cancels included (their
    gradients are rounding noise, which Adam scales up to whole steps)."""
    (x, y, w), _ = _torch_rows(_rows())
    x, y, w = x[:32], y[:32], w[:32]
    params, state, flags = ts.init_population(3, _spec(ts), GENOMES)
    out = {}
    for impl in ("grouped", "vmap"):
        trainer = tt.PopulationTrainer(
            _spec(ts), tt.TrainSettings(parallel_impl=impl, **SETTINGS), 5)
        leaves = ts.tree_map(lambda t: t.detach().requires_grad_(True),
                             params)
        logits, new_state = trainer.forward(leaves, state, flags, x,
                                            train=train)
        got = [logits.detach()] + ts.tree_leaves(new_state)
        if train:
            loss, _ = trainer.pop_loss(leaves, state, flags, x, y, w, 0)
            got += torch.autograd.grad(loss, ts.tree_leaves(leaves))
        out[impl] = got
    assert len(out["vmap"]) == len(out["grouped"])
    for a, b in zip(out["vmap"], out["grouped"]):
        assert torch.equal(a, b)


def test_single_model_layers_differentiate_outside_vmap():
    """``apply_model``, the single-model forward that training one genome
    and the exported model run: one genome's logits, BN state and
    gradients equal those of a grouped population of one, bit for bit."""
    from cmoop_audio_processing_torch.models.grouped import apply_population

    (x, _, _), _ = _torch_rows(_rows())
    params, state, flags = ts.init_population(3, _spec(ts), GENOMES[:1])
    one = ts.tree_map(lambda t: t[0].detach().requires_grad_(True), params)
    lg, st = ts.apply_model(_spec(ts), one, ts.tree_map(lambda t: t[0], state),
                            ts.tree_map(lambda t: t[0], flags), x[:32],
                            train=True)
    got = torch.autograd.grad(lg.square().sum(), ts.tree_leaves(one))
    pop = ts.tree_map(lambda t: t.detach().requires_grad_(True), params)
    lg1, st1 = apply_population(_spec(ts), pop, state, flags, x[:32],
                                train=True)
    want = torch.autograd.grad(lg1.square().sum(), ts.tree_leaves(pop))
    assert torch.equal(lg, lg1[0])
    for a, b in zip(ts.tree_leaves(st), ts.tree_leaves(st1)):
        assert torch.equal(a, b[0])
    for a, b in zip(got, want):
        assert torch.equal(a, b[0])


class _JaxShuffle(tt.PopulationTrainer):
    """The port's trainer fed the JAX trainer's per-epoch permutations
    (``jax.random.permutation(fold_in(key, epoch), n)``)."""

    def __init__(self, *args, perms):
        super().__init__(*args)
        self.perms = perms

    def permutation(self, epoch_key, n_train):
        return self.perms[epoch_key]


def test_whole_epochs_match_jax():
    """From the JAX package's initial weights and its shuffle stream, the
    port's trainer runs the same epochs as the JAX trainer and ends at its
    accuracy and macro FPR: ``epochs_ran`` equal, acc_eval, fpr and
    val_loss within rtol/atol 2e-3 (the two frameworks round differently,
    and Adam scales noise-sized gradients up, so bits are not expected)."""
    (xtr, ytr, wtr), (xval, yval, wval) = _rows()
    jparams, jstate, jflags = js.init_population(jax.random.key(3), _spec(js),
                                                 GENOMES)
    settings = jt.TrainSettings(**SETTINGS)
    want = jax.jit(jt.make_population_trainer(_spec(js), settings, 5).train)(
        jparams, jstate, jflags, *(jnp.asarray(a) for a in
                                   (xtr, ytr, wtr, xval, yval, wval)),
        jax.random.key(4))

    train_key = 4
    perms = {
        fold_in(train_key, e): torch.as_tensor(np.array(
            jax.random.permutation(jax.random.fold_in(jax.random.key(4), e),
                                   xtr.shape[0])), dtype=torch.int64)
        for e in range(SETTINGS["epochs"])
    }
    params, state = ts.params_from_jax(jax.tree.map(np.asarray, jparams),
                                       jax.tree.map(np.asarray, jstate))
    flags = ts.stack_flags(GENOMES)
    trainer = _JaxShuffle(_spec(ts), tt.TrainSettings(**SETTINGS), 5,
                          perms=perms)
    train, val = _torch_rows(((xtr, ytr, wtr), (xval, yval, wval)))
    got = trainer.train(params, state, flags, train, val, train_key)

    np.testing.assert_array_equal(got["epochs_ran"].numpy(),
                                  np.asarray(want["epochs_ran"]))
    for key in ("acc_eval", "fpr", "val_loss"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=2e-3, atol=2e-3, err_msg=key)
