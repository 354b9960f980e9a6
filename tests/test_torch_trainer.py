"""The PyTorch port's population trainer: one gradient + per-lane Adam step
against a JAX step built from ``grouped.apply_population`` and
``optax.adam(1e-3, eps=1e-7)``, frozen lanes, macro FPR, and the
``accuracy_from`` / ``restore_best_weights`` semantics pinned for the JAX
package in tests/test_trainer_semantics.py. f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cmoop_audio_processing_torch.engine import trainer as tt
from cmoop_audio_processing_torch.models import supernet as ts
from cmoop_audio_processing_tpu.engine import trainer as jt
from cmoop_audio_processing_tpu.models import grouped as jg
from cmoop_audio_processing_tpu.models import supernet as js

# the test workers share the CPU's cores: one intra-op thread per worker
# keeps PyTorch's thread pool from oversubscribing them
torch.set_num_threads(1)

GENOMES = [
    dict(filters=16, kernel_size=3, use_bn=bn, residual_blocks=nb,
         fc_layers=nfc, use_dropout=False)
    for bn, nb, nfc in ((True, 1, 1), (False, 2, 3), (True, 3, 4), (False, 1, 2))
]


def _batch(seed=0, b=8, h=45, w=13):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, 1)).astype(np.float32)
    y = rng.integers(0, 10, b).astype(np.int32)
    wts = np.ones(b, np.float32)
    wts[-2:] = 0.0  # padding rows
    return x, y, wts


def _jax_steps(template, params, state, flags, batch, active, n_steps):
    """JAX reference: n gradient + optax Adam steps on one batch. Returns
    the gradients of every step and the final params/state."""
    spec = js.BucketSpec(template, 16, 3, 10, compute_dtype="float32")
    opt = optax.adam(1e-3, eps=1e-7)
    x, y, w = (jnp.asarray(a) for a in batch)

    def loss_fn(p, st):
        logits, new_st = jg.apply_population(spec, p, st, flags, x, train=True,
                                             dropout_key=jax.random.key(0))
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.broadcast_to(y, logits.shape[:-1]))
        return ((ce * w).sum(axis=1) / jnp.maximum(w.sum(), 1.0)).sum(), new_st

    @jax.jit
    def step(p, st, o):
        (_, new_st), g = jax.value_and_grad(loss_fn, has_aux=True)(p, st)
        upd, new_o = jax.vmap(opt.update)(g, o, p)
        new_p = jax.vmap(optax.apply_updates)(p, upd)
        sel = lambda a, b: jax.tree.map(  # noqa: E731
            lambda u, v: jnp.where(active.reshape((-1,) + (1,) * (u.ndim - 1)), u, v),
            a, b)
        return sel(new_p, p), sel(new_st, st), sel(new_o, o), g

    o = jax.vmap(opt.init)(params)
    grads, states = [], []
    for _ in range(n_steps):
        params, state, o, g = step(params, state, o)
        grads.append(g)
        states.append(state)
    return grads, states, params


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict, independent of key order."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _flat(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


def _to_port(params, state=None):
    return ts.params_from_jax(jax.tree.map(np.asarray, params),
                              jax.tree.map(np.asarray, state or {}))


@pytest.mark.parametrize("template", ["A", "B"])
def test_batch_steps_match_jax_and_freeze_stopped_lanes(template):
    """Gradients and new BN state of a step equal JAX's (f32 reassociation
    tolerance); the per-lane Adam fed JAX's gradients lands on JAX's
    params after two steps; a lane that is not active stays bitwise
    unchanged. (State after whole steps is not compared elementwise: Adam's
    first steps move a weight by ~lr * g / (|g| + 1e-7), which turns a
    last-bit difference in a gradient near 1e-7 into a visible one.)"""
    jspec = js.BucketSpec(template, 16, 3, 10, compute_dtype="float32")
    params, state, flags = js.init_population(jax.random.key(1), jspec, GENOMES)
    batch = _batch()
    active = np.array([True, False, True, True])
    jgrads, jstates, jp = _jax_steps(template, params, state, flags, batch,
                                     jnp.asarray(active), n_steps=2)

    tspec = ts.BucketSpec(template, 16, 3, 10, compute_dtype="float32")
    tp0, tst0 = _to_port(params, state)
    trainer = tt.PopulationTrainer(tspec, tt.TrainSettings(), num_classes=10)
    carry = trainer.init_carry(tp0, tst0, ts.stack_flags(GENOMES))
    xb, yb, wb = (torch.as_tensor(a) for a in batch)
    yb = yb.long()

    # gradients of the first step
    leaves = ts.tree_map(lambda t: t.detach().requires_grad_(True), tp0)
    loss, new_state = trainer.pop_loss(leaves, tst0, carry["flags"], xb, yb,
                                       wb, 0)
    got_g = torch.autograd.grad(loss, ts.tree_leaves(leaves))
    want_g, want_s = _to_port(jgrads[0], jstates[0])
    for got, want in zip(got_g, ts.tree_leaves(want_g)):
        # f32 reassociation of sums over B*H*W terms with cancellation:
        # relative to the leaf's scale, with an absolute floor for the conv
        # biases under BN, whose exact gradient is 0 (both sides ~1e-8 noise)
        torch.testing.assert_close(
            got, want, rtol=1e-4, atol=2e-5 * float(want.abs().max()) + 1e-7)
    assert set(new_state) == set(want_s)
    on = torch.as_tensor(active)  # JAX's state is already lane-selected
    for name in want_s:
        for stat in ("mean", "var"):
            torch.testing.assert_close(new_state[name][stat].detach()[on],
                                       want_s[name][stat][on], rtol=1e-4,
                                       atol=1e-5)

    # the optimizer alone, on JAX's gradients
    tp, opt = tp0, carry["opt"]
    for g in jgrads:
        tp, opt = trainer.adam_step(tp, _to_port(g)[0], opt,
                                    torch.as_tensor(active))
    want_p, _ = _to_port(jp)
    for got, want in zip(ts.tree_leaves(tp), ts.tree_leaves(want_p)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)

    # whole steps: frozen lane, per-lane step count
    tp, tst, opt = carry["params"], carry["state"], carry["opt"]
    for _ in range(2):
        tp, tst, opt = trainer.batch_step(tp, tst, opt, carry["flags"], xb,
                                          yb, wb, 0, torch.as_tensor(active))
    for new_tree, old_tree in ((tp, tp0), (tst, tst0)):
        new_flat, old_flat = _flat(new_tree), _flat(old_tree)
        assert set(new_flat) == set(old_flat)
        for path in old_flat:
            assert torch.equal(new_flat[path][1], old_flat[path][1]), path
    assert all(torch.all(m[1] == 0) for m in ts.tree_leaves(opt["mu"]))
    assert opt["count"].tolist() == [2, 0, 2, 2]


def test_macro_fpr_matches_jax():
    rng = np.random.default_rng(4)
    y_true = rng.integers(0, 10, 200).astype(np.int32)
    y_pred = np.where(rng.random(200) < 0.7, y_true, rng.integers(0, 10, 200))
    w = (rng.random(200) < 0.9).astype(np.float32)
    want = float(jt.macro_fpr(jnp.asarray(y_true), jnp.asarray(y_pred),
                              jnp.asarray(w), 10))
    got = float(tt.macro_fpr(torch.as_tensor(y_true).long(),
                             torch.as_tensor(y_pred).long(),
                             torch.as_tensor(w), 10))
    assert abs(got - want) < 1e-6


def test_cross_entropy_matches_optax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 16, 10)).astype(np.float32) * 4
    labels = rng.integers(0, 10, 16)
    want = optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits), jnp.broadcast_to(jnp.asarray(labels), (3, 16)))
    got = tt.cross_entropy(torch.as_tensor(logits),
                           torch.as_tensor(labels).expand(3, 16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_pad_dataset_matches_jax():
    x = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    y = np.arange(10, dtype=np.int32)
    for a, b in zip(tt.pad_dataset(x, y, 4), jt.pad_dataset(x, y, 4)):
        np.testing.assert_array_equal(a, b)


def _run(restore_best, epochs=30, seed=0):
    spec = ts.BucketSpec("A", 16, 3, 10)
    genomes = [g for g in (dict(filters=16, kernel_size=3, use_bn=bn,
                                residual_blocks=nb, fc_layers=nfc,
                                use_dropout=do)
                           for bn, nb, nfc, do in ((True, 1, 1, False),
                                                   (False, 2, 3, True),
                                                   (True, 3, 4, True),
                                                   (False, 1, 2, False)))]
    params, state, flags = ts.init_population(0, spec, genomes)
    settings = tt.TrainSettings(epochs=epochs, batch_size=8, patience=2,
                                eval_batch_size=8,
                                restore_best_weights=restore_best)
    rng = np.random.default_rng(seed)

    def split(n, bs):
        x, y, w = tt.pad_dataset(
            rng.standard_normal((n, 12, 9, 1)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32), bs)
        return (torch.as_tensor(x), torch.as_tensor(y).long(),
                torch.as_tensor(w))

    train, val = split(32, 8), split(16, 8)
    trainer = tt.PopulationTrainer(spec, settings, num_classes=10)
    return trainer, (params, state, flags, train, val)


def test_acc_last_diverges_from_acc_eval_under_early_stopping():
    trainer, (p, s, f, train, val) = _run(restore_best=True)
    out = trainer.train(p, s, f, train, val, train_key=tt.train_key_of(0))
    assert bool((out["epochs_ran"] < 30).any()), "ES never fired"
    assert bool((out["acc_last"] != out["acc_eval"]).any()), out


def test_no_restore_best_evaluates_final_weights():
    trainer, (p, s, f, train, val) = _run(restore_best=False)
    out = trainer.train(p, s, f, train, val, train_key=tt.train_key_of(0))
    assert bool((out["epochs_ran"] < 30).any()), "ES never fired"
    assert torch.equal(out["acc_eval"], out["acc_last"])


def test_chunked_run_equals_one_shot_and_repeats():
    """Keys come from the global epoch index, so running to epoch 3 and
    then on to 6 is the one-shot run to 6, and a rerun repeats bitwise."""
    trainer, (p, s, f, train, val) = _run(restore_best=True, epochs=6)
    key = tt.train_key_of(3)
    one = trainer.finalize(
        trainer.run_chunk(trainer.init_carry(p, s, f), train, val, key, 6), val)
    carry = trainer.run_chunk(trainer.init_carry(p, s, f), train, val, key, 3)
    two = trainer.finalize(trainer.run_chunk(carry, train, val, key, 6), val)
    again = trainer.finalize(
        trainer.run_chunk(trainer.init_carry(p, s, f), train, val, key, 6), val)
    for k in one:
        assert torch.equal(one[k], two[k]), k
        assert torch.equal(one[k], again[k]), k
