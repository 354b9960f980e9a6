"""The PyTorch port's launch planner against the JAX evaluator's: the
policy functions (``_effective_chunk``, ``_est_epoch_seconds``,
``_should_split_lanes``) and the whole launch plan of ``evaluate`` (with
``_run_bucket`` stubbed on both sides) equal the JAX evaluator's, heavy-lane
split and launch-duration bound included, with both packages' sustained
rate set to one value (the port's own, and rates low enough that the split
and the bound engage at these shapes); ``gather_lanes`` takes the JAX
carry's lanes; and on the port's own side, compacted training equals
one-shot bit for bit and the ``vmap`` setting gives the grouped forward's
results bit for bit. f32 on the CPU, at the shapes of
tests/test_compaction.py (192 x 16 x 8, 4 classes, 12 epochs, patience
2)."""

import jax
import numpy as np
import pytest
import torch

from cmoop_audio_processing_torch.core.config import TrainConfig
from cmoop_audio_processing_torch.core.genome import all_genomes, genome_key
from cmoop_audio_processing_torch.engine import evaluator as tev
from cmoop_audio_processing_torch.engine import trainer as tt
from cmoop_audio_processing_torch.models import supernet as ts
from cmoop_audio_processing_tpu.core.config import DataConfig
from cmoop_audio_processing_tpu.core.config import TrainConfig as JTrainConfig
from cmoop_audio_processing_tpu.data.pipeline import prepare_dataset
from cmoop_audio_processing_tpu.engine import evaluator as jev
from cmoop_audio_processing_tpu.engine import trainer as jt

# the test workers share the CPU's cores: one intra-op thread per worker
# keeps PyTorch's thread pool from oversubscribing them
torch.set_num_threads(1)

# mixed depth, BN and FC entry in one (16, 3) bucket of 4 lanes; at
# learning rate 1e-2 they early-stop at different epochs, so chunked
# training really compacts (4 -> 2 -> 1 lanes)
GENOMES = [
    dict(filters=16, kernel_size=3, use_bn=False, residual_blocks=1,
         fc_layers=1, use_dropout=False),
    dict(filters=16, kernel_size=3, use_bn=True, residual_blocks=2,
         fc_layers=2, use_dropout=False),
    dict(filters=16, kernel_size=3, use_bn=False, residual_blocks=2,
         fc_layers=4, use_dropout=False),
    dict(filters=16, kernel_size=3, use_bn=True, residual_blocks=1,
         fc_layers=3, use_dropout=False),
]


@pytest.fixture(scope="module")
def data():
    return prepare_dataset(
        DataConfig(synthetic_train=192, synthetic_eval=64, time_steps=16,
                   features=8, num_classes=4)
    )


# the port's own sustained rate, before any test sets another
OWN_RATE = tev.PopulationEvaluator._SUSTAINED_FLOPS_PER_S
# rates at which the 16 x 8 shapes' one-lane epochs take ~1.6-120 s
# (every bucket splits, the duration bound engages), ~0.016-1.2 s (the
# split depends on the bucket and the epoch budget) and ~1600 s or more
# (every chunk is one epoch)
LOW_RATES = (1e9, 1e11, 1e6)


def set_rate(monkeypatch, rate):
    """Both packages' sustained rate set to ``rate``."""
    for ev_cls in (jev.PopulationEvaluator, tev.PopulationEvaluator):
        monkeypatch.setattr(ev_cls, "_SUSTAINED_FLOPS_PER_S", rate)


def _pair(data, monkeypatch, rate=OWN_RATE, **kw):
    """(JAX evaluator, port evaluator) on one config, with both packages'
    sustained rate set to ``rate``."""
    set_rate(monkeypatch, rate)
    base = dict(num_classes=4, compute_dtype="float32", batch_size=32)
    base.update(kw)
    return (jev.PopulationEvaluator(data, JTrainConfig(**base)),
            tev.PopulationEvaluator(data, TrainConfig(**base), device="cpu"))


@pytest.mark.parametrize("patience", [2, 5])
@pytest.mark.parametrize("chunk", [-1, 0, 3])
def test_policy_functions_equal_jax(data, monkeypatch, patience, chunk):
    """``_effective_chunk``, ``_est_epoch_seconds`` (rtol 1e-12) and
    ``_should_split_lanes`` give the JAX evaluator's values for every lane
    count, epoch budget, bucket shape and depth, at launch budgets of 0,
    20 and 0.5 s, at the port's rate and at rates where the split and the
    duration bound engage."""
    for rate in (OWN_RATE,) + LOW_RATES:
        for budget in (0.0, 20.0, 0.5):
            for epochs in (12, 16, 39, 40, 300):
                jax_ev, ev = _pair(data, monkeypatch, rate, epochs=epochs,
                                   patience=patience, compaction_chunk=chunk,
                                   launch_seconds_budget=budget)
                _assert_policy_equal(jax_ev, ev, (rate, budget, epochs))


def _assert_policy_equal(jax_ev, ev, case):
    for f, k in ((16, 3), (64, 5)):
        for blocks in (1, 2, 3):
            jspec = jax_ev._bucket_spec(f, k, blocks)
            spec = ev._bucket_spec(f, k, blocks)
            sub = [dict(residual_blocks=b) for b in range(1, blocks + 1)]
            assert ev._should_split_lanes(f, k, sub) == \
                jax_ev._should_split_lanes(f, k, sub), (case, f, k, blocks)
            for pop in (1, 2, 4, 8, 16):
                np.testing.assert_allclose(
                    ev._est_epoch_seconds(pop, spec),
                    jax_ev._est_epoch_seconds(pop, jspec), rtol=1e-12)
                assert ev._effective_chunk(pop, spec) == \
                    jax_ev._effective_chunk(pop, jspec), (
                        case, f, k, blocks, pop)


def _stub(calls, with_lanes):
    """A ``_run_bucket`` that trains nothing: it records the launch and
    answers with per-lane results derived from the genome alone."""
    def run_bucket(self, spec, padded, seed):
        calls.append((spec.filters, spec.kernel, spec.max_blocks,
                      [genome_key(g) for g in padded]))
        keys = [genome_key(g) for g in padded]
        out = {
            "acc": np.array([0.5 + 0.01 * k[3] + 0.001 * k[4] for k in keys]),
            "fpr": np.array([0.1 - 0.01 * k[3] for k in keys]),
            "epochs": np.array([3 + 2 * k[4] + 5 * int(k[2]) for k in keys],
                               np.int32),
        }
        if with_lanes:
            out["lanes"] = [len(padded)]
        return out

    return run_bucket


PLAN_CASES = [
    # (TrainConfig fields, sustained rate, a launch is compacted, every
    # launch has one lane)
    (dict(compaction_chunk=-1, epochs=300, patience=5,
          max_models_per_program=4), OWN_RATE, False, False),
    (dict(compaction_chunk=-1, epochs=300, patience=5,
          bucket_genes=("filters", "kernel_size")), OWN_RATE, True, False),
    (dict(compaction_chunk=-1, epochs=25, max_models_per_program=2),
     OWN_RATE, False, False),
    (dict(compaction_chunk=3, epochs=12, patience=2, pack_by_stop_epoch=False,
          max_models_per_program=4), OWN_RATE, True, False),
    # every bucket splits; the 20-s bound chunks the one-lane launches
    (dict(compaction_chunk=-1, epochs=300, patience=5), 1e9, True, True),
    # the split depends on the bucket; no duration bound
    (dict(compaction_chunk=-1, epochs=25, launch_seconds_budget=0.0,
          bucket_genes=("filters", "kernel_size")), 1e11, False, False),
    # a small budget chunks the split launches
    (dict(compaction_chunk=-1, epochs=300, patience=5,
          launch_seconds_budget=0.5, max_models_per_program=4), 1e11, True,
     True),
    # every chunk one epoch
    (dict(compaction_chunk=-1, epochs=25), 1e6, True, True),
]


@pytest.mark.parametrize("kw, rate, compacted, one_lane", PLAN_CASES, ids=[
    "default", "two_gene_buckets", "short_budget", "fixed_chunk",
    "split_rate_1e9", "split_no_budget_1e11", "split_small_budget_1e11",
    "split_rate_1e6"])
@pytest.mark.parametrize("draw", [5, 6])
def test_launch_plan_equals_jax(data, monkeypatch, kw, rate, compacted,
                                one_lane, draw):
    """The same genomes give the same launches in the same order (one-shot
    first, compacted last; stop-epoch packing from the first call's epochs
    on the second call), the same chunk records and the same fitness
    list, at the port's rate and at rates where the heavy-lane split and
    the launch-duration bound engage."""
    rng = np.random.default_rng(draw)
    space = all_genomes()
    genomes = [space[i] for i in rng.choice(len(space), 40, replace=False)]
    genomes += genomes[:3]  # a population may repeat a genome
    jax_ev, ev = _pair(data, monkeypatch, rate, **kw)
    jcalls, tcalls = [], []
    monkeypatch.setattr(jev.PopulationEvaluator, "_run_bucket",
                        _stub(jcalls, False))
    monkeypatch.setattr(tev.PopulationEvaluator, "_run_bucket",
                        _stub(tcalls, True))
    for call in range(2):
        want = jax_ev.evaluate(genomes, seed=1)
        got = ev.evaluate(genomes, seed=1)
        assert got == want
        assert tcalls == jcalls and tcalls
        records = ev.timings[-1]["chunks"]
        assert [dict(r, lanes=None) for r in records] == [
            dict(r, lanes=None) for r in jax_ev.timings[-1]["chunks"]]
        flags = [r["compacted"] for r in records]
        assert flags == sorted(flags)  # compacted launches last
        # pop 8 buckets at 300 epochs, a fixed chunk and the duration
        # bound really compact
        assert any(flags) == compacted
        # at low rates heavy buckets split into one-lane launches
        assert ({r["pop"] for r in records} == {1}) == one_lane
        assert ev.timings[-1]["cache_hits"] == 0
        tcalls.clear()
        jcalls.clear()
    assert ev.total_true_evals == jax_ev.total_true_evals == 2 * len(genomes)


def test_gather_lanes_matches_jax():
    """Every per-lane leaf of the port's carry is gathered as the JAX
    package's ``gather_lanes`` gathers the same carry in the JAX layout
    (HWIO kernels, optax's Adam state); the epoch stays."""
    import optax

    spec = ts.BucketSpec("A", 16, 3, 4, compute_dtype="float32", max_blocks=2)
    genomes = [dict(g, residual_blocks=min(g["residual_blocks"], 2))
               for g in GENOMES]
    params, state, flags = ts.init_population(0, spec, genomes)
    carry = tt.PopulationTrainer(spec, tt.TrainSettings(), 4).init_carry(
        params, state, flags)
    # distinct values in every lane of every leaf but the genomes' flags
    rng = np.random.default_rng(0)

    def fill(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.dtype == torch.bool:
            return torch.as_tensor(rng.random(tuple(x.shape)) < 0.5)
        if not x.is_floating_point():
            return torch.as_tensor(rng.integers(0, 1000, tuple(x.shape))).to(
                x.dtype)
        return torch.as_tensor(rng.standard_normal(tuple(x.shape)),
                               dtype=x.dtype)

    carry = dict(ts.tree_map(fill, carry), flags=flags, epoch=7)
    per_lane = ("best_val_loss", "wait", "stopped", "last_val_acc",
                "last_val_loss", "epochs_ran")

    def to_jax(c):
        p, s = ts.params_to_jax(c["params"], c["state"])
        bp, bs = ts.params_to_jax(c["best_params"], c["best_state"])
        adam = optax.ScaleByAdamState(
            count=c["opt"]["count"].numpy(),
            mu=ts.params_to_jax(c["opt"]["mu"], {})[0],
            nu=ts.params_to_jax(c["opt"]["nu"], {})[0])
        return {"params": p, "state": s, "best_params": bp, "best_state": bs,
                "opt_state": (adam, optax.EmptyState()),
                "flags": {k: v.numpy() for k, v in c["flags"].items()},
                **{k: c[k].numpy() for k in per_lane},
                "epoch": np.int32(c["epoch"])}

    idx = np.array([2, 0, 0])
    got = tt.gather_lanes(carry, idx)
    assert got["epoch"] == 7
    assert got["flags"]["uid"].tolist() == [
        ts.genome_uid(genomes[i]) for i in idx]
    want = jax.tree.map(np.asarray, jt.gather_lanes(to_jax(carry), idx))
    jax.tree.map(np.testing.assert_array_equal, to_jax(got), want)


def _cfg(chunk, **kw):
    # 2-gene bucketing on purpose: the mixed-depth GENOMES share ONE
    # 4-lane bucket, so the chunked path has lanes to compact
    return TrainConfig(
        epochs=12, batch_size=32, patience=2, num_classes=4,
        compute_dtype="float32", compaction_chunk=chunk, learning_rate=1e-2,
        bucket_genes=("filters", "kernel_size"), **kw,
    )


@pytest.mark.parametrize("dropout, seed", [(False, 2), (True, 0)],
                         ids=["no_dropout", "dropout"])
def test_compacted_equals_oneshot_bit_for_bit(data, dropout, seed):
    """Shuffle streams are keyed by global epoch and dropout streams by
    genome uid, so chunk boundaries and lane positions leave the fitness
    unchanged, bit for bit on the CPU — with the lane count really falling."""
    genomes = [dict(g, use_dropout=dropout) for g in GENOMES]
    oneshot = tev.PopulationEvaluator(data, _cfg(0), device="cpu")
    want = oneshot.evaluate(genomes, seed=seed)
    ev = tev.PopulationEvaluator(data, _cfg(3), device="cpu")
    got = ev.evaluate(genomes, seed=seed)
    (rec,) = ev.timings[-1]["chunks"]
    assert rec["compacted"] and rec["lanes"][0] == 4
    assert min(rec["lanes"]) < 4, rec  # the population really compacted
    assert rec["epochs"] == oneshot.timings[-1]["chunks"][0]["epochs"]
    assert len(set(rec["epochs"])) > 1
    assert got == want


def _vmap_against_grouped(spec, params, state, flags, x, y, w, dkey):
    """One training step's logits, loss, gradients and new BN state and one
    validation pass's metrics, through the vmap forward and through the
    grouped one, from the same params and BN state."""
    out = {}
    for impl in ("grouped", "vmap"):
        trainer = tt.PopulationTrainer(
            spec, tt.TrainSettings(parallel_impl=impl), 4)
        leaves = ts.tree_map(lambda t: t.detach().requires_grad_(True), params)
        logits, new_state = trainer.forward(leaves, state, flags, x,
                                            train=True, dropout_key=dkey)
        loss, _ = trainer.pop_loss(leaves, state, flags, x, y, w, dkey)
        grads = torch.autograd.grad(loss, ts.tree_leaves(leaves))
        metrics = trainer.evaluate(params, state, flags, (x, y, w))
        out[impl] = ([logits.detach(), loss.detach(), *metrics, *grads]
                     + [t.detach() for t in ts.tree_leaves(new_state)])
    return out["vmap"], out["grouped"]


def _assert_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("template", ["A", "B"])
def test_vmap_forward_equals_grouped(template):
    """``parallel_impl="vmap"`` runs the grouped forward, so its logits, BN
    state, loss, gradients and validation metrics equal the grouped
    setting's in f32 bit for bit."""
    genomes = [dict(g, use_dropout=True) for g in GENOMES]
    spec = ts.BucketSpec(template, 16, 3, 4, compute_dtype="float32",
                         max_blocks=2)
    params, state, flags = ts.init_population(3, spec, genomes)
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((32, 16, 8, 1)).astype(np.float32))
    y = torch.as_tensor(rng.integers(0, 4, 32))
    w = torch.ones(32)
    w[-3:] = 0.0
    got, want = _vmap_against_grouped(spec, params, state, flags, x, y, w,
                                      torch.tensor(777))
    assert got[0].shape == (4, 32, 4)
    _assert_equal(got, want)


@pytest.mark.parametrize("template", ["A", "B"])
def test_vmap_step_equals_grouped_from_trained_states(data, template):
    """After each of three epochs of grouped training (dropout on, no lane
    stopping), a vmap step and a vmap validation pass from the trained
    params and BN state give the grouped ones' results bit for bit as
    above: the trained state, not only the initial one, goes through vmap
    as through the grouped forward. (Any rounding difference would not
    stay small over whole runs: Adam turns the rounding of near-zero
    gradients, such as a bias that BN cancels, into whole learning-rate
    steps.)"""
    genomes = [dict(g, use_dropout=True) for g in GENOMES]
    spec = ts.BucketSpec(template, 16, 3, 4, compute_dtype="float32",
                         max_blocks=2)
    ev = tev.PopulationEvaluator(data, _cfg(0), device="cpu")
    trainer = tt.PopulationTrainer(
        spec, tt.TrainSettings(epochs=3, batch_size=32, patience=10), 4)
    carry = trainer.init_carry(*ts.init_population(3, spec, genomes))
    x, y, w = (t[:32] for t in ev._train)
    for epoch in range(3):
        carry = trainer.run_chunk(carry, ev._train, ev._val,
                                  tt.train_key_of(3), epoch + 1)
        got, want = _vmap_against_grouped(spec, carry["params"],
                                          carry["state"], carry["flags"],
                                          x, y, w, torch.tensor(epoch))
        _assert_equal(got, want)
    assert not bool(carry["stopped"].any())
