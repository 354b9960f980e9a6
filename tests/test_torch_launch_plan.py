"""The PyTorch port's heavy-lane split and launch-duration bound
(engine/evaluator.py) on its own side, and ``--launch-budget``: the JAX
package's policy tests (tests/test_compaction.py) and budget cases
(tests/test_cli.py) on the port; real training on the CPU in f32, where
the split plan, the fused plan and each genome alone give the same fitness
bit for bit and a duration-chunked one-lane launch equals one-shot; and a
fitness cache of the fused plan's format (2) is refused on ``--resume``.
tests/test_torch_compaction.py holds the policy functions and whole plans
equal to the JAX evaluator's."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from cmoop_audio_processing_torch.cli import main as tcli
from cmoop_audio_processing_torch.core.config import DataConfig, TrainConfig
from cmoop_audio_processing_torch.core.genome import genome_key
from cmoop_audio_processing_torch.data.loaders import save_npy_dir
from cmoop_audio_processing_torch.data.pipeline import prepare_dataset
from cmoop_audio_processing_torch.data.synthetic import make_synthetic
from cmoop_audio_processing_torch.engine import evaluator as tev
from cmoop_audio_processing_torch.utils import fitness_cache as tfc
from cmoop_audio_processing_tpu.cli import main as jcli

# the test workers share the CPU's cores: one intra-op thread per worker
# keeps PyTorch's thread pool from oversubscribing them
torch.set_num_threads(1)

# one (16, 3) bucket of mixed depth, BN and FC entry (those of
# tests/test_torch_compaction.py); at learning rate 1e-2 they stop at
# different epochs
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
# a rate at which one lane's epoch of these genomes at 16 x 8 is estimated
# at ~1-3 s: the bucket splits
LOW_RATE = 1e9
EPOCHS = 8  # the real trainings' budget


@pytest.fixture(scope="module")
def data():
    return prepare_dataset(
        DataConfig(synthetic_train=192, synthetic_eval=64, time_steps=16,
                   features=8, num_classes=4)
    )


@pytest.fixture(scope="module")
def small():
    """Half the training rows, for the real trainings: the genomes still
    stop at different epochs."""
    return prepare_dataset(
        DataConfig(synthetic_train=96, synthetic_eval=32, time_steps=16,
                   features=8, num_classes=4)
    )


def _ev(data, **kw):
    cfg = dict(epochs=12, batch_size=32, patience=2, num_classes=4,
               compute_dtype="float32", learning_rate=1e-2,
               bucket_genes=("filters", "kernel_size"))
    cfg.update(kw)
    return tev.PopulationEvaluator(data, TrainConfig(**cfg), device="cpu")


@pytest.mark.parametrize("extra, want", [
    ([], 20.0), (["--launch-budget", "8"], 8.0),
    (["--launch-budget", "0"], 0.0),
], ids=["preset_default", "8", "0"])
def test_launch_budget_reaches_the_config(extra, want):
    """``--launch-budget`` sets ``launch_seconds_budget`` as the JAX CLI
    does; 0 disables the bound, and the preset's 20.0 stays otherwise."""
    argv = ["--preset", "sa_nsga_penalty", "--seed", "7"] + extra
    for cli in (tcli, jcli):
        cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
        assert cfg.train.launch_seconds_budget == want
        assert cfg.search.seed == 7 and cfg.train.template == "B"


def test_launch_duration_bound(data):
    """The adaptive policy chunks any launch whose estimated one-shot time
    exceeds ``launch_seconds_budget``, even below the 8-lane compaction
    gate, at the port's own rate (tests/test_compaction.py's case)."""
    big = prepare_dataset(
        DataConfig(synthetic_train=96, synthetic_eval=48, time_steps=501,
                   features=40, num_classes=11)
    )
    cfg = TrainConfig(num_classes=11, template="B")  # 300-epoch default
    ev = tev.PopulationEvaluator(big, cfg, device="cpu")
    heavy = ev._bucket_spec(64, 5, 1)
    chunk = ev._effective_chunk(2, heavy)
    assert 0 < chunk < cfg.epochs  # bounded launches for the heavy bucket
    # per-chunk estimated seconds stay within the budget
    assert ev._est_epoch_seconds(2, heavy) * chunk <= cfg.launch_seconds_budget
    # the bound scales: more lanes -> shorter chunks
    assert ev._effective_chunk(8, heavy) <= chunk
    # budget 0 disables the duration term entirely
    off = tev.PopulationEvaluator(
        big, dataclasses.replace(cfg, launch_seconds_budget=0.0), device="cpu")
    assert off._effective_chunk(2, heavy) == 0
    # KWS-sized launches at the bench budget never engage it
    kws = tev.PopulationEvaluator(
        data, TrainConfig(num_classes=4, epochs=25, compute_dtype="float32"),
        device="cpu")
    assert kws._effective_chunk(4, kws._bucket_spec(16, 3, 3)) == 0


def test_heavy_lane_split():
    """Under the adaptive policy, BirdCLEF-sized buckets split into
    per-genome one-lane launches at the port's own rate, an explicit
    one-shot plan is honored, KWS-sized lanes stay fused, and split lanes
    stay under the duration bound (tests/test_compaction.py's case, with
    a quarter of its rows)."""
    big = prepare_dataset(
        DataConfig(synthetic_train=500, synthetic_eval=125, time_steps=501,
                   features=40, num_classes=11)
    )
    cfg = TrainConfig(num_classes=11, template="B", epochs=25)
    ev = tev.PopulationEvaluator(big, cfg, device="cpu")
    two = [dict(GENOMES[1], filters=64, kernel_size=5, residual_blocks=b)
           for b in (1, 2)]
    assert ev._should_split_lanes(64, 5, two)
    forced = tev.PopulationEvaluator(
        big, dataclasses.replace(cfg, compaction_chunk=0), device="cpu")
    assert not forced._should_split_lanes(64, 5, two)
    kws = prepare_dataset(
        DataConfig(synthetic_train=2000, synthetic_eval=500, num_classes=10)
    )
    kws_ev = tev.PopulationEvaluator(
        kws, TrainConfig(num_classes=10, epochs=25), device="cpu")
    assert not kws_ev._should_split_lanes(16, 3, [
        dict(GENOMES[1], residual_blocks=b) for b in (1, 2)])
    long_cfg = tev.PopulationEvaluator(
        big, dataclasses.replace(cfg, epochs=300), device="cpu")
    assert long_cfg._effective_chunk(1, long_cfg._bucket_spec(64, 5, 2)) > 0


def test_split_equals_fused_and_each_genome_alone(small, monkeypatch):
    """At a rate that splits the bucket, the default policy trains each
    genome in a one-lane launch at its own depth, and the fitness and stop
    epochs equal the fused 4-lane launch's and each genome's trained
    alone, bit for bit on the CPU (dropout in two of the four)."""
    monkeypatch.setattr(tev.PopulationEvaluator, "_SUSTAINED_FLOPS_PER_S",
                        LOW_RATE)
    genomes = [dict(g, use_dropout=bool(i % 2)) for i, g in enumerate(GENOMES)]
    fused = _ev(small, epochs=EPOCHS, compaction_chunk=0)
    want = fused.evaluate(genomes, seed=2)
    assert [r["pop"] for r in fused.timings[-1]["chunks"]] == [4]
    split = _ev(small, epochs=EPOCHS, launch_seconds_budget=0.0)
    got = split.evaluate(genomes, seed=2)
    assert [(r["pop"], r["max_blocks"], r["compacted"])
            for r in split.timings[-1]["chunks"]] == [
        (1, g["residual_blocks"], False) for g in genomes]
    alone = _ev(small, epochs=EPOCHS, compaction_chunk=0)
    each = [alone.evaluate([g], seed=2)[0] for g in genomes]
    assert got == want == each
    epochs = [[ev._epoch_history[genome_key(g)] for g in genomes]
              for ev in (fused, split, alone)]
    assert epochs[0] == epochs[1] == epochs[2] and len(set(epochs[0])) > 1


def test_duration_chunked_one_lane_launch_equals_oneshot(small, monkeypatch):
    """Under a budget of 2.5 estimated epochs, the split's one-lane
    launches train in segments, and each genome's fitness equals its
    one-shot training bit for bit."""
    monkeypatch.setattr(tev.PopulationEvaluator, "_SUSTAINED_FLOPS_PER_S",
                        LOW_RATE)
    genomes = [dict(g, use_dropout=True) for g in GENOMES[1:3]]
    probe = _ev(small)
    budget = 2.5 * probe._est_epoch_seconds(1, probe._bucket_spec(16, 3, 2))
    chunked = _ev(small, epochs=EPOCHS, launch_seconds_budget=budget)
    got = chunked.evaluate(genomes, seed=4)
    records = chunked.timings[-1]["chunks"]
    assert [(r["pop"], r["compacted"]) for r in records] == [(1, True)] * 2
    assert all(r["lanes"] == [1] * len(r["lanes"]) and len(r["lanes"]) > 1
               for r in records), records
    assert chunked.timings[-1]["launches"] > len(genomes)
    oneshot = _ev(small, epochs=EPOCHS, compaction_chunk=0)
    assert got == [oneshot.evaluate([g], seed=4)[0] for g in genomes]


def test_format_2_fitness_cache_is_refused_on_resume(tmp_path):
    """A cache the fused plan wrote (format 2: no launch budget, lanes per
    launch, bucket genes or split rule in its fingerprint) makes
    ``--resume`` raise the fingerprint error instead of replaying its
    fitnesses; the current fingerprint is accepted."""
    npy = tmp_path / "npy"
    save_npy_dir(make_synthetic(n_train=64, n_eval=32, time_steps=12,
                                features=9), str(npy))
    argv = ["--preset", "nsga_penalty", "--source", "npy", "--data-path",
            str(npy), "--device", "cpu", "--compute-dtype", "float32",
            "--pop-size", "2", "--max-gen", "1", "--epochs", "1", "--out",
            str(tmp_path / "out")]
    cfg = tcli.config_from_args(tcli.build_parser().parse_args(argv))
    fp = tfc.evaluator_fingerprint(cfg.train, prepare_dataset(cfg.data), "cpu")
    new_keys = ("launch_seconds_budget", "max_models_per_program",
                "bucket_genes", "split_flops_per_s", "split_min_seconds")
    old = {k: v for k, v in fp.items() if k not in new_keys}
    assert fp["format"] == 3
    path = tmp_path / "out" / "nsga_penalty" / "fitness_cache.jsonl"
    path.parent.mkdir(parents=True)
    path.write_text(json.dumps({"fingerprint": dict(old, format=2)}) + "\n"
                    + json.dumps({"g": [16, 3, True, 1, 1, False], "seed": 0,
                                  "acc": 0.5, "size": 0.1, "fpr": 0.1}) + "\n")
    with pytest.raises(ValueError, match="different training config"):
        tcli.main(argv + ["--resume"])
    path.write_text(json.dumps({"fingerprint": fp}) + "\n")
    assert len(tfc.FitnessCache(str(path), fp)) == 0
    np.testing.assert_equal(json.loads(path.read_text())["fingerprint"], fp)


def test_eval_batches_over_the_index_limit_take_fewer_rows(data,
                                                            monkeypatch):
    """A validation batch whose stem activation would pass cuDNN's 32-bit
    indexing (a fused 8-lane BirdCLEF launch: 256 rows x 8 lanes x 64
    filters x 501 x 40) is taken in fewer rows, a multiple of the data
    parts, to the same metrics; training batches keep their size."""
    from cmoop_audio_processing_torch.engine import trainer as tt
    from cmoop_audio_processing_torch.models import supernet as ts

    spec = ts.BucketSpec("A", 16, 3, 4, compute_dtype="float32", max_blocks=2)
    trainer = tt.PopulationTrainer(spec, tt.TrainSettings(), 4)
    params, state, flags = ts.init_population(0, spec, GENOMES)
    ev = _ev(data)
    val = tt.SplitData.of(ev._val)
    assert val.rows == 256 and trainer._eval_rows(4, val) == 256
    want = trainer.evaluate(params, state, flags, ev._val)
    row = 4 * 16 * 16 * 8  # the stem's activation of one row, 4 lanes
    monkeypatch.setattr(tt, "MAX_ACTIVATION_ELEMENTS", 100 * row + 7)
    assert trainer._eval_rows(4, val) == 100
    assert trainer._eval_rows(4, tt.SplitData([ev._val] * 3)) == 99
    rows = []
    forward = trainer.forward
    monkeypatch.setattr(trainer, "forward", lambda p, s, f, xs, **kw: (
        rows.append(len(xs[0])) or forward(p, s, f, xs, **kw)))
    got = trainer.evaluate(params, state, flags, ev._val)
    assert rows == [100, 100, 56]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
