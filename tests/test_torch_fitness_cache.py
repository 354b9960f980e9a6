"""The PyTorch port's durable fitness cache (utils/fitness_cache.py)
against the JAX package's: byte-identical entry lines, the same handling of
a crash-torn tail and of a foreign fingerprint, and a fingerprint that also
names the backend, the device, the population forward and the compaction
setting, so caches of another launch plan, of another device or of the
JAX package never replay. On the port's side: the evaluator replays cached
fitness exactly and trains only what is missing, each launch's results are
on disk before the next launch starts, and the CLI keeps a cache for every
real run. f32 on the CPU, at the shapes of tests/test_compaction.py
(192 x 16 x 8, 4 classes, 12 epochs, patience 2)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from cmoop_audio_processing_torch.cli import main as tcli
from cmoop_audio_processing_torch.core import config as tconfig
from cmoop_audio_processing_torch.core.config import TrainConfig
from cmoop_audio_processing_torch.core.genome import all_genomes
from cmoop_audio_processing_torch.engine import evaluator as tev
from cmoop_audio_processing_torch.utils import fitness_cache as tfc
from cmoop_audio_processing_tpu.core.config import DataConfig
from cmoop_audio_processing_tpu.data.pipeline import prepare_dataset
from cmoop_audio_processing_tpu.utils import fitness_cache as jfc

# the test workers share the CPU's cores: one intra-op thread per worker
# keeps PyTorch's thread pool from oversubscribing them
torch.set_num_threads(1)

CFG = TrainConfig(
    epochs=12, batch_size=32, patience=2, num_classes=4,
    compute_dtype="float32", learning_rate=1e-2,
)
GENOMES = [
    dict(filters=16, kernel_size=3, use_bn=False, residual_blocks=1,
         fc_layers=1, use_dropout=False),
    dict(filters=16, kernel_size=3, use_bn=True, residual_blocks=1,
         fc_layers=3, use_dropout=True),
    dict(filters=16, kernel_size=5, use_bn=True, residual_blocks=1,
         fc_layers=2, use_dropout=False),
]
ENTRIES = [
    (all_genomes()[0], 0, (0.1 + 0.2, 0.07356262207031250, 1 / 3)),
    (all_genomes()[77], 3, (np.float32(0.9375), np.float64(1.5e-7), 0.0)),
    (all_genomes()[287], 12, (1.0, 2.3969268798828125, 0.0123456789012345)),
]


@pytest.fixture(scope="module")
def data():
    return prepare_dataset(
        DataConfig(synthetic_train=192, synthetic_eval=64, time_steps=16,
                   features=8, num_classes=4)
    )


def _lines(path):
    with open(path, "rb") as f:
        return f.read().split(b"\n")


def test_fingerprint_is_the_jax_packages_plus_backend_and_device(data):
    """The JAX package's keys (in format 3), plus the backend, the device
    and the launch plan's settings (population forward, compaction chunk,
    launch budget, lanes per launch, bucket genes, the split rule)."""
    want = jfc.evaluator_fingerprint(CFG, data)
    rule = tev.PopulationEvaluator
    for device in ("cpu", "cuda"):
        got = tfc.evaluator_fingerprint(CFG, data, device)
        assert got == {**want, "format": 3, "backend": "torch",
                       "device": device, "parallel_impl": "grouped",
                       "compaction_chunk": -1, "launch_seconds_budget": 20.0,
                       "max_models_per_program": 16,
                       "bucket_genes": ["filters", "kernel_size",
                                        "residual_blocks"],
                       "split_flops_per_s": rule._SUSTAINED_FLOPS_PER_S,
                       "split_min_seconds": 2.0}
    assert tfc.dataset_fingerprint(data) == jfc.dataset_fingerprint(data)


def test_entry_lines_are_byte_identical_to_the_jax_packages(tmp_path, data):
    tpath, jpath = str(tmp_path / "torch.jsonl"), str(tmp_path / "jax.jsonl")
    tcache = tfc.FitnessCache(tpath, tfc.evaluator_fingerprint(CFG, data, "cpu"))
    jcache = jfc.FitnessCache(jpath, jfc.evaluator_fingerprint(CFG, data))
    for cache in (tcache, jcache):
        cache.put_many(ENTRIES[:2])
        cache.put_many(ENTRIES[1:])  # a repeated entry is not written again
    assert _lines(tpath)[1:] == _lines(jpath)[1:]
    assert len(_lines(tpath)) == 1 + len(ENTRIES) + 1  # header, entries, ""
    assert json.loads(_lines(tpath)[0])["fingerprint"]["backend"] == "torch"


def test_torn_tail_is_skipped_and_repaired_as_in_the_jax_package(tmp_path,
                                                                  data):
    paths = {}
    for name, mod, fp in (
            ("torch", tfc, tfc.evaluator_fingerprint(CFG, data, "cpu")),
            ("jax", jfc, jfc.evaluator_fingerprint(CFG, data))):
        path = paths[name] = str(tmp_path / f"{name}.jsonl")
        mod.FitnessCache(path, fp).put_many(ENTRIES[:2])
        with open(path, "a") as f:
            f.write('{"g": [16, 3, true')  # no newline: a torn append
        reopened = mod.FitnessCache(path, fp)
        assert len(reopened) == 2
        assert reopened.get(ENTRIES[1][0], 3) == tuple(
            float(v) for v in ENTRIES[1][2])
        assert reopened.get(ENTRIES[1][0], 4) is None  # the seed is in the key
        # the tail was repaired on load: the next append is a line of its own
        reopened.put_many(ENTRIES[2:])
        again = mod.FitnessCache(path, fp)
        assert len(again) == 3
        assert again.get(ENTRIES[2][0], 12) == ENTRIES[2][2]
    assert _lines(paths["torch"])[1:] == _lines(paths["jax"])[1:]


@pytest.mark.parametrize("change", [
    dict(device="cuda"),
    dict(cfg=dict(epochs=5)),
    dict(shift=1e-3),
    dict(cfg=dict(parallel_impl="vmap")),
    dict(cfg=dict(compaction_chunk=3)),
    dict(cfg=dict(launch_seconds_budget=8.0)),
    dict(cfg=dict(max_models_per_program=4)),
    dict(cfg=dict(bucket_genes=("filters", "kernel_size"))),
    dict(rule=("_SUSTAINED_FLOPS_PER_S", 1e12)),
    dict(rule=("_MIN_SPLIT_PROGRAM_SECONDS", 4.0)),
], ids=["device", "epochs", "data", "vmap", "compaction_chunk",
        "launch_seconds_budget", "max_models_per_program", "bucket_genes",
        "split_rate", "split_threshold"])
def test_foreign_fingerprints_are_refused(tmp_path, data, monkeypatch,
                                          change):
    """A cache written under another device, training config, dataset,
    population forward or launch plan (compaction setting, launch budget,
    lanes per launch, bucket genes, the split rule's rate or threshold)
    raises ``ValueError`` instead of replaying."""
    path = str(tmp_path / "cache.jsonl")
    tfc.FitnessCache(path, tfc.evaluator_fingerprint(CFG, data, "cpu")
                     ).put_many(ENTRIES)
    if "rule" in change:
        monkeypatch.setattr(tev.PopulationEvaluator, *change["rule"])
    fp = tfc.evaluator_fingerprint(
        dataclasses.replace(CFG, **change.get("cfg", {})),
        dict(data, x_train=data["x_train"] + change.get("shift", 0.0)),
        change.get("device", "cpu"))
    with pytest.raises(ValueError, match="different training config"):
        tfc.FitnessCache(path, fp)


def test_the_jax_packages_cache_and_the_ports_refuse_each_other(tmp_path,
                                                                 data):
    """The JAX package refuses the port's cache and the port the JAX one's;
    a file without a header is not a cache."""
    path = str(tmp_path / "cache.jsonl")
    cpu = tfc.evaluator_fingerprint(CFG, data, "cpu")
    tfc.FitnessCache(path, cpu).put_many(ENTRIES)
    with pytest.raises(ValueError, match="different training config"):
        jfc.FitnessCache(path, jfc.evaluator_fingerprint(CFG, data))
    jpath = str(tmp_path / "jax.jsonl")
    jfc.FitnessCache(jpath, jfc.evaluator_fingerprint(CFG, data)).put_many(
        ENTRIES)
    with pytest.raises(ValueError, match="different training config"):
        tfc.FitnessCache(jpath, cpu)
    bad = tmp_path / "bad.jsonl"
    bad.write_text("not json\n")
    with pytest.raises(ValueError, match="not a fitness cache"):
        tfc.FitnessCache(str(bad), cpu)


def test_evaluator_replays_cached_fitness_exactly(tmp_path, data):
    """A fresh evaluator over a complete cache trains nothing and returns
    the same fitness bit for bit; over a cache cut after one launch (a
    crash) it trains only the missing genomes, to the same fitness."""
    path = str(tmp_path / "fits.jsonl")
    first = tev.PopulationEvaluator(data, CFG, device="cpu",
                                    fitness_cache_path=path)
    want = first.evaluate(GENOMES, seed=7)
    assert first.timings[-1]["cache_hits"] == 0
    assert first.total_true_evals == 3
    assert len(first.timings[-1]["chunks"]) == 2  # two (filters, k) buckets

    replay = tev.PopulationEvaluator(data, CFG, device="cpu",
                                     fitness_cache_path=path)
    assert replay.evaluate(GENOMES, seed=7) == want
    assert replay.timings[-1]["cache_hits"] == 3
    assert replay.timings[-1]["launches"] == 0
    assert replay.timings[-1]["chunks"] == []
    assert replay.total_true_evals == 0

    # keep the header and the first launch's entries only
    lines = _lines(path)
    first_launch = len(first.timings[-1]["chunks"][0]["epochs"])
    assert first_launch == 2
    with open(path, "wb") as f:
        f.write(b"\n".join(lines[:1 + first_launch]) + b"\n")
    resumed = tev.PopulationEvaluator(data, CFG, device="cpu",
                                      fitness_cache_path=path)
    assert resumed.evaluate(GENOMES, seed=7) == want
    assert resumed.timings[-1]["cache_hits"] == first_launch
    assert resumed.total_true_evals == 3 - first_launch

    # a different seed is a different training: nothing replays
    other = tev.PopulationEvaluator(data, CFG, device="cpu",
                                    fitness_cache_path=path)
    other._run_bucket = lambda spec, padded, seed: {
        "acc": np.zeros(len(padded)), "fpr": np.zeros(len(padded)),
        "epochs": np.ones(len(padded), np.int32), "lanes": [len(padded)]}
    other.evaluate(GENOMES, seed=8)
    assert other.timings[-1]["cache_hits"] == 0


def test_each_launch_is_durable_before_the_next(tmp_path, data, monkeypatch):
    """A crash in the second launch leaves the first launch's trainings on
    disk, where a resumed evaluator finds them."""
    launches, crash = [], [True]

    def run_bucket(self, spec, padded, seed):
        launches.append(spec.kernel)
        if crash[0] and len(launches) == 2:
            raise RuntimeError("card lost")
        n = len(padded)
        return {"acc": np.full(n, 0.75), "fpr": np.full(n, 0.05),
                "epochs": np.full(n, 4, np.int32), "lanes": [n]}

    monkeypatch.setattr(tev.PopulationEvaluator, "_run_bucket", run_bucket)
    path = str(tmp_path / "crash.jsonl")
    ev = tev.PopulationEvaluator(data, CFG, device="cpu",
                                 fitness_cache_path=path)
    with pytest.raises(RuntimeError, match="card lost"):
        ev.evaluate(GENOMES, seed=5)
    fp = tfc.evaluator_fingerprint(CFG, data, "cpu")
    on_disk = tfc.FitnessCache(path, fp)
    survived = [g for g in GENOMES if on_disk.get(g, 5) is not None]
    assert survived == [g for g in GENOMES if g["kernel_size"] == launches[0]]
    assert on_disk.get(survived[0], 5)[0] == 0.75

    launches.clear()
    crash[0] = False
    resumed = tev.PopulationEvaluator(data, CFG, device="cpu",
                                      fitness_cache_path=path)
    fits = resumed.evaluate(GENOMES, seed=5)
    assert resumed.timings[-1]["cache_hits"] == len(survived)
    assert len(launches) == 1 and all(f[0] == 0.75 for f in fits)


def test_cli_keeps_a_cache_for_every_real_run(tmp_path, monkeypatch):
    """A real run writes <out>/<preset>/fitness_cache.jsonl under the port's
    fingerprint, truncating a stale one; after a crash that lost the
    checkpoint, ``--resume`` replays every fitness and trains nothing."""
    base = tconfig.get_preset("nsga_penalty")
    tiny = base.replace(
        data=dataclasses.replace(base.data, synthetic_train=64,
                                 synthetic_eval=32, time_steps=12, features=8,
                                 num_classes=4),
        train=dataclasses.replace(base.train, epochs=1, batch_size=32,
                                  patience=2, num_classes=4,
                                  compute_dtype="float32"),
    )
    monkeypatch.setitem(tconfig.PRESETS, "nsga_penalty", tiny)
    out = tmp_path / "run"
    run_dir = out / "nsga_penalty"
    cache = run_dir / "fitness_cache.jsonl"
    run_dir.mkdir(parents=True)
    cache.write_text('{"fingerprint": {"format": 0, "stale": true}}\n')
    args = ["--preset", "nsga_penalty", "--out", str(out), "--seed", "3",
            "--pop-size", "4", "--max-gen", "2", "--device", "cpu"]

    trained = []
    run_bucket = tev.PopulationEvaluator._run_bucket

    def counting(self, spec, padded, seed):
        trained.append(len(padded))
        return run_bucket(self, spec, padded, seed)

    monkeypatch.setattr(tev.PopulationEvaluator, "_run_bucket", counting)
    assert tcli.main(args) == 0  # fresh run: the stale cache is truncated
    lines = [json.loads(x) for x in cache.read_text().splitlines()]
    assert lines[0]["fingerprint"]["backend"] == "torch"
    assert lines[0]["fingerprint"]["device"] == "cpu"
    assert len(lines) > 1 and trained
    front = (run_dir / "final_pareto.csv").read_bytes()

    os.remove(run_dir / "checkpoint.json")  # a crash before the checkpoint
    trained.clear()
    assert tcli.main(args + ["--resume"]) == 0
    assert trained == []  # every fitness came from the cache
    assert (run_dir / "final_pareto.csv").read_bytes() == front
    assert [json.loads(x) for x in cache.read_text().splitlines()] == lines

    # 'off' writes no cache (a stub stands in for the training here)
    monkeypatch.setattr(tev.PopulationEvaluator, "_run_bucket",
                        lambda self, spec, padded, seed: {
                            "acc": np.full(len(padded), 0.5),
                            "fpr": np.full(len(padded), 0.1),
                            "epochs": np.ones(len(padded), np.int32),
                            "lanes": [len(padded)]})
    assert tcli.main(args + ["--fitness-cache", "off",
                             "--out", str(tmp_path / "off")]) == 0
    assert not (tmp_path / "off" / "nsga_penalty" / "fitness_cache.jsonl").exists()
