"""The PyTorch port's evaluator and CLI: fitness keyed by genome (not by
population), presets equal to the JAX package's, ``--fake-eval`` artifacts
byte-identical to the JAX CLI's, and a small real CPU run."""

import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch

from cmoop_audio_processing_torch.cli import main as tcli
from cmoop_audio_processing_torch.core import config as tconfig
from cmoop_audio_processing_torch.core.config import DataConfig, TrainConfig
from cmoop_audio_processing_torch.core.genome import all_genomes
from cmoop_audio_processing_torch.data.loaders import save_npy_dir
from cmoop_audio_processing_torch.data.pipeline import prepare_dataset
from cmoop_audio_processing_torch.engine import evaluator as tev
from cmoop_audio_processing_tpu.cli import main as jcli
from cmoop_audio_processing_tpu.core import config as jconfig
from cmoop_audio_processing_tpu.engine.evaluator import FakeEvaluator as JaxFake

# the test workers share the CPU's cores: one intra-op thread per worker
# keeps PyTorch's thread pool from oversubscribing them
torch.set_num_threads(1)

GENOMES = [
    dict(filters=16, kernel_size=3, use_bn=True, residual_blocks=1,
         fc_layers=1, use_dropout=True),
    dict(filters=16, kernel_size=3, use_bn=False, residual_blocks=2,
         fc_layers=3, use_dropout=True),
    dict(filters=16, kernel_size=3, use_bn=True, residual_blocks=2,
         fc_layers=4, use_dropout=True),
    dict(filters=16, kernel_size=3, use_bn=False, residual_blocks=1,
         fc_layers=2, use_dropout=False),
]


@pytest.fixture(scope="module")
def data():
    return prepare_dataset(DataConfig(synthetic_train=96, synthetic_eval=48,
                                      time_steps=12, features=9))


def _cfg(**kw):
    return dataclasses.replace(
        TrainConfig(epochs=3, batch_size=32, patience=2,
                    compute_dtype="float32"), **kw)


def test_fitness_does_not_depend_on_population_composition(data):
    """A genome's fitness is a function of (genome, seed, dataset) alone:
    alone, or in a population of other genomes (shared bucket, padded
    lanes), it trains to the same result; a rerun repeats it."""
    cfg = _cfg(bucket_genes=("filters", "kernel_size"))
    alone = tev.PopulationEvaluator(data, cfg, device="cpu").evaluate(
        [GENOMES[1]], seed=3)[0]
    ev = tev.PopulationEvaluator(data, cfg, device="cpu")
    in_pop = ev.evaluate(GENOMES[:1] + GENOMES[1:], seed=3)[1]
    assert ev.timings[-1]["launches"] == 1  # all four share one population
    np.testing.assert_allclose(np.asarray(in_pop), np.asarray(alone),
                               rtol=1e-5, atol=1e-6)
    assert ev.evaluate(GENOMES, seed=3)[1] == in_pop


def test_buckets_pad_to_pow2_and_specialize_depth(data):
    ev = tev.PopulationEvaluator(data, _cfg(max_models_per_program=2),
                                 device="cpu")
    genomes = [dict(GENOMES[0], fc_layers=n) for n in (1, 2, 3)]
    fits = ev.evaluate(genomes, seed=1)
    chunks = ev.timings[-1]["chunks"]
    assert [c["pop"] for c in chunks] == [2, 1]
    assert all(c["max_blocks"] == 1 for c in chunks)
    assert [f[1] for f in fits] == [tev.model_size_mb(g, 10, "A") for g in genomes]


def test_evaluator_refuses_cuda_without_a_gpu(data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tev.PopulationEvaluator(data, _cfg())


def test_presets_equal_the_jax_packages():
    assert sorted(tconfig.PRESETS) == sorted(jconfig.PRESETS)
    for name in jconfig.PRESETS:
        assert dataclasses.asdict(tconfig.PRESETS[name]) == dataclasses.asdict(
            jconfig.PRESETS[name]), name


def test_fake_evaluator_equals_the_jax_packages():
    genomes = all_genomes()
    for noise in (0.0, 0.01):
        assert tev.FakeEvaluator(noise=noise, seed=2).evaluate(genomes, 5) == \
            JaxFake(noise=noise, seed=2).evaluate(genomes, 5)


@pytest.mark.parametrize("max_gen", [3, 5])
def test_fake_eval_artifacts_are_byte_identical_to_the_jax_cli(tmp_path, max_gen):
    args = ["--preset", "nsga_penalty", "--fake-eval", "--max-gen",
            str(max_gen), "--seed", "11"]
    assert jcli.main(args + ["--out", str(tmp_path / "jax")]) == 0
    assert tcli.main(args + ["--out", str(tmp_path / "torch"),
                             "--device", "cpu"]) == 0
    jdir, tdir = tmp_path / "jax" / "nsga_penalty", tmp_path / "torch" / "nsga_penalty"
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    csvs = sorted(f for f in os.listdir(jdir) if f.endswith(".csv"))
    assert "final_pareto.csv" in csvs and "all_generations.csv" in csvs
    assert ("pareto_iteration_5.csv" in csvs) == (max_gen == 5)
    for name in csvs:
        assert filecmp.cmp(jdir / name, tdir / name, shallow=False), name


def test_resume_of_a_completed_fake_run_keeps_artifacts(tmp_path):
    args = ["--preset", "acc_size_nsga_1", "--fake-eval", "--max-gen", "3",
            "--out", str(tmp_path), "--device", "cpu"]
    assert tcli.main(args) == 0
    d = tmp_path / "acc_size_nsga_1"
    before = {f: (d / f).read_bytes() for f in ("final_pareto.csv",
                                                 "all_generations.csv")}
    assert filecmp.cmp(d / "final_pareto.csv", d / "final_pareto_2_obj.csv",
                       shallow=False)
    assert tcli.main(args + ["--resume"]) == 0
    for f, b in before.items():
        assert (d / f).read_bytes() == b, f


def test_resume_over_a_torn_generations_csv_starts_clean(tmp_path):
    """A row cut short by a crash reads back as None cells: the reporter
    drops the file's rows instead of failing to resume."""
    from cmoop_audio_processing_torch.utils.reporting import RunReporter

    d = tmp_path / "run"
    d.mkdir()
    (d / "all_generations.csv").write_text(
        "Generation,Accuracy,Size_MB,FPR,CV,filters,kernel_size,use_bn,"
        "residual_blocks,fc_layers,use_dropout\n0,0.9,0.1\n")
    assert RunReporter(str(tmp_path), "run", resume=True).gen_rows == []


def _small_npy(tmp_path):
    raw = {k: v for k, v in __import__(
        "cmoop_audio_processing_torch.data.synthetic", fromlist=["x"]
    ).make_synthetic(n_train=64, n_eval=32, time_steps=12, features=9).items()}
    path = tmp_path / "npy"
    save_npy_dir(raw, str(path))
    return path


def _check_real_run(tmp_path, extra):
    out = tmp_path / "out"
    assert tcli.main(["--preset", "nsga_penalty", "--device", "cpu",
                      "--compute-dtype", "float32", "--pop-size", "4",
                      "--max-gen", "2", "--epochs", "2", "--out", str(out)]
                     + extra) == 0
    jout = tmp_path / "jax_fake"
    assert jcli.main(["--preset", "nsga_penalty", "--fake-eval", "--pop-size",
                      "4", "--max-gen", "2", "--out", str(jout)]) == 0
    tdir, jdir = out / "nsga_penalty", jout / "nsga_penalty"
    # the same artifact set as the JAX CLI (which adds its fitness cache
    # only on real runs)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in ("all_generations.csv", "final_pareto.csv"):
        header = (tdir / name).read_text().splitlines()[:1]
        want = (jdir / name).read_text().splitlines()[:1]
        if header and want:
            assert header == want, name
    gens = (tdir / "all_generations.csv").read_text().splitlines()
    assert len(gens) == 1 + 2 * 4


def test_small_real_cpu_run_writes_the_reference_artifacts(tmp_path):
    _check_real_run(tmp_path, ["--source", "npy", "--data-path",
                               str(_small_npy(tmp_path))])


@pytest.mark.slow
def test_real_cpu_run_on_default_synthetic_data(tmp_path):
    """The preset's own synthetic dataset (2000 x 44 x 13): ~75 s on the
    CPU, hence slow."""
    _check_real_run(tmp_path, ["--source", "synthetic"])


@pytest.mark.parametrize("extra", [
    ["--preset", "sa_nsga_penalty", "--launch-budget", "5"],
    ["--preset", "mobo_penalty"],
    ["--preset", "nsga_penalty", "--mesh", "2"],
    ["--preset", "nsga_penalty", "--fitness-cache", "cache.jsonl"],
    ["--preset", "nsga_penalty", "--compaction-chunk", "4"],
    ["--preset", "nsga_penalty", "--launch-budget", "5"],
    ["--preset", "nsga_penalty", "--parallel-impl", "vmap"],
], ids=["sa_nsga2", "mobo", "mesh", "fitness_cache", "compaction",
        "launch_budget", "vmap"])
def test_options_the_port_does_not_carry_exit_naming_the_roadmap(extra):
    """The sa_nsga2 presets run (tests/test_torch_sa_nsga2.py); an option
    the port does not carry still exits for them."""
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        tcli.main(extra + ["--fake-eval", "--device", "cpu"])


@pytest.mark.parametrize("preset", sorted(
    n for n, c in tconfig.PRESETS.items() if c.algorithm == "sa_nsga2"))
def test_sa_nsga2_presets_run_under_fake_eval(tmp_path, preset):
    """Every sa_nsga2 preset runs (the PSI ones from a stage-1 front) and
    writes its reference artifact names."""
    from cmoop_audio_processing_torch.utils.reporting import write_csv

    extra = []
    if tconfig.PRESETS[preset].search.initializer == "psi":
        seed_file = str(tmp_path / "stage1.csv")
        write_csv(seed_file, [
            {"Accuracy": 0.93, "Size_MB": 0.5, "FPR": 0.04, **g}
            for g in all_genomes()[:6]
        ])
        extra = ["--psi-seed-file", seed_file]
    assert tcli.main(["--preset", preset, "--fake-eval", "--max-gen", "2",
                      "--pop-size", "6", "--device", "cpu", "--out",
                      str(tmp_path)] + extra) == 0
    suffix = tconfig.PRESETS[preset].artifact_suffix
    run_dir = tmp_path / preset
    assert (run_dir / f"final_pareto_{suffix}.csv").exists()
    assert (run_dir / f"all_generations_{suffix}.xlsx").exists()
