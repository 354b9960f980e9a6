"""The PyTorch port stands alone: no module of it, and none of the scripts
that run it on the card (chip_smoke.py, profile_torch.py,
kernel_variants.py, planner_drift.py), imports JAX, optax or the JAX package; pandas, sklearn and h5py are
imported only inside functions off the main path, so the main path runs on
a machine that has none of them."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "cmoop_audio_processing_torch")
FORBIDDEN = {"jax", "jaxlib", "optax", "cmoop_audio_processing_tpu"}
LAZY_ONLY = {"pandas", "sklearn", "h5py"}


def _sources():
    paths = [os.path.join(ROOT, f) for f in
             ("chip_smoke.py", "profile_torch.py", "kernel_variants.py",
              "planner_drift.py")]
    for d, _, files in os.walk(PORT):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imports(tree):
    """(top-level package, node) for every absolute import in ``tree``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node


def _function_bodies(tree):
    """ids of the import nodes that sit inside a function."""
    inside = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inside.update(id(n) for n in ast.walk(fn))
    return inside


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_and_lazy_only_heavy_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    inside = _function_bodies(tree)
    for top, node in _imports(tree):
        assert top not in FORBIDDEN, f"{path}:{node.lineno} imports {top}"
        if top in LAZY_ONLY:
            assert id(node) in inside, (
                f"{path}:{node.lineno} imports {top} at module level")


def test_main_path_runs_with_pandas_sklearn_h5py_and_jax_blocked(tmp_path):
    """Every module of both paths imports, and both CPU paths complete, with
    the optional packages and JAX made unimportable: KWS (MFCC extraction,
    npy split, a tiny real NSGA-II run with lane compaction and the vmap
    forward, another on a (2, 2) mesh of CPU entries) and BirdCLEF (the extraction CLI on a tiny wav tree with
    --kind log_mel, then a tiny real sa_nsga_penalty run with its GP fits);
    each real run keeps its fitness cache."""
    script = textwrap.dedent(f"""
        import importlib, os, sys
        BLOCKED = {sorted(LAZY_ONLY | FORBIDDEN)!r}

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{{name}} is blocked")

        sys.meta_path.insert(0, Block())
        import numpy as np
        for m in ("cli.main", "cli.nsga_penalty", "cli.extract_features",
                  "cli.sa_nsga_penalty", "cli.sa_nsga_local",
                  "cli.sa_nsga_init", "cli.init_sa_nsga_local",
                  "cli.psi_init_sa_nsga", "cli.psi_sa_nsga_local",
                  "engine.evaluator", "engine.trainer", "models.grouped",
                  "models.supernet", "frontend.features",
                  "frontend.cuda_kernels", "frontend.audio_io",
                  "data.pipeline", "data.loaders", "algorithms.nsga2",
                  "algorithms.sa_nsga2", "algorithms.local_search",
                  "algorithms.initializers", "surrogate.gp",
                  "surrogate.kernels", "surrogate.manager",
                  "utils.reporting", "utils.xlsx", "utils.checkpoint",
                  "utils.fitness_cache", "utils.profiling",
                  "parallel.mesh", "native.build", "ops", "core.rng"):
            importlib.import_module("cmoop_audio_processing_torch." + m)
        from cmoop_audio_processing_torch.cli import extract_features
        from cmoop_audio_processing_torch.cli.main import main
        from cmoop_audio_processing_torch.data.loaders import save_npy_dir
        from cmoop_audio_processing_torch.frontend.audio_io import save_wav
        from cmoop_audio_processing_torch.frontend.features import (
            FrontendConfig, extract_features as extract)

        rng = np.random.default_rng(0)
        n = 40
        t = np.arange(4000) / 16000.0
        labels = np.arange(n) % 2
        wavs = (np.sin(2 * np.pi * (300.0 + 900.0 * labels[:, None]) * t)
                + 0.05 * rng.standard_normal((n, 4000))).astype(np.float32)
        feats = extract(wavs, FrontendConfig(hop_length=360), kind="mfcc",
                        device="cpu")
        assert feats.shape == (n, 12, 13), feats.shape
        split = {{"x_train": feats[:24], "y_train": labels[:24],
                  "x_val": feats[24:32], "y_val": labels[24:32],
                  "x_test": feats[32:], "y_test": labels[32:]}}
        save_npy_dir(split, {str(tmp_path / "npy")!r})
        assert main(["--preset", "nsga_penalty", "--source", "npy",
                     "--data-path", {str(tmp_path / "npy")!r},
                     "--device", "cpu", "--compute-dtype", "float32",
                     "--pop-size", "2", "--max-gen", "1", "--epochs", "1",
                     "--compaction-chunk", "1", "--parallel-impl", "vmap",
                     "--out", {str(tmp_path / "out")!r}]) == 0
        assert main(["--preset", "nsga_penalty", "--source", "npy",
                     "--data-path", {str(tmp_path / "npy")!r},
                     "--device", "cpu", "--compute-dtype", "float32",
                     "--pop-size", "2", "--max-gen", "1", "--epochs", "1",
                     "--mesh", "2", "--mesh-data", "2",
                     "--out", {str(tmp_path / "mesh")!r}]) == 0

        wav_dir = {str(tmp_path / "bird_wavs")!r}
        for k in range(3):
            os.makedirs(os.path.join(wav_dir, f"call_{{k}}"))
            for i in range(8):
                y = np.sin(2 * np.pi * (1500.0 + 700.0 * k) * t)
                save_wav(os.path.join(wav_dir, f"call_{{k}}", f"{{i}}.wav"),
                         y + 0.05 * rng.standard_normal(len(t)), 16000)
        bird_npy = {str(tmp_path / "bird_npy")!r}
        assert extract_features.main([
            "--wav-dir", wav_dir, "--out", bird_npy, "--kind", "log_mel",
            "--duration", "0.25", "--device", "cpu"]) == 0
        assert np.load(os.path.join(bird_npy, "X_train.npy")).shape[1:] == (26, 40)
        assert main(["--preset", "sa_nsga_penalty", "--source", "npy",
                     "--data-path", bird_npy, "--device", "cpu",
                     "--compute-dtype", "float32", "--pop-size", "2",
                     "--max-gen", "1", "--epochs", "1",
                     "--out", {str(tmp_path / "out")!r}]) == 0
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not leaked, leaked
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")
    for preset, final in (("nsga_penalty", "final_pareto.csv"),
                          ("sa_nsga_penalty", "final_pareto_surrogate.csv")):
        run_dir = tmp_path / "out" / preset
        assert (run_dir / "all_generations.csv").exists()
        assert (run_dir / "all_generations.xlsx").exists()
        assert (run_dir / final).exists()
        assert (run_dir / "fitness_cache.jsonl").exists()


def test_mobo_export_and_compare_run_with_pandas_sklearn_h5py_and_jax_blocked(
        tmp_path):
    """The MOBO presets (``psi_mobo_2`` reading examples/all8/Final.csv),
    ``train_final`` from the MOBO front and ``compare`` on two CSV fronts
    complete on the CPU with the optional packages and JAX unimportable."""
    final_csv = os.path.join(ROOT, "examples", "all8", "Final.csv")
    nsga_front = os.path.join(ROOT, "examples", "all8", "front_sa_nsga_penalty.csv")
    out = str(tmp_path / "out")
    script = textwrap.dedent(f"""
        import importlib, json, os, sys
        BLOCKED = {sorted(LAZY_ONLY | FORBIDDEN)!r}

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{{name}} is blocked")

        sys.meta_path.insert(0, Block())
        for m in ("cli.mobo_penalty", "cli.psi_mobo_2", "cli.acc_size_nsga_1",
                  "cli.acc_fpr_nsga_1", "cli.size_fpr_nsga_1",
                  "cli.train_final", "cli.compare", "cli.psi_merge",
                  "algorithms.mobo", "surrogate.acquisition",
                  "engine.export", "models.keras_export",
                  "metrics.hypervolume", "metrics.quality",
                  "metrics.tchebycheff"):
            importlib.import_module("cmoop_audio_processing_torch." + m)
        from cmoop_audio_processing_torch.cli import compare, train_final
        from cmoop_audio_processing_torch.cli.main import main
        from cmoop_audio_processing_torch.data.loaders import save_npy_dir
        from cmoop_audio_processing_torch.data.synthetic import make_synthetic

        out = {out!r}
        assert main(["--preset", "mobo_penalty", "--fake-eval", "--device",
                     "cpu", "--max-gen", "2", "--out", out]) == 0
        assert main(["--preset", "psi_mobo_2", "--fake-eval", "--device",
                     "cpu", "--max-gen", "2", "--psi-seed-file",
                     {final_csv!r}, "--out", out]) == 0
        front = os.path.join(out, "psi_mobo_2", "mobo_pareto.csv")
        save_npy_dir(make_synthetic(num_classes=10, n_train=64, n_eval=32,
                                    time_steps=12, features=9),
                     os.path.join(out, "npy"))
        assert train_final.main([
            "--preset", "nsga_penalty", "--front", front, "--row", "0",
            "--source", "npy", "--data-path", os.path.join(out, "npy"),
            "--epochs", "1", "--device", "cpu",
            "--out", os.path.join(out, "deployed")]) == 0
        report = os.path.join(out, "report.json")
        assert compare.main(["--front", "MOBO=" + front, "--front",
                             "SA=" + {nsga_front!r}, "--out", report]) == 0
        with open(report) as f:
            hv = json.load(f)["hypervolume"]
        assert sorted(hv) == ["MOBO", "SA"] and min(hv.values()) > 0, hv
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not leaked, leaked
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")
    for preset in ("mobo_penalty", "psi_mobo_2"):
        run_dir = tmp_path / "out" / preset
        for name in ("mobo_pareto.csv", "mobo_iterations.xlsx",
                     "all_generations.csv", "mobo_iteration_2.csv"):
            assert (run_dir / name).exists(), (preset, name)
    assert (tmp_path / "out" / "deployed" / "model.npz").exists()


def test_validation_scripts_run_with_pandas_sklearn_h5py_and_jax_blocked(
        tmp_path):
    """The port's validation scripts import, and the pieces the card runs
    without pandas do run, with the optional packages and JAX unimportable:
    ``psi_merge`` (run_all8's stage-1 merge) on the committed stage-1
    fronts, and the exhaustive sweep, report and comparison."""
    stage1 = [os.path.join(ROOT, "examples", "all8", f"front_{n}_nsga_1.csv")
              for n in ("acc_size", "acc_fpr", "size_fpr")]
    committed = os.path.join(ROOT, "examples", "exhaustive")
    script = textwrap.dedent(f"""
        import importlib, os, sys
        BLOCKED = {sorted(LAZY_ONLY | FORBIDDEN)!r}

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{{name}} is blocked")

        sys.meta_path.insert(0, Block())
        for m in ("run_exhaustive", "run_all8", "make_kws_corpus",
                  "make_birdclef_corpus"):
            importlib.import_module("cmoop_audio_processing_torch.examples." + m)
        from cmoop_audio_processing_torch.cli import psi_merge
        from cmoop_audio_processing_torch.examples import run_exhaustive

        assert psi_merge.main({stage1!r} + ["--dedup", "--limit", "10",
                              "--interleave", "--out", "Final.csv"]) == 0
        assert run_exhaustive.main(["--fake-eval", "--device", "cpu",
                                    "--out", "exh"]) == 0
        assert run_exhaustive.main(["--out", "exh", "--compare-to",
                                    {committed!r}]) == 0
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not leaked, leaked
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")
    with open(tmp_path / "Final.csv") as f:
        assert f.readline().startswith("Accuracy,Size_MB,FPR,filters")
    for name in ("exhaustive_A_288.csv", "exhaustive_B_288.csv",
                 "exhaustive_report.json", "meta.json"):
        assert (tmp_path / "exh" / name).exists(), name


def test_all8_resume_export_and_comparison_run_with_jax_blocked(tmp_path):
    """The all-8 harness's additions run with the optional packages and JAX
    unimportable: a closed-form replica with ``--compaction-chunk``, its
    ``--resume`` (every search skipped), ``--export`` and ``--compare-to``
    against the JAX package's committed reports and both exhaustive
    truths."""
    script = textwrap.dedent(f"""
        import json, os, sys
        BLOCKED = {sorted(LAZY_ONLY | FORBIDDEN)!r}

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{{name}} is blocked")

        sys.meta_path.insert(0, Block())
        from cmoop_audio_processing_torch.examples import run_all8

        argv = ["--fake-eval", "--pop", "4", "--gen", "1", "--seed", "11",
                "--device", "cpu", "--compaction-chunk", "0", "--out", "run"]
        rc = run_all8.main(argv)
        assert run_all8.main(argv + ["--resume"]) == rc
        assert run_all8.main(["--out", "run", "--export", "art"]) == 0
        assert run_all8.main(["--out", "art", "--compare-to",
                              {os.path.join(ROOT, "examples")!r}]) == 0
        with open(os.path.join("art", "meta.json")) as f:
            meta = json.load(f)
        assert len(meta["jax_reports"]) == 5, meta["jax_reports"]
        assert meta["ordering"]["exit_code"] == rc
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not leaked, leaked
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")
    assert "in the run record, not run again" in proc.stderr
    for name in ["Final.csv", "compare_report_all8.json", "all8_run.json"] + [
            f"front_{p}.csv" for p in ("acc_size_nsga_1", "mobo_penalty",
                                       "psi_mobo_2", "sa_nsga_penalty")]:
        assert (tmp_path / "art" / name).exists(), name
