"""The PyTorch port stands alone: no module of it, and not chip_smoke.py,
imports JAX, optax or the JAX package; pandas, sklearn and h5py are
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
    paths = [os.path.join(ROOT, "chip_smoke.py")]
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
    """Every main-path module imports, and the CPU main path (MFCC
    extraction, npy split, a tiny real NSGA-II run) completes, with the
    optional packages and JAX made unimportable."""
    script = textwrap.dedent(f"""
        import importlib, os, sys
        BLOCKED = {sorted(LAZY_ONLY | FORBIDDEN)!r}

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{{name}} is blocked")

        sys.meta_path.insert(0, Block())
        import numpy as np
        for m in ("cli.main", "cli.nsga_penalty", "engine.evaluator",
                  "engine.trainer", "models.grouped", "models.supernet",
                  "frontend.features", "frontend.cuda_kernels",
                  "data.pipeline", "data.loaders", "algorithms.nsga2",
                  "algorithms.initializers", "utils.reporting",
                  "utils.xlsx", "utils.checkpoint", "core.rng"):
            importlib.import_module("cmoop_audio_processing_torch." + m)
        from cmoop_audio_processing_torch.cli.main import main
        from cmoop_audio_processing_torch.data.loaders import save_npy_dir
        from cmoop_audio_processing_torch.frontend.features import (
            FrontendConfig, extract_features)

        rng = np.random.default_rng(0)
        n = 40
        t = np.arange(4000) / 16000.0
        labels = np.arange(n) % 2
        wavs = (np.sin(2 * np.pi * (300.0 + 900.0 * labels[:, None]) * t)
                + 0.05 * rng.standard_normal((n, 4000))).astype(np.float32)
        feats = extract_features(wavs, FrontendConfig(hop_length=360),
                                 kind="mfcc", device="cpu")
        assert feats.shape == (n, 12, 13), feats.shape
        split = {{"x_train": feats[:24], "y_train": labels[:24],
                  "x_val": feats[24:32], "y_val": labels[24:32],
                  "x_test": feats[32:], "y_test": labels[32:]}}
        save_npy_dir(split, {str(tmp_path / "npy")!r})
        assert main(["--preset", "nsga_penalty", "--source", "npy",
                     "--data-path", {str(tmp_path / "npy")!r},
                     "--device", "cpu", "--compute-dtype", "float32",
                     "--pop-size", "2", "--max-gen", "1", "--epochs", "1",
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
    run_dir = tmp_path / "out" / "nsga_penalty"
    assert (run_dir / "all_generations.csv").exists()
    assert (run_dir / "all_generations.xlsx").exists()
    assert (run_dir / "final_pareto.csv").exists()
