"""The harness as a command: without a card it exits with an error and
prints no result; no JAX module and nothing of the JAX package is loaded
by a run or by the reference, and the reference loads nothing of the
port; in a directory that holds only the benchmark it fails."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
RUN = os.path.join(ROOT, "benchmark", "run.py")
ARGS = ["--workload", "bird_sa_nsga_penalty.fused16", "--seed",
        str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"]


def _py(code, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=600)


def test_no_card_is_an_error_not_a_cpu_run():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, RUN] + ARGS, cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "torch.cuda.is_available() is False" in p.stderr


def test_a_run_loads_no_jax_and_the_reference_none_of_the_port():
    code = """
import json, sys
sys.path.insert(0, '.')
import torch
import benchmark.check, benchmark.frozen
import benchmark.reference.keras_cnn, benchmark.reference.training
ref_only = sorted({m.split('.')[0] for m in sys.modules})
from benchmark import cell, check
c = cell.resolve('bird_sa_nsga_penalty.fused16')
c['config']['data'] = {'time_steps': 20, 'features': 8, 'n_train': 70, 'n_val': 30}
c['traffic']['genomes']['grid']['filters'] = [16]
c['traffic']['genomes']['grid']['fc_layers'] = [1]
cell.run(c, 3, 0.0, False, device='cpu', log=lambda s: None)
sys.path.insert(0, 'benchmark')
import run
print(json.dumps({'ref_only': ref_only, 'forbidden': run.forbidden_modules()}))
"""
    p = _py(code)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == []
    assert "cmoop_audio_processing_torch" not in out["ref_only"]
    assert not {"jax", "jaxlib", "flax", "cmoop_audio_processing_tpu"} & set(
        out["ref_only"])


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    try:
        import run
    finally:
        sys.path.pop(0)
    sys.modules["cmoop_audio_processing_tpux"] = sys
    try:
        assert "cmoop_audio_processing_tpu" not in run.forbidden_modules()
    finally:
        del sys.modules["cmoop_audio_processing_tpux"]


def test_fails_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py"] + ARGS,
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    code = """
import sys
sys.path.insert(0, '.')
from benchmark import cell
cell.run(cell.resolve('bird_sa_nsga_penalty.fused16'), 1, 0.0, False, device='cpu')
"""
    p = _py(code, cwd=tmp_path)
    assert p.returncode != 0
    assert "cmoop_audio_processing_torch" in p.stderr


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, RUN] + ARGS, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
