"""The PyTorch port's last host modules against the JAX package's: the
native HV core (native/hv.cpp, built by native/build.py into a temporary
directory here) against the port's numpy HV and JAX's ``hypervolume`` on
seeded 2-D and 3-D fronts (tests/test_metrics.py's 1e-14 relative); the GP
kernels ``rbf`` and ``scaled_matern_white`` against JAX's
(tests/test_torch_surrogate.py's f32 tolerance); utils/profiling (the
cases of tests/test_profiling.py, on torch.profiler); and the ops index:
JAX's names, each the port's function, held against JAX's ops, and an
import that builds and loads no kernel."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmoop_audio_processing_torch import ops as tops
from cmoop_audio_processing_torch.frontend import cuda_kernels
from cmoop_audio_processing_torch.metrics import hypervolume as TH
from cmoop_audio_processing_torch.native import build as tbuild
from cmoop_audio_processing_torch.surrogate import kernels as TK
from cmoop_audio_processing_torch.utils import profiling as tprof
from cmoop_audio_processing_tpu import ops as jops
from cmoop_audio_processing_tpu.metrics import hypervolume as JH
from cmoop_audio_processing_tpu.surrogate import kernels as JK

# the test workers share the CPU's cores: one intra-op thread per worker
# keeps PyTorch's thread pool from oversubscribing them
torch.set_num_threads(1)

GP_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def native_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("native")
    if not tbuild.build(out_dir=str(out)):
        pytest.skip("no native toolchain (g++)")
    return out


@pytest.mark.parametrize("d", [2, 3])
def test_native_hv_equals_numpy_and_jax(native_dir, monkeypatch, d):
    """With the library loaded, ``hypervolume`` runs the C++ core on 2-D
    and 3-D fronts; it equals the port's numpy sweep and JAX's
    ``hypervolume`` within 1e-14 relative."""
    lib = TH.open_native(str(native_dir / "libhv.so"))
    assert lib is not None
    monkeypatch.setattr(TH, "_NATIVE", lib)
    monkeypatch.setattr(TH, "_NATIVE_TRIED", True)
    assert TH.core() == "native"
    rng = np.random.default_rng(11 + d)
    for _ in range(20):
        pts = rng.random((int(rng.integers(1, 40)), d))
        ref = np.ones(d) * (1.0 + rng.random())
        got = TH.hypervolume(pts, ref)
        plain = {2: TH._hv2d, 3: TH._hv3d}[d](pts, ref)
        assert got == pytest.approx(plain, rel=1e-14, abs=1e-15)
        assert got == pytest.approx(JH.hypervolume(pts, ref), rel=1e-14,
                                    abs=1e-15)


def test_native_build_is_idempotent_and_the_core_optional(native_dir,
                                                          monkeypatch):
    """A second build leaves a library newer than its source alone; the
    default path is build/native/libhv.so at the checkout's root; without
    a library there the numpy code runs."""
    lib = native_dir / "libhv.so"
    before = os.path.getmtime(lib)
    assert tbuild.build(out_dir=str(native_dir))
    assert os.path.getmtime(lib) == before
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert tbuild.HV_LIB == os.path.join(root, "build", "native", "libhv.so")
    monkeypatch.setattr(TH, "HV_LIB", str(native_dir / "missing.so"))
    monkeypatch.setattr(TH, "_NATIVE", None)
    monkeypatch.setattr(TH, "_NATIVE_TRIED", False)
    assert TH.core() == "numpy"
    pts = np.array([[0.2, 0.5], [0.4, 0.1]])
    assert TH.hypervolume(pts, np.ones(2)) == TH._hv2d(pts, np.ones(2))


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
def test_rbf_and_scaled_matern_white_equal_jax(nu):
    """Gram matrices of the same f32 inputs and log-hyperparameters, with
    and without the white term, square and cross."""
    rng = np.random.default_rng(int(10 * nu))
    xa = rng.random((7, 4)).astype(np.float32)
    xb = rng.random((5, 4)).astype(np.float32)
    for a, b in ((xa, xa), (xa, xb)):
        ta, tb = torch.as_tensor(a), torch.as_tensor(b)
        for diag in (True, False):
            got = TK.scaled_matern_white(ta, tb, 0.3, -0.2, -2.0, nu, diag)
            want = JK.scaled_matern_white(a, b, 0.3, -0.2, -2.0, nu, diag)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **GP_TOL)
        got = TK.scaled_matern_white(ta, tb, torch.tensor(0.3),
                                     torch.tensor(-0.2), torch.tensor(-2.0), nu)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(JK.scaled_matern_white(
                a, b, 0.3, -0.2, -2.0, nu)), **GP_TOL)
        np.testing.assert_allclose(TK.rbf(ta, tb, 0.1 + nu).numpy(),
                                   np.asarray(JK.rbf(a, b, 0.1 + nu)), **GP_TOL)


def test_trace_noop_without_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("CMOOP_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with tprof.trace("stage"):
        x = 1 + 1
    assert x == 2
    assert not any(tmp_path.iterdir())


def test_trace_writes_profile(tmp_path, monkeypatch):
    """With a trace dir (argument or CMOOP_TRACE_DIR) the stage's Chrome
    trace is written, holding the stage and the annotated region."""
    monkeypatch.setenv("CMOOP_TRACE_DIR", str(tmp_path / "env"))
    for where, kw in ((tmp_path / "arg", dict(trace_dir=str(tmp_path / "arg"))),
                      (tmp_path / "env", {})):
        with tprof.trace("stage", **kw):
            with tprof.annotate("inner"):
                torch.ones(4).sum()
        with open(where / "stage.json") as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert {"stage", "inner"} <= names, sorted(map(str, names))[:20]


def test_device_memory_stats_shape():
    """One entry per visible CUDA device, keyed as ``str(torch.device)``,
    with the allocator's counters; none without a GPU (the JAX package
    lists its CPU device there)."""
    stats = tprof.device_memory_stats()
    assert isinstance(stats, dict)
    if not torch.cuda.is_available():
        assert stats == {}
        return
    assert sorted(stats) == [f"cuda:{i}" for i in
                             range(torch.cuda.device_count())]
    assert all("allocated_bytes.all.current" in s for s in stats.values())


def test_ops_index_names_the_jax_surface_and_builds_nothing():
    """The index exports JAX's names, each the port's own function, and
    importing it compiled and loaded no kernel."""
    assert tops.__all__ == jops.__all__
    homes = {"log_mel_fused": cuda_kernels, "mfcc_fused": cuda_kernels,
             "rbf": TK, "scaled_matern_white": TK, "matern": TK, "sqdist": TK}
    for name in tops.__all__:
        fn = getattr(tops, name)
        assert callable(fn) and fn.__module__.startswith(
            "cmoop_audio_processing_torch."), name
        if name in homes:
            assert fn is getattr(homes[name], name)
    assert cuda_kernels._library.cache_info().currsize == 0


@pytest.mark.parametrize("name", ["sqdist", "matern", "rbf",
                                  "scaled_matern_white"])
def test_ops_gp_kernels_equal_jax_ops(name):
    rng = np.random.default_rng(3)
    xa = rng.random((6, 3)).astype(np.float32)
    xb = rng.random((4, 3)).astype(np.float32)
    args = {"sqdist": (), "matern": (0.7,), "rbf": (0.7,),
            "scaled_matern_white": (0.1, -0.3, -1.5)}[name]
    got = getattr(tops, name)(torch.as_tensor(xa), torch.as_tensor(xb), *args)
    want = getattr(jops, name)(jnp.asarray(xa), jnp.asarray(xb), *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GP_TOL)
