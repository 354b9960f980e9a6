"""Hand-written CUDA kernels of the audio frontend, and their plain versions.

* ``mfcc_fused`` replaces cmoop_audio_processing_tpu/frontend/
  pallas_kernels.py::mfcc_fused: the whole MFCC chain (windowed real DFT ->
  power -> mel -> 10*log10 -> orthonormal DCT-II) in one kernel,
  csrc/mfcc_fused.cu.
* ``log_mel_fused`` replaces pallas_kernels.py::log_mel_fused: the same
  chain up to the log (natural or dB) in one kernel, csrc/log_mel_fused.cu,
  then the per-sample ``top_db`` step as torch ops, as the JAX wrapper ran
  it in XLA after its Pallas call.

Both share their frame gather, DFT, power and mel stages
(csrc/mel_tile.cuh).

The kernels are compiled with nvcc for sm_90a into build/kernels/ at first
use, from the sources in this checkout, and bound through ctypes (plain C
entry points: no PyTorch headers, so a build takes seconds). Nothing is
built or loaded when this module is imported.

On a CPU tensor each wrapper computes its ``*_reference``, the plain
PyTorch version of the kernel's arithmetic (same reflected frame gather,
same GEMM chain); on a CUDA tensor it launches the kernel or raises.
``launch_counts`` counts kernel launches, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict

import numpy as np
import torch

from .features import FrontendConfig, dct_matrix, dft_matrices, mel_matrix

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
_DFT_DEPTH_TILE = 32  # csrc/mel_tile.cuh NC: n_fft must be a multiple

launch_counts: Dict[str, int] = {"mfcc_fused": 0, "log_mel_fused": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {home}/bin and on PATH); the CUDA "
            "kernels are built from source at first use"
        )
    return found


def source_digest(name: str) -> str:
    """Hash of csrc/<name>.cu, every header in csrc/ (the kernels include
    them) and the flags: what a built library must match."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    return digest.hexdigest()[:12]


def build_library(name: str, verbose: bool = False) -> str:
    """Compile csrc/<name>.cu into build/kernels/lib<name>_<hash>.so and
    return the path; an edited kernel or header gets a new ``source_digest``
    and is rebuilt. ``verbose`` adds ``-Xptxas -v`` and prints the
    compiler's report."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    out = os.path.join(BUILD_DIR, f"lib{name}_{source_digest(name)}.so")
    if os.path.exists(out) and not verbose:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) for {src}:\n{proc.stderr}"
        )
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _mfcc_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library("mfcc_fused"))
    lib.mfcc_fused_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    )
    lib.mfcc_fused_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _log_mel_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library("log_mel_fused"))
    lib.log_mel_fused_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    )
    lib.log_mel_fused_launch.restype = ctypes.c_int
    return lib


def _put(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


@functools.lru_cache(maxsize=16)
def _log_mel_operands(cfg: FrontendConfig, device: torch.device):
    """Device copies of the constant matrices both kernels take:
    [cos | -sin] with the window folded in (n_fft, 2*n_bins) and M^T
    (n_bins, n_mels)."""
    return _put(dft_matrices(cfg), device), _put(mel_matrix(cfg).T, device)


@functools.lru_cache(maxsize=16)
def _mfcc_operands(cfg: FrontendConfig, device: torch.device):
    """The log-mel operands plus D^T (n_mels, n_mfcc)."""
    return (*_log_mel_operands(cfg, device), _put(dct_matrix(cfg).T, device))


def _reflect_frames(y: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """(batch, samples) -> (batch * n_frames, n_fft): the kernel's gather.
    Frame t reads samples t*hop - n_fft/2 + n, reflected at both edges."""
    n_samples = y.shape[1]
    n_frames = cfg.n_frames(n_samples)
    pad = cfg.n_fft // 2 if cfg.center else 0
    j = (
        torch.arange(n_frames, device=y.device)[:, None] * cfg.hop_length
        + torch.arange(cfg.n_fft, device=y.device)[None, :] - pad
    )
    j = torch.where(j < 0, -j, j)
    j = torch.where(j >= n_samples, 2 * (n_samples - 1) - j, j)
    return y[:, j].reshape(-1, cfg.n_fft)


def mfcc_fused_reference(
    y: torch.Tensor, cfg: FrontendConfig = FrontendConfig()
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (batch, samples) ->
    (batch, n_frames, n_mfcc), full f32."""
    w, mel_t, dct_t = _mfcc_operands(cfg, y.device)
    frames = _reflect_frames(y.float(), cfg)
    proj = frames @ w
    re, im = proj[:, : cfg.n_bins], proj[:, cfg.n_bins :]
    mel = (re * re + im * im) @ mel_t
    out = (10.0 * torch.log10(torch.clamp(mel, min=1e-10))) @ dct_t
    return out.reshape(y.shape[0], -1, cfg.n_mfcc)


def _check_input(name: str, y: torch.Tensor, cfg: FrontendConfig) -> None:
    if y.dtype != torch.float32 or y.dim() != 2 or not y.is_contiguous():
        raise ValueError(
            f"{name} takes a contiguous float32 (batch, samples) tensor; "
            f"got {y.dtype} of shape {tuple(y.shape)}"
        )
    if cfg.n_fft % _DFT_DEPTH_TILE:
        raise ValueError(f"n_fft must be a multiple of {_DFT_DEPTH_TILE}")
    if cfg.center and y.shape[1] <= cfg.n_fft // 2:
        raise ValueError("centred framing needs more than n_fft/2 samples")
    if not cfg.center and y.shape[1] < cfg.n_fft:
        raise ValueError("uncentred framing needs at least n_fft samples")


def mfcc_fused(y: torch.Tensor, cfg: FrontendConfig = FrontendConfig()) -> torch.Tensor:
    """(batch, samples) -> (batch, n_frames, n_mfcc): the fused MFCC chain.
    CUDA tensor: the kernel. CPU tensor: ``mfcc_fused_reference``."""
    _check_input("mfcc_fused", y, cfg)
    if cfg.n_mfcc > cfg.n_mels:
        raise ValueError("n_mfcc must not exceed n_mels")
    if y.device.type == "cpu":
        return mfcc_fused_reference(y, cfg)
    if y.device.type != "cuda":
        raise ValueError(f"mfcc_fused: unsupported device {y.device}")
    lib = _mfcc_library()
    w, mel_t, dct_t = _mfcc_operands(cfg, y.device)
    batch, n_samples = y.shape
    n_frames = cfg.n_frames(n_samples)
    out = torch.empty((batch * n_frames, cfg.n_mfcc), dtype=torch.float32,
                      device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    err = lib.mfcc_fused_launch(
        y.data_ptr(), w.data_ptr(), mel_t.data_ptr(), dct_t.data_ptr(),
        out.data_ptr(), batch, n_samples, n_frames, cfg.n_fft, cfg.n_bins,
        cfg.hop_length, int(cfg.center), cfg.n_mels, cfg.n_mfcc, stream,
    )
    if err != 0:
        raise RuntimeError(f"mfcc_fused kernel launch failed: cudaError {err}")
    launch_counts["mfcc_fused"] += 1
    return out.view(batch, n_frames, cfg.n_mfcc)


def _top_db(out: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """The per-sample max-referenced dB step of the JAX wrapper
    (pallas_kernels.py:150-155), on (batch, n_frames, n_mels) raw dB. Once
    each clip's max is subtracted its max is exactly 0 (ref - ref = 0, every
    other element <= 0), so the wrapper's second max-referenced clamp is a
    clamp at -top_db: bit-identical, one reduction fewer."""
    if cfg.log == "db" and cfg.top_db is not None:
        out = (out - out.amax(dim=(1, 2), keepdim=True)).clamp_(min=-cfg.top_db)
    return out


def log_mel_fused_reference(
    y: torch.Tensor, cfg: FrontendConfig = FrontendConfig()
) -> torch.Tensor:
    """Plain PyTorch version of the kernel and its ``top_db`` step:
    (batch, samples) -> (batch, n_frames, n_mels), full f32."""
    w, mel_t = _log_mel_operands(cfg, y.device)
    frames = _reflect_frames(y.float(), cfg)
    proj = frames @ w
    re, im = proj[:, : cfg.n_bins], proj[:, cfg.n_bins :]
    mel = (re * re + im * im) @ mel_t
    if cfg.log == "natural":
        out = torch.log(mel + 1e-6)
    else:
        out = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    return _top_db(out.reshape(y.shape[0], -1, cfg.n_mels), cfg)


def log_mel_fused(y: torch.Tensor, cfg: FrontendConfig = FrontendConfig()) -> torch.Tensor:
    """(batch, samples) -> (batch, n_frames, n_mels): the fused log-mel
    chain. CUDA tensor: the kernel, then the ``top_db`` step. CPU tensor:
    ``log_mel_fused_reference``."""
    _check_input("log_mel_fused", y, cfg)
    if cfg.log not in ("db", "natural"):
        raise ValueError(f"unknown log mode {cfg.log!r}; use 'db' or 'natural'")
    if y.device.type == "cpu":
        return log_mel_fused_reference(y, cfg)
    if y.device.type != "cuda":
        raise ValueError(f"log_mel_fused: unsupported device {y.device}")
    lib = _log_mel_library()
    w, mel_t = _log_mel_operands(cfg, y.device)
    batch, n_samples = y.shape
    n_frames = cfg.n_frames(n_samples)
    out = torch.empty((batch * n_frames, cfg.n_mels), dtype=torch.float32,
                      device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    err = lib.log_mel_fused_launch(
        y.data_ptr(), w.data_ptr(), mel_t.data_ptr(), out.data_ptr(), batch,
        n_samples, n_frames, cfg.n_fft, cfg.n_bins, cfg.hop_length,
        int(cfg.center), cfg.n_mels, int(cfg.log == "natural"), stream,
    )
    if err != 0:
        raise RuntimeError(f"log_mel_fused kernel launch failed: cudaError {err}")
    launch_counts["log_mel_fused"] += 1
    return _top_db(out.view(batch, n_frames, cfg.n_mels), cfg)
