"""Hand-written CUDA kernels of the audio frontend, and their plain versions.

``mfcc_fused`` replaces cmoop_audio_processing_tpu/frontend/pallas_kernels.py
::mfcc_fused: the whole MFCC chain (windowed real DFT -> power -> mel ->
10*log10 -> orthonormal DCT-II) in one kernel, csrc/mfcc_fused.cu, whose
header states what bounds it on an H100 (f32 CUDA-core arithmetic, ~548
kFLOP against ~1.5 KB per KWS frame) and what the design does about it.

The kernel is compiled with nvcc for sm_90a into build/kernels/ at first
use, from the sources in this checkout, and bound through ctypes (a plain
C entry point: no PyTorch headers, so the build takes seconds). Nothing is
built or loaded when this module is imported.

``mfcc_fused`` on a CPU tensor computes ``mfcc_fused_reference``, the plain
PyTorch version of the kernel's arithmetic (same reflected frame gather,
same GEMM chain); on a CUDA tensor it launches the kernel or raises.
``launch_counts`` counts kernel launches, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
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
_DFT_DEPTH_TILE = 32  # csrc/mfcc_fused.cu NC: n_fft must be a multiple

launch_counts: Dict[str, int] = {"mfcc_fused": 0}


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


def build_library(name: str, verbose: bool = False) -> str:
    """Compile csrc/<name>.cu into build/kernels/lib<name>_<hash>.so (the
    hash of the source, so an edited kernel is rebuilt) and return the path.
    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")
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


@functools.lru_cache(maxsize=16)
def _mfcc_operands(cfg: FrontendConfig, device: torch.device):
    """Device copies of the kernel's constant matrices: [cos | -sin] with
    the window folded in (n_fft, 2*n_bins), M^T (n_bins, n_mels) and D^T
    (n_mels, n_mfcc)."""
    def put(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return (put(dft_matrices(cfg)), put(mel_matrix(cfg).T),
            put(dct_matrix(cfg).T))


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


def _check_mfcc_input(y: torch.Tensor, cfg: FrontendConfig) -> None:
    if y.dtype != torch.float32 or y.dim() != 2 or not y.is_contiguous():
        raise ValueError(
            "mfcc_fused takes a contiguous float32 (batch, samples) tensor; "
            f"got {y.dtype} of shape {tuple(y.shape)}"
        )
    if cfg.n_fft % _DFT_DEPTH_TILE:
        raise ValueError(f"n_fft must be a multiple of {_DFT_DEPTH_TILE}")
    if cfg.center and y.shape[1] <= cfg.n_fft // 2:
        raise ValueError("centred framing needs more than n_fft/2 samples")
    if not cfg.center and y.shape[1] < cfg.n_fft:
        raise ValueError("uncentred framing needs at least n_fft samples")
    if cfg.n_mfcc > cfg.n_mels:
        raise ValueError("n_mfcc must not exceed n_mels")


def mfcc_fused(y: torch.Tensor, cfg: FrontendConfig = FrontendConfig()) -> torch.Tensor:
    """(batch, samples) -> (batch, n_frames, n_mfcc): the fused MFCC chain.
    CUDA tensor: the kernel. CPU tensor: ``mfcc_fused_reference``."""
    _check_mfcc_input(y, cfg)
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
