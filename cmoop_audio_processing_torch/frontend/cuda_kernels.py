"""Hand-written CUDA kernels of the audio frontend, and their plain versions.

* ``mfcc_fused`` replaces cmoop_audio_processing_tpu/frontend/
  pallas_kernels.py::mfcc_fused: the whole MFCC chain (windowed real DFT ->
  power -> mel -> 10*log10 -> orthonormal DCT-II) in one kernel,
  csrc/mfcc_fused.cu.
* ``log_mel_fused`` replaces pallas_kernels.py::log_mel_fused: the same
  chain up to the log (natural or dB) in one kernel, csrc/log_mel_fused.cu,
  then the per-sample ``top_db`` step.

Each kernel has two routes, chosen by ``dft_route(cfg.n_fft)``:

* ``"fft"`` — the n_fft of ``FFT_SIZES``: every even n_fft from 64 to 2048
  whose half N factors as 2^a 3^b 5^c into P points a lane (at most
  ``FFT_MAX_POINTS``) times Q lanes (``fft_plan``). A packed real FFT by a
  warp (the powers of two) or a group of Q lanes (the mixed-radix sizes,
  such as 320, 400 and 480), a sparse mel product over the filter bank's
  CSR form, frames of one clip per block (csrc/mel_fft.cuh).
  ``log_mel_fused``'s ``top_db`` step is a per-clip atomic max in the
  kernel and one in-place pass after it, in the same .cu;
* ``"dense"`` — every other n_fft (odd sizes, a prime factor above 5, or
  more than ``FFT_MAX_POINTS`` points a lane): a dense-GEMM DFT
  (csrc/mel_tile.cuh), with ``top_db`` as torch ops after it, as the JAX
  wrapper ran it in XLA.

The kernels are compiled with nvcc for sm_90a into build/kernels/ at first
use, from the sources in this checkout, and bound through ctypes (plain C
entry points: no PyTorch headers, so a build takes seconds). Nothing is
built or loaded when this module is imported.

On a CPU tensor each wrapper computes its ``*_reference``, the plain
PyTorch version of the kernel's arithmetic (same reflected frame gather,
same GEMM chain); on a CUDA tensor it launches the kernel or raises.
``launch_counts`` counts kernel launches and ``route_counts`` the same
launches by route, so a run can show that its main path went through the
kernel, and on which route.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .features import FrontendConfig, dct_matrix, dft_matrices, mel_matrix, window

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# complex points a lane holds in registers on the FFT route: the radix-2
# plan's most (n_fft 2048), which ptxas fits with 0 spills
FFT_MAX_POINTS = 32

launch_counts: Dict[str, int] = {"mfcc_fused": 0, "log_mel_fused": 0}
route_counts: Dict[str, int] = {
    f"{name}/{route}": 0 for name in launch_counts for route in ("fft", "dense")
}


def reset_launch_counts() -> None:
    for counts in (launch_counts, route_counts):
        for name in counts:
            counts[name] = 0


def _count(name: str, route: str) -> None:
    launch_counts[name] += 1
    route_counts[f"{name}/{route}"] += 1


def fft_plan(n_fft: int) -> Optional[Tuple[int, int]]:
    """(P, Q) of the FFT route for ``n_fft``, with N = n_fft / 2 = P * Q: Q
    the largest power of two dividing N, at most 32 (the lanes that take
    one frame), P the points each lane holds; None where the route does not
    take n_fft (odd, outside 64..2048, P not 2^a 3^b 5^c, or P above
    ``FFT_MAX_POINTS``). P a power of two is the radix-2 plan (Q = 32)."""
    if n_fft % 2 or not 64 <= n_fft <= 2048:
        return None
    half = n_fft // 2
    q = min(half & -half, 32)
    p = rest = half // q
    for f in (2, 3, 5):
        while rest % f == 0:
            rest //= f
    return (p, q) if rest == 1 and p <= FFT_MAX_POINTS else None


# the n_fft the FFT route is built for: csrc/mel_fft.cuh with_plan lists
# the same sizes, each with its P
FFT_SIZES = tuple(n for n in range(64, 2049, 2) if fft_plan(n))


def first_radix(length: int) -> int:
    """The first stage's radix of the mixed plan's ``length``-point FFT in
    registers (csrc/mel_fft.cuh first_radix): 5, then 3, then 4, then 2."""
    for r in (5, 3, 4, 2):
        if length % r == 0:
            return r
    raise ValueError(f"{length} is not 2^a 3^b 5^c")


def dif_order(length: int, pos: int) -> int:
    """The frequency that register ``pos`` holds after the mixed plan's
    ``length``-point decimation-in-frequency FFT (csrc/mel_fft.cuh
    dif_order)."""
    if length == 1:
        return 0
    r = first_radix(length)
    m = length // r
    return r * dif_order(m, pos % m) + pos // m


def dft_route(n_fft: int) -> str:
    """The kernels' route for ``n_fft``: "fft" for the sizes of
    ``FFT_SIZES`` (csrc/mel_fft.cuh), "dense" for any other
    (csrc/mel_tile.cuh)."""
    return "fft" if fft_plan(n_fft) else "dense"


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


def _compile(name: str, extra=()) -> tuple:
    """nvcc csrc/<name>.cu into build/kernels/lib<name>_<hash>.so; returns
    (path, the compiler's messages)."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    out = os.path.join(BUILD_DIR, f"lib{name}_{source_digest(name)}.so")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *extra, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) for {src}:\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out, proc.stderr


def build_library(name: str) -> str:
    """Compile csrc/<name>.cu into build/kernels/lib<name>_<hash>.so unless
    it is there, and return the path; an edited kernel or header gets a new
    ``source_digest`` and is rebuilt."""
    out = os.path.join(BUILD_DIR, f"lib{name}_{source_digest(name)}.so")
    return out if os.path.exists(out) else _compile(name)[0]


def ptxas_report(name: str) -> str:
    """Build csrc/<name>.cu (as ``build_library``) with ``-Xptxas -v`` and
    return ptxas's report: each kernel function's registers and spills."""
    return _compile(name, ("-Xptxas", "-v"))[1]


def kernel_function(mangled: str) -> str:
    """'name<arg>' of a mangled kernel function: the <length><name> part
    that names a *_kernel, and its integer template argument, if any."""
    for i in range(len(mangled)):
        m = re.match(r"(\d+)(\w+?_kernel)(IL[a-z](\d+)E)?", mangled[i:])
        if m and int(m.group(1)) == len(m.group(2)):
            return f"{m.group(2)}<{m.group(4)}>" if m.group(4) else m.group(2)
    return mangled


def ptxas_summary(report: str):
    """(kernel function, registers, stack frame bytes, spill store bytes,
    spill load bytes) for each entry function in a ``ptxas_report``."""
    rows, name, frame = [], None, (0, 0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_function(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            frame = tuple(int(g) for g in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *frame))
            name, frame = None, (0, 0, 0)
    return rows


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# each library's C entry points and their argument types (all return int);
# lane_adam is the trainer's (engine/lane_adam.py)
_ENTRY_POINTS = {
    "mfcc_fused": {
        "mfcc_fused_launch": [_P] * 5 + [_I] * 9 + [_P],
        "mfcc_fft_launch": [_P] * 6 + [_I] * 9 + [_P],
    },
    "log_mel_fused": {
        "log_mel_fused_launch": [_P] * 4 + [_I] * 9 + [_P],
        "log_mel_fft_launch": [_P] * 6 + [_I] * 9 + [ctypes.c_float, _P],
    },
    "lane_adam": {
        "lane_adam_launch": [_P, _I] + [_P] * 6 + [_L] + [_F] * 6 + [_P],
    },
}


def load_library(name: str, path: str) -> ctypes.CDLL:
    """The built library of kernel ``name`` at ``path``, its entry points
    typed."""
    lib = ctypes.CDLL(path)
    for fn, argtypes in _ENTRY_POINTS[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    return load_library(name, build_library(name))


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


def bitrev(v: int, bits: int) -> int:
    return int(format(v, f"0{bits}b")[::-1], 2) if bits else 0


def fft_tables(cfg: FrontendConfig) -> np.ndarray:
    """The FFT route's constant table, float32, computed in float64, with
    N = n_fft / 2 = P * Q (``fft_plan``) and W_M = exp(-2*pi*i/M)
    (csrc/mel_fft.cuh table_floats), all but the window as (re, im) pairs:

    * radix 2 (P a power of two, Q = 32): window (n_fft) | W_N^j, j < N |
      W_n_fft^k, k <= N/2 | W_N^(lane * bitrev(r)) at [r][lane] for the P
      registers r and 32 lanes;
    * mixed radix: window (n_fft) | W_N^j, j < N | W_N^(l * k1(r)) at
      [r][l] | W_n_fft^(k1(r) + P * bitrev_Q(l)) at [r][l], for the P
      registers r and Q lanes l, where k1(r) = ``dif_order(P, r)`` is the
      frequency register r holds after the in-register FFT; the last two
      are what lane l reads at step r (consecutive over a group's lanes:
      conflict-free)."""
    plan = fft_plan(cfg.n_fft)
    if plan is None:
        raise ValueError(f"the FFT route does not take n_fft {cfg.n_fft}")
    p, q = plan
    half = cfg.n_fft // 2

    def pairs(turns):
        angles = 2.0 * np.pi * np.asarray(turns, np.float64).ravel()
        return np.stack([np.cos(angles), -np.sin(angles)], axis=1).ravel()

    head = [window(cfg), pairs(np.arange(half) / half)]
    if p & (p - 1) == 0:
        rev = [bitrev(r, p.bit_length() - 1) for r in range(p)]
        tail = [pairs(np.arange(half // 2 + 1) / cfg.n_fft),
                pairs(np.outer(rev, np.arange(32)) / half)]
    else:
        k1 = np.array([dif_order(p, r) for r in range(p)])
        k2 = np.array([bitrev(l, q.bit_length() - 1) for l in range(q)])
        tail = [pairs(np.outer(k1, np.arange(q)) / half),
                pairs((k1[:, None] + p * k2[None, :]) / cfg.n_fft)]
    return np.concatenate(head + tail).astype(np.float32)


def mel_csr(cfg: FrontendConfig):
    """The filter bank ``mel_matrix(cfg)`` (n_mels, n_bins) in the FFT
    route's sparse form: ``csr`` (4, n_mels) int32 holds each band's first
    bin, bin count and offset into ``weights`` (the float32 values of the
    band's bins from its first nonzero to its last; an empty band has count
    0), then the bands longest first, the order in which the kernel's warps
    take them."""
    m = mel_matrix(cfg)
    csr = np.zeros((4, cfg.n_mels), np.int32)
    bands, offset = [], 0
    for i, row in enumerate(m):
        nz = np.flatnonzero(row)
        if len(nz):
            bands.append(row[nz[0]:nz[-1] + 1])
            csr[:3, i] = nz[0], len(bands[-1]), offset
            offset += len(bands[-1])
    csr[3] = np.argsort(-csr[1], kind="stable")
    return csr, np.concatenate(bands or [np.zeros(0, np.float32)])


@functools.lru_cache(maxsize=16)
def _fft_operands(cfg: FrontendConfig, device: torch.device):
    """Device copies of the FFT route's constants: the table, the CSR mel
    bank (index, weights) and D^T (n_mels, n_mfcc)."""
    csr, weights = mel_csr(cfg)
    return (_put(fft_tables(cfg), device), _put(csr, device),
            _put(weights, device), _put(dct_matrix(cfg).T, device))


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
    if cfg.center and y.shape[1] <= cfg.n_fft // 2:
        raise ValueError("centred framing needs more than n_fft/2 samples")
    if not cfg.center and y.shape[1] < cfg.n_fft:
        raise ValueError("uncentred framing needs at least n_fft samples")


def mfcc_fused(y: torch.Tensor, cfg: FrontendConfig = FrontendConfig()) -> torch.Tensor:
    """(batch, samples) -> (batch, n_frames, n_mfcc): the fused MFCC chain.
    CUDA tensor: the kernel of ``dft_route(cfg.n_fft)``. CPU tensor:
    ``mfcc_fused_reference``."""
    _check_input("mfcc_fused", y, cfg)
    if cfg.n_mfcc > cfg.n_mels:
        raise ValueError("n_mfcc must not exceed n_mels")
    if y.device.type == "cpu":
        return mfcc_fused_reference(y, cfg)
    if y.device.type != "cuda":
        raise ValueError(f"mfcc_fused: unsupported device {y.device}")
    return _mfcc_launch(_library("mfcc_fused"), y, cfg)


def _mfcc_launch(lib: ctypes.CDLL, y: torch.Tensor,
                 cfg: FrontendConfig) -> torch.Tensor:
    """``mfcc_fused`` on a checked CUDA tensor, through ``lib``."""
    batch, n_samples = y.shape
    n_frames = cfg.n_frames(n_samples)
    out = torch.empty((batch * n_frames, cfg.n_mfcc), dtype=torch.float32,
                      device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    route = dft_route(cfg.n_fft)
    if route == "fft":
        tables, csr, weights, dct_t = _fft_operands(cfg, y.device)
        err = lib.mfcc_fft_launch(
            y.data_ptr(), tables.data_ptr(), csr.data_ptr(), weights.data_ptr(),
            dct_t.data_ptr(), out.data_ptr(), batch, n_samples, n_frames,
            cfg.n_fft, cfg.hop_length, int(cfg.center), cfg.n_mels,
            weights.numel(), cfg.n_mfcc, stream,
        )
    else:
        w, mel_t, dct_t = _mfcc_operands(cfg, y.device)
        err = lib.mfcc_fused_launch(
            y.data_ptr(), w.data_ptr(), mel_t.data_ptr(), dct_t.data_ptr(),
            out.data_ptr(), batch, n_samples, n_frames, cfg.n_fft, cfg.n_bins,
            cfg.hop_length, int(cfg.center), cfg.n_mels, cfg.n_mfcc, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"mfcc_fused ({route} route) kernel launch failed: cudaError {err}")
    _count("mfcc_fused", route)
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
    chain and its ``top_db`` step. CUDA tensor: the kernel of
    ``dft_route(cfg.n_fft)``. CPU tensor: ``log_mel_fused_reference``."""
    _check_input("log_mel_fused", y, cfg)
    if cfg.log not in ("db", "natural"):
        raise ValueError(f"unknown log mode {cfg.log!r}; use 'db' or 'natural'")
    if y.device.type == "cpu":
        return log_mel_fused_reference(y, cfg)
    if y.device.type != "cuda":
        raise ValueError(f"log_mel_fused: unsupported device {y.device}")
    return _log_mel_launch(_library("log_mel_fused"), y, cfg)


def _log_mel_launch(lib: ctypes.CDLL, y: torch.Tensor,
                    cfg: FrontendConfig) -> torch.Tensor:
    """``log_mel_fused`` on a checked CUDA tensor, through ``lib``."""
    batch, n_samples = y.shape
    n_frames = cfg.n_frames(n_samples)
    out = torch.empty((batch * n_frames, cfg.n_mels), dtype=torch.float32,
                      device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    route = dft_route(cfg.n_fft)
    if route == "fft":
        tables, csr, weights, _ = _fft_operands(cfg, y.device)
        top_db = cfg.log == "db" and cfg.top_db is not None
        clip_max = torch.empty(batch if top_db else 0, dtype=torch.int32,
                               device=y.device)
        err = lib.log_mel_fft_launch(
            y.data_ptr(), tables.data_ptr(), csr.data_ptr(), weights.data_ptr(),
            out.data_ptr(), clip_max.data_ptr(), batch, n_samples, n_frames,
            cfg.n_fft, cfg.hop_length, int(cfg.center), cfg.n_mels,
            weights.numel(), 0 if cfg.log == "natural" else 1 + int(top_db),
            -cfg.top_db if top_db else 0.0, stream,
        )
    else:
        w, mel_t = _log_mel_operands(cfg, y.device)
        err = lib.log_mel_fused_launch(
            y.data_ptr(), w.data_ptr(), mel_t.data_ptr(), out.data_ptr(), batch,
            n_samples, n_frames, cfg.n_fft, cfg.n_bins, cfg.hop_length,
            int(cfg.center), cfg.n_mels, int(cfg.log == "natural"), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"log_mel_fused ({route} route) kernel launch failed: cudaError {err}")
    _count("log_mel_fused", route)
    out = out.view(batch, n_frames, cfg.n_mels)
    return out if route == "fft" else _top_db(out, cfg)
