"""Audio frontend: wav -> frames -> DFT -> mel -> log / MFCC as matmuls.

Every stage after framing is a matrix product (GEMM-native DFT, no FFT):

    P[f, k] = (frames ⊙ window) @ [cos | -sin]     (T x n_fft)(n_fft x 2K)
    power   = P_cos^2 + P_sin^2                    elementwise
    mel     = power @ M^T                          (T x K)(K x n_mels)
    logmel  = 10 log10(clamp(mel))                 elementwise
    mfcc    = logmel @ D^T                         (T x n_mels)(n_mels x n_mfcc)

``stft_power``, ``log_mel`` and ``mfcc`` are the plain PyTorch version of
that chain, numerically held against frontend/reference_impl.py (librosa's
conventions). On a CUDA device the MFCC and log-mel chains each run as one
hand-written kernel (frontend/cuda_kernels.py, csrc/mfcc_fused.cu and
csrc/log_mel_fused.cu).

All GEMMs are full float32. cuBLAS matmuls already are by default, but the
flags are set explicitly because TF32 keeps ~3 decimal digits and breaks
the librosa match (the JAX package pins ``Precision.HIGHEST`` for the same
reason, cmoop_audio_processing_tpu/frontend/features.py:97-104).

Batched: all functions take (batch, samples) and give
(batch, n_frames, n_feats).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import full_f32, resolve_device
from . import reference_impl as ref


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    sr: int = 16000
    n_fft: int = 512
    hop_length: int = 160
    win_length: Optional[int] = None
    n_mels: int = 40
    n_mfcc: int = 13
    fmin: float = 0.0
    fmax: Optional[float] = None
    center: bool = True
    log: str = "db"  # "db" (librosa power_to_db) | "natural" (ln(mel+1e-6))
    top_db: Optional[float] = 80.0
    compute_dtype: str = "float32"

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    def n_frames(self, n_samples: int) -> int:
        # centred framing pads n_fft // 2 samples on each side: for an odd
        # n_fft that is n_fft - 1 in all, as the JAX package frames
        padded = n_samples + (2 * (self.n_fft // 2) if self.center else 0)
        return 1 + (padded - self.n_fft) // self.hop_length


def window(cfg: FrontendConfig) -> np.ndarray:
    """(n_fft,) float64 periodic Hann window of ``win_length`` samples,
    zero-padded to n_fft on both sides."""
    win_length = cfg.win_length or cfg.n_fft
    pad = cfg.n_fft - win_length
    return np.pad(ref.hann_periodic(win_length), (pad // 2, pad - pad // 2))


def dft_matrices(cfg: FrontendConfig) -> np.ndarray:
    """(n_fft, 2*n_bins) windowed real-DFT matrix [cos | -sin], window
    folded in so framing feeds the GEMM directly."""
    n = np.arange(cfg.n_fft)[:, None]
    k = np.arange(cfg.n_bins)[None, :]
    ang = 2.0 * np.pi * n * k / cfg.n_fft
    win = window(cfg)
    cos = np.cos(ang) * win[:, None]
    sin = -np.sin(ang) * win[:, None]
    return np.concatenate([cos, sin], axis=1).astype(np.float32)


def frame_indices(n_samples: int, cfg: FrontendConfig) -> np.ndarray:
    return (
        np.arange(cfg.n_frames(n_samples))[:, None] * cfg.hop_length
        + np.arange(cfg.n_fft)[None, :]
    )


def mel_matrix(cfg: FrontendConfig) -> np.ndarray:
    return ref.mel_filterbank(
        cfg.sr, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax
    ).astype(np.float32)


def dct_matrix(cfg: FrontendConfig) -> np.ndarray:
    """(n_mfcc, n_mels) orthonormal DCT-II."""
    return ref.dct_ortho_matrix(cfg.n_mfcc, cfg.n_mels).astype(np.float32)


def _operand(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def _frame(y: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """(batch, samples) -> (batch, n_frames, n_fft) with reflect centering
    (numpy's "reflect": the edge sample is not repeated)."""
    n_samples = y.shape[1]
    if cfg.center:
        pad = cfg.n_fft // 2
        y = F.pad(y[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    idx = torch.as_tensor(frame_indices(n_samples, cfg), device=y.device)
    return y[:, idx]


def stft_power(y: torch.Tensor, cfg: FrontendConfig = FrontendConfig()) -> torch.Tensor:
    """(batch, samples) -> (batch, n_frames, n_bins) power spectrogram."""
    full_f32()
    frames = _frame(y.float(), cfg)
    proj = frames @ _operand(dft_matrices(cfg), frames)
    re, im = proj[..., : cfg.n_bins], proj[..., cfg.n_bins :]
    return re * re + im * im


def _mel(y: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    p = stft_power(y, cfg)
    return p @ _operand(mel_matrix(cfg), p).T


def log_mel(y: torch.Tensor, cfg: FrontendConfig = FrontendConfig()) -> torch.Tensor:
    """(batch, samples) -> (batch, n_frames, n_mels) log-mel features."""
    mel = _mel(y, cfg)
    if cfg.log == "natural":
        return torch.log(mel + 1e-6)
    amin = 1e-10
    db = 10.0 * torch.log10(torch.clamp(mel, min=amin))
    if cfg.top_db is not None:
        # per-sample reference: max over that sample's spectrogram
        ref_db = 10.0 * torch.log10(
            torch.clamp(mel.amax(dim=(1, 2), keepdim=True), min=amin)
        )
        db = db - ref_db
        db = torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - cfg.top_db)
    return db


def mfcc(y: torch.Tensor, cfg: FrontendConfig = FrontendConfig()) -> torch.Tensor:
    """(batch, samples) -> (batch, n_frames, n_mfcc)."""
    mel = _mel(y, cfg)
    logmel = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    return logmel @ _operand(dct_matrix(cfg), logmel).T


def extract_features_device(
    wavs, cfg: FrontendConfig = FrontendConfig(), kind: str = "log_mel",
    device="cuda",
) -> torch.Tensor:
    """Like :func:`extract_features` but returns the device tensor without
    waiting for it, so the caller can overlap host work (decoding the next
    batch) with this batch's device work.

    On CUDA, ``kind="mfcc"`` and ``kind="log_mel"`` always run their fused
    kernels; on the CPU, ``log_mel`` is the plain GEMM chain."""
    dev = resolve_device(device)
    y = torch.as_tensor(np.atleast_2d(np.asarray(wavs, np.float32)), device=dev)
    if kind == "mfcc":
        from .cuda_kernels import mfcc_fused

        return mfcc_fused(y.contiguous(), cfg)
    if kind == "log_mel":
        if dev.type == "cuda":
            from .cuda_kernels import log_mel_fused

            return log_mel_fused(y.contiguous(), cfg)
        return log_mel(y, cfg)
    if kind == "stft_power":
        return stft_power(y, cfg)
    raise ValueError(f"unknown feature kind {kind!r}")


def extract_features(
    wavs, cfg: FrontendConfig = FrontendConfig(), kind: str = "log_mel",
    device="cuda",
) -> np.ndarray:
    """Host-facing batch API: (batch, samples) float waveforms ->
    (batch, n_frames, n_feats) features ready for the data pipeline."""
    return extract_features_device(wavs, cfg, kind, device).cpu().numpy()
