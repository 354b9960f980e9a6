"""Pure-numpy float64 reference implementation of the audio frontend,
following librosa's documented conventions (librosa is not installed in this
image, so this module IS the bit-match oracle for the device kernels; its own
correctness is anchored to np.fft and closed-form filterbank identities in
tests).

Upstream of the reference repo, the precomputed features
(KWS_10_log_mel_3000 / mel_spec.h5; nsga_penalty.py:157,
sa_nsga_penalty.py:58) were produced with the standard librosa/TF stack:

* STFT: centered (reflect-padded n_fft//2), periodic Hann window of
  win_length zero-padded to n_fft, hop_length frames, n_fft//2+1 bins.
* mel filterbank: Slaney-style mel scale (linear < 1 kHz, log above),
  triangular filters, Slaney area normalization 2/(f[m+2]-f[m]).
* log-mel: power_to_db = 10*log10(max(S, amin)/max(ref, amin)), amin=1e-10,
  optional top_db floor at max - top_db.
* MFCC: DCT-II orthonormal over the mel axis, first n_mfcc coefficients.
"""

from __future__ import annotations

import numpy as np


def hann_periodic(win_length: int) -> np.ndarray:
    """Periodic (fftbins=True) Hann window."""
    n = np.arange(win_length)
    return 0.5 - 0.5 * np.cos(2 * np.pi * n / win_length)


def frame_signal(
    y: np.ndarray, n_fft: int, hop_length: int, center: bool = True
) -> np.ndarray:
    """(n_frames, n_fft) frame matrix with librosa's centering."""
    if center:
        y = np.pad(y, n_fft // 2, mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop_length
    idx = (
        np.arange(n_frames)[:, None] * hop_length + np.arange(n_fft)[None, :]
    )
    return y[idx]


def stft_power(
    y: np.ndarray,
    n_fft: int = 512,
    hop_length: int = 160,
    win_length: int | None = None,
    center: bool = True,
) -> np.ndarray:
    """Power spectrogram |STFT|^2, shape (n_frames, n_fft//2 + 1)."""
    win_length = win_length or n_fft
    window = hann_periodic(win_length)
    # pad window to n_fft (librosa util.pad_center)
    pad = n_fft - win_length
    window = np.pad(window, (pad // 2, pad - pad // 2))
    frames = frame_signal(y.astype(np.float64), n_fft, hop_length, center)
    spec = np.fft.rfft(frames * window, n=n_fft, axis=1)
    return np.abs(spec) ** 2


def hz_to_mel_slaney(f):
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mel = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):  # unselected branch at f == 0
        return np.where(
            f >= min_log_hz, min_log_mel + np.log(f / min_log_hz) / logstep, mel
        )


def mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), m * f_sp
    )


def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int = 40,
    fmin: float = 0.0,
    fmax: float | None = None,
    norm: str | None = "slaney",
) -> np.ndarray:
    """(n_mels, n_fft//2+1) triangular Slaney-mel filterbank."""
    fmax = fmax if fmax is not None else sr / 2
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = np.linspace(
        hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax), n_mels + 2
    )
    hz_pts = mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    weights = np.zeros((n_mels, len(fft_freqs)))
    for m in range(n_mels):
        lower = -ramps[m] / fdiff[m]
        upper = ramps[m + 2] / fdiff[m + 1]
        weights[m] = np.maximum(0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
        weights *= enorm[:, None]
    return weights


def power_to_db(
    s: np.ndarray,
    ref: float = 1.0,
    amin: float = 1e-10,
    top_db: float | None = 80.0,
) -> np.ndarray:
    log_spec = 10.0 * np.log10(np.maximum(amin, s))
    log_spec -= 10.0 * np.log10(np.maximum(amin, ref))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def dct_ortho_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) orthonormal DCT-II matrix (scipy.fft.dct norm='ortho')."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    mat = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in)) * np.sqrt(2.0 / n_in)
    mat[0] /= np.sqrt(2.0)
    return mat


def log_mel_spectrogram(
    y: np.ndarray,
    sr: int = 16000,
    n_fft: int = 512,
    hop_length: int = 160,
    n_mels: int = 40,
    fmin: float = 0.0,
    fmax: float | None = None,
    top_db: float | None = 80.0,
    log: str = "db",
) -> np.ndarray:
    """(n_frames, n_mels) log-mel features. log='db' (librosa power_to_db)
    or 'natural' (TF-style ln(mel + 1e-6))."""
    p = stft_power(y, n_fft, hop_length)
    mel = p @ mel_filterbank(sr, n_fft, n_mels, fmin, fmax).T
    if log == "db":
        return power_to_db(mel, ref=np.max(mel) if top_db is not None else 1.0,
                           top_db=top_db)
    if log == "natural":
        return np.log(mel + 1e-6)
    raise ValueError(f"unknown log mode {log!r}")


def mfcc(
    y: np.ndarray,
    sr: int = 16000,
    n_mfcc: int = 13,
    n_fft: int = 512,
    hop_length: int = 160,
    n_mels: int = 40,
) -> np.ndarray:
    """(n_frames, n_mfcc) MFCCs: DCT-II-ortho of dB log-mel (librosa
    feature.mfcc semantics with ref=1.0)."""
    p = stft_power(y, n_fft, hop_length)
    mel = p @ mel_filterbank(sr, n_fft, n_mels).T
    logmel = power_to_db(mel, ref=1.0, top_db=None)
    return logmel @ dct_ortho_matrix(n_mfcc, n_mels).T
