"""Waveform I/O without external audio libraries.

The reference's feature extraction ran upstream with librosa (not installed
here). For end-to-end ingestion we read PCM WAV via the stdlib ``wave``
module and provide polyphase-free high-quality resampling with a windowed-
sinc kernel applied as a strided matmul (soxr's role; clips are small, so
host numpy is enough). A copy of cmoop_audio_processing_tpu/frontend/
audio_io.py, which imports only numpy and the stdlib.
"""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a PCM WAV file -> (float32 mono waveform in [-1, 1], sr)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return data, sr


def save_wav(path: str, y: np.ndarray, sr: int) -> None:
    y16 = np.clip(y, -1.0, 1.0)
    y16 = (y16 * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(y16.tobytes())


def resample(y: np.ndarray, sr_in: int, sr_out: int, num_zeros: int = 32) -> np.ndarray:
    """Windowed-sinc resampling (Kaiser window), gcd-rational rates."""
    if sr_in == sr_out:
        return y.astype(np.float32)
    g = np.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    n_out = int(np.ceil(len(y) * up / down))
    # output sample t maps to input position t * down / up
    pos = np.arange(n_out) * (down / up)
    left = np.floor(pos).astype(int)
    cutoff = min(1.0, up / down)  # anti-alias when downsampling
    taps = np.arange(-num_zeros, num_zeros + 1)
    out = np.zeros(n_out, np.float64)
    ypad = np.pad(y.astype(np.float64), num_zeros + 1)
    frac = pos - left
    for i, t in enumerate(taps):
        x = (t - frac) * cutoff
        sinc = np.sinc(x)
        window = np.kaiser(2 * num_zeros + 1, 8.0)[i]
        out += sinc * window * cutoff * ypad[left + t + num_zeros + 1]
    return out.astype(np.float32)
