"""The PyTorch port's audio frontend against the JAX package and the numpy
float64 oracle: the plain torch GEMM path (features.*) and the fused MFCC
kernel's plain version (cuda_kernels.mfcc_fused_reference), which the CUDA
kernel is held against on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from cmoop_audio_processing_torch.frontend import cuda_kernels as tk
from cmoop_audio_processing_torch.frontend import features as tf
from cmoop_audio_processing_tpu.frontend import features as jf
from cmoop_audio_processing_tpu.frontend import reference_impl as ref
from cmoop_audio_processing_tpu.frontend.pallas_kernels import mfcc_fused

# the test workers share the CPU's cores: one intra-op thread per worker
# keeps PyTorch's thread pool from oversubscribing them
torch.set_num_threads(1)

CFG = dict(sr=16000, n_fft=512, hop_length=160, n_mels=40, n_mfcc=13)
KWS = dict(CFG, hop_length=360)  # 1-s clip -> 45 frames


def tone(freq, sr=16000, dur=1.0, amp=0.5):
    t = np.arange(int(sr * dur)) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _signals():
    rng = np.random.default_rng(7)
    return np.stack([
        tone(440),
        tone(3000, amp=0.3) + tone(150, amp=0.2),
        rng.standard_normal(16000).astype(np.float32) * 0.1,
    ])


def _birdclef_signals():
    rng = np.random.default_rng(3)
    return np.stack([
        tone(700, dur=5.0) + rng.standard_normal(80000).astype(np.float32) * 0.05,
        tone(2100, dur=5.0) * 0.2,
        rng.standard_normal(80000).astype(np.float32),
    ])


def _port(fn, ys, **cfg):
    return fn(torch.as_tensor(ys), tf.FrontendConfig(**cfg)).numpy()


def test_stft_power_matches_reference_and_jax():
    ys = _signals()
    got = _port(tf.stft_power, ys, **CFG)
    for i, y in enumerate(ys):
        want = ref.stft_power(y, CFG["n_fft"], CFG["hop_length"])
        np.testing.assert_allclose(got[i], want, rtol=2e-3, atol=2e-4)
    jax_out = np.asarray(jf.stft_power(ys, jf.FrontendConfig(**CFG)))
    np.testing.assert_allclose(got, jax_out, rtol=2e-3, atol=2e-4)


def test_log_mel_matches_reference_and_jax():
    ys = _signals()
    got = _port(tf.log_mel, ys, **CFG)
    for i, y in enumerate(ys):
        want = ref.log_mel_spectrogram(
            y, CFG["sr"], CFG["n_fft"], CFG["hop_length"], CFG["n_mels"],
            top_db=80.0,
        )
        np.testing.assert_allclose(got[i], want, atol=2e-2)
    jax_out = np.asarray(jf.log_mel(ys, jf.FrontendConfig(**CFG)))
    np.testing.assert_allclose(got, jax_out, atol=2e-2)


def test_natural_log_mel_matches_jax():
    ys = _signals()
    got = _port(tf.log_mel, ys, **CFG, log="natural")
    want = np.asarray(jf.log_mel(ys, jf.FrontendConfig(**CFG, log="natural")))
    np.testing.assert_allclose(got, want, atol=2e-2)


@pytest.mark.parametrize("cfg", [CFG, KWS], ids=["hop160", "kws_hop360"])
def test_mfcc_matches_reference_and_jax(cfg):
    ys = _signals()
    got = _port(tf.mfcc, ys, **cfg)
    for i, y in enumerate(ys):
        want = ref.mfcc(y, cfg["sr"], cfg["n_mfcc"], cfg["n_fft"],
                        cfg["hop_length"], cfg["n_mels"])
        np.testing.assert_allclose(got[i], want, atol=3e-2)
    jax_out = np.asarray(jf.mfcc(ys, jf.FrontendConfig(**cfg)))
    np.testing.assert_allclose(got, jax_out, atol=3e-2)


@pytest.mark.parametrize(
    "signals,cfg,frames",
    [(_signals, CFG, 101), (_signals, KWS, 45), (_birdclef_signals, CFG, 501)],
    ids=["default", "kws_hop360", "birdclef_3x80000"],
)
def test_mfcc_fused_reference_matches_pallas_mfcc_fused(signals, cfg, frames):
    """The kernel's plain version against the Pallas kernel (interpret mode
    on the CPU). At 3x80000, frames of different clips share the TPU
    kernel's 128-row tiles and the CUDA kernel's 64-frame blocks."""
    ys = signals()
    got = _port(tk.mfcc_fused_reference, ys, **cfg)
    want = np.asarray(mfcc_fused(ys, jf.FrontendConfig(**cfg)))
    assert got.shape == want.shape == (len(ys), frames, cfg["n_mfcc"])
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=1e-3)


def test_mfcc_fused_reference_uncentred_matches_jax():
    ys = _signals()
    cfg = dict(KWS, center=False)
    got = _port(tk.mfcc_fused_reference, ys, **cfg)
    want = np.asarray(jf.mfcc(ys, jf.FrontendConfig(**cfg)))
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=1e-3)


def test_kernel_gather_equals_reflect_pad_framing():
    """The kernel's index arithmetic (reflect at both edges) is numpy's
    'reflect' padding followed by framing, bit for bit."""
    y = torch.as_tensor(np.random.default_rng(1).standard_normal((2, 1000)),
                        dtype=torch.float32)
    cfg = tf.FrontendConfig(hop_length=360)
    frames = tk._reflect_frames(y, cfg).view(2, -1, cfg.n_fft)
    torch.testing.assert_close(frames, tf._frame(y, cfg), rtol=0, atol=0)


def test_extract_features_cpu_runs_the_plain_version_without_launching():
    ys = _signals()
    tk.reset_launch_counts()
    got = tf.extract_features(ys, tf.FrontendConfig(**KWS), kind="mfcc",
                              device="cpu")
    assert tk.launch_counts["mfcc_fused"] == 0
    want = _port(tk.mfcc_fused_reference, ys, **KWS)
    np.testing.assert_array_equal(got, want)
    lm = tf.extract_features(ys, tf.FrontendConfig(**CFG), kind="log_mel",
                             device="cpu")
    assert lm.shape == (3, 101, 40)


def test_extract_features_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.extract_features(_signals(), kind="mfcc")


@pytest.mark.parametrize("bad", ["float64", "1d", "short"])
def test_mfcc_fused_rejects_inputs_the_kernel_does_not_take(bad):
    y = torch.zeros(2, 16000)
    if bad == "float64":
        y = y.double()
    elif bad == "1d":
        y = y[0]
    else:
        y = y[:, :200]
    with pytest.raises(ValueError):
        tk.mfcc_fused(y, tf.FrontendConfig())
