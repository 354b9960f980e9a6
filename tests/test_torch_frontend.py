"""The PyTorch port's audio frontend against the JAX package and the numpy
float64 oracle: the plain torch GEMM path (features.*) and the fused
kernels' plain versions (cuda_kernels.mfcc_fused_reference,
cuda_kernels.log_mel_fused_reference), which the CUDA kernels are held
against on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from cmoop_audio_processing_torch.frontend import cuda_kernels as tk
from cmoop_audio_processing_torch.frontend import features as tf
from cmoop_audio_processing_tpu.frontend import features as jf
from cmoop_audio_processing_tpu.frontend import reference_impl as ref
from cmoop_audio_processing_tpu.frontend.pallas_kernels import (
    log_mel_fused,
    mfcc_fused,
)

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


@pytest.mark.parametrize("log,atol", [("natural", 2e-3), ("db", 2e-2)])
def test_log_mel_fused_reference_matches_pallas_log_mel_fused(log, atol):
    """The kernel's plain version against the Pallas kernel (interpret mode
    on the CPU), at test_frontend.py's Pallas-vs-XLA tolerances."""
    ys = _signals()
    got = _port(tk.log_mel_fused_reference, ys, **CFG, log=log)
    want = np.asarray(log_mel_fused(ys, jf.FrontendConfig(**CFG, log=log)))
    assert got.shape == want.shape == (3, 101, 40)
    np.testing.assert_allclose(got, want, atol=atol)


def test_log_mel_fused_reference_matches_jax_log_mel_at_birdclef_shape():
    """3 x 80000 samples -> 501 frames each: frames of different clips share
    the CUDA kernel's 64-frame blocks, and the per-sample top_db step must
    reference each clip's own maximum."""
    ys = _birdclef_signals()
    cfg = dict(CFG, log="db", top_db=80.0)
    got = _port(tk.log_mel_fused_reference, ys, **cfg)
    want = np.asarray(jf.log_mel(ys, jf.FrontendConfig(**cfg)))
    assert got.shape == want.shape == (3, 501, 40)
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=1e-3)


def test_wav_io_matches_the_jax_packages(tmp_path):
    from cmoop_audio_processing_torch.frontend import audio_io as tio
    from cmoop_audio_processing_tpu.frontend import audio_io as jio

    y = tone(440, dur=0.25) + tone(3100, dur=0.25, amp=0.3)
    tio.save_wav(str(tmp_path / "t.wav"), y, 22050)
    jio.save_wav(str(tmp_path / "j.wav"), y, 22050)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    got, sr = tio.load_wav(str(tmp_path / "t.wav"))
    assert sr == 22050
    np.testing.assert_array_equal(got, jio.load_wav(str(tmp_path / "t.wav"))[0])
    np.testing.assert_array_equal(tio.resample(got, 22050, 16000),
                                  jio.resample(got, 22050, 16000))


def test_an_edited_shared_header_rebuilds_both_kernels(tmp_path, monkeypatch):
    """build_library names a library by source_digest: editing the header
    the kernels include changes both kernels' digests, editing one kernel
    only its own."""
    for name in ("mfcc_fused.cu", "log_mel_fused.cu", "mel_tile.cuh"):
        (tmp_path / name).write_text("// " + name)
    monkeypatch.setattr(tk, "CSRC_DIR", str(tmp_path))
    before = {k: tk.source_digest(k) for k in ("mfcc_fused", "log_mel_fused")}
    (tmp_path / "mel_tile.cuh").write_text("// edited")
    after = {k: tk.source_digest(k) for k in before}
    assert all(before[k] != after[k] for k in before)
    (tmp_path / "log_mel_fused.cu").write_text("// edited")
    assert tk.source_digest("mfcc_fused") == after["mfcc_fused"]
    assert tk.source_digest("log_mel_fused") != after["log_mel_fused"]


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
    assert tk.launch_counts == {"mfcc_fused": 0, "log_mel_fused": 0}


def test_extract_features_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.extract_features(_signals(), kind="mfcc")


def _bad_input(bad):
    y = torch.zeros(2, 16000)
    if bad == "float64":
        y = y.double()
    elif bad == "1d":
        y = y[0]
    elif bad == "short":
        y = y[:, :200]
    return y


@pytest.mark.parametrize("bad", ["float64", "1d", "short"])
def test_mfcc_fused_rejects_inputs_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        tk.mfcc_fused(_bad_input(bad), tf.FrontendConfig())


@pytest.mark.parametrize("bad", ["float64", "1d", "short", "log_mode"])
def test_log_mel_fused_rejects_inputs_the_kernel_does_not_take(bad):
    cfg = tf.FrontendConfig(log="log2" if bad == "log_mode" else "db")
    with pytest.raises(ValueError):
        tk.log_mel_fused(_bad_input(bad), cfg)
