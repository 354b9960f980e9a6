"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions, and the determinism of the CUDA evaluation path.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch; the JAX-importing tests/conftest.py is left out there:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from cmoop_audio_processing_torch.frontend import cuda_kernels as tk
from cmoop_audio_processing_torch.frontend import features as tf

pytestmark = pytest.mark.cuda

KWS = tf.FrontendConfig(hop_length=360, n_mels=40, n_mfcc=13)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    from cmoop_audio_processing_torch.core.device import resolve_device

    return resolve_device("cuda")


def _clips(n, n_samples, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / 16000.0
    f = rng.uniform(100.0, 7000.0, (n, 1))
    y = 0.4 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal((n, n_samples))
    return y.astype(np.float32)


@pytest.mark.parametrize("n,n_samples,cfg", [
    (64, 16000, KWS),
    (3, 80000, tf.FrontendConfig()),
    (5, 16000, dataclasses.replace(KWS, center=False)),
    (2, 700, KWS),
], ids=["kws_64x16000", "birdclef_3x80000", "uncentred", "short_clip"])
def test_mfcc_fused_kernel_matches_its_plain_version(cuda, n, n_samples, cfg):
    """atol 3e-2 / rtol 1e-3: the JAX package's Pallas-vs-XLA tolerance
    (tests/test_frontend.py); both sides are full f32 and differ only in
    summation order."""
    y = torch.as_tensor(_clips(n, n_samples), device=cuda)
    before = tk.launch_counts["mfcc_fused"]
    got = tk.mfcc_fused(y, cfg)
    assert tk.launch_counts["mfcc_fused"] == before + 1
    want = tk.mfcc_fused_reference(y, cfg)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n, cfg.n_frames(n_samples), cfg.n_mfcc)
    torch.testing.assert_close(got, want, atol=3e-2, rtol=1e-3)


def test_extract_features_on_cuda_goes_through_the_kernel(cuda):
    ys = _clips(4, 16000, seed=1)
    before = tk.launch_counts["mfcc_fused"]
    got = tf.extract_features(ys, KWS, kind="mfcc", device="cuda")
    assert tk.launch_counts["mfcc_fused"] == before + 1
    want = tf.extract_features(ys, KWS, kind="mfcc", device="cpu")
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=1e-3)
    with pytest.raises(NotImplementedError, match="log_mel_fused"):
        tf.extract_features(ys, KWS, kind="log_mel", device="cuda")


def test_mfcc_fused_rejects_float64_on_cuda(cuda):
    with pytest.raises(ValueError):
        tk.mfcc_fused(torch.zeros(2, 16000, dtype=torch.float64, device=cuda), KWS)


def test_cuda_evaluation_repeats_bit_for_bit(cuda):
    from cmoop_audio_processing_torch.core.config import DataConfig, TrainConfig
    from cmoop_audio_processing_torch.data.pipeline import prepare_dataset
    from cmoop_audio_processing_torch.engine.evaluator import PopulationEvaluator

    data = prepare_dataset(DataConfig(synthetic_train=256, synthetic_eval=128,
                                      time_steps=45, features=13))
    cfg = TrainConfig(epochs=2, compute_dtype="bfloat16")
    genomes = [
        dict(filters=32, kernel_size=5, use_bn=True, residual_blocks=2,
             fc_layers=3, use_dropout=True),
        dict(filters=32, kernel_size=5, use_bn=False, residual_blocks=1,
             fc_layers=1, use_dropout=False),
    ]
    runs = [PopulationEvaluator(data, cfg, device="cuda").evaluate(genomes, seed=2)
            for _ in range(2)]
    assert runs[0] == runs[1]
    assert all(np.isfinite(v) for fit in runs[0] for v in fit)
