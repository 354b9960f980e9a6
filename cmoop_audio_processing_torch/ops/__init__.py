"""Compute ops index: the port's device surface in one place, under the
names of cmoop_audio_processing_tpu/ops.

The hot-path ops live with their subsystems; this package re-exports them
so the op inventory is discoverable at a glance:

* audio frontend: the plain torch chain and the hand-written CUDA kernels
  (frontend/features.py, frontend/cuda_kernels.py; built at first launch,
  never by this import);
* population forward passes: the grouped population network and one model
  (models/);
* training-step machinery: macro-FPR, dataset padding (engine/);
* GP kernels: Matern/RBF/White Gram matrices (surrogate/).
"""

from ..engine.trainer import macro_fpr, pad_dataset
from ..frontend.cuda_kernels import log_mel_fused, mfcc_fused
from ..frontend.features import log_mel, mfcc, stft_power
from ..models.grouped import apply_population
from ..models.supernet import apply_model
from ..surrogate.kernels import matern, rbf, scaled_matern_white, sqdist

__all__ = [
    "macro_fpr",
    "pad_dataset",
    "log_mel",
    "mfcc",
    "stft_power",
    "log_mel_fused",
    "mfcc_fused",
    "apply_population",
    "apply_model",
    "matern",
    "rbf",
    "scaled_matern_white",
    "sqdist",
]
