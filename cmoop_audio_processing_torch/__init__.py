"""cmoop_audio_processing_torch: the PyTorch / CUDA (Hopper) port of
cmoop_audio_processing_tpu.

Same constrained multi-objective NAS over the 288-genome TinyML CNN space,
with the module layout of the JAX package so every module has a named
counterpart there. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; the audio frontend's fused MFCC and log-mel chains are
hand-written CUDA kernels (``csrc/mfcc_fused.cu``, ``csrc/log_mel_fused.cu``)
built at first use.
"""

__version__ = "0.1.0"
