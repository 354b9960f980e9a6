"""Device selection and the numeric mode of the CUDA path.

Every entry point takes a ``device`` argument that defaults to ``"cuda"``.
Asking for CUDA on a machine without a usable GPU raises: nothing here
falls back to the CPU. The CPU runs only when the caller says
``device="cpu"`` (the tests do).

The first use of CUDA puts the process into the mode the evaluation path
needs:

* full-f32 matmuls and convolutions (no TF32), as the JAX package pins
  ``Precision.HIGHEST`` for its frontend;
* deterministic kernels, so one (genome, seed) trains to the same fitness
  on every run — the property fitness-keyed caching and re-evaluation rest
  on. cuBLAS reads ``CUBLAS_WORKSPACE_CONFIG`` when its first handle is
  created, so the variable is set before any cuBLAS call of the process.
"""

from __future__ import annotations

import os

import torch


def full_f32() -> None:
    """Full-f32 matmuls and convolutions on CUDA: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def configure_cuda() -> None:
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    full_f32()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a GPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU"
            )
        configure_cuda()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev
