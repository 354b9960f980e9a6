"""Where the FFT-route frontend kernels spend their time, on one CUDA card.

    python3 kernel_variants.py

Builds variants of csrc/log_mel_fused.cu and csrc/mfcc_fused.cu from this
checkout's sources, each with one text substitution in csrc/mel_fft.cuh (a
phase cut out, or a launch constant changed), into a temporary directory,
and times each variant's FFT route through the wrappers' own launch code
(``cuda_kernels._log_mel_launch`` / ``_mfcc_launch`` on the variant's
library) at chip_smoke.py's path shapes: ``log_mel_fused`` at 512 5-s clips
(hop 160, dB with top_db 80) and ``mfcc_fused`` at 4096 1-s clips (hop 360,
13 MFCC), at n_fft 512 (the radix-2 plan) and 400 (the mixed-radix plan,
P = 25 points a lane). A substitution whose text is not in the header is an
error. A variant with a phase cut out computes something else; the others
must still match the plain versions (atol 3e-2, rtol 1e-3). Prints one JSON
line per variant and the card's name and power limit; nothing here is used
by the port.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

HEADER = "mel_fft.cuh"
REPS = 100  # timed launches per variant and kernel
PHASE_A = [("    for (int f = warp; f < rb; f += WARPS)\n      frame_power",
            "    for (int f = warp; f < 0; f += WARPS)\n      frame_power"),
           ("for (int f0 = warp * per_warp; f0 < rb; f0 += WARPS * per_warp) {",
            "for (int f0 = warp * per_warp; f0 < 0; f0 += WARPS * per_warp) {")]
# the mixed plan's register plan (mel_fft.cuh rolled_stages, min_blocks)
UNROLLED = ("constexpr bool rolled_stages(int P) { return P > 20; }",
            "constexpr bool rolled_stages(int P) { return false; }")
ONE_BLOCK = ("return rolled_stages(P) ? 1 : 2;", "return 1;")
N_FFTS = (512, 400)
PHASE_B = ("for (int i = 0; i < count[m]; ++i) acc = fmaf(pm[i], wm[i], acc);",
           "acc = pm[0];")


def budget(kib: int):
    return ("SMEM_TARGET = 75 * 1024", f"SMEM_TARGET = {kib} * 1024")


VARIANTS = {
    "as_built": [],
    "no_fft": PHASE_A,            # phase A (the FFT and split) cut out
    "no_mel": [PHASE_B],          # phase B (the mel product) cut out
    "no_fft_no_mel": PHASE_A + [PHASE_B],  # loads, barriers, epilogue only
    "smem_56k": [budget(56)],     # four blocks an SM
    "smem_90k": [budget(90)],
    "smem_110k": [budget(110)],   # two blocks an SM
    "warps_4": [("constexpr int WARPS = 8;", "constexpr int WARPS = 4;")],
    "warps_16": [("constexpr int WARPS = 8;", "constexpr int WARPS = 16;")],
    # P > 20 with unrolled cross-lane stages: capped at 128 registers (two
    # blocks an SM, spilling), or uncapped (one block an SM)
    "unrolled_stages": [UNROLLED],
    "unrolled_stages_one_block": [UNROLLED, ONE_BLOCK],
}
CHECKED = ("as_built", "smem_56k", "smem_90k", "smem_110k", "warps_4",
           "warps_16", "unrolled_stages", "unrolled_stages_one_block")
KERNELS = ("log_mel_fused", "mfcc_fused")


def build(name: str, root: str):
    """({kernel: library}, ptxas rows of the n_fft 512 and 400 kernels,
    P = 8 and 25) of one variant."""
    from cmoop_audio_processing_torch.frontend import cuda_kernels as ck

    src = os.path.join(root, name)
    os.makedirs(src)
    for fname in os.listdir(ck.CSRC_DIR):
        with open(os.path.join(ck.CSRC_DIR, fname)) as f:
            text = f.read()
        if fname == HEADER:
            for old, new in VARIANTS[name]:
                if old not in text:
                    raise ValueError(f"{name}: {old!r} is not in {HEADER}")
                text = text.replace(old, new)
        with open(os.path.join(src, fname), "w") as f:
            f.write(text)
    libs, ptxas = {}, []
    for kernel in KERNELS:
        out = os.path.join(src, f"lib{kernel}.so")
        proc = subprocess.run(
            [ck._nvcc(), *ck.NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
             os.path.join(src, f"{kernel}.cu")], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{proc.stderr}")
        ptxas += [r for r in ck.ptxas_summary(proc.stderr)
                  if "<8>" in r[0] or "<25>" in r[0]]
        libs[kernel] = ck.load_library(kernel, out)
    return libs, ptxas


def main() -> int:
    import dataclasses

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_variants: no CUDA device")
    import chip_smoke as cs
    from cmoop_audio_processing_torch.core.device import resolve_device
    from cmoop_audio_processing_torch.frontend import cuda_kernels as ck
    from cmoop_audio_processing_torch.frontend.features import FrontendConfig

    resolve_device("cuda")
    with tempfile.TemporaryDirectory() as root, ThreadPoolExecutor(8) as pool:
        built = dict(zip(VARIANTS, pool.map(lambda v: build(v, root), VARIANTS)))

    rng = np.random.default_rng(0)
    launch = {"log_mel_fused": ck._log_mel_launch, "mfcc_fused": ck._mfcc_launch}
    plain = {"log_mel_fused": ck.log_mel_fused_reference,
             "mfcc_fused": ck.mfcc_fused_reference}
    inputs = {
        "log_mel_fused": (torch.as_tensor(
            cs.synth_clips(rng, 512, cs.BIRD_N_SAMPLES), device="cuda"),
            FrontendConfig()),
        "mfcc_fused": (torch.as_tensor(
            cs.synth_clips(rng, 4096, cs.KWS_N_SAMPLES), device="cuda"),
            FrontendConfig(hop_length=cs.KWS_HOP)),
    }
    configs = {(k, n): dataclasses.replace(inputs[k][1], n_fft=n)
               for k in KERNELS for n in N_FFTS}
    want = {key: plain[key[0]](inputs[key[0]][0], cfg)
            for key, cfg in configs.items()}
    for name, (libs, ptxas) in built.items():
        rec = {"variant": name, "ptxas": ptxas}
        for (kernel, n_fft), cfg in configs.items():
            y = inputs[kernel][0]
            assert ck.dft_route(cfg.n_fft) == "fft"
            run = lambda: launch[kernel](libs[kernel], y, cfg)  # noqa: E731
            if name in CHECKED:
                rec[f"{kernel}_{n_fft}_max_abs_err"] = cs.check_close(
                    f"{kernel} ({name}, n_fft {n_fft})", run(),
                    want[(kernel, n_fft)])
            rec[f"{kernel}_{n_fft}_ms"] = cs.cuda_time_ms(run, reps=REPS)
        print(json.dumps(rec), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
