"""GPU smoke run of the PyTorch port's main path (KWS: 1-s wavs -> fused
MFCC kernel -> population trainer -> NSGA-II front), on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; nothing is caught):

1. build   — compile every CUDA kernel of the path from csrc/ (nvcc, sm_90a);
2. kernels — each kernel against its plain PyTorch version on the card, at
             the main path's shapes (mfcc_fused: 4096 1-s clips, hop 360,
             40 mels, 13 MFCC; atol 3e-2, rtol 1e-3, the JAX package's
             Pallas-vs-XLA tolerance), with kernel, plain and bound times;
3. extract — ~2000 class-dependent synthetic wavs through
             ``extract_features(kind="mfcc")`` into a stratified 70/15/15
             npy split;
4. train   — ``PopulationEvaluator.evaluate`` in bf16 on 8 fixed genomes,
             the widest and the narrowest among them, twice: the fitness must
             repeat bit for bit;
5. search  — the CLI, ``--preset nsga_penalty --source npy --device cuda``;
             its per-generation and final CSVs must carry the reference
             schema.

Launch counts are zeroed just before phase 3 and read after phase 5: each
kernel of the path must have launched there. The last lines are one JSON
object per kernel record set, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "smoke")

KWS_N_SAMPLES = 16000
KWS_HOP = 360
CLASSES = 10
N_WAVS = 2000
# (name, bytes/s, f32 FLOP/s outside the tensor cores): published dense peaks
PEAKS = {
    "H100 PCIe": (2.0e12, 51e12),
    "H200": (4.8e12, 67e12),
    "H100": (3.35e12, 67e12),  # SXM part, the default for an "H100" name
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return key, peaks
    return "H100", PEAKS["H100"]


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def synth_clips(rng, n: int, n_samples: int):
    """Tones + noise, 1-s clips (kernel check input)."""
    import numpy as np

    t = np.arange(n_samples) / 16000.0
    f = rng.uniform(100.0, 7000.0, (n, 1))
    y = 0.4 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal((n, n_samples))
    return y.astype(np.float32)


def synth_kws(rng, n: int):
    """Class-dependent 1-s 'words': class k is a chirp between two
    class-specific frequencies with a class-specific onset, plus a random
    gain, jitter and noise floor."""
    import numpy as np

    labels = np.arange(n) % CLASSES
    rng.shuffle(labels)
    t = np.arange(KWS_N_SAMPLES) / 16000.0
    wavs = np.empty((n, KWS_N_SAMPLES), np.float32)
    for i, k in enumerate(labels):
        f0 = 300.0 + 450.0 * k * rng.uniform(0.97, 1.03)
        f1 = f0 * (1.5 if k % 2 else 0.6)
        onset = 0.1 + 0.05 * (k % 4) + rng.uniform(-0.03, 0.03)
        dur = 0.35 + 0.04 * (k % 3)
        env = np.clip((t - onset) / 0.02, 0, 1) * np.clip((onset + dur - t) / 0.02, 0, 1)
        phase = 2 * np.pi * (f0 * t + (f1 - f0) * t * t / 2.0)
        y = env * np.sin(phase) * rng.uniform(0.2, 0.8)
        wavs[i] = y + rng.uniform(0.005, 0.05) * rng.standard_normal(KWS_N_SAMPLES)
    return wavs, labels.astype(np.int32)


def stratified_split(rng, labels, fracs=(0.70, 0.15, 0.15)):
    import numpy as np

    parts = [[], [], []]
    for k in np.unique(labels):
        idx = rng.permutation(np.nonzero(labels == k)[0])
        a = int(round(fracs[0] * len(idx)))
        b = a + int(round(fracs[1] * len(idx)))
        for p, sl in zip(parts, (idx[:a], idx[a:b], idx[b:])):
            p.extend(sl.tolist())
    return [np.asarray(sorted(p)) for p in parts]


def phase_build() -> dict:
    from cmoop_audio_processing_torch.frontend.cuda_kernels import build_library

    t0 = time.perf_counter()
    path = build_library("mfcc_fused", verbose=True)
    secs = time.perf_counter() - t0
    log(f"[build] mfcc_fused -> {os.path.relpath(path, ROOT)} in {secs:.1f} s")
    return {"mfcc_fused": secs}


def phase_kernels(seed: int, device_name: str) -> dict:
    import numpy as np
    import torch

    from cmoop_audio_processing_torch.frontend.cuda_kernels import (
        mfcc_fused,
        mfcc_fused_reference,
    )
    from cmoop_audio_processing_torch.frontend.features import FrontendConfig

    cfg = FrontendConfig(hop_length=KWS_HOP, n_mels=40, n_mfcc=13)
    rng = np.random.default_rng(seed)
    y = torch.as_tensor(synth_clips(rng, 4096, KWS_N_SAMPLES), device="cuda")
    got = mfcc_fused(y, cfg)
    want = mfcc_fused_reference(y, cfg)
    torch.cuda.synchronize()
    n_frames = cfg.n_frames(KWS_N_SAMPLES)
    assert got.shape == want.shape == (4096, n_frames, 13), got.shape
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs()
    max_err = float(err.max())
    tol = 3e-2 + 1e-3 * want.abs()
    if not bool((err <= tol).all()):
        raise AssertionError(
            f"mfcc_fused disagrees with its plain version: max |err| "
            f"{max_err} ({int((err > tol).sum())} elements out of tolerance)"
        )
    ms = cuda_time_ms(lambda: mfcc_fused(y, cfg), reps=20)
    plain_ms = cuda_time_ms(lambda: mfcc_fused_reference(y, cfg), reps=5)
    frames = 4096 * n_frames
    flops = frames * (2 * cfg.n_fft * 2 * cfg.n_bins
                      + 2 * cfg.n_bins * cfg.n_mels + 2 * cfg.n_mels * cfg.n_mfcc)
    nbytes = 4 * (y.numel() + frames * cfg.n_mfcc + cfg.n_fft * 2 * cfg.n_bins
                  + cfg.n_bins * cfg.n_mels + cfg.n_mels * cfg.n_mfcc)
    peak_name, (bw, f32_peak) = card_peaks(device_name)
    t_ops, t_bytes = flops / f32_peak * 1e3, nbytes / bw * 1e3
    rec = {
        "name": "mfcc_fused",
        "route": "cuda",
        "source": "cmoop_audio_processing_torch/csrc/mfcc_fused.cu",
        "replaces": "cmoop_audio_processing_tpu/frontend/pallas_kernels.py:160",
        "launches": None,  # filled from the main path's run
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        # no single PyTorch call computes DFT -> power -> mel -> dB -> DCT
        "library_ms": None,
    }
    log(f"[kernels] mfcc_fused on (4096, {KWS_N_SAMPLES}): max |err| "
        f"{max_err:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{rec['bound_ms']:.3f} ms by {rec['bound_by']} ({flops / 1e9:.1f} "
        f"GFLOP, {nbytes / 1e6:.1f} MB; {peak_name} peaks)")
    return {"mfcc_fused": rec}


def phase_extract(seed: int, device: str, n_wavs: int, data_dir: str) -> None:
    import numpy as np

    from cmoop_audio_processing_torch.data.loaders import save_npy_dir
    from cmoop_audio_processing_torch.frontend import reference_impl
    from cmoop_audio_processing_torch.frontend.features import (
        FrontendConfig,
        extract_features,
    )

    rng = np.random.default_rng(seed + 1)
    wavs, labels = synth_kws(rng, n_wavs)
    cfg = FrontendConfig(hop_length=KWS_HOP, n_mfcc=13)
    t0 = time.perf_counter()
    feats = np.concatenate([
        extract_features(wavs[i:i + 500], cfg, kind="mfcc", device=device)
        for i in range(0, n_wavs, 500)
    ])
    secs = time.perf_counter() - t0
    assert feats.shape == (n_wavs, cfg.n_frames(KWS_N_SAMPLES), 13), feats.shape
    assert np.isfinite(feats).all()
    # the first clips against the numpy float64 oracle (librosa's
    # conventions), at the JAX package's MFCC tolerance
    for i in range(8):
        want = reference_impl.mfcc(wavs[i].astype(np.float64), cfg.sr,
                                   cfg.n_mfcc, cfg.n_fft, cfg.hop_length,
                                   cfg.n_mels)
        err = float(np.abs(feats[i] - want).max())
        assert err <= 3e-2, f"clip {i}: MFCC off the float64 oracle by {err}"
    tr, va, te = stratified_split(rng, labels)
    save_npy_dir({
        "x_train": feats[tr], "y_train": labels[tr],
        "x_val": feats[va], "y_val": labels[va],
        "x_test": feats[te], "y_test": labels[te],
    }, data_dir)
    log(f"[extract] {n_wavs} wavs -> {feats.shape} MFCC in {secs:.2f} s; "
        f"split {len(tr)}/{len(va)}/{len(te)} -> {os.path.relpath(data_dir, ROOT)}")


SMOKE_GENOMES = [
    # widest: 64 filters, 5x5, 3 blocks (64->512 channels), 4 FC, BN, dropout
    dict(filters=64, kernel_size=5, use_bn=True, residual_blocks=3,
         fc_layers=4, use_dropout=True),
    # narrowest
    dict(filters=16, kernel_size=3, use_bn=False, residual_blocks=1,
         fc_layers=1, use_dropout=False),
    dict(filters=16, kernel_size=3, use_bn=True, residual_blocks=1,
         fc_layers=2, use_dropout=True),
    dict(filters=32, kernel_size=3, use_bn=True, residual_blocks=2,
         fc_layers=3, use_dropout=False),
    dict(filters=32, kernel_size=5, use_bn=False, residual_blocks=2,
         fc_layers=4, use_dropout=True),
    dict(filters=64, kernel_size=3, use_bn=True, residual_blocks=3,
         fc_layers=1, use_dropout=False),
    dict(filters=64, kernel_size=5, use_bn=False, residual_blocks=3,
         fc_layers=2, use_dropout=False),
    dict(filters=16, kernel_size=5, use_bn=True, residual_blocks=3,
         fc_layers=3, use_dropout=True),
]


def phase_train(device: str, data_dir: str, epochs: int) -> None:
    import dataclasses

    from cmoop_audio_processing_torch.core.config import DataConfig, TrainConfig
    from cmoop_audio_processing_torch.data.pipeline import prepare_dataset
    from cmoop_audio_processing_torch.engine.evaluator import PopulationEvaluator

    data = prepare_dataset(DataConfig(source="npy", path=data_dir))
    cfg = dataclasses.replace(TrainConfig(), epochs=epochs,
                              compute_dtype="bfloat16")
    runs = []
    for _ in range(2):
        ev = PopulationEvaluator(data, cfg, device=device)
        t0 = time.perf_counter()
        runs.append(ev.evaluate(SMOKE_GENOMES, seed=7))
        log(f"[train] {len(SMOKE_GENOMES)} genomes, {ev.timings[-1]['launches']} "
            f"populations, {time.perf_counter() - t0:.2f} s")
    for fit in runs[0]:
        assert all(v == v and abs(v) != float("inf") for v in fit), fit
    if runs[0] != runs[1]:
        raise AssertionError(f"fitness not repeatable: {runs[0]} vs {runs[1]}")
    best = max(acc for acc, _, _ in runs[0])
    assert best > 0.5, f"no genome learned the 10-class task (best acc {best})"
    for g, (acc, size, fpr) in zip(SMOKE_GENOMES, runs[0]):
        log(f"[train]   f={g['filters']} k={g['kernel_size']} "
            f"blocks={g['residual_blocks']} fc={g['fc_layers']} "
            f"bn={g['use_bn']} do={g['use_dropout']}: acc={acc!r} "
            f"size={size!r} MB fpr={fpr!r}")


def phase_search(device: str, data_dir: str, out_dir: str, epochs: int,
                 pop: int, gens: int) -> None:
    from cmoop_audio_processing_torch.cli.main import main as cli_main
    from cmoop_audio_processing_torch.core.genome import GENE_ORDER

    t0 = time.perf_counter()
    rc = cli_main([
        "--preset", "nsga_penalty", "--source", "npy", "--data-path", data_dir,
        "--device", device, "--max-gen", str(gens), "--pop-size", str(pop),
        "--epochs", str(epochs), "--out", out_dir,
    ])
    assert rc == 0, rc
    run_dir = os.path.join(out_dir, "nsga_penalty")
    with open(os.path.join(run_dir, "all_generations.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    gen_cols = ["Generation", "Accuracy", "Size_MB", "FPR", "CV", *GENE_ORDER]
    assert rows and list(rows[0]) == gen_cols, rows[:1]
    assert sorted({int(r["Generation"]) for r in rows}) == list(range(gens))
    with open(os.path.join(run_dir, "final_pareto.csv"), newline="") as f:
        front = list(csv.reader(f))
    if len(front) > 1:
        assert front[0] == ["Accuracy", "Size_MB", "FPR", *GENE_ORDER], front[0]
    assert os.path.exists(os.path.join(run_dir, "all_generations.xlsx"))
    best = max(float(r["Accuracy"]) for r in rows)
    log(f"[search] nsga_penalty pop {pop} x {gens} gens in "
        f"{time.perf_counter() - t0:.1f} s; best val acc {best!r}; front "
        f"{len(front) - 1} rows")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    import cmoop_audio_processing_torch as port

    if not os.path.abspath(port.__file__).startswith(ROOT + os.sep):
        sys.exit("chip_smoke: cmoop_audio_processing_torch is not in this checkout")
    from cmoop_audio_processing_torch.core.device import resolve_device
    from cmoop_audio_processing_torch.frontend import cuda_kernels

    resolve_device("cuda")  # deterministic mode before the first cuBLAS call
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t_all = time.perf_counter()
    phase_build()
    records = phase_kernels(args.seed, name)

    data_dir = os.path.join(WORK, "kws_npy")
    cuda_kernels.reset_launch_counts()
    phase_extract(args.seed, "cuda", N_WAVS, data_dir)
    phase_train("cuda", data_dir, epochs=4)
    phase_search("cuda", data_dir, os.path.join(WORK, "results"), epochs=3,
                 pop=8, gens=2)
    counts = dict(cuda_kernels.launch_counts)
    for kname, rec in records.items():
        rec["launches"] = counts[kname]
        if counts[kname] <= 0:
            raise AssertionError(f"kernel {kname} never launched on the main path")
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": list(records.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
