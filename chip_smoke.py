"""GPU smoke run of the PyTorch port's two paths on one CUDA card:

* KWS: 1-s wavs -> fused MFCC kernel -> population trainer -> NSGA-II front;
* BirdCLEF: 5-s wav files -> extraction CLI (fused log-mel kernel) -> 501x40
  npy split -> template-B population trainer -> GP-surrogate SA-NSGA-II
  (``sa_nsga_penalty``) front.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; nothing is caught):

1. build   — compile every CUDA kernel from csrc/ (nvcc, sm_90a), one nvcc
             per kernel, all started together; ptxas's registers and
             spills for each kernel function;
2. kernels — each kernel against its plain PyTorch version on the card, at
             its path's shapes (atol 3e-2, rtol 1e-3, the JAX package's
             Pallas-vs-XLA tolerance), with kernel, plain and bound times:
             mfcc_fused at 4096 1-s clips, hop 360, 40 mels, 13 MFCC;
             log_mel_fused at 512 5-s clips, hop 160, 40 mels, in dB with
             top_db 80 and in natural-log mode. n_fft 512 takes the FFT
             route; each kernel's dense route is checked and timed at the
             same shapes with n_fft 400. Beside them, the time of a cuFFT
             chain the port never calls (torch.stft -> |.|^2 -> mel -> log
             (-> DCT)), as a yardstick;
3. extract — ~2000 class-dependent synthetic 1-s wavs through
             ``extract_features(kind="mfcc")`` into a stratified 70/15/15
             npy split;
4. train   — ``PopulationEvaluator.evaluate`` in bf16 on 8 fixed genomes,
             the widest and the narrowest among them, twice: the fitness must
             repeat bit for bit;
5. search  — the CLI, ``--preset nsga_penalty --source npy --device cuda``;
             its per-generation and final CSVs must carry the reference
             schema, and its front must not be empty;
6. bird-extract — 11 classes x 120 synthetic 5-s bird calls written as
             16-bit wavs, then ``cli/extract_features.py --kind log_mel
             --duration 5 --layout npy --device cuda``; (n, 501, 40) rows,
             the first against the float64 oracle;
7. bird-train — template B at 501x40 in bf16, the widest and the narrowest
             genome, twice: bit-for-bit repeatable fitness; peak memory;
8. bird-search — the CLI, ``--preset sa_nsga_penalty --source npy --device
             cuda``: GP fits on the card; the reference's surrogate
             artifacts, with a front of at least one feasible genome.

Launch counts are zeroed just before each path (phase 3, phase 6) and read
just after it (phase 5, phase 8): each kernel of a path must have launched
there, on the FFT route only. The last lines are one JSON object with the kernel records, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "smoke")

KWS_N_SAMPLES = 16000
KWS_HOP = 360
CLASSES = 10
N_WAVS = 2000
BIRD_N_SAMPLES = 80000  # 5-s clips at 16 kHz -> 501 frames at hop 160
BIRD_CLASSES = 11
BIRD_PER_CLASS = 120
BIRD_MIN_ACC = 0.5  # bird-train, 4 epochs; chance is 1/11
BIRD_SEARCH_EPOCHS = 15  # enough for a genome of the search to pass the
# preset's constraints (accuracy >= 0.75, FPR <= 0.09), so that its front
# is not empty
BIRD_CHECK_CLIPS = 512
TOL = dict(atol=3e-2, rtol=1e-3)  # the JAX package's Pallas-vs-XLA tolerance
KERNELS = ("mfcc_fused", "log_mel_fused")
DENSE_N_FFT = 400  # not a power of two: the kernels' dense route
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


def kernel_function(mangled: str) -> str:
    """'name<arg>' of a mangled kernel function: the <length><name> part
    that names a *_kernel, and its integer template argument, if any."""
    for i in range(len(mangled)):
        m = re.match(r"(\d+)(\w+?_kernel)(IL[a-z](\d+)E)?", mangled[i:])
        if m and int(m.group(1)) == len(m.group(2)):
            return f"{m.group(2)}<{m.group(4)}>" if m.group(4) else m.group(2)
    return mangled


def ptxas_summary(report: str):
    """(kernel function, registers, spill store bytes, spill load bytes) for
    each entry function in an ``nvcc -Xptxas -v`` report."""
    rows, name, spills = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_function(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    return rows


def phase_build() -> None:
    from cmoop_audio_processing_torch.frontend.cuda_kernels import (
        build_library,
        ptxas_report,
    )

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        reports = list(pool.map(ptxas_report, KERNELS))
    secs = time.perf_counter() - t0
    for name, report in zip(KERNELS, reports):
        log(f"[build] {name} -> {os.path.relpath(build_library(name), ROOT)}")
        for fn, regs, st, ld in ptxas_summary(report):
            log(f"[build]   ptxas {fn}: {regs} registers, spill stores {st} B, "
                f"spill loads {ld} B")
    log(f"[build] {len(KERNELS)} kernels in {secs:.1f} s")


def check_close(name: str, got, want) -> float:
    """Max |got - want|; raises unless every element is within TOL."""
    import torch

    torch.cuda.synchronize()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert bool(torch.isfinite(got).all()), f"{name}: non-finite output"
    err = (got - want).abs()
    tol = TOL["atol"] + TOL["rtol"] * want.abs()
    if not bool((err <= tol).all()):
        raise AssertionError(
            f"{name} disagrees with its plain version: max |err| "
            f"{float(err.max())} ({int((err > tol).sum())} elements out of "
            "tolerance)"
        )
    return float(err.max())


def frontend_work(cfg, batch: int, n_samples: int, n_out: int,
                  epilogue_flops: int):
    """(FLOPs, bytes) the frontend function needs for one call, whatever a
    kernel spends: per frame a real FFT of n_fft points (2.5 n log2 n, the
    usual count for a real transform), the window, the power (3 per bin),
    the mel product over the filter bank's nonzero weights, the log and
    ``epilogue_flops``; the waveform read once and the (frames, n_out)
    output written once. The kernels' dense-GEMM DFT (2*n_fft*2*n_bins per
    frame) is ~38x the FFT's count and is not what the function needs."""
    import math

    import numpy as np

    from cmoop_audio_processing_torch.frontend.features import mel_matrix

    n = cfg.n_fft
    per_frame = (2.5 * n * math.log2(n) + n + 3 * cfg.n_bins
                 + 2 * int(np.count_nonzero(mel_matrix(cfg))) + cfg.n_mels
                 + epilogue_flops)
    frames = batch * cfg.n_frames(n_samples)
    return frames * per_frame, 4 * (batch * n_samples + frames * n_out)


def kernel_record(name, source, replaces, max_err, ms, plain_ms, work,
                  device_name, **extra) -> dict:
    flops, nbytes = work
    peak_name, (bw, f32_peak) = card_peaks(device_name)
    t_ops, t_bytes = flops / f32_peak * 1e3, nbytes / bw * 1e3
    rec = {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": None,  # filled from its path's run
        "dft_route": None,  # likewise
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        # no single PyTorch call computes DFT -> power -> mel -> log (->
        # DCT): torch.stft is an FFT and covers only the first stage
        "library_ms": None,
        **extra,
    }
    log(f"[kernels] {name}: max |err| {max_err:.3e}; kernel {ms:.4f} ms "
        f"(FFT route), plain {plain_ms:.3f} ms, cuFFT chain "
        f"{extra['fft_chain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms by "
        f"{rec['bound_by']} ({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB; "
        f"{peak_name} peaks)")
    return rec


def fft_chain(y, cfg, dct: bool):
    """The function through PyTorch's cuFFT-backed ``torch.stft``: |.|^2 ->
    mel -> dB (-> DCT-II), or the log mode and top_db step of ``cfg``. A
    yardstick the port never calls."""
    import torch

    from cmoop_audio_processing_torch.frontend import cuda_kernels as ck
    from cmoop_audio_processing_torch.frontend.features import window

    _, mel_t, *dct_t = (ck._mfcc_operands if dct else ck._log_mel_operands)(
        cfg, y.device)
    win = torch.as_tensor(window(cfg), dtype=torch.float32, device=y.device)
    spec = torch.stft(y, cfg.n_fft, cfg.hop_length, window=win,
                      center=cfg.center, pad_mode="reflect", return_complex=True)
    mel = (spec.real ** 2 + spec.imag ** 2).transpose(1, 2) @ mel_t
    if dct:
        return (10.0 * torch.log10(torch.clamp(mel, min=1e-10))) @ dct_t[0]
    if cfg.log == "natural":
        return torch.log(mel + 1e-6)
    return ck._top_db(10.0 * torch.log10(torch.clamp(mel, min=1e-10)), cfg)


def time_kernel(tag, fn, ref, y, cfg, shape, dct: bool):
    """fn (a kernel wrapper) against ref (its plain version) and the cuFFT
    chain on y: (max |err|, kernel ms, plain ms, chain ms). The first call
    must launch the kernel on the route of cfg.n_fft."""
    from cmoop_audio_processing_torch.frontend import cuda_kernels as ck

    key = f"{fn.__name__}/{ck.dft_route(cfg.n_fft)}"
    before = ck.route_counts[key]
    got = fn(y, cfg)
    assert ck.route_counts[key] == before + 1, (tag, key, ck.route_counts)
    assert got.shape == shape, (tag, got.shape)
    err = check_close(tag, got, ref(y, cfg))
    check_close(f"{tag} cuFFT chain", fft_chain(y, cfg, dct), ref(y, cfg))
    del got
    return (err, cuda_time_ms(lambda: fn(y, cfg), reps=50),
            cuda_time_ms(lambda: ref(y, cfg), reps=5),
            cuda_time_ms(lambda: fft_chain(y, cfg, dct), reps=20))


def phase_kernels(seed: int, device_name: str) -> dict:
    import dataclasses

    import numpy as np
    import torch

    from cmoop_audio_processing_torch.frontend import cuda_kernels as ck
    from cmoop_audio_processing_torch.frontend.features import FrontendConfig

    rng = np.random.default_rng(seed)
    records = {}

    cfg = FrontendConfig(hop_length=KWS_HOP, n_mels=40, n_mfcc=13)
    dense = dataclasses.replace(cfg, n_fft=DENSE_N_FFT)
    y = torch.as_tensor(synth_clips(rng, 4096, KWS_N_SAMPLES), device="cuda")
    assert ck.dft_route(cfg.n_fft) == "fft" and ck.dft_route(dense.n_fft) == "dense"
    err, ms, plain_ms, chain_ms = time_kernel(
        "mfcc_fused", ck.mfcc_fused, ck.mfcc_fused_reference, y, cfg,
        (4096, cfg.n_frames(KWS_N_SAMPLES), 13), dct=True)
    d_err, d_ms, d_plain, _ = time_kernel(
        "mfcc_fused (dense route)", ck.mfcc_fused, ck.mfcc_fused_reference, y,
        dense, (4096, dense.n_frames(KWS_N_SAMPLES), 13), dct=True)
    log(f"[kernels] mfcc_fused dense route at n_fft {DENSE_N_FFT}: max |err| "
        f"{d_err:.3e}; kernel {d_ms:.3f} ms, plain {d_plain:.3f} ms")
    records["mfcc_fused"] = kernel_record(
        "mfcc_fused", "cmoop_audio_processing_torch/csrc/mfcc_fused.cu",
        "cmoop_audio_processing_tpu/frontend/pallas_kernels.py:160", err, ms,
        plain_ms,
        # the DCT-II: n_mels x n_mfcc multiply-adds
        frontend_work(cfg, 4096, KWS_N_SAMPLES, cfg.n_mfcc,
                      2 * cfg.n_mels * cfg.n_mfcc),
        device_name, fft_chain_ms=chain_ms,
        dense_route={"n_fft": DENSE_N_FFT, "max_abs_err": d_err, "ms": d_ms,
                     "plain_ms": d_plain},
    )
    del y

    # the BirdCLEF shape: 512 5-s clips, 256,512 frames
    y = torch.as_tensor(synth_clips(rng, BIRD_CHECK_CLIPS, BIRD_N_SAMPLES),
                        device="cuda")
    db = FrontendConfig(log="db", top_db=80.0)
    natural = FrontendConfig(log="natural")
    dense = dataclasses.replace(db, n_fft=DENSE_N_FFT)
    shape = (BIRD_CHECK_CLIPS, db.n_frames(BIRD_N_SAMPLES), 40)
    err, ms, plain_ms, chain_ms = time_kernel(
        "log_mel_fused (db)", ck.log_mel_fused, ck.log_mel_fused_reference, y,
        db, shape, dct=False)
    n_err, n_ms, _, _ = time_kernel(
        "log_mel_fused (natural)", ck.log_mel_fused,
        ck.log_mel_fused_reference, y, natural, shape, dct=False)
    d_err, d_ms, d_plain, _ = time_kernel(
        "log_mel_fused (dense route)", ck.log_mel_fused,
        ck.log_mel_fused_reference, y, dense,
        (BIRD_CHECK_CLIPS, dense.n_frames(BIRD_N_SAMPLES), 40), dct=False)
    log(f"[kernels] log_mel_fused max |err|: db+top_db {err:.3e}, natural "
        f"{n_err:.3e} ({n_ms:.4f} ms); dense route at n_fft {DENSE_N_FFT} "
        f"{d_err:.3e}, kernel {d_ms:.3f} ms, plain {d_plain:.3f} ms")
    records["log_mel_fused"] = kernel_record(
        "log_mel_fused", "cmoop_audio_processing_torch/csrc/log_mel_fused.cu",
        "cmoop_audio_processing_tpu/frontend/pallas_kernels.py:122",
        max(err, n_err),
        # the path's mode (dB, top_db 80), the top_db step included
        ms, plain_ms,
        # top_db: a max, a subtract and a clamp per output
        frontend_work(db, BIRD_CHECK_CLIPS, BIRD_N_SAMPLES, db.n_mels,
                      3 * db.n_mels),
        device_name, fft_chain_ms=chain_ms,
        natural_ms=n_ms,
        dense_route={"n_fft": DENSE_N_FFT, "max_abs_err": d_err, "ms": d_ms,
                     "plain_ms": d_plain},
    )
    return records


def phase_extract(seed: int, device: str, n_wavs: int, data_dir: str) -> None:
    import numpy as np

    from cmoop_audio_processing_torch.data.loaders import (
        save_npy_dir,
        three_way_split,
    )
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
    tr, va, te = three_way_split(labels, 0.3, 0.5, seed)
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


def phase_train(tag: str, device: str, data_dir: str, genomes, cfg,
                min_acc: float) -> None:
    """``PopulationEvaluator.evaluate`` under ``cfg`` on ``genomes``, twice:
    the fitness must repeat bit for bit and the best genome must pass
    ``min_acc``."""
    import torch

    from cmoop_audio_processing_torch.core.config import DataConfig
    from cmoop_audio_processing_torch.data.pipeline import prepare_dataset
    from cmoop_audio_processing_torch.engine.evaluator import PopulationEvaluator

    data = prepare_dataset(DataConfig(source="npy", path=data_dir,
                                      num_classes=cfg.num_classes))
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(2):
        ev = PopulationEvaluator(data, cfg, device=device)
        t0 = time.perf_counter()
        runs.append(ev.evaluate(genomes, seed=7))
        log(f"[{tag}] {len(genomes)} genomes, {ev.timings[-1]['launches']} "
            f"populations, {time.perf_counter() - t0:.2f} s")
    for fit in runs[0]:
        assert all(v == v and abs(v) != float("inf") for v in fit), fit
    if runs[0] != runs[1]:
        raise AssertionError(f"fitness not repeatable: {runs[0]} vs {runs[1]}")
    best = max(acc for acc, _, _ in runs[0])
    assert best > min_acc, (
        f"no genome learned the {cfg.num_classes}-class task (best acc {best})")
    for g, (acc, size, fpr) in zip(genomes, runs[0]):
        log(f"[{tag}]   f={g['filters']} k={g['kernel_size']} "
            f"blocks={g['residual_blocks']} fc={g['fc_layers']} "
            f"bn={g['use_bn']} do={g['use_dropout']}: acc={acc!r} "
            f"size={size!r} MB fpr={fpr!r}")
    log(f"[{tag}] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def phase_search(tag: str, preset: str, device: str, data_dir: str,
                 out_dir: str, epochs: int, pop: int, gens: int) -> None:
    """The CLI on ``preset``: its per-generation CSV and its final front,
    under the reference script's own file names, must carry the reference
    schema, and the front must hold at least one feasible genome."""
    from cmoop_audio_processing_torch.cli.main import main as cli_main
    from cmoop_audio_processing_torch.core.config import get_preset
    from cmoop_audio_processing_torch.core.genome import GENE_ORDER

    run_dir = os.path.join(out_dir, preset)
    shutil.rmtree(run_dir, ignore_errors=True)  # a fresh run, fresh progress log
    t0 = time.perf_counter()
    rc = cli_main([
        "--preset", preset, "--source", "npy", "--data-path", data_dir,
        "--device", device, "--max-gen", str(gens), "--pop-size", str(pop),
        "--epochs", str(epochs), "--out", out_dir,
    ])
    assert rc == 0, rc
    suffix = get_preset(preset).artifact_suffix
    suffix = f"_{suffix}" if suffix else ""
    with open(os.path.join(run_dir, "all_generations.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    gen_cols = ["Generation", "Accuracy", "Size_MB", "FPR", "CV", *GENE_ORDER]
    assert rows and list(rows[0]) == gen_cols, rows[:1]
    assert sorted({int(r["Generation"]) for r in rows}) == list(range(gens))
    with open(os.path.join(run_dir, f"final_pareto{suffix}.csv"), newline="") as f:
        front = list(csv.reader(f))
    # an empty front is written as a bare header line: nothing to check
    assert len(front) > 1, f"{preset}: no feasible genome in the final front"
    assert front[0] == ["Accuracy", "Size_MB", "FPR", *GENE_ORDER], front[0]
    assert os.path.exists(os.path.join(run_dir, f"all_generations{suffix}.xlsx"))
    stages: dict = {}
    with open(os.path.join(run_dir, "progress.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["event"] == "stage" and rec["stage"] != "generation":
                stages[rec["stage"]] = stages.get(rec["stage"], 0.0) + rec["seconds"]
    best = max(float(r["Accuracy"]) for r in rows)
    log(f"[{tag}] {preset} pop {pop} x {gens} gens in "
        f"{time.perf_counter() - t0:.1f} s; best val acc {best!r}; front "
        f"{len(front) - 1} rows; stage seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))


def synth_birds(rng, per_class: int):
    """Class-dependent 5-s 'calls' that a CNN ending in global average
    pooling can tell apart by local shape: class k repeats a 0.15-s
    syllable whose sweep (falling, flat or rising), trill (15 Hz notes or
    one tone) and harmonics (one or three) are set by k, at a class-specific
    rate, with a random pitch, phase, gain and noise floor."""
    import numpy as np

    sr = 16000
    labels = np.repeat(np.arange(BIRD_CLASSES), per_class)
    t = np.arange(BIRD_N_SAMPLES) / sr
    wavs = np.empty((len(labels), BIRD_N_SAMPLES), np.float32)
    syl = 0.15  # syllable length, s
    for i, k in enumerate(labels):
        f0 = rng.uniform(600.0, 1200.0)
        sweep = (-0.5, 0.0, 0.8)[k % 3] * f0  # over one syllable
        rate = 2.0 + (k % 4)  # syllables per second
        pos = (t - rng.uniform(0.0, 1.0 / rate)) % (1.0 / rate)
        frac = np.clip(pos / syl, 0, 1)
        env = np.where(pos < syl, np.sin(np.pi * frac), 0.0)
        if (k // 3) % 2:
            env = env * (np.sin(2 * np.pi * 15.0 * pos) > 0)
        phase = 2 * np.pi * np.cumsum(f0 + sweep * frac) / sr
        tone = sum(np.sin(h * phase) / h for h in (1, 2, 3)[:1 + 2 * (k // 6)])
        y = rng.uniform(0.2, 0.7) * env * tone
        wavs[i] = y + rng.uniform(0.005, 0.03) * rng.standard_normal(BIRD_N_SAMPLES)
    return wavs, labels


def phase_bird_extract(seed: int, device: str, wav_dir: str,
                       data_dir: str) -> None:
    import numpy as np

    from cmoop_audio_processing_torch.cli import extract_features as cli
    from cmoop_audio_processing_torch.data.loaders import load_npy_dir
    from cmoop_audio_processing_torch.frontend import reference_impl
    from cmoop_audio_processing_torch.frontend.audio_io import save_wav

    rng = np.random.default_rng(seed + 2)
    wavs, labels = synth_birds(rng, BIRD_PER_CLASS)
    shutil.rmtree(wav_dir, ignore_errors=True)
    for i, (y, k) in enumerate(zip(wavs, labels)):
        os.makedirs(os.path.join(wav_dir, f"call_{k:02d}"), exist_ok=True)
        save_wav(os.path.join(wav_dir, f"call_{k:02d}", f"{i:04d}.wav"), y, 16000)
    t0 = time.perf_counter()
    assert cli.main(["--wav-dir", wav_dir, "--out", data_dir, "--kind",
                     "log_mel", "--duration", "5", "--layout", "npy",
                     "--device", device]) == 0
    secs = time.perf_counter() - t0
    data = load_npy_dir(data_dir)
    sizes = [len(data[f"x_{s}"]) for s in ("train", "val", "test")]
    assert sum(sizes) == len(wavs), sizes
    for split in ("train", "val", "test"):
        x = data[f"x_{split}"]
        assert x.shape[1:] == (501, 40) and np.isfinite(x).all(), (split, x.shape)
    # the first training rows against the numpy float64 oracle (librosa's
    # conventions), on the 16-bit wavs the CLI read
    paths, file_labels, _ = cli.collect_wavs(wav_dir)
    train, _, _ = cli.split_indices(file_labels, (0.7, 0.15, 0.15), 42)
    for j in range(4):
        clip = cli.load_clip(paths[train[j]], 16000, BIRD_N_SAMPLES)
        want = reference_impl.log_mel_spectrogram(clip.astype(np.float64),
                                                  top_db=80.0)
        err = float(np.abs(data["x_train"][j] - want).max())
        assert err <= 3e-2, f"row {j}: log-mel off the float64 oracle by {err}"
        assert data["y_train"][j] == file_labels[train[j]]
    log(f"[bird-extract] {len(wavs)} wavs -> CLI -> (n, 501, 40) log-mel in "
        f"{secs:.2f} s; split {sizes[0]}/{sizes[1]}/{sizes[2]} -> "
        f"{os.path.relpath(data_dir, ROOT)}")


BIRD_GENOMES = [SMOKE_GENOMES[0], SMOKE_GENOMES[1]]  # widest, narrowest


def read_launches(records: dict, names, path: str) -> None:
    """Each kernel's launches in the path's run, which must all have taken
    the FFT route."""
    from cmoop_audio_processing_torch.frontend import cuda_kernels as ck

    for name in names:
        ran = [r for r in ("fft", "dense") if ck.route_counts[f"{name}/{r}"] > 0]
        records[name]["launches"] = ck.launch_counts[name]
        records[name]["dft_route"] = "+".join(ran)
        if ran != ["fft"]:
            raise AssertionError(f"kernel {name} on the {path} path: launches "
                                 f"by route {ck.route_counts}")


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
    from cmoop_audio_processing_torch.core.config import TrainConfig
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
    phase_train("train", "cuda", data_dir, SMOKE_GENOMES,
                TrainConfig(epochs=4, compute_dtype="bfloat16"), min_acc=0.5)
    phase_search("search", "nsga_penalty", "cuda", data_dir,
                 os.path.join(WORK, "results"), epochs=3, pop=8, gens=2)
    read_launches(records, ["mfcc_fused"], "KWS")

    bird_dir = os.path.join(WORK, "bird_npy")
    cuda_kernels.reset_launch_counts()
    phase_bird_extract(args.seed, "cuda", os.path.join(WORK, "bird_wavs"),
                       bird_dir)
    phase_train("bird-train", "cuda", bird_dir, BIRD_GENOMES,
                TrainConfig(num_classes=BIRD_CLASSES, template="B", epochs=4,
                            compute_dtype="bfloat16"), min_acc=BIRD_MIN_ACC)
    phase_search("bird-search", "sa_nsga_penalty", "cuda", bird_dir,
                 os.path.join(WORK, "results"), epochs=BIRD_SEARCH_EPOCHS,
                 pop=6, gens=2)
    read_launches(records, ["log_mel_fused"], "BirdCLEF")
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": list(records.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
