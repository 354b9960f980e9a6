"""GPU smoke run of the PyTorch port's paths on one CUDA card:

* KWS: 1-s wavs -> fused MFCC kernel -> population trainer -> NSGA-II front;
* KWS-MOBO: the same MFCC split -> MOBO search (one-lane trainings, GP fits
  on the card) -> the front's first genome retrained and exported -> the
  validation wavs through the fused MFCC kernel into the exported model ->
  the NSGA-II and MOBO fronts compared;
* BirdCLEF: 5-s wav files -> extraction CLI (fused log-mel kernel) -> 501x40
  npy split -> template-B population trainer -> GP-surrogate SA-NSGA-II
  (``sa_nsga_penalty``) front;
* the evaluator's launch planner on both splits: lane compaction, the vmap
  setting, fitness-cache replay, the card's executed training FLOP rate;
* the device mesh on the one card: pop shards and data shards;
* the heavy-lane split and the launch-duration bound on the BirdCLEF split;
* the exhaustive sweep's template B, all 288 genomes;
* the all-8 harness at a toy size, its run record and its resume;
* the all-8 harness on the exhaustive tables (no training) at its
  committed volume, its GP fits on the card.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; nothing is caught):

1. build   — compile every CUDA kernel from csrc/ (nvcc, sm_90a), one nvcc
             per kernel, and the native HV core (native/hv.cpp, g++), all
             started together; ptxas's registers and spills for each
             kernel function;
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
             repeat bit for bit, and every launch must hold the lane count
             the default policy's split rule gives its bucket (as in
             phases 5, 10 and 11);
5. search  — the CLI, ``--preset nsga_penalty --source npy --device cuda``;
             its per-generation and final CSVs must carry the reference
             schema, and its front must not be empty;
6. mobo-search — the CLI, ``--preset mobo_penalty`` on phase 3's split:
             15 initial genomes + 4 acquisitions, each a one-lane training,
             and 4 GP refits on the card; ``mobo_pareto.csv`` with the
             reference columns (CV included) and at least one feasible
             genome, ``mobo_iterations.xlsx`` with the 19 archive rows; the
             seconds per true evaluation and per GP fit from the run's stage
             timers;
7. deploy  — ``cli/train_final.py`` on the MOBO front's first row, twice:
             the two ``model.npz`` must be the same bytes; ``load_model`` +
             ``predict`` on the card over the split's validation set must
             give the logits of the weights ``train_single`` trains in the
             same process bit for bit, and the validation loss (1%) and
             accuracy (one sample) that ``meta.json`` reports; the
             validation wavs, extracted again through ``mfcc_fused`` and
             standardized with the training split's scaler, must give the
             split's features and logits bit for bit;
8. compare — ``cli/compare.py`` on phase 5's and phase 6's fronts, on the
             native HV core built in phase 1: each front's hypervolume
             finite and above 0;
9. bird-extract — 11 classes x 120 synthetic 5-s bird calls written as
             16-bit wavs, then ``cli/extract_features.py --kind log_mel
             --duration 5 --layout npy --device cuda``; (n, 501, 40) rows,
             the first against the float64 oracle;
10. bird-train — template B at 501x40 in bf16, the widest and the narrowest
             genome, twice: bit-for-bit repeatable fitness; peak memory;
11. bird-search — the CLI, ``--preset sa_nsga_penalty --source npy --device
             cuda``: GP fits on the card; the reference's surrogate
             artifacts, with a front of at least one feasible genome. At
             501x40 the split rule trains the heavy buckets' genomes in
             one-lane launches, and the duration bound chunks the longest;
12. planner — 8 genomes of one (64, 5) bucket, mixed depth, BN and dropout,
             on phase 3's split in bf16 (12 epochs, patience 2): one-shot,
             compacted every 2 epochs (twice), the vmap setting one-shot,
             and a fresh evaluator on the compacted run's fitness cache.
             The compacted run must really compact, repeat bit for bit
             and agree with the one-shot run within ``patience`` epochs and
             one validation sample; the replay must return its fitness bit
             for bit and train nothing; the vmap run must equal the
             one-shot run bit for bit. Then the executed training FLOP rate
             at KWS and at BirdCLEF 501x40 (phase 9's split, 1 and 2
             lanes, 2 epochs). Last, the vmap setting against the grouped
             one from the same params and BN state, initial and after each
             of 3 epochs of grouped training, in f32 and bf16: a training
             step's logits, BN state and gradients and a validation pass's
             metrics must be bit for bit;
13. mesh   — the device mesh in a world of one process, on phase 3's split
             at full width, 3 epochs: ``--mesh 1`` through the CLI against
             the same run without a mesh, one-shot, bit for bit; the
             planner's genomes on a (4, 1) mesh over ``[cuda:0] * 4`` in
             bf16 bit for bit against the no-mesh run whose launches hold
             2 lanes, and repeating itself; on a (2, 2) mesh in f32 (batch
             rows split, BN and gradients over the global batch), one step
             and one validation pass at a time split by the mesh's own
             placement against the unsplit population, by the JAX
             package's bounds. Each run's seconds and its drift from the
             8-lane no-mesh run are printed;
14. split  — the planner's 8 genomes on phase 9's BirdCLEF split in bf16,
             for enough epochs (at least 3) that the split rule splits
             their bucket: fused (one 8-lane launch), the default policy
             without a duration bound (8 one-lane launches at their own
             depths), each genome alone, and the default policy with a
             budget of 2.5 one-lane epochs (segmented launches). The split
             must equal each genome alone and the segmented run bit for
             bit; trainings per hour of fused and split, the split's drift
             from fused and the executed one-lane rates at BirdCLEF and KWS
             beside the rate the plan assumes are printed;
15. exhaustive — the port's exhaustive sweep
             (``examples/run_exhaustive.sweep``) on template B at 2 epochs,
             all 288 genomes on the synthetic KWS shape (2000 rows of
             44x13): 288 rows, each genome's ``Size_MB`` equal to the JAX
             package's committed ``examples/exhaustive/exhaustive_B_288.csv``
             string for string, and every launch the split rule's lane
             count; the launches, one-lane launches, seconds and trainings
             per hour are printed beside the card. Budget 150 s;
16. all8   — the all-8 harness (``examples/run_all8``) at a toy size on the
             card: pop 4, one generation, 2 epochs, fused launches
             (``--compaction-chunk 0``). Every search's entry in the run
             record ``all8_run.json`` must name the card; a ``--resume``
             must run no search and leave every front, ``Final.csv`` and
             the report as they were; with the first SA-family entry that
             trained taken out of the record, a ``--resume`` must run that
             search alone, training nothing (cache hits only), and write
             its front and the report byte for byte; a resume under another
             ``--compaction-chunk`` must be refused, by the run record and,
             with the record gone, by the fitness cache. Budget 90 s;
17. oracle — ``run_all8 --table-eval`` at seed 7, pop 10, 8 generations:
             every fitness read from the JAX package's exhaustive tables
             (template A for stage 1 and MOBO, B for the SA family), the
             GP fits on the card. It must exit with the harness's verdict
             (0 or 1); the run record must hold all 11 searches, each naming
             the card; every front row must be its template's table row in
             ``Size_MB``, rows whose accuracy or FPR differ (the SA family's
             surrogate-predicted survivors) counted, and a 2-stage SA
             front's PSI seed rows may hold the template-A table's fitness.
             Each method's GD and IGD against the truth are printed beside
             the committed CPU values for seed 7
             (``examples/artifacts/search_parity/seed_7.json``), with the
             GP refits' seconds. Budget 180 s.

Launch counts are zeroed just before each path (phase 3, phase 6, phase 9)
and read just after it (phase 5, phase 8, phase 11): each kernel of a path
must have launched there, on the FFT route only. A kernel record's
``launches`` is its count on the first path that runs it, and
``path_launches`` holds its count on each path. The last lines are one
JSON object with the kernel records, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
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
import tempfile
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
MOBO_ITERS = 4  # acquisitions after the preset's 15 initial genomes
MOBO_EPOCHS = 3
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
    from cmoop_audio_processing_torch.native import build as native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:
        hv = pool.submit(native.build)
        reports = list(pool.map(ptxas_report, KERNELS))
        assert hv.result(), "the native HV core did not build (g++)"
    secs = time.perf_counter() - t0
    log(f"[build] native HV core -> {os.path.relpath(native.HV_LIB, ROOT)}")
    for name, report in zip(KERNELS, reports):
        log(f"[build] {name} -> {os.path.relpath(build_library(name), ROOT)}")
        for fn, regs, st, ld in ptxas_summary(report):
            log(f"[build]   ptxas {fn}: {regs} registers, spill stores {st} B, "
                f"spill loads {ld} B")
    log(f"[build] {len(KERNELS)} kernels and the HV core in {secs:.1f} s")


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


def phase_extract(seed: int, device: str, n_wavs: int, data_dir: str):
    """The KWS split, extracted on ``device``; returns the validation wavs."""
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
    return wavs[va]


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


def recording(ev, calls: list):
    """Wrap ``ev.evaluate`` to append, for each call, the genomes it had to
    train (those its fitness cache did not hold) and its timing record."""
    evaluate = ev.evaluate

    def wrapped(genomes, seed=0):
        cache = ev.fitness_cache
        fresh = [g for g in genomes if cache is None or cache.get(g, seed) is None]
        out = evaluate(genomes, seed=seed)
        calls.append((fresh, ev.timings[-1]))
        return out

    ev.evaluate = wrapped
    return ev


def check_split_rule(tag: str, ev, calls) -> None:
    """Every launch of ``calls`` (from ``recording``) has the lane count
    the default policy gives its bucket: one lane a genome where
    ``_should_split_lanes`` holds for the bucket, else one launch of the
    bucket's genomes padded to a power of two. The buckets are the
    default (filters, kernel_size, residual_blocks) ones, so a record's
    (filters, kernel, max_blocks) names its bucket."""
    from collections import Counter

    assert ev.cfg.compaction_chunk == -1 and ev.mesh is None, ev.cfg
    assert tuple(ev.cfg.bucket_genes) == ("filters", "kernel_size",
                                          "residual_blocks"), ev.cfg
    n_split = n_launches = 0
    for fresh, timing in calls:
        sizes = Counter((g["filters"], g["kernel_size"], g["residual_blocks"])
                        for g in fresh)
        want = Counter()
        for (f, k, b), n in sizes.items():
            assert n <= ev.cfg.max_models_per_program, (f, k, b, n)
            split = ev._should_split_lanes(f, k, [{"residual_blocks": b}])
            n_split += split and n > 1
            if split:
                want[(f, k, b, 1)] += n
            else:
                want[(f, k, b, 1 << (n - 1).bit_length())] += 1
        got = Counter((r["filters"], r["kernel"], r["max_blocks"], r["pop"])
                      for r in timing["chunks"])
        if got != want:
            raise AssertionError(f"[{tag}] launches {sorted(got.items())} are "
                                 "not the split rule's "
                                 f"{sorted(want.items())}")
        n_launches += len(timing["chunks"])
    log(f"[{tag}] launch plan: {n_launches} launches over {len(calls)} "
        f"evaluations, each with the split rule's lane count "
        f"({n_split} buckets of several genomes split into one-lane "
        f"launches; rule: one lane's run >= "
        f"{ev._MIN_SPLIT_PROGRAM_SECONDS} s at "
        f"{ev._SUSTAINED_FLOPS_PER_S / 1e12:g} TFLOP/s)")


def phase_train(tag: str, device: str, data_dir: str, genomes, cfg,
                min_acc: float) -> None:
    """``PopulationEvaluator.evaluate`` under ``cfg`` on ``genomes``, twice:
    the fitness must repeat bit for bit, the best genome must pass
    ``min_acc`` and every launch must have the split rule's lane count."""
    import torch

    from cmoop_audio_processing_torch.core.config import DataConfig
    from cmoop_audio_processing_torch.data.pipeline import prepare_dataset
    from cmoop_audio_processing_torch.engine.evaluator import PopulationEvaluator

    data = prepare_dataset(DataConfig(source="npy", path=data_dir,
                                      num_classes=cfg.num_classes))
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(2):
        calls = []
        ev = recording(PopulationEvaluator(data, cfg, device=device), calls)
        t0 = time.perf_counter()
        runs.append(ev.evaluate(genomes, seed=7))
        log(f"[{tag}] {len(genomes)} genomes, {ev.timings[-1]['launches']} "
            f"training segments, lanes per launch "
            f"{[r['pop'] for r in ev.timings[-1]['chunks']]}, "
            f"{time.perf_counter() - t0:.2f} s")
        check_split_rule(tag, ev, calls)
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


def stage_seconds(run_dir: str) -> dict:
    """{stage: [seconds, ...]} from a run's progress.jsonl stage timers."""
    stages: dict = {}
    with open(os.path.join(run_dir, "progress.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["event"] == "stage":
                stages.setdefault(rec["stage"], []).append(rec["seconds"])
    return stages


def phase_search(tag: str, preset: str, device: str, data_dir: str,
                 out_dir: str, epochs: int, pop: int, gens: int) -> None:
    """The CLI on ``preset``: its per-generation CSV and its final front,
    under the reference script's own file names, must carry the reference
    schema, the front must hold at least one feasible genome, and every
    launch must have the split rule's lane count."""
    from cmoop_audio_processing_torch.cli import main as cli
    from cmoop_audio_processing_torch.core.config import get_preset
    from cmoop_audio_processing_torch.core.genome import GENE_ORDER

    run_dir = os.path.join(out_dir, preset)
    shutil.rmtree(run_dir, ignore_errors=True)  # a fresh run, fresh progress log
    make, made, calls = cli.make_evaluator, [], []

    def make_recording(*a, **kw):  # the CLI's own evaluator, recorded
        made.append(recording(make(*a, **kw), calls))
        return made[-1]

    cli.make_evaluator = make_recording
    t0 = time.perf_counter()
    try:
        rc = cli.main([
            "--preset", preset, "--source", "npy", "--data-path", data_dir,
            "--device", device, "--max-gen", str(gens), "--pop-size",
            str(pop), "--epochs", str(epochs), "--out", out_dir,
        ])
    finally:
        cli.make_evaluator = make
    assert rc == 0, rc
    check_split_rule(tag, made[0], calls)
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
    stages = {k: sum(v) for k, v in stage_seconds(run_dir).items()
              if k != "generation"}
    best = max(float(r["Accuracy"]) for r in rows)
    log(f"[{tag}] {preset} pop {pop} x {gens} gens in "
        f"{time.perf_counter() - t0:.1f} s; best val acc {best!r}; front "
        f"{len(front) - 1} rows; stage seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))


def phase_mobo_search(device: str, data_dir: str, out_dir: str) -> str:
    """The CLI on ``mobo_penalty``: the reference's MOBO artifacts, a front
    of at least one feasible genome. Returns the front's path."""
    from cmoop_audio_processing_torch.cli.main import main as cli_main
    from cmoop_audio_processing_torch.core.config import get_preset
    from cmoop_audio_processing_torch.core.genome import GENE_ORDER
    from cmoop_audio_processing_torch.utils.xlsx import read_rows

    preset = "mobo_penalty"
    n_init = get_preset(preset).mobo.initial_samples
    run_dir = os.path.join(out_dir, preset)
    shutil.rmtree(run_dir, ignore_errors=True)  # a fresh run, fresh progress log
    t0 = time.perf_counter()
    assert cli_main([
        "--preset", preset, "--source", "npy", "--data-path", data_dir,
        "--device", device, "--max-gen", str(MOBO_ITERS),
        "--epochs", str(MOBO_EPOCHS), "--out", out_dir,
    ]) == 0
    secs = time.perf_counter() - t0
    front_path = os.path.join(run_dir, "mobo_pareto.csv")
    with open(front_path, newline="") as f:
        front = list(csv.reader(f))
    # an empty front is written as one empty line
    assert len(front) > 1, f"{preset}: no feasible genome in the front"
    assert front[0] == ["Accuracy", "Size_MB", "FPR", "CV", *GENE_ORDER], front[0]
    header, archive = read_rows(os.path.join(run_dir, "mobo_iterations.xlsx"))
    assert header[:5] == ["Iteration", "Accuracy", "Size_MB", "FPR", "CV"], header
    assert len(archive) == n_init + MOBO_ITERS, len(archive)
    stages = stage_seconds(run_dir)
    assert len(stages["true_eval"]) == len(stages["gp_fit"]) == MOBO_ITERS, stages
    init_per_eval = stages["init_eval"][0] / n_init
    eval_s = sum(stages["true_eval"]) / MOBO_ITERS
    fit_s = sum(stages["gp_fit"]) / MOBO_ITERS
    best = max(float(r[1]) for r in archive)
    log(f"[mobo-search] {preset}: {n_init} initial + {MOBO_ITERS} acquired "
        f"one-lane trainings x {MOBO_EPOCHS} epochs in {secs:.1f} s; best val "
        f"acc {best!r}; front {len(front) - 1} rows; seconds per true "
        f"evaluation: initial design {init_per_eval:.3f}, acquisitions "
        f"{eval_s:.3f} ({', '.join(f'{v:.3f}' for v in stages['true_eval'])}); "
        f"per GP refit (3 objective GPs + 1 CV GP) {fit_s:.3f} "
        f"({', '.join(f'{v:.3f}' for v in stages['gp_fit'])})")
    return front_path


def phase_deploy(device: str, data_dir: str, val_wavs, front: str,
                 out_dir: str) -> None:
    """``cli/train_final.py`` on the front's first row, twice: the same
    ``model.npz`` bytes. The reloaded model's logits on the card must equal
    those of the weights ``train_single`` trains in this process for the
    same preset, genome and seed, and their validation loss and accuracy
    must be ``meta.json``'s; the validation wavs, extracted again through
    the MFCC kernel, must give the split's features and logits bit for
    bit."""
    import dataclasses

    import numpy as np

    from cmoop_audio_processing_torch.cli import train_final
    from cmoop_audio_processing_torch.core.config import get_preset
    from cmoop_audio_processing_torch.data.pipeline import prepare_dataset
    from cmoop_audio_processing_torch.engine.export import (
        load_model,
        predict,
        train_single,
    )
    from cmoop_audio_processing_torch.frontend.features import (
        FrontendConfig,
        extract_features,
    )

    preset = "nsga_penalty"  # keeps the last-epoch weights, reports their metrics
    npz = []
    for _ in range(2):
        t0 = time.perf_counter()
        assert train_final.main([
            "--preset", preset, "--front", front, "--row", "0",
            "--source", "npy", "--data-path", data_dir, "--device", device,
            "--epochs", str(MOBO_EPOCHS), "--out", out_dir,
        ]) == 0
        log(f"[deploy] train_final in {time.perf_counter() - t0:.2f} s")
        with open(os.path.join(out_dir, "model.npz"), "rb") as f:
            npz.append(f.read())
    assert npz[0] == npz[1], "two exports of one training differ"
    genome, spec, params, state, meta = load_model(out_dir, device=device)
    assert genome == train_final.genome_from_row(front, 0), genome
    cfg = get_preset(preset)
    data = prepare_dataset(dataclasses.replace(cfg.data, source="npy",
                                               path=data_dir))
    # the weights before the save/load round trip: a layout or BN-state
    # fault of the round trip changes the logits, which a saturated
    # accuracy would not show
    t_params, t_state, t_metrics = train_single(
        genome, data, dataclasses.replace(cfg.train, epochs=MOBO_EPOCHS),
        seed=0, device=device)
    assert t_metrics == meta["metrics"], (t_metrics, meta["metrics"])
    want = predict(spec, genome, t_params, t_state, data["x_val"], device=device)
    logits = predict(spec, genome, params, state, data["x_val"], device=device)
    assert np.isfinite(logits).all()
    if not np.array_equal(logits, want):
        raise AssertionError("reloaded model's logits off the trained "
                             f"weights' by {np.abs(logits - want).max()}")
    # the trainer's own validation pass scored these weights: its loss is
    # meta.json's, so the exported leaves are the ones the metrics measured
    z = logits - logits.max(-1, keepdims=True)
    log_p = z - np.log(np.exp(z).sum(-1, keepdims=True))
    y_val = data["y_val"]
    loss = float(-log_p[np.arange(len(y_val)), y_val].mean())
    meta_loss = meta["metrics"]["val_loss"]
    assert abs(loss - meta_loss) <= 1e-2 * meta_loss + 1e-4, (loss, meta_loss)
    acc = float((logits.argmax(-1) == y_val).mean())
    n_val = len(y_val)
    meta_acc = meta["metrics"]["accuracy"]
    assert abs(acc - meta_acc) <= 1.0 / n_val + 1e-6, (acc, meta_acc, n_val)
    # a deployed model's input: wav -> MFCC kernel -> the training scaler
    feats = extract_features(val_wavs, FrontendConfig(hop_length=KWS_HOP,
                                                      n_mfcc=13),
                             kind="mfcc", device=device)
    x = data["scaler"].transform(feats)[..., None]
    if not np.array_equal(x, data["x_val"]):
        raise AssertionError("validation wavs through mfcc_fused: features "
                             f"off the split's by {np.abs(x - data['x_val']).max()}")
    wav_logits = predict(spec, genome, params, state, x, device=device)
    assert np.array_equal(wav_logits, logits), "wav-path logits differ"
    log(f"[deploy] {genome} -> {os.path.relpath(out_dir, ROOT)}: model.npz "
        f"{len(npz[0])} B, the same bytes twice; predict on {device}: logits "
        f"equal to the trained weights' bit for bit; val loss {loss!r} "
        f"(meta.json {meta_loss!r}), acc {acc!r} over {n_val} (meta.json "
        f"{meta_acc!r}); the wavs through mfcc_fused give the split's "
        f"features and logits bit for bit")


def phase_compare(fronts: dict, report: str) -> None:
    """``cli/compare.py`` on named fronts: each hypervolume finite, > 0."""
    import math

    from cmoop_audio_processing_torch.cli import compare
    from cmoop_audio_processing_torch.metrics import hypervolume

    assert hypervolume.core() == "native", "the HV core built in phase 1 " \
        "did not load"
    assert compare.main([f"--front={k}={v}" for k, v in fronts.items()]
                        + ["--out", report]) == 0
    with open(report) as f:
        rep = json.load(f)
    hv = rep["hypervolume"]
    assert sorted(hv) == sorted(fronts), hv
    assert all(math.isfinite(v) and v > 0 for v in hv.values()), hv
    log(f"[compare] hypervolume {hv} ({hypervolume.core()} core); true "
        f"front {rep['true_front_size']} rows")


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


# the planner phase: 8 genomes of one (filters, kernel) bucket at full
# width, of mixed depth, BN, FC entry and dropout
PLANNER_GENOMES = [
    dict(filters=64, kernel_size=5, use_bn=bn, residual_blocks=nb,
         fc_layers=nfc, use_dropout=do)
    for bn, nb, nfc, do in ((True, 3, 4, True), (False, 1, 1, False),
                            (True, 1, 2, True), (True, 2, 3, False),
                            (False, 2, 4, True), (True, 3, 1, False),
                            (False, 3, 2, True), (True, 2, 1, True))
]
PLANNER_EPOCHS = 12
PLANNER_PATIENCE = 2
# Three times the presets' learning rate, compaction every 2 epochs: the
# population halves once 4 of its 8 lanes have stopped at a chunk's end.
# At 1e-3 nearly every genome still improves at the 12-epoch cap on this
# easy synthetic split. Since the grouped forward took the layout that
# keeps a lane's bits independent of its lane count (PERF.md), 2e-3 stops
# 3 lanes before the cap, and 3e-3 stops 5, the fourth at epoch 10, which
# a 3-epoch chunk does not end on
PLANNER_CHUNK = 2
PLANNER_LR = 3e-3
VMAP_EPOCHS = 3
# Bounds on a vmap step against the grouped step from the same state
# (``vmap_step``): the vmap setting runs the grouped forward
# (engine/trainer.py), so every reading is 0 on the card, in f32 and bf16,
# from the initial and trained states (PERF.md): logits, BN state,
# gradients, validation loss, accuracy and FPR bit for bit.
VMAP_BOUNDS = {
    "float32": {"logits": 0.0, "state": 0.0, "grads": 0.0, "val_loss": 0.0},
    "bfloat16": {"logits": 0.0, "state": 0.0, "grads": 0.0, "val_loss": 0.0},
}


def phase_planner(device: str, data_dir: str, bird_dir: str, smi: str) -> None:
    """The launch planner on the card, at full width on the KWS split, in
    bf16: (a) one-shot, (b) compacted every 2 epochs, (c) (b) again, (d) the
    vmap setting one-shot, (e) a fresh evaluator on (b)'s fitness cache.
    Gates: (b) really compacted; (c) equals (b) and (e) returns (b)'s
    fitness bit for bit, (e) training nothing; (b) agrees with (a) bit for
    bit or, failing that, within ``patience`` epochs and one validation
    sample; (d) equals (a) bit for bit. How far (b) and (d) drift from (a)
    over the whole run is printed. Then the executed training FLOP rate at KWS and at BirdCLEF
    501x40 (one population, 2 epochs, 1 lane and 2 lanes). Last, the vmap
    setting against the grouped one, from the initial state and from
    trained ones (``vmap_steps``)."""
    import dataclasses

    from cmoop_audio_processing_torch.core.config import DataConfig, TrainConfig
    from cmoop_audio_processing_torch.core.genome import genome_key
    from cmoop_audio_processing_torch.data.pipeline import prepare_dataset
    from cmoop_audio_processing_torch.engine.evaluator import PopulationEvaluator

    log(f"[planner] card: {smi}")
    data = prepare_dataset(DataConfig(source="npy", path=data_dir,
                                      num_classes=CLASSES))
    n_val = len(data["y_val"])
    base = TrainConfig(epochs=PLANNER_EPOCHS, patience=PLANNER_PATIENCE,
                       learning_rate=PLANNER_LR, compute_dtype="bfloat16",
                       bucket_genes=("filters", "kernel_size"))
    cache = os.path.join(WORK, "planner_fitness_cache.jsonl")
    if os.path.exists(cache):
        os.remove(cache)

    def run(tag, cfg, cache_path=None):
        ev = PopulationEvaluator(data, cfg, device=device,
                                 fitness_cache_path=cache_path)
        t0 = time.perf_counter()
        fits = ev.evaluate(PLANNER_GENOMES, seed=5)
        secs = time.perf_counter() - t0
        timing = ev.timings[-1]
        lanes = [r["lanes"] for r in timing["chunks"]]
        log(f"[planner] ({tag}) {secs:.2f} s; {timing['launches']} training "
            f"segments, lanes per segment {lanes}, cache hits "
            f"{timing['cache_hits']}")
        epochs = [ev._epoch_history.get(genome_key(g)) for g in PLANNER_GENOMES]
        return ev, fits, epochs, secs

    ev_a, fits_a, ep_a, secs_a = run("a: one-shot",
                                     dataclasses.replace(base, compaction_chunk=0))
    compacted = dataclasses.replace(base, compaction_chunk=PLANNER_CHUNK)
    ev_b, fits_b, ep_b, _ = run("b: compacted", compacted, cache)
    _, fits_c, _, _ = run("c: compacted again", compacted)
    _, fits_d, ep_d, _ = run("d: vmap one-shot", dataclasses.replace(
        base, compaction_chunk=0, parallel_impl="vmap"))
    ev_e, fits_e, _, _ = run("e: replay of (b)'s cache", compacted, cache)

    (rec_b,) = ev_b.timings[-1]["chunks"]
    if not min(rec_b["lanes"]) < rec_b["lanes"][0]:
        raise AssertionError(f"(b) never compacted: lanes {rec_b['lanes']}, "
                             f"epochs {rec_b['epochs']}")
    if fits_c != fits_b:
        raise AssertionError(f"(c) differs from (b): {fits_c} vs {fits_b}")
    if fits_e != fits_b:
        raise AssertionError(f"(e) differs from (b): {fits_e} vs {fits_b}")
    t_e = ev_e.timings[-1]
    assert t_e["cache_hits"] == len(PLANNER_GENOMES), t_e
    assert t_e["launches"] == 0 and ev_e.total_true_evals == 0, t_e
    for tag, fits, ep in (("b", fits_b, ep_b), ("d", fits_d, ep_d)):
        d_acc = [abs(x[0] - y[0]) for x, y in zip(fits, fits_a)]
        d_fpr = [abs(x[2] - y[2]) for x, y in zip(fits, fits_a)]
        d_ep = [abs(x - y) for x, y in zip(ep, ep_a)]
        n_diff = sum(1 for a, e in zip(d_acc, d_ep) if a or e)
        # accuracies are f32 values: one sample is 1/n_val up to rounding
        within = (max(d_ep) <= PLANNER_PATIENCE
                  and max(d_acc) <= 1.0 / n_val + 1e-6)
        held = ("bit for bit" if fits == fits_a and ep == ep_a else
                "within the bound" if within else "beyond the bound")
        log(f"[planner] ({tag}) against (a): {n_diff} of "
            f"{len(PLANNER_GENOMES)} genomes differ in epochs_ran or "
            f"accuracy; largest |d epochs| {max(d_ep)}, |d acc| "
            f"{max(d_acc)!r} (one validation sample {1 / n_val!r}), |d fpr| "
            f"{max(d_fpr)!r}; {held}; epochs_ran {ep}")
        # (b) runs (a)'s very steps until its first compaction, so only the
        # epochs after it can drift: it is held to the bound. (d) runs
        # (a)'s forward: bit for bit
        if tag == "b" and not within:
            raise AssertionError(f"({tag}) off (a) beyond the bound: epochs "
                                 f"{ep} vs {ep_a}, fitness {fits} vs {fits_a}")
        if tag == "d" and (fits, ep) != (fits_a, ep_a):
            raise AssertionError(f"(d) differs from (a): epochs {ep} vs "
                                 f"{ep_a}, fitness {fits} vs {fits_a}")
    log(f"[planner] epochs_ran (a) {ep_a}; accuracy (a) "
        f"{[round(f[0], 4) for f in fits_a]}")
    planner_rates(device, ev_a, secs_a, bird_dir)

    # the vmap setting against the grouped one from the same states: the
    # initial params and those after each of VMAP_EPOCHS epochs of grouped
    # training, with dropout and no lane stopping, in both compute dtypes
    t0 = time.perf_counter()
    for dtype, bounds in VMAP_BOUNDS.items():
        for epoch, m in enumerate(vmap_steps(device, ev_a, dtype)):
            log(f"[planner] vmap against grouped, {dtype}, after {epoch} "
                f"epochs of grouped training: {m}")
            off = [k for k, b in bounds.items() if m[k] > b]
            off += [k for k in ("grads_max", "val_acc", "val_fpr") if m[k]]
            if off:
                raise AssertionError(f"a vmap step off the grouped one in "
                                     f"{off} after {epoch} epochs ({dtype}): "
                                     f"{m}, bounds {bounds}")
    log(f"[planner] vmap checks {time.perf_counter() - t0:.2f} s")


def vmap_step(device: str, ev, dtype: str, carry=None) -> dict:
    """One training step of the planner's population on the first 64 rows
    of ``ev``'s padded training split, and one validation pass over its
    padded validation split, through the vmap setting and the grouped one,
    from the same params and BN state: ``carry``'s, or the initial ones.
    Returns the largest difference of the step's logits, of its new BN
    state and of the lanes' validation losses, each relative to the
    grouped one's largest magnitude; the norm of the gradients' difference
    relative to the grouped gradients' norm (``grads``) and the largest
    difference relative to the largest gradient (``grads_max``); and the
    largest difference of a lane's validation accuracy and FPR."""
    import torch

    from cmoop_audio_processing_torch.engine import trainer as tt
    from cmoop_audio_processing_torch.models import supernet as ts

    f, k = PLANNER_GENOMES[0]["filters"], PLANNER_GENOMES[0]["kernel_size"]
    spec = ts.BucketSpec("A", f, k, CLASSES, compute_dtype=dtype, max_blocks=3)
    if carry is None:
        params, state, flags = ts.init_population(5, spec, PLANNER_GENOMES,
                                                  device)
    else:
        params, state, flags = carry["params"], carry["state"], carry["flags"]
    x, y, w = (t[:64] for t in ev._train)
    dkey = torch.tensor(5, device=device)
    out = {}
    for impl in ("grouped", "vmap"):
        trainer = tt.PopulationTrainer(
            spec, tt.TrainSettings(parallel_impl=impl), CLASSES)
        leaves = ts.tree_map(lambda t: t.detach().requires_grad_(True), params)
        logits, new_state = trainer.forward(leaves, state, flags, x,
                                            train=True, dropout_key=dkey)
        loss, _ = trainer.pop_loss(leaves, state, flags, x, y, w, dkey)
        grads = torch.autograd.grad(loss, ts.tree_leaves(leaves))
        out[impl] = ([logits.detach()],
                     [t.detach() for t in ts.tree_leaves(new_state)], grads,
                     trainer.evaluate(params, state, flags, ev._val))

    def rel(got, want):
        return (max(float((a - b).float().abs().max()) for a, b in zip(got, want))
                / max(float(b.float().abs().max()) for b in want))

    (lg_g, st_g, gr_g, (loss_g, acc_g, fpr_g)) = out["grouped"]
    (lg_v, st_v, gr_v, (loss_v, acc_v, fpr_v)) = out["vmap"]
    def norm(ts_):
        return sum(float(t.float().pow(2).sum()) for t in ts_) ** 0.5

    return {"logits": rel(lg_v, lg_g), "state": rel(st_v, st_g),
            "grads": norm([a - b for a, b in zip(gr_v, gr_g)]) / norm(gr_g),
            "grads_max": rel(gr_v, gr_g),
            "val_loss": rel([loss_v], [loss_g]),
            "val_acc": float((acc_v - acc_g).abs().max()),
            "val_fpr": float((fpr_v - fpr_g).abs().max())}


def vmap_steps(device: str, ev, dtype: str):
    """``vmap_step`` from the initial params and after each of
    ``VMAP_EPOCHS`` epochs of grouped training of the planner's population
    on ``ev``'s padded splits in ``dtype``, with a patience no lane
    reaches; yields its results."""
    import dataclasses

    from cmoop_audio_processing_torch.engine import trainer as tt
    from cmoop_audio_processing_torch.models import supernet as ts

    f, k = PLANNER_GENOMES[0]["filters"], PLANNER_GENOMES[0]["kernel_size"]
    spec = ts.BucketSpec("A", f, k, CLASSES, compute_dtype=dtype, max_blocks=3)
    trainer = tt.PopulationTrainer(spec, dataclasses.replace(
        ev.settings, epochs=VMAP_EPOCHS, patience=VMAP_EPOCHS + 1), CLASSES)
    carry = trainer.init_carry(
        *ts.init_population(5, spec, PLANNER_GENOMES, device))
    yield vmap_step(device, ev, dtype, carry)
    for epoch in range(VMAP_EPOCHS):
        carry = trainer.run_chunk(carry, ev._train, ev._val,
                                  tt.train_key_of(5), epoch + 1)
        yield vmap_step(device, ev, dtype, carry)
    assert not bool(carry["stopped"].any())


def planner_rates(device: str, kws_ev, kws_secs: float, bird_dir: str) -> None:
    """Executed training FLOP rates: KWS from ``kws_ev``'s last (one-shot)
    launch, BirdCLEF 501x40 from one population of 1 and of 2 lanes, 2
    epochs each, nothing stopping early."""
    from cmoop_audio_processing_torch.core.config import DataConfig, TrainConfig
    from cmoop_audio_processing_torch.data.pipeline import prepare_dataset
    from cmoop_audio_processing_torch.engine.evaluator import PopulationEvaluator

    f, k = PLANNER_GENOMES[0]["filters"], PLANNER_GENOMES[0]["kernel_size"]
    (rec,) = kws_ev.timings[-1]["chunks"]
    spec = kws_ev._bucket_spec(f, k, rec["max_blocks"])
    rate = kws_ev._epoch_flops(rec["pop"], spec) * max(rec["epochs"]) / kws_secs
    log(f"[planner] KWS executed training rate {rate / 1e12:.4f} TFLOP/s "
        f"({rec['pop']} lanes x {max(rec['epochs'])} epochs, {kws_secs:.2f} s)")
    bird = prepare_dataset(DataConfig(source="npy", path=bird_dir,
                                      num_classes=BIRD_CLASSES))
    bird_cfg = TrainConfig(num_classes=BIRD_CLASSES, template="B", epochs=2,
                           patience=10, compute_dtype="bfloat16",
                           compaction_chunk=0,
                           bucket_genes=("filters", "kernel_size"))
    pair = [PLANNER_GENOMES[0], PLANNER_GENOMES[5]]  # both 3 blocks
    for lanes in (1, 2):
        ev = PopulationEvaluator(bird, bird_cfg, device=device)
        t0 = time.perf_counter()
        ev.evaluate(pair[:lanes], seed=5)
        secs = time.perf_counter() - t0
        spec = ev._bucket_spec(f, k, 3)
        rate = ev._epoch_flops(lanes, spec) * bird_cfg.epochs / secs
        log(f"[planner] BirdCLEF 501x40 executed training rate, {lanes} "
            f"lane(s): {rate / 1e12:.4f} TFLOP/s ({secs:.2f} s for 2 epochs "
            f"of {len(bird['y_train'])} rows)")


MESH_EPOCHS = 3
MESH_LANES_BOUND = 2  # at most 2 genomes differ (the compaction bound)


def _cache_results(path: str) -> list:
    """A fitness cache's result lines in order, its fingerprint dropped."""
    with open(path) as f:
        return [json.loads(line) for line in f][1:]


def _fit_diff(fits, ref, ep, ep_ref, n_val: int):
    """(genomes differing, largest |d epochs|, largest |d acc|, within
    the compaction bound)."""
    d_acc = [abs(x[0] - y[0]) for x, y in zip(fits, ref)]
    d_ep = [abs(x - y) for x, y in zip(ep, ep_ref)]
    n_diff = sum(1 for a, e in zip(d_acc, d_ep) if a or e)
    within = (n_diff <= MESH_LANES_BOUND and max(d_ep) <= PLANNER_PATIENCE
              and max(d_acc) <= 1.0 / n_val + 1e-6)
    return n_diff, max(d_ep), max(d_acc), within


def phase_mesh(device: str, data_dir: str, smi: str) -> None:
    """The device mesh (parallel/mesh.py) on the one card, in a world of
    one process, on the KWS split at full width, 3 epochs:

    (a) ``--mesh 1`` through the CLI (nsga_penalty, pop 4, one generation,
        bf16) against the same run without a mesh with
        ``--compaction-chunk 0``: the same launch plan, so the fitness cache
        lines must be equal bit for bit;
    (b) the planner's 8 genomes on a (4, 1) mesh over ``[cuda:0] * 4`` (2
        lanes a pop shard) in bf16, against the no-mesh run whose launches
        hold 2 lanes in the same genome order (``max_models_per_program``
        2): the same kernels at the same shapes, so bit for bit; then again,
        bit for bit. Its drift from the 8-lane no-mesh run is printed, not
        gated: cuDNN runs other kernels at 2 groups than at 8, and over 3
        epochs, with the best epoch restored, their rounding
        moves a genome's validation accuracy by tens of samples (PERF.md);
    (c) a (2, 2) mesh over ``[cuda:0] * 4`` in f32 (each batch's rows split
        over two entries, BN statistics and gradients over the global
        batch) against the no-mesh run in f32: the whole run is printed,
        not gated, for the same reason (its batches are half as tall).
        Instead one training step and one validation pass at a time, from
        the same states (the initial ones and after one epoch), placed by
        the mesh's own helpers, are held against the unsplit population by
        the JAX package's bounds (tests/test_parallel.py): validation
        accuracy and FPR within rtol 2e-4, logits within 5e-3, equal argmax
        on decisive samples (``mesh_steps``)."""
    import dataclasses

    import torch

    from cmoop_audio_processing_torch.cli.main import main as cli_main
    from cmoop_audio_processing_torch.core.config import DataConfig, TrainConfig
    from cmoop_audio_processing_torch.core.genome import genome_key
    from cmoop_audio_processing_torch.data.pipeline import prepare_dataset
    from cmoop_audio_processing_torch.engine.evaluator import PopulationEvaluator
    from cmoop_audio_processing_torch.parallel.mesh import population_mesh

    log(f"[mesh] card: {smi}")
    t_phase = time.perf_counter()
    # (a) the CLI with --mesh 1 against no mesh, one-shot
    caches = []
    for tag, extra in (("mesh 1", ["--mesh", "1"]),
                       ("no mesh", ["--compaction-chunk", "0"])):
        out = os.path.join(WORK, "mesh_cli", tag.replace(" ", "_"))
        shutil.rmtree(out, ignore_errors=True)
        t0 = time.perf_counter()
        assert cli_main([
            "--preset", "nsga_penalty", "--source", "npy", "--data-path",
            data_dir, "--device", device, "--max-gen", "1", "--pop-size", "4",
            "--epochs", str(MESH_EPOCHS), "--seed", "3", "--out", out,
        ] + extra) == 0
        caches.append(_cache_results(
            os.path.join(out, "nsga_penalty", "fitness_cache.jsonl")))
        log(f"[mesh] (a) CLI {tag}: {len(caches[-1])} trainings, "
            f"{time.perf_counter() - t0:.2f} s")
    if caches[0] != caches[1] or not caches[0]:
        raise AssertionError(f"(a) --mesh 1 differs from no mesh: "
                             f"{caches[0]} vs {caches[1]}")
    log("[mesh] (a) --mesh 1 equals no mesh, one-shot, bit for bit")

    data = prepare_dataset(DataConfig(source="npy", path=data_dir,
                                      num_classes=CLASSES))
    n_val = len(data["y_val"])
    cuda4 = [torch.device(device)] * 4

    def run(tag, cfg, mesh=None):
        ev = PopulationEvaluator(data, cfg, device=device, mesh=mesh)
        t0 = time.perf_counter()
        fits = ev.evaluate(PLANNER_GENOMES, seed=5)
        secs = time.perf_counter() - t0
        epochs = [ev._epoch_history.get(genome_key(g)) for g in PLANNER_GENOMES]
        log(f"[mesh] ({tag}) {secs:.2f} s; {ev.timings[-1]['launches']} "
            f"launches; epochs_ran {epochs}")
        return ev, fits, epochs

    def against(tag, got, ref):
        n_diff, d_ep, d_acc, within = _fit_diff(got[1], ref[1], got[2],
                                                ref[2], n_val)
        log(f"[mesh] ({tag}) against no mesh: {n_diff} of "
            f"{len(PLANNER_GENOMES)} genomes differ; largest |d epochs| "
            f"{d_ep}, |d acc| {d_acc!r} (one validation sample "
            f"{1 / n_val!r}); "
            + ("bit for bit" if got[1:] == ref[1:] else
               "within the bound" if within else "beyond the bound"))
        return within

    # (b) a (4, 1) mesh on one card against the no-mesh run of 2-lane
    # launches, bit for bit, and against itself
    bf16 = TrainConfig(epochs=MESH_EPOCHS, patience=PLANNER_PATIENCE,
                       learning_rate=PLANNER_LR, compute_dtype="bfloat16",
                       compaction_chunk=0,
                       bucket_genes=("filters", "kernel_size"))
    ref_bf16 = run("b: no mesh, bf16", bf16)
    ref_2 = run("b: no mesh, 2-lane launches, bf16",
                dataclasses.replace(bf16, max_models_per_program=2))
    b_bf16 = run("b: (4, 1) mesh, bf16", bf16, population_mesh(4, 1, cuda4))
    b_again = run("b: (4, 1) mesh, bf16, again", bf16,
                  population_mesh(4, 1, cuda4))
    against("b: 2-lane launches against 8, printed", ref_2, ref_bf16)
    against("b: mesh against 8-lane launches, printed", b_bf16, ref_bf16)
    if b_bf16[1:] != ref_2[1:]:
        raise AssertionError(f"(b) the (4, 1) mesh differs from the 2-lane "
                             f"no-mesh run: {b_bf16[1:]} vs {ref_2[1:]}")
    if b_again[1:] != b_bf16[1:]:
        raise AssertionError(f"(b) bf16 does not repeat: {b_again[1:]} vs "
                             f"{b_bf16[1:]}")
    log("[mesh] (b) the (4, 1) mesh equals the 2-lane no-mesh run and "
        "itself, bit for bit")
    # (c) a (2, 2) mesh in f32: the whole run printed, steps held
    f32 = dataclasses.replace(bf16, compute_dtype="float32")
    ref_f32 = run("c: no mesh, f32", f32)
    c = run("c: (2, 2) mesh, f32", f32, population_mesh(2, 2, cuda4))
    assert c[0].settings.parallel_impl == "vmap"
    assert [f[1] for f in c[1]] == [f[1] for f in ref_f32[1]]
    against("c: whole run, printed", c, ref_f32)

    t0 = time.perf_counter()
    mesh = population_mesh(2, 2, cuda4)
    for epoch, m in enumerate(mesh_steps(device, ref_f32[0], mesh)):
        log(f"[mesh] (c) a (2, 2) step against no mesh after {epoch} "
            f"epochs: {m}")
        if not (m["acc_fpr_rel"] <= 2e-4 and m["logits"] <= 5e-3
                and m["argmax_flips"] == 0):
            raise AssertionError(f"(c) off the JAX bounds after {epoch} "
                                 f"epochs: {m}")
    log(f"[mesh] steps {time.perf_counter() - t0:.2f} s; phase "
        f"{time.perf_counter() - t_phase:.2f} s")


def mesh_steps(device: str, ev, mesh):
    """The planner's population in f32 split as ``mesh`` splits it
    (``shard_population``; each pop shard's batches over its data devices
    through ``SplitData``), against the unsplit population, from the same
    params and BN state: the initial ones, then after one epoch of
    unsplit training. For each, one training step on the first 64
    training rows (logits, BN state, gradients) and one validation pass
    (accuracy, FPR, the lanes' logits on the validation rows); yields the
    largest differences."""
    import torch

    from cmoop_audio_processing_torch.engine import trainer as tt
    from cmoop_audio_processing_torch.models import supernet as ts
    from cmoop_audio_processing_torch.parallel.mesh import (
        SplitData, batch_sharding, shard_population)

    f, k = PLANNER_GENOMES[0]["filters"], PLANNER_GENOMES[0]["kernel_size"]
    spec = ts.BucketSpec("A", f, k, CLASSES, compute_dtype="float32",
                         max_blocks=3)
    trainer = tt.PopulationTrainer(spec, ev.settings, CLASSES)
    carry = trainer.init_carry(
        *ts.init_population(5, spec, PLANNER_GENOMES, device))
    dkey = torch.tensor(5, device=device)
    first = torch.arange(64, device=device)

    def run(trees):
        """{name: per-lane results, the pop shards joined}; ``trees`` are
        (params, state, flags, train, val) per pop shard."""
        got = {k_: [] for k_ in ("logits", "state", "grads", "acc", "fpr",
                                 "val_logits")}
        for p, s_, fl, train, val in trees:
            x, y, w = train.take(first)
            leaves = ts.tree_map(lambda t: t.detach().requires_grad_(True), p)
            lg, st = trainer.forward(leaves, s_, fl, x, train=True,
                                     dropout_key=dkey)
            loss, _ = trainer.pop_loss(leaves, s_, fl, x, y, w, dkey)
            got["grads"].append(torch.autograd.grad(loss,
                                                    ts.tree_leaves(leaves)))
            got["logits"].append(torch.cat(lg, 1).detach())
            got["state"].append([t.detach() for t in ts.tree_leaves(st)])
            _, acc, fpr = trainer.evaluate(p, s_, fl, val)
            got["acc"].append(acc)
            got["fpr"].append(fpr)
            with torch.no_grad():
                vl, _ = trainer.forward(p, s_, fl,
                                        val.take(slice(0, val.rows))[0],
                                        train=False)
            got["val_logits"].append(torch.cat(vl, 1))
        # lane axis first on every per-lane result, shards joined
        return {k_: ([torch.cat(c) for c in zip(*v)]
                     if isinstance(v[0], (list, tuple)) else torch.cat(v))
                for k_, v in got.items()}

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    def norm(ts_):
        return sum(float(t.float().pow(2).sum()) for t in ts_) ** 0.5

    for epoch in range(2):
        if epoch:
            carry = trainer.run_chunk(carry, ev._train, ev._val,
                                      tt.train_key_of(5), epoch)
        tree = {"params": carry["params"], "state": carry["state"],
                "flags": carry["flags"]}
        want = run([(*tree.values(), SplitData.of(ev._train),
                     SplitData.of(ev._val))])
        shards = shard_population(tree, mesh)

        def split(data, i):
            return SplitData([tuple(a.to(d) for a in data)
                              for d in batch_sharding(mesh, i)])

        got = run([(t["params"], t["state"], t["flags"], split(ev._train, i),
                    split(ev._val, i)) for i, t in sorted(shards.items())])
        lg_u, lg_s = want["val_logits"], got["val_logits"]
        top2 = lg_u.topk(2, dim=-1).values
        decisive = (top2[..., 0] - top2[..., 1]) > 1e-2
        yield {
            "step_logits": rel(got["logits"], want["logits"]),
            "state": max(rel(a, b) for a, b in zip(got["state"],
                                                  want["state"])),
            "grads": norm([a - b for a, b in zip(got["grads"], want["grads"])])
            / norm(want["grads"]),
            "acc_fpr_rel": max(rel(got[k_], want[k_]) for k_ in ("acc", "fpr")),
            "logits": float((lg_s - lg_u).abs().max()),
            "decisive": float(decisive.float().mean()),
            "argmax_flips": int((lg_u.argmax(-1) != lg_s.argmax(-1))
                                [decisive].sum()),
        }


def phase_split(device: str, data_dir: str, bird_dir: str, smi: str) -> None:
    """The heavy-lane split and the launch-duration bound on the BirdCLEF
    501x40 split (phase 9's), the planner's 8 genomes of one (64, 5) bucket
    in bf16, patience 2, for E epochs: at least 3, and enough that the
    split rule splits the bucket at the port's rate.

    (a) fused: ``compaction_chunk=0``, one 8-lane launch;
    (b) the default policy with ``launch_seconds_budget=0``: 8 one-lane
        launches, each specialized to its genome's depth;
    (c) each genome evaluated alone with ``compaction_chunk=0``;
    (d) the default policy with a budget of 2.5 epochs of a 3-block lane's
        estimate, so that its one-lane launches train in segments.

    Gates: (b)'s launch records; (b) equals (c) bit for bit (accuracy, FPR,
    epochs: the same one-lane kernels); (d) has more training segments
    than (b) has launches and equals (b) bit for bit (chunk boundaries
    alone). Printed: the seconds and trainings per hour of (a) and (b),
    how far (b) is from (a) (another group count), and the executed
    one-lane training rates at BirdCLEF (from (b)) and at KWS (one genome
    on phase 3's split) beside ``_SUSTAINED_FLOPS_PER_S``."""
    import dataclasses
    import math

    from cmoop_audio_processing_torch.core.config import DataConfig, TrainConfig
    from cmoop_audio_processing_torch.core.genome import genome_key
    from cmoop_audio_processing_torch.data.pipeline import prepare_dataset
    from cmoop_audio_processing_torch.engine.evaluator import PopulationEvaluator

    log(f"[split] card: {smi}")
    t_phase = time.perf_counter()
    bird = prepare_dataset(DataConfig(source="npy", path=bird_dir,
                                      num_classes=BIRD_CLASSES))
    n_val = len(bird["y_val"])
    genomes = PLANNER_GENOMES
    f, k = genomes[0]["filters"], genomes[0]["kernel_size"]
    base = TrainConfig(num_classes=BIRD_CLASSES, template="B",
                       patience=PLANNER_PATIENCE, compute_dtype="bfloat16",
                       bucket_genes=("filters", "kernel_size"))
    probe = PopulationEvaluator(bird, base, device=device)
    rate = probe._SUSTAINED_FLOPS_PER_S
    est3 = probe._est_epoch_seconds(1, probe._bucket_spec(f, k, 3))
    epochs = max(3, math.ceil(probe._MIN_SPLIT_PROGRAM_SECONDS / est3))
    base = dataclasses.replace(base, epochs=epochs)
    del probe
    log(f"[split] {epochs} epochs: one 3-block lane's epoch is estimated at "
        f"{est3:.4f} s at {rate / 1e12:g} TFLOP/s; the rule splits at "
        f">= {PopulationEvaluator._MIN_SPLIT_PROGRAM_SECONDS} s a run")

    def run(tag, cfg, alone=False):
        ev = PopulationEvaluator(bird, cfg, device=device)
        t0 = time.perf_counter()
        if alone:
            fits = [ev.evaluate([g], seed=5)[0] for g in genomes]
        else:
            fits = ev.evaluate(genomes, seed=5)
        secs = time.perf_counter() - t0
        ep = [ev._epoch_history[genome_key(g)] for g in genomes]
        chunks = [r for t in ev.timings for r in t["chunks"]]
        segments = sum(t["launches"] for t in ev.timings)
        log(f"[split] ({tag}) {secs:.2f} s, "
            f"{len(genomes) * 3600 / secs:.1f} trainings/h; {len(chunks)} "
            f"launches, {segments} training segments, lanes per launch "
            f"{[r['pop'] for r in chunks]}; epochs_ran {ep}")
        return ev, fits, ep, secs, chunks, segments

    ev_a, fits_a, ep_a, secs_a, _, _ = run(
        "a: fused", dataclasses.replace(base, compaction_chunk=0))
    split = dataclasses.replace(base, launch_seconds_budget=0.0)
    ev_b, fits_b, ep_b, secs_b, rec_b, seg_b = run("b: split", split)
    assert ev_b._should_split_lanes(f, k, genomes)
    got = [(r["pop"], r["max_blocks"], r["compacted"]) for r in rec_b]
    want = [(1, g["residual_blocks"], False) for g in genomes]
    if got != want:
        raise AssertionError(f"(b) launches (pop, max_blocks, compacted) "
                             f"{got}, want {want}")
    _, fits_c, ep_c, _, _, _ = run(
        "c: each genome alone", dataclasses.replace(base, compaction_chunk=0),
        alone=True)
    if (fits_c, ep_c) != (fits_b, ep_b):
        raise AssertionError(f"(c) differs from (b): {fits_c} {ep_c} vs "
                             f"{fits_b} {ep_b}")
    budget = 2.5 * est3
    ev_d, fits_d, ep_d, _, rec_d, seg_d = run(
        f"d: split, budget {budget:.4f} s",
        dataclasses.replace(base, launch_seconds_budget=budget))
    if not seg_d > seg_b:
        raise AssertionError(f"(d) ran {seg_d} training segments, (b) "
                             f"{seg_b}: the duration bound never engaged")
    if (fits_d, ep_d) != (fits_b, ep_b):
        raise AssertionError(f"(d) differs from (b): {fits_d} {ep_d} vs "
                             f"{fits_b} {ep_b}")
    log(f"[split] (b) one-lane launches at their genomes' depths, equal to "
        f"(c) bit for bit; (d) {seg_d} segments, lanes per segment "
        f"{[r['lanes'] for r in rec_d]}, equal to (b) bit for bit")
    d_acc = [abs(x[0] - y[0]) for x, y in zip(fits_b, fits_a)]
    n_diff = sum(1 for a, x, y in zip(d_acc, ep_b, ep_a) if a or x != y)
    log(f"[split] (b) against (a): {n_diff} of {len(genomes)} genomes "
        f"differ; largest |d acc| {max(d_acc)!r} (one validation sample "
        f"{1 / n_val!r}); trainings/h (b) / (a) {secs_a / secs_b:.4f}; "
        f"epochs_ran (a) {ep_a}")

    # executed one-lane training rates, beside the rate the plan assumes
    flops = sum(ev_b._epoch_flops(1, ev_b._bucket_spec(f, k, r["max_blocks"]))
                * r["epochs"][0] for r in rec_b)
    bird_rate = flops / secs_b
    kws = prepare_dataset(DataConfig(source="npy", path=data_dir,
                                     num_classes=CLASSES))
    kws_cfg = TrainConfig(epochs=epochs, patience=epochs + 1,
                          compute_dtype="bfloat16", compaction_chunk=0)
    ev = PopulationEvaluator(kws, kws_cfg, device=device)
    t0 = time.perf_counter()
    ev.evaluate(genomes[:1], seed=5)
    secs = time.perf_counter() - t0
    (rec,) = ev.timings[-1]["chunks"]
    spec = ev._bucket_spec(f, k, rec["max_blocks"])
    kws_rate = ev._epoch_flops(1, spec) * rec["epochs"][0] / secs
    low = min(bird_rate, kws_rate)
    log(f"[split] executed one-lane training rate: BirdCLEF 501x40 "
        f"{bird_rate / 1e12:.4f} TFLOP/s ((b), {secs_b:.2f} s), KWS 45x13 "
        f"{kws_rate / 1e12:.4f} TFLOP/s ({rec['epochs'][0]} epochs of "
        f"{len(kws['y_train'])} rows, {secs:.2f} s); the plan assumes "
        f"{rate / 1e12:g} TFLOP/s ("
        + ("at or below both" if rate <= low else "ABOVE the lower") + ")")
    log(f"[split] phase {time.perf_counter() - t_phase:.2f} s")


EXHAUSTIVE_EPOCHS = 2
EXHAUSTIVE_BUDGET_S = 150


def phase_exhaustive(smi: str) -> None:
    """The exhaustive sweep of template B on the card, at
    ``EXHAUSTIVE_EPOCHS`` epochs: the table's sizes against the JAX
    package's committed table, and each launch against the split rule."""
    from cmoop_audio_processing_torch.examples import run_exhaustive as rx

    t0 = time.perf_counter()
    rows, ev = rx.sweep("B", epochs=EXHAUSTIVE_EPOCHS, seed=7, fake=False,
                        device="cuda")
    secs = time.perf_counter() - t0
    if len(rows) != 288:
        raise AssertionError(f"[exhaustive] {len(rows)} rows, want 288")
    want = {k: r["Size_MB"] for k, r in rx.text_table(os.path.join(
        ROOT, "examples", "exhaustive", "exhaustive_B_288.csv")).items()}
    off = [r for r in rows if repr(r["Size_MB"]) != want[rx.genome_key_of_row(r)]]
    if off:
        raise AssertionError(f"[exhaustive] {len(off)} sizes differ from the "
                             f"JAX table, first {off[0]}")
    check_split_rule("exhaustive", ev, [(rx.all_genomes(), ev.timings[-1])])
    chunks = ev.timings[-1]["chunks"]
    log(f"[exhaustive] template B, {EXHAUSTIVE_EPOCHS} epochs: 288 rows, "
        f"sizes equal to the JAX table; {len(chunks)} launches "
        f"({sum(c['pop'] == 1 for c in chunks)} one-lane), "
        f"{ev.timings[-1]['seconds']:.2f} s evaluate, {secs:.2f} s phase, "
        f"{288 * 3600 / ev.timings[-1]['seconds']:.1f} trainings/h; card: "
        f"{smi}" + ("" if secs <= EXHAUSTIVE_BUDGET_S else
                    f"; OVER the {EXHAUSTIVE_BUDGET_S}-s budget"))


ALL8_EPOCHS = 2
ALL8_BUDGET_S = 90


def all8_outputs(out: str) -> dict:
    """The bytes of every front, ``Final.csv`` and the report in ``out``."""
    from cmoop_audio_processing_torch.core.config import get_preset
    from cmoop_audio_processing_torch.examples import run_all8 as ra

    presets = ra.STAGE1 + [p for _, p, _ in ra.METHODS]
    paths = [ra.front_path(get_preset(p), out) for p in presets]
    paths += [os.path.join(out, "Final.csv"),
              os.path.join(out, "compare_report_all8.json")]
    got = {}
    for p in paths:
        if os.path.exists(p):
            with open(p, "rb") as f:
                got[os.path.relpath(p, out)] = f.read()
    return got


def phase_all8(name: str, smi: str) -> None:
    """``run_all8`` at a toy size, fused, on the card; then its resume."""
    from cmoop_audio_processing_torch.examples import run_all8 as ra

    t_phase = time.perf_counter()
    out = os.path.join(WORK, "all8")
    shutil.rmtree(out, ignore_errors=True)
    base = ["--pop", "4", "--gen", "1", "--epochs", str(ALL8_EPOCHS),
            "--seed", "7", "--device", "cuda", "--out", out]
    argv = base + ["--compaction-chunk", "0"]
    record_path = os.path.join(out, ra.RUN_RECORD)
    t0 = time.perf_counter()
    rc = ra.main(argv)
    first_s = time.perf_counter() - t0
    with open(record_path) as f:
        record = json.load(f)
    presets = ra.STAGE1 + [p for _, p, _ in ra.METHODS]
    got = [e["preset"] for e in record["searches"]]
    if got != presets:
        raise AssertionError(f"[all8] run record holds {got}, want {presets}")
    off = [e["preset"] for e in record["searches"]
           if (e["card"], e["nvidia_smi"]) != (name, smi)]
    if off:
        raise AssertionError(f"[all8] entries not naming {smi!r}: {off}")
    before = all8_outputs(out)
    # the resume check drops the first SA-family entry that trained
    victim = next(e["preset"] for e in record["searches"]
                  if e["preset"] in [p for _, p, _ in ra.METHODS[:6]]
                  and e["trainings"])
    ran = []
    real = ra.run_one

    def counting(cfg, *a, **k):
        ran.append(cfg.name)
        return real(cfg, *a, **k)

    ra.run_one = counting
    try:
        t0 = time.perf_counter()
        rc_skip = ra.main(argv + ["--resume"])
        skip_s = time.perf_counter() - t0
        if ran or rc_skip != rc or all8_outputs(out) != before:
            raise AssertionError(f"[all8] a resume of a finished run ran "
                                 f"{ran} (rc {rc_skip}, first run {rc}) or "
                                 f"changed its outputs")
        record["searches"] = [e for e in record["searches"]
                              if e["preset"] != victim]
        ra.save_record(record, out)
        t0 = time.perf_counter()
        rc_replay = ra.main(argv + ["--resume"])
        replay_s = time.perf_counter() - t0
    finally:
        ra.run_one = real
    with open(record_path) as f:
        entry = [e for e in json.load(f)["searches"]
                 if e["preset"] == victim][0]
    after = all8_outputs(out)
    changed = sorted(k for k in set(before) | set(after)
                     if before.get(k) != after.get(k))
    if (ran != [victim] or entry["trainings"] or entry["launches"]
            or not entry["cache_hits"] or changed or rc_replay != rc):
        raise AssertionError(
            f"[all8] resume without {victim}'s entry ran {ran}, "
            f"trained {entry['trainings']} in {entry['launches']} launches "
            f"with {entry['cache_hits']} cache hits (rc {rc_replay}); "
            f"changed: {changed}")
    for drop_record, refusal in ((False, "--resume refused"),
                                 (True, "different training config")):
        if drop_record:
            os.unlink(record_path)
        try:
            ra.main(base + ["--compaction-chunk", "2", "--resume"])
        except (SystemExit, ValueError) as e:
            why = str(e).splitlines()[0]
            if refusal not in why:
                raise
        else:
            raise AssertionError("[all8] a resume under another plan ran")
        log(f"[all8] resume under --compaction-chunk 2 refused"
            f"{' (record removed)' if drop_record else ''}: {why[:160]}")
    entries = record["searches"]
    total = time.perf_counter() - t_phase
    log(f"[all8] pop 4, 1 generation, {ALL8_EPOCHS} epochs, fused: "
        f"{len(presets)} searches in {first_s:.2f} s, "
        f"{sum(e['trainings'] for e in entries)} trainings in "
        f"{sum(e['launches'] for e in entries)} launches, verdict rc {rc}, "
        f"{len(before)} outputs; resume of the finished run {skip_s:.2f} s "
        f"(no search run); {victim} replayed from its cache "
        f"({entry['cache_hits']} hits, 0 trainings) in {replay_s:.2f} s, "
        f"outputs byte-equal; phase {total:.2f} s; card: {smi}"
        + ("" if total <= ALL8_BUDGET_S else
           f"; OVER the {ALL8_BUDGET_S}-s budget"))


ORACLE_BUDGET_S = 180
PARITY = os.path.join(ROOT, "cmoop_audio_processing_torch", "examples",
                      "artifacts", "search_parity", "seed_7.json")


def phase_oracle(name: str, smi: str) -> None:
    """``run_all8 --table-eval`` at seed 7, pop 10, 8 generations on the
    card: every fitness read from the JAX package's exhaustive tables, the
    GP fits on the card. The run record must hold all 11 searches, each
    naming the card; every front row must be a row of its template's table
    in ``Size_MB``: a row whose accuracy or FPR differs from it is a
    surrogate-predicted survivor (SA family only, counted), and a 2-stage
    SA front may also carry its PSI seed's rows, which hold the stage-1
    (template A) table's fitness untrained, as the reference carries them.
    Each method's GD and IGD against the truth are printed beside the
    committed CPU values of the same seed."""
    from cmoop_audio_processing_torch.core.config import get_preset
    from cmoop_audio_processing_torch.examples import run_all8 as ra
    from cmoop_audio_processing_torch.examples import run_exhaustive as rx

    t_phase = time.perf_counter()
    out = os.path.join(WORK, "oracle")
    shutil.rmtree(out, ignore_errors=True)
    rc = ra.main(["--table-eval", "--device", "cuda", "--seed", "7",
                  "--pop", "10", "--gen", "8", "--out", out])
    if rc not in (0, 1):
        raise AssertionError(f"[oracle] run_all8 exited {rc}")
    secs = time.perf_counter() - t_phase
    with open(os.path.join(out, ra.RUN_RECORD)) as f:
        entries = json.load(f)["searches"]
    presets = ra.STAGE1 + [p for _, p, _ in ra.METHODS]
    if [e["preset"] for e in entries] != presets:
        raise AssertionError(f"[oracle] run record holds "
                             f"{[e['preset'] for e in entries]}")
    off = [e["preset"] for e in entries
           if (e["card"], e["nvidia_smi"]) != (name, smi)]
    if off:
        raise AssertionError(f"[oracle] entries not naming {smi!r}: {off}")
    truths = {t: rx.read_table(os.path.join(
        ROOT, "examples", "exhaustive", f"exhaustive_{t}_288.csv"))
        for t in ("B", "A")}
    tables = {t: {rx.genome_key_of_row(r): r for r in rows}
              for t, rows in truths.items()}

    def fits(r):
        return r["Accuracy"], r["Size_MB"], r["FPR"]

    sa_family = [p for _, p, _ in ra.METHODS[:6]]
    two_stage = [p for _, p, seeded in ra.METHODS[:6] if seeded]
    counts = {}
    for p in presets:
        cfg = get_preset(p)
        path = ra.front_path(cfg, out)
        rows = rx.read_table(path) if os.path.getsize(path) else []
        predicted = seeded = 0
        for r in rows:
            key = rx.genome_key_of_row(r)
            want = tables[cfg.train.template][key]
            if fits(r) == fits(want):
                continue
            if r["Size_MB"] == want["Size_MB"] and p in sa_family:
                predicted += 1
            elif p in two_stage and fits(r) == fits(tables["A"][key]):
                seeded += 1
            else:
                raise AssertionError(f"[oracle] {p}: front row {r} is not "
                                     f"its template's table row {want}")
        counts[p] = (len(rows), predicted, seeded)
    with open(PARITY) as f:
        cpu = json.load(f)["port_cpu"]["truth"]
    with tempfile.TemporaryDirectory() as fronts:
        ra.export(out, fronts)
        truth = rx.report_on(truths, fronts, None, None)["methods"]
    for m, p, _ in ra.METHODS:
        rows, predicted, seeded = counts[p]
        got, want = truth.get(m, {}), cpu.get(m, {})
        log(f"[oracle] {m}: {rows} front rows ({predicted} predicted, "
            f"{seeded} PSI seed); GD {got.get('gd_vs_truth')} IGD "
            f"{got.get('igd_vs_truth')} (CPU, seed 7: "
            f"{want.get('gd_vs_truth')} / {want.get('igd_vs_truth')})")
    gp = sum(e["gp_refit_s"] or 0.0 for e in entries)
    total = time.perf_counter() - t_phase
    log(f"[oracle] seed 7, pop 10, 8 generations on the tables: 11 searches "
        f"in {secs:.2f} s, verdict rc {rc}, "
        f"{sum(e['gp_refits'] for e in entries)} GP refits in {gp:.2f} s; "
        f"phase {total:.2f} s; card: {smi}"
        + ("" if total <= ORACLE_BUDGET_S else
           f"; OVER the {ORACLE_BUDGET_S}-s budget"))


def read_launches(records: dict, names, path: str) -> None:
    """Each kernel's launches in the path's run, which must all have taken
    the FFT route. ``launches`` keeps the first path's count,
    ``path_launches`` each path's."""
    from cmoop_audio_processing_torch.frontend import cuda_kernels as ck

    for name in names:
        ran = [r for r in ("fft", "dense") if ck.route_counts[f"{name}/{r}"] > 0]
        if records[name]["launches"] is None:
            records[name]["launches"] = ck.launch_counts[name]
        records[name].setdefault("path_launches", {})[path] = ck.launch_counts[name]
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
    val_wavs = phase_extract(args.seed, "cuda", N_WAVS, data_dir)
    phase_train("train", "cuda", data_dir, SMOKE_GENOMES,
                TrainConfig(epochs=4, compute_dtype="bfloat16"), min_acc=0.5)
    phase_search("search", "nsga_penalty", "cuda", data_dir,
                 os.path.join(WORK, "results"), epochs=3, pop=8, gens=2)
    read_launches(records, ["mfcc_fused"], "KWS")

    results = os.path.join(WORK, "results")
    cuda_kernels.reset_launch_counts()
    mobo_front = phase_mobo_search("cuda", data_dir, results)
    phase_deploy("cuda", data_dir, val_wavs, mobo_front,
                 os.path.join(WORK, "deployed"))
    phase_compare({"NSGA": os.path.join(results, "nsga_penalty", "final_pareto.csv"),
                   "MOBO": mobo_front}, os.path.join(WORK, "report.json"))
    read_launches(records, ["mfcc_fused"], "KWS-MOBO")

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
    phase_planner("cuda", data_dir, bird_dir, smi)
    phase_mesh("cuda", data_dir, smi)
    phase_split("cuda", data_dir, bird_dir, smi)
    phase_exhaustive(smi)
    phase_all8(name, smi)
    phase_oracle(name, smi)
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": list(records.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
