"""Where the time of the PyTorch port's main path goes, on one CUDA card.

    python3 profile_torch.py [--seed N] [--epochs E]

Builds chip_smoke.py's KWS workload (2000 class-dependent synthetic 1-s
clips, 10 classes, through ``extract_features(kind="mfcc")`` into 45x13
maps, stratified 70/15/15), then runs two stages under ``torch.profiler``:

* extract — ``extract_features`` over the 2000 clips (batches of 500);
* train   — ``PopulationEvaluator.evaluate`` in bf16 on chip_smoke's 8
            genomes (widest and narrowest included), E epochs, after one
            untimed 1-epoch warm-up.

For each stage it prints the host wall time without and with the profiler,
the device busy time (sum of the kernels' device times), the device idle
share (against the profiled wall time), the kernel count and the kernels
that take most device time; the last line is one JSON object with those
numbers and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


def profiled(fn):
    """Run ``fn`` once plain and once under torch.profiler; returns
    (result, stage record)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    rec = {
        "wall_unprofiled_s": plain_wall,
        "wall_s": wall,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "kernels": len(kernels),
        "top": [{"name": n[:90], "count": c, "device_s": t / 1e6}
                for n, (c, t) in top],
    }
    return out, rec


def report(stage: str, rec: dict) -> None:
    print(f"[{stage}] wall {rec['wall_unprofiled_s']:.3f} s (profiled "
          f"{rec['wall_s']:.3f} s), device busy "
          f"{rec['device_busy_s']:.3f} s, idle share "
          f"{rec['device_idle_share']:.3f}, {rec['kernels']} kernels", flush=True)
    for t in rec["top"]:
        print(f"[{stage}]   {t['device_s']:.4f} s  x{t['count']}  {t['name']}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--epochs", type=int, default=4)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_torch: no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from cmoop_audio_processing_torch.core.config import TrainConfig
    from cmoop_audio_processing_torch.core.device import resolve_device
    from cmoop_audio_processing_torch.data.pipeline import (
        add_channel_axis,
        standardize_splits,
    )
    from cmoop_audio_processing_torch.engine.evaluator import PopulationEvaluator
    from cmoop_audio_processing_torch.frontend.features import (
        FrontendConfig,
        extract_features,
    )

    resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {smi}", flush=True)

    rng = np.random.default_rng(args.seed + 1)
    wavs, labels = cs.synth_kws(rng, cs.N_WAVS)
    cfg = FrontendConfig(hop_length=cs.KWS_HOP, n_mfcc=13)

    def extract():
        return np.concatenate([
            extract_features(wavs[i:i + 500], cfg, kind="mfcc", device="cuda")
            for i in range(0, len(wavs), 500)
        ])

    extract()  # build + warm-up
    feats, rec_x = profiled(extract)
    rec_x["frames_per_s"] = (feats.shape[0] * feats.shape[1]
                             / rec_x["wall_unprofiled_s"])
    report("extract", rec_x)

    tr, va, te = cs.stratified_split(rng, labels)
    data = add_channel_axis(standardize_splits({
        "x_train": feats[tr], "y_train": labels[tr],
        "x_val": feats[va], "y_val": labels[va],
        "x_test": feats[te], "y_test": labels[te],
    }))
    tcfg = TrainConfig(epochs=args.epochs, compute_dtype="bfloat16")
    PopulationEvaluator(data, dataclasses.replace(tcfg, epochs=1),
                        device="cuda").evaluate(cs.SMOKE_GENOMES, seed=7)
    ev = PopulationEvaluator(data, tcfg, device="cuda")
    fits, rec_t = profiled(lambda: ev.evaluate(cs.SMOKE_GENOMES, seed=7))
    chunks = ev.timings[-1]["chunks"]
    rec_t["populations"] = len(chunks)
    rec_t["lane_epochs"] = sum(sum(c["epochs"]) for c in chunks)
    rec_t["steps"] = sum(max(c["epochs"]) for c in chunks) * (
        -(-len(tr) // tcfg.batch_size))
    report("train", rec_t)
    print(f"[train] {rec_t['populations']} populations, {rec_t['steps']} "
          f"optimizer steps, {rec_t['lane_epochs']} lane-epochs; "
          f"accs {[round(f[0], 4) for f in fits]}")
    print(json.dumps({"device": name, "power": smi, "extract": rec_x,
                      "train": rec_t}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
