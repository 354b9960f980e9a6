"""How far the planner's training runs drift apart on the card when only
the order of floating-point sums changes.

    python3 planner_drift.py

On chip_smoke.py's KWS split (2000 synthetic 1-s clips, written by its
extraction phase) and its planner genomes (8 lanes of one 64-filter 5x5
bucket, 12 epochs, patience 2), for each learning rate and compute dtype
below: (a) one-shot, (b) compacted every 2 epochs, (d) the vmap setting
one-shot; each genome's epochs_ran and accuracy. Before that, in bf16 and
f32, chip_smoke.py's vmap checks (``vmap_steps``): a training step and a
validation pass of the same population through the vmap and the grouped
setting from the same params, initial and after each of 3 epochs of
grouped training, and how far their results differ. Needs one CUDA card;
about 5 minutes.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time

import chip_smoke as cs

SETTINGS = ((1e-3, "bfloat16"), (1.5e-3, "bfloat16"), (2e-3, "bfloat16"),
            (2e-3, "float32"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.exit("planner_drift: no CUDA device")
    from cmoop_audio_processing_torch.core.config import DataConfig, TrainConfig
    from cmoop_audio_processing_torch.core.device import resolve_device
    from cmoop_audio_processing_torch.core.genome import genome_key
    from cmoop_audio_processing_torch.data.pipeline import prepare_dataset
    from cmoop_audio_processing_torch.engine.evaluator import PopulationEvaluator

    resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cs.log(f"[drift] {smi}")
    data_dir = os.path.join(cs.WORK, "kws_npy")
    cs.phase_extract(0, "cuda", cs.N_WAVS, data_dir)
    data = prepare_dataset(DataConfig(source="npy", path=data_dir,
                                      num_classes=cs.CLASSES))
    ev = PopulationEvaluator(data, TrainConfig(learning_rate=cs.PLANNER_LR),
                             device="cuda")
    for dtype in ("bfloat16", "float32"):
        for epoch, m in enumerate(cs.vmap_steps("cuda", ev, dtype)):
            cs.log(f"[drift] vmap against grouped, {dtype}, after {epoch} "
                   f"epochs of grouped training: {m}")
    for lr, dtype in SETTINGS:
        base = TrainConfig(epochs=cs.PLANNER_EPOCHS,
                           patience=cs.PLANNER_PATIENCE, learning_rate=lr,
                           compute_dtype=dtype,
                           bucket_genes=("filters", "kernel_size"))
        for tag, cfg in (
                ("a", dataclasses.replace(base, compaction_chunk=0)),
                ("b", dataclasses.replace(base,
                                          compaction_chunk=cs.PLANNER_CHUNK)),
                ("d", dataclasses.replace(base, compaction_chunk=0,
                                          parallel_impl="vmap"))):
            ev = PopulationEvaluator(data, cfg, device="cuda")
            t0 = time.perf_counter()
            fits = ev.evaluate(cs.PLANNER_GENOMES, seed=5)
            secs = time.perf_counter() - t0
            (rec,) = ev.timings[-1]["chunks"]
            epochs = [ev._epoch_history[genome_key(g)]
                      for g in cs.PLANNER_GENOMES]
            cs.log(f"[drift] lr {lr} {dtype} ({tag}) {secs:.2f} s, lanes "
                   f"{rec['lanes']}, epochs_ran {epochs}, accuracy "
                   f"{[f[0] for f in fits]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
