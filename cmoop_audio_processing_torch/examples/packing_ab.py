"""Same-run A/B: stop-epoch lane packing (TrainConfig.pack_by_stop_epoch)
ON against OFF, as two PopulationEvaluator instances sharing one dataset.

The port's copy of examples/packing_ab.py. One (32, 5) template-B bucket
of 16 genomes, ``max_models_per_program`` 8, so two fused launches an
evaluate (``compaction_chunk=0``, no duration bound, no heavy-lane split).
The OFF arm evaluates in the shuffled input order, so each launch mixes
fast and slow stoppers and both run until their slowest lane stops; the
ON arm sees the same shuffled input but packs lanes by each genome's last
observed stop epoch, isolating the stragglers in one launch.

Both arms get a full warm-up pass first (the ON arm's packer reads the
recorded history, so the A/B measures the real mechanism, not an oracle).
Then ``AB_REPS`` reps, each a fresh shuffle, time ON then OFF; each rep's
largest fitness difference between the arms is reported beside the
times. On the CPU a genome's fitness does not depend on the lanes that
share its launch, so the arms agree bit for bit there; on the card another
lane grouping runs other kernels and may move it.

    python -m cmoop_audio_processing_torch.examples.packing_ab
        [--device cuda|cpu] [--out FILE]

Environment, as in the JAX script: ``AB_EPOCHS`` (300), ``AB_REPS`` (5),
``AB_MAXM`` (8). The last line of the output is the result as JSON, with
the card's name and power limit on CUDA; ``--out`` writes it to FILE too.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List

import numpy as np

from ..core.config import DataConfig, TrainConfig
from ..core.genome import Genome
from .run_exhaustive import device_record

EPOCHS = int(os.environ.get("AB_EPOCHS", "300"))
REPS = int(os.environ.get("AB_REPS", "5"))
MAXM = int(os.environ.get("AB_MAXM", "8"))
DATA = DataConfig(synthetic_train=2000, synthetic_eval=500, num_classes=10)


def ab_genomes() -> List[Genome]:
    """The JAX script's 16 genomes of the (32, 5) bucket."""
    genomes = []
    for rb in (1, 2, 3):
        for fc in (1, 2, 3, 4):
            genomes.append({
                "filters": 32, "kernel_size": 5,
                "use_bn": (fc + rb) % 2 == 0,
                "residual_blocks": rb, "fc_layers": fc,
                "use_dropout": rb == 2,
            })
    for fc in (1, 2, 3, 4):
        genomes.append({
            "filters": 32, "kernel_size": 5, "use_bn": fc % 2 == 1,
            "residual_blocks": 2, "fc_layers": fc, "use_dropout": False,
        })
    return genomes


def run_ab(data, genomes: List[Genome], epochs: int, reps: int, maxm: int,
           device="cuda") -> Dict:
    """The A/B on ``data``: warm-up, then ``reps`` timed reps of each arm."""
    from ..engine.evaluator import PopulationEvaluator

    def make_ev(pack):
        cfg = TrainConfig(
            epochs=epochs, patience=5, compute_dtype="bfloat16",
            template="B", bucket_genes=("filters", "kernel_size"),
            max_models_per_program=maxm, compaction_chunk=0,
            launch_seconds_budget=0, pack_by_stop_epoch=pack,
        )
        return PopulationEvaluator(data, cfg, device=device)

    ev_off, ev_on = make_ev(False), make_ev(True)
    # warm-up: every launch shape both arms use, and the ON arm's history
    ev_off.evaluate(genomes, seed=1)
    stop_epochs = [int(e) for launch in ev_off.timings[-1]["chunks"]
                   for e in launch["epochs"]]
    print(f"stop epochs (input order): {stop_epochs}", file=sys.stderr,
          flush=True)
    ev_on.evaluate(genomes, seed=1)  # builds its own history
    ev_on.evaluate(genomes, seed=1)  # and runs the packed launches once

    rng = np.random.default_rng(0)
    off_s, on_s, drift, fits = [], [], [], []
    for r in range(reps):
        gs = [genomes[i] for i in rng.permutation(len(genomes))]
        t0 = time.perf_counter()
        f_on = ev_on.evaluate(gs, seed=1)
        on_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        f_off = ev_off.evaluate(gs, seed=1)
        off_s.append(time.perf_counter() - t0)
        drift.append(max(abs(a - b) for fo, fn in zip(f_off, f_on)
                         for a, b in zip(fo, fn)))
        fits.append({"off": [list(f) for f in f_off],
                     "on": [list(f) for f in f_on]})
        print(f"rep {r}: off={off_s[-1]:.2f}s on={on_s[-1]:.2f}s "
              f"max_fitness_drift={drift[-1]:.4g}", file=sys.stderr,
              flush=True)

    def med(xs):
        return sorted(xs)[len(xs) // 2]

    ma, mb = med(off_s), med(on_s)
    return {
        "config": {"epochs": epochs, "max_models_per_program": maxm,
                   "reps": reps, "genomes": len(genomes),
                   "device": str(ev_off.device)},
        "stop_epochs": stop_epochs,
        "off_s": off_s, "on_s": on_s,
        "median_off_s": ma, "median_on_s": mb,
        "win_frac": (ma - mb) / ma,
        "max_fitness_drift": drift,
        "fitness": fits,
        **device_record(ev_off.device),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--out", metavar="FILE", help="also write the result here")
    args = p.parse_args(argv)
    from ..core.device import resolve_device
    from ..data.pipeline import prepare_dataset

    resolve_device(args.device)  # raises for cuda without a GPU
    out = run_ab(prepare_dataset(DATA), ab_genomes(), EPOCHS, REPS, MAXM,
                 args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "fitness"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
