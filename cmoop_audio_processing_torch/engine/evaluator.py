"""Population evaluator: genome list -> (accuracy, size_mb, fpr) fitness.

The true-fitness layer (cmoop_audio_processing_tpu/engine/evaluator.py).
Instead of the reference's serial build/fit per individual
(sa_nsga_penalty.py:205-253), genomes are grouped into shape buckets
(``TrainConfig.bucket_genes``); each bucket's sub-population is padded to a
power of two (at most ``max_models_per_program``, repeating its first
genome) and trained as ONE grouped population (engine/trainer.py)
specialized to the deepest genome it holds. When a bucket splits into
several launches, genomes are packed by their last observed stop epoch so
fast stoppers share a launch.

Size is computed analytically from the genome (models/genome_arch.py),
exactly reproducing Keras count_params * 4 bytes (nsga_penalty.py:337-344).

A genome's fitness is a function of (genome, seed, dataset) alone:
genome-keyed init and uid-keyed dropout streams plus a seed-keyed shuffle
make it independent of which genomes share its population. On CUDA the
path runs in deterministic mode (core/device.py), so re-evaluations repeat
bit for bit.

Not carried over from the JAX package (ROADMAP.md lists them): lane
compaction, device meshes, the launch-duration budget, the heavy-lane
split, the ``CMOOP_*`` environment knobs with the in-flight window, and
the durable fitness cache.

A deterministic FakeEvaluator over the enumerable 288-genome space stands in
for training in driver tests.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import TrainConfig
from ..core.device import resolve_device
from ..core.genome import HPARAM_SPACE, Genome, genome_key, validate
from ..models.genome_arch import model_size_mb
from ..models.supernet import BucketSpec
from .trainer import PopulationTrainer, TrainSettings, pad_dataset

Fitness = Tuple[float, float, float]  # (acc, size_mb, fpr)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class PopulationEvaluator:
    """Evaluates genome populations on one device, one grouped population
    per launch."""

    def __init__(
        self,
        data: Dict[str, np.ndarray],
        train_cfg: TrainConfig,
        device="cuda",
    ):
        # evaluate() reads bucket-key slots 0/1 as (filters, kernel_size) to
        # build the BucketSpec; a reordered/malformed bucket_genes would
        # silently construct wrong architectures, so fail loudly here
        bg = tuple(train_cfg.bucket_genes)
        if bg[:2] != ("filters", "kernel_size"):
            raise ValueError(
                "bucket_genes must start with ('filters', 'kernel_size'); "
                f"got {bg!r}"
            )
        unknown = [g for g in bg if g not in HPARAM_SPACE]
        if unknown:
            raise ValueError(f"unknown bucket_genes {unknown!r}")
        self.cfg = train_cfg
        self.device = resolve_device(device)
        self.settings = TrainSettings(
            epochs=train_cfg.epochs,
            batch_size=train_cfg.batch_size,
            patience=train_cfg.patience,
            learning_rate=train_cfg.learning_rate,
            restore_best_weights=train_cfg.restore_best_weights,
        )
        # pad once, move to the device once
        xtr, ytr, wtr = pad_dataset(
            data["x_train"], data["y_train"], train_cfg.batch_size
        )
        xval, yval, wval = pad_dataset(
            data["x_val"], data["y_val"], self.settings.eval_batch_size
        )

        def put(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

        self._train = (put(xtr, torch.float32), put(ytr, torch.int64),
                       put(wtr, torch.float32))
        self._val = (put(xval, torch.float32), put(yval, torch.int64),
                     put(wval, torch.float32))
        self._eval_count = 0
        self._launch_count = 0  # population trainings this evaluate()
        self.timings: List[Dict] = []
        # genome -> last observed epochs_ran (stop-epoch packing predictor)
        self._epoch_history: Dict[tuple, float] = {}

    def _bucket_spec(self, f: int, k: int, max_blocks: int = 3) -> BucketSpec:
        return BucketSpec(
            template=self.cfg.template,
            filters=f,
            kernel=k,
            num_classes=self.cfg.num_classes,
            dropout_rate=self.cfg.dropout_rate,
            compute_dtype=self.cfg.compute_dtype,
            max_blocks=max_blocks,
        )

    def evaluate(self, genomes: Sequence[Genome], seed: int = 0) -> List[Fitness]:
        """Evaluate all genomes; returns fitness per genome in input order.
        Genomes sharing a bucket train together in one population."""
        t0 = time.perf_counter()
        self._launch_count = 0
        for g in genomes:
            validate(g)  # out-of-space genomes would silently mis-bucket
        results: List[Optional[Fitness]] = [None] * len(genomes)

        buckets: Dict[tuple, List[int]] = {}
        for i, g in enumerate(genomes):
            key = tuple(g[b] for b in self.cfg.bucket_genes)
            buckets.setdefault(key, []).append(i)

        chunk_records = []
        for bkey, idxs in buckets.items():
            f, k = int(bkey[0]), int(bkey[1])
            sub = [genomes[i] for i in idxs]
            pop = min(
                _next_pow2(len(sub)), max(self.cfg.max_models_per_program, 1)
            )
            if len(sub) > pop and self.cfg.pack_by_stop_epoch:
                # stop-epoch packing (TrainConfig.pack_by_stop_epoch): group
                # similar-stop genomes into the same launch; unknown genomes
                # sort last, input order breaks ties
                order = sorted(
                    range(len(sub)),
                    key=lambda j: (
                        self._epoch_history.get(
                            genome_key(sub[j]), float("inf")
                        ),
                        j,
                    ),
                )
                idxs = [idxs[j] for j in order]
                sub = [sub[j] for j in order]
            for start in range(0, len(sub), pop):
                chunk_idx = idxs[start : start + pop]
                chunk = sub[start : start + pop]
                padded = list(chunk) + [chunk[0]] * (
                    _next_pow2(len(chunk)) - len(chunk)
                )
                # specialize to the deepest genome actually in this launch
                spec = self._bucket_spec(
                    f, k, max(int(g["residual_blocks"]) for g in chunk)
                )
                fits = self._run_bucket(spec, padded, seed)
                for j, gi in enumerate(chunk_idx):
                    g = genomes[gi]
                    size = model_size_mb(g, self.cfg.num_classes, self.cfg.template)
                    results[gi] = (float(fits["acc"][j]), size,
                                   float(fits["fpr"][j]))
                    self._epoch_history[genome_key(g)] = float(fits["epochs"][j])
                chunk_records.append({
                    "filters": spec.filters,
                    "kernel": spec.kernel,
                    "max_blocks": spec.max_blocks,
                    "pop": len(padded),
                    "epochs": [int(e) for e in fits["epochs"]],
                })
        self.timings.append(
            {
                "n_genomes": len(genomes),
                "n_buckets": len(buckets),
                "launches": self._launch_count,
                "seconds": time.perf_counter() - t0,
                # per-launch execution shape for FLOPs accounting: lockstep
                # bills every (padded) lane until the slowest stops
                "chunks": chunk_records,
            }
        )
        self._eval_count += len(genomes)
        return results  # type: ignore[return-value]

    def run_single_with_params(self, genome: Genome, seed: int):
        """One-genome training that RETURNS the trained carry — the
        evaluation paths deliberately discard parameters. It runs the
        search's own ``run_full`` (same spec, init and shuffle/dropout
        streams as ``evaluate``), so the exported model reproduces the
        search-reported fitness (engine/export.py). Returns (finalize's
        outputs, carry), every leaf with a pop axis of 1."""
        validate(genome)
        spec = self._bucket_spec(int(genome["filters"]),
                                 int(genome["kernel_size"]),
                                 int(genome["residual_blocks"]))
        trainer = PopulationTrainer(spec, self.settings, self.cfg.num_classes)
        return trainer.run_full([genome], self._train, self._val, seed,
                                self.settings.epochs)

    def _run_bucket(self, spec: BucketSpec, padded: List[Genome], seed: int):
        trainer = PopulationTrainer(spec, self.settings, self.cfg.num_classes)
        out, _ = trainer.run_full(padded, self._train, self._val, seed,
                                  self.settings.epochs)
        self._launch_count += 1
        acc_key = "acc_eval" if self.cfg.accuracy_from == "best" else "acc_last"
        return {
            "acc": out[acc_key].cpu().numpy(),
            "fpr": out["fpr"].cpu().numpy(),
            "epochs": out["epochs_ran"].cpu().numpy(),
        }

    @property
    def total_true_evals(self) -> int:
        return self._eval_count


class FakeEvaluator:
    """Deterministic closed-form fitness over the 288-genome space.

    acc/fpr are smooth functions of the genome (bigger nets & BN help
    accuracy; more blocks & BN reduce FPR), size is the real analytic size,
    so constraint structure mirrors the real problem and the exact Pareto set
    is computable by enumeration. Optional noise mimics retraining variance
    while honoring the REAL engine's idempotence contract (a fitness is a
    pure function of (genome, seed, dataset)): the draw is keyed by
    (genome, eval seed, instance seed), so re-evaluating with the same seed
    repeats it and a different eval seed gives a fresh draw."""

    def __init__(
        self,
        num_classes: int = 10,
        template: str = "A",
        noise: float = 0.0,
        seed: int = 0,
    ):
        self.num_classes = num_classes
        self.template = template
        self.noise = noise
        self.seed = int(seed)
        self.total_true_evals = 0
        self.timings: List[Dict] = []

    def fitness(self, g: Genome) -> Fitness:
        f_idx = HPARAM_SPACE["filters"].index(g["filters"])
        acc = (
            0.80
            + 0.02 * f_idx
            + 0.02 * g["residual_blocks"]
            + 0.008 * g["fc_layers"]
            + (0.012 if g["use_bn"] else 0.0)
            - (0.004 if g["use_dropout"] else 0.0)
            + (0.002 if g["kernel_size"] == 5 else 0.0)
        )
        size = model_size_mb(g, self.num_classes, self.template)
        fpr = (
            0.14
            - 0.035 * g["residual_blocks"]
            - (0.015 if g["use_bn"] else 0.0)
            - 0.01 * f_idx
            + (0.003 if g["kernel_size"] == 5 else 0.0)
        )
        return min(acc, 0.995), size, max(fpr, 0.002)

    def evaluate(self, genomes: Sequence[Genome], seed: int = 0) -> List[Fitness]:
        out = []
        for g in genomes:
            acc, size, fpr = self.fitness(g)
            if self.noise:
                rng = np.random.default_rng(
                    [int(v) for v in genome_key(g)] + [int(seed), self.seed]
                )
                acc = float(np.clip(acc + rng.normal(0, self.noise), 0, 1))
                fpr = float(max(fpr + rng.normal(0, self.noise / 2), 0.0))
            out.append((acc, size, fpr))
        self.total_true_evals += len(genomes)
        return out
