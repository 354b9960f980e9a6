"""Persistent (genome, seed) -> fitness cache for mid-generation crash
recovery (the port's copy of cmoop_audio_processing_tpu/utils/
fitness_cache.py).

The search drivers checkpoint once per generation (algorithms/*.py), so a
crash INSIDE a generation loses every training that already finished. The
reference has the same exposure (its loop has no checkpointing at all,
sa_nsga_penalty.py:237-253); here we can do better because this engine's
evaluations are idempotent BY CONSTRUCTION: model inits are genome-keyed
and dropout streams are uid-keyed, so the same (genome, seed) produces the
same fitness regardless of bucketing, padding, population composition, or
compaction on the CPU (tests/test_torch_compaction.py). Replaying a
finished training's fitness from disk is therefore behaviorally invisible
there — a resumed generation trains only the lanes that never completed.

Format: JSONL. Line 1 is a header ``{"fingerprint": {...}}`` binding the
cache to everything a fitness DOES depend on (training budget, optimizer
settings, template, dtype, data-mesh width, dataset content hash, the
backend and device kind that computed it, and every setting that chooses
the launch plan).

The backend and device are part of the identity: a CPU run, a CUDA run and
a JAX run of one (genome, seed) agree in distribution, not bit for bit, so
their caches never replay into each other. So are ``parallel_impl`` (as
in the JAX package, where the vmap forward sums in another order; both
names run one forward in this port) and the settings that decide which
genomes share a launch and how many lanes it holds: ``compaction_chunk``,
``launch_seconds_budget``, ``max_models_per_program``, ``bucket_genes``
and the heavy-lane split rule's rate and threshold (engine/evaluator.py).
On CUDA a launch of another lane count runs other cuDNN and cuBLAS
kernels, whose sums round differently, and a training run can amplify
that into another stop epoch and accuracy (chip_smoke.py's planner and
split phases print how far). On CUDA the
evaluation path runs in deterministic mode (core/device.py), so one
launch plan repeats bit for bit, and a resume under the same settings
replays fitnesses that plan computed; genomes that share a launch with
other genomes than before can still differ from a fresh launch.

Subsequent lines are one completed training each, in the JAX package's
format:
``{"g": [genes in GENE_ORDER], "seed": s, "acc": a, "size": m, "fpr": f}``.
Appends are flushed+fsync'd per batch; a truncated final line (crash
mid-append) is skipped on load.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..core.genome import GENE_ORDER, Genome, genome_key

Fitness = Tuple[float, float, float]


def dataset_fingerprint(data: Dict[str, np.ndarray]) -> str:
    """Content hash of the splits the evaluator trains/validates on."""
    h = hashlib.blake2b(digest_size=16)
    for k in ("x_train", "y_train", "x_val", "y_val"):
        a = np.ascontiguousarray(data[k])
        h.update(k.encode())
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def evaluator_fingerprint(train_cfg, data: Dict[str, np.ndarray], device: str,
                          data_axis: int = 1, pop_axis: int = 1) -> Dict:
    """The inputs a cached fitness is valid for: the JAX package's
    fingerprint (in format 3) plus ``"backend": "torch"``, ``device``
    ("cuda" or "cpu") and the launch plan's settings: ``parallel_impl``,
    ``compaction_chunk``, ``launch_seconds_budget``,
    ``max_models_per_program``, ``bucket_genes`` and the split rule
    (``split_flops_per_s``, ``split_min_seconds``, the evaluator's class
    constants). ``data_axis`` and ``pop_axis`` are the mesh widths (1
    without a mesh), kept from the JAX format: sharding changes per-shard
    group sizes and reduction order, so fitnesses of other widths are not
    bit-equal either."""
    from ..engine.evaluator import PopulationEvaluator

    return {
        "format": 3,
        "backend": "torch",
        "device": str(device),
        "parallel_impl": str(train_cfg.parallel_impl),
        "compaction_chunk": int(train_cfg.compaction_chunk),
        "launch_seconds_budget": float(train_cfg.launch_seconds_budget),
        "max_models_per_program": int(train_cfg.max_models_per_program),
        "bucket_genes": [str(g) for g in train_cfg.bucket_genes],
        "split_flops_per_s": float(
            PopulationEvaluator._SUSTAINED_FLOPS_PER_S),
        "split_min_seconds": float(
            PopulationEvaluator._MIN_SPLIT_PROGRAM_SECONDS),
        "pop_axis": int(pop_axis),
        "epochs": int(train_cfg.epochs),
        "batch_size": int(train_cfg.batch_size),
        "patience": int(train_cfg.patience),
        "learning_rate": float(train_cfg.learning_rate),
        "num_classes": int(train_cfg.num_classes),
        "restore_best_weights": bool(train_cfg.restore_best_weights),
        "accuracy_from": str(train_cfg.accuracy_from),
        "template": str(train_cfg.template),
        "dropout_rate": float(train_cfg.dropout_rate),
        "compute_dtype": str(train_cfg.compute_dtype),
        "data_axis": int(data_axis),
        "dataset": dataset_fingerprint(data),
    }


class FitnessCache:
    """Append-only JSONL cache of completed trainings.

    Raises ``ValueError`` if ``path`` already holds a cache written under a
    different fingerprint — resuming a run whose config, data, backend or
    device changed would silently mix incompatible fitnesses otherwise.
    """

    def __init__(self, path: str, fingerprint: Dict):
        self.path = path
        self.fingerprint = fingerprint
        self._mem: Dict[Tuple[tuple, int], Fitness] = {}
        if os.path.exists(path) and os.path.getsize(path) > 0:
            self._load()
            # Repair a crash-torn tail: a final line without a newline would
            # otherwise concatenate with (and destroy) the next append.
            # Writing the missing newline turns the torn fragment into its
            # own junk line, which every load skips.
            with open(path, "rb+") as f:
                f.seek(-1, os.SEEK_END)
                if f.read(1) != b"\n":
                    f.write(b"\n")
                    f.flush()
                    os.fsync(f.fileno())
        else:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            with open(path, "w") as f:
                f.write(json.dumps({"fingerprint": fingerprint}) + "\n")
                f.flush()
                os.fsync(f.fileno())

    def _load(self) -> None:
        with open(self.path) as f:
            lines = f.read().split("\n")
        try:
            header = json.loads(lines[0])
        except (json.JSONDecodeError, IndexError):
            raise ValueError(
                f"{self.path} is not a fitness cache (unreadable header)"
            )
        if header.get("fingerprint") != self.fingerprint:
            raise ValueError(
                f"fitness cache {self.path} was written under a different "
                "training config / dataset; delete it (or point "
                "--fitness-cache elsewhere) to proceed.\n"
                f"  cached: {header.get('fingerprint')}\n"
                f"  current: {self.fingerprint}"
            )
        for line in lines[1:]:
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # truncated final line from a crash mid-append
            self._mem[(tuple(rec["g"]), int(rec["seed"]))] = (
                float(rec["acc"]), float(rec["size"]), float(rec["fpr"])
            )

    def __len__(self) -> int:
        return len(self._mem)

    def get(self, genome: Genome, seed: int) -> Optional[Fitness]:
        return self._mem.get((genome_key(genome), int(seed)))

    def put_many(
        self, entries: Sequence[Tuple[Genome, int, Fitness]]
    ) -> None:
        """Record completed trainings; one durable append per call."""
        new_lines = []
        for genome, seed, fit in entries:
            key = (genome_key(genome), int(seed))
            if key in self._mem:
                continue
            self._mem[key] = tuple(float(v) for v in fit)  # type: ignore
            new_lines.append(json.dumps({
                "g": [genome[g] for g in GENE_ORDER],
                "seed": int(seed),
                "acc": float(fit[0]),
                "size": float(fit[1]),
                "fpr": float(fit[2]),
            }))
        if not new_lines:
            return
        with open(self.path, "a") as f:
            f.write("\n".join(new_lines) + "\n")
            f.flush()
            os.fsync(f.fileno())
