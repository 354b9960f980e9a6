"""Population evaluator: genome list -> (accuracy, size_mb, fpr) fitness.

The true-fitness layer (cmoop_audio_processing_tpu/engine/evaluator.py).
Instead of the reference's serial build/fit per individual
(sa_nsga_penalty.py:205-253), genomes are grouped into shape buckets
(``TrainConfig.bucket_genes``); each bucket's sub-population is padded to a
power of two (at most ``max_models_per_program``, repeating its first
genome) and trained as ONE population (engine/trainer.py) specialized to
the deepest genome it holds.

The launch plan is the JAX package's:

* cache replay — with a fitness cache, (genome, seed) pairs already on disk
  are answered from it and never trained (utils/fitness_cache.py);
* stop-epoch packing — when a bucket splits into several launches, genomes
  are ordered by their last observed stop epoch so fast stoppers share a
  launch;
* the heavy-lane split (``_should_split_lanes``) — under the adaptive
  policy (``compaction_chunk=-1``, no mesh) a bucket whose one-lane whole
  run is estimated at ``_MIN_SPLIT_PROGRAM_SECONDS`` or more trains each
  genome in a launch of its own, specialized to its own depth;
* lane compaction (``_effective_chunk``) — a population trains in chunks
  of epochs; between chunks the lanes that early-stopped are finalized and
  dropped, and the survivors go on as a population of the next power of
  two. Compacted launches run last;
* the launch-duration bound (``_effective_chunk``) — under the adaptive
  policy a launch estimated to run longer than ``TrainConfig.
  launch_seconds_budget`` trains in chunks of at most that many seconds
  (0 disables it).

Both estimates come from ``_est_epoch_seconds``: the executed training
FLOPs of an epoch (``_epoch_flops``) over ``_SUSTAINED_FLOPS_PER_S``, a
rate read on the card.

Launches run one after another and each one's results are read, published
and written to the fitness cache before the next starts (the JAX package's
``CMOOP_SYNC_DISPATCH=1`` mode), so a crash loses only the launch that was
running. ``CMOOP_LOG_LAUNCHES=1`` prints each launch to stderr.

Size is computed analytically from the genome (models/genome_arch.py),
exactly reproducing Keras count_params * 4 bytes (nsga_penalty.py:337-344).

A genome's fitness is a function of (genome, seed, dataset) alone:
genome-keyed init and uid-keyed dropout streams plus a seed-keyed shuffle
make it independent of which genomes share its population, so chunking,
compaction and packing leave it unchanged (bit for bit on the CPU; on CUDA
another lane count runs other kernels, see utils/fitness_cache.py). On
CUDA the path runs in deterministic mode (core/device.py), so
re-evaluations of one launch plan repeat bit for bit.

With a device mesh (parallel/mesh.py) every launch is one-shot and its
lanes are padded to a multiple of the pop width. With a data axis of 1,
each pop shard trains its slice of the lanes on its own device with the
configured forward and no collective; every process runs the shards it
owns and, after training, gathers every shard's results
(``_gather_replicated``). With a data axis larger than 1 (one process),
each pop shard's batch rows are split over its data devices
(``mesh.SplitData``), with BN statistics, gradients and the loss over the
global batch. In one process the pop shards train one after another, so
a mesh of several GPUs is no faster than one GPU there (and slower than
no mesh: each shard runs fewer lanes per launch); only one process per
GPU (``mesh.distributed_init``, called by the caller) runs shards at the
same time.

A deterministic FakeEvaluator over the enumerable 288-genome space stands in
for training in driver tests.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import TrainConfig
from ..core.device import resolve_device
from ..core.genome import HPARAM_SPACE, Genome, genome_key, validate
from ..models.genome_arch import count_fwd_flops, model_size_mb
from ..models.supernet import BucketSpec, init_population
from ..parallel.mesh import (
    Mesh,
    SplitData,
    batch_sharding,
    pop_sharding,
    replicated,
    shard_population,
)
from ..utils.profiling import span
from .trainer import (
    PopulationTrainer,
    TrainSettings,
    gather_lanes,
    host_read,
    pad_dataset,
    train_key_of,
)

Fitness = Tuple[float, float, float]  # (acc, size_mb, fpr)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@contextlib.contextmanager
def _launch_span(n: int, total: int, spec: BucketSpec, pop: int, t0: float,
                 log: bool):
    """The ``evaluator.launch`` span of launch ``n`` of ``total``; with
    ``log`` (CMOOP_LOG_LAUNCHES=1) its start and end are printed to stderr,
    timed from ``t0``."""
    if log:
        print(
            f"[launch {n+1}/{total}] f={spec.filters} "
            f"k={spec.kernel} blocks={spec.max_blocks} "
            f"pop={pop} start t+{time.perf_counter()-t0:.1f}s",
            file=sys.stderr, flush=True,
        )
    with span("evaluator.launch", filters=spec.filters, kernel=spec.kernel,
              blocks=spec.max_blocks, pop=pop):
        yield
    if log:
        print(
            f"[launch {n+1}/{total}] done "
            f"t+{time.perf_counter()-t0:.1f}s",
            file=sys.stderr, flush=True,
        )


class PopulationEvaluator:
    """Evaluates genome populations on one device, or on the devices of a
    mesh, one population per launch, with an optional durable fitness
    cache. With a ``mesh``, ``device`` is not read: the data sets go to
    every distinct device of the mesh that this process owns, once."""

    def __init__(
        self,
        data: Dict[str, np.ndarray],
        train_cfg: TrainConfig,
        device="cuda",
        mesh: Optional[Mesh] = None,
        fitness_cache_path: Optional[str] = None,
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
        self.mesh = mesh
        # a mesh spanning several processes: each runs the pop shards it
        # owns and the results are gathered after training
        self._multiproc = mesh is not None and mesh.process_count > 1
        n_data = mesh.shape["data"] if mesh is not None else 1
        if self._multiproc and n_data > 1:
            raise NotImplementedError(
                "multi-host meshes support data axis == 1 (population "
                "sharding over processes); shard the batch within a "
                "process's chips instead"
            )
        # a data axis larger than 1 sets parallel_impl "vmap", as the JAX
        # package does (its GSPMD psums need the vmap forward). Here it
        # only mirrors JAX's settings and fingerprint: both names run the
        # same forward (engine/trainer.py, TrainSettings)
        impl = train_cfg.parallel_impl
        if n_data > 1:
            impl = "vmap"
        self.settings = TrainSettings(
            epochs=train_cfg.epochs,
            batch_size=train_cfg.batch_size,
            patience=train_cfg.patience,
            learning_rate=train_cfg.learning_rate,
            restore_best_weights=train_cfg.restore_best_weights,
            parallel_impl=impl,
            compaction_chunk=train_cfg.compaction_chunk,
        )
        if n_data > 1 and (train_cfg.batch_size % n_data
                           or self.settings.eval_batch_size % n_data):
            raise ValueError(
                f"batch sizes ({train_cfg.batch_size}, "
                f"{self.settings.eval_batch_size}) must divide by the "
                f"'data' mesh axis ({n_data})"
            )
        devices = replicated(mesh) if mesh is not None else []
        devices = [resolve_device(d) for d in devices] or [
            resolve_device(device)]
        self.device = devices[0]
        # pad once, move to the device once
        xtr, ytr, wtr = pad_dataset(
            data["x_train"], data["y_train"], train_cfg.batch_size
        )
        xval, yval, wval = pad_dataset(
            data["x_val"], data["y_val"], self.settings.eval_batch_size
        )

        def put(a, dtype, dev):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        # {device: (train, val)}, each distinct device once
        self._data_on = {
            dev: tuple(
                (put(x, torch.float32, dev), put(y, torch.int64, dev),
                 put(w, torch.float32, dev))
                for x, y, w in ((xtr, ytr, wtr), (xval, yval, wval)))
            for dev in devices
        }
        self._train, self._val = self._data_on[self.device]
        # Optional durable (genome, seed) -> fitness cache: completed
        # trainings survive a mid-generation crash and are replayed on
        # resume (utils/fitness_cache.py). Fingerprinted against the RAW
        # (pre-padding) splits, every result-affecting config field and the
        # device kind.
        self.fitness_cache = None
        if fitness_cache_path:
            from ..utils.fitness_cache import FitnessCache, evaluator_fingerprint

            n_pop = mesh.shape["pop"] if mesh is not None else 1
            self.fitness_cache = FitnessCache(
                fitness_cache_path,
                evaluator_fingerprint(train_cfg, data, self.device.type,
                                      n_data, n_pop),
            )
        self._eval_count = 0
        self._launch_count = 0  # training segments run this evaluate()
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

    # -- evaluation -----------------------------------------------------------

    def evaluate(self, genomes: Sequence[Genome], seed: int = 0) -> List[Fitness]:
        """Evaluate all genomes; returns fitness per genome in input order.
        Genomes sharing a bucket train together in one population."""
        with span("evaluator.call", n_genomes=len(genomes), seed=seed):
            return self._evaluate(genomes, seed)

    def _evaluate(self, genomes: Sequence[Genome], seed: int) -> List[Fitness]:
        t0 = time.perf_counter()
        self._launch_count = 0
        for g in genomes:
            validate(g)  # out-of-space genomes would silently mis-bucket
        results: List[Optional[Fitness]] = [None] * len(genomes)
        # replay finished trainings from the durable cache (crash-resume);
        # idempotence makes the replay behaviorally invisible
        cached: set = set()
        if self.fitness_cache is not None:
            for i, g in enumerate(genomes):
                hit = self.fitness_cache.get(g, seed)
                if hit is not None:
                    results[i] = hit
                    cached.add(i)

        buckets: Dict[tuple, List[int]] = {}
        for i, g in enumerate(genomes):
            if i in cached:
                continue
            key = tuple(g[b] for b in self.cfg.bucket_genes)
            buckets.setdefault(key, []).append(i)

        launches = []
        for bkey, idxs in buckets.items():
            f, k = int(bkey[0]), int(bkey[1])
            sub = [genomes[i] for i in idxs]
            pop = min(
                _next_pow2(len(sub)), max(self.cfg.max_models_per_program, 1)
            )
            if pop > 1 and self._should_split_lanes(f, k, sub):
                # heavy lanes: one launch per genome, each specialized to
                # its own depth
                pop = 1
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
                target = _next_pow2(len(chunk))
                if self.mesh is not None:
                    # lanes shard over 'pop': pad to a multiple of its width
                    npop = self.mesh.shape["pop"]
                    target = -(-target // npop) * npop
                padded = list(chunk) + [chunk[0]] * (target - len(chunk))
                # specialize to the deepest genome actually in this launch
                spec = self._bucket_spec(
                    f, k, max(int(g["residual_blocks"]) for g in chunk)
                )
                launches.append((chunk_idx, spec, padded))
        # one-shot launches first, compacted ones last (the JAX package's
        # order; a stable sort keeps the bucket order within each group)
        launches.sort(
            key=lambda t: self._effective_chunk(len(t[2]), t[1]) > 0
        )
        log_launches = os.environ.get("CMOOP_LOG_LAUNCHES", "0") == "1"
        chunk_records = []
        for n, (chunk_idx, spec, padded) in enumerate(launches):
            with _launch_span(n, len(launches), spec, len(padded), t0,
                              log_launches):
                fits = self._run_bucket(spec, padded, seed)
                for j, gi in enumerate(chunk_idx):
                    g = genomes[gi]
                    size = model_size_mb(g, self.cfg.num_classes,
                                         self.cfg.template)
                    results[gi] = (float(fits["acc"][j]), size,
                                   float(fits["fpr"][j]))
                    self._epoch_history[genome_key(g)] = float(
                        fits["epochs"][j])
                # durable per launch: a crash in a later launch loses nothing
                # of this one
                if self.fitness_cache is not None:
                    self.fitness_cache.put_many(
                        [(genomes[gi], seed, results[gi]) for gi in chunk_idx]
                    )
                pop = len(padded)
                chunk_records.append({
                    "filters": spec.filters,
                    "kernel": spec.kernel,
                    "max_blocks": spec.max_blocks,
                    "pop": pop,
                    "compacted": self._effective_chunk(pop, spec) > 0,
                    "epochs": [int(e) for e in fits["epochs"]],
                    # lanes of each training segment: one entry for a one-shot
                    # launch, falling where compaction dropped stopped lanes
                    "lanes": list(fits["lanes"]),
                })
        self.timings.append(
            {
                "n_genomes": len(genomes),
                "n_buckets": len(buckets),
                "launches": self._launch_count,
                "seconds": time.perf_counter() - t0,
                "cache_hits": len(cached),
                # per-launch execution shape for FLOPs accounting: lockstep
                # bills every (padded) lane until the slowest stops
                "chunks": chunk_records,
            }
        )
        # trainings actually performed (cache replays are not true evals)
        self._eval_count += len(genomes) - len(cached)
        return results  # type: ignore[return-value]

    # -- the launch policy ----------------------------------------------------

    # Sustained training rate assumed by the launch-time estimates: at or
    # below the lowest executed training rate chip_smoke.py has read at
    # full width on either preset's shape, on an NVIDIA H100 80GB HBM3 at a
    # 700.00 W power limit: one KWS 45x13 lane, where the host's per-step
    # work bounds the trainer (PERF.md). Underestimating it only makes the
    # plan split and chunk earlier.
    _SUSTAINED_FLOPS_PER_S = 3e12

    def _epoch_flops(self, pop: int, spec: BucketSpec) -> int:
        """Executed training FLOPs of one lockstep epoch of a ``pop``-lane
        launch of ``spec``: the spec's largest genome, 3x its forward for
        every padded training row and 1x for every padded validation row."""
        gmax = {
            "filters": spec.filters, "kernel_size": spec.kernel,
            "use_bn": True, "residual_blocks": spec.max_blocks,
            "fc_layers": 4, "use_dropout": False,
        }
        hw = tuple(int(d) for d in self._train[0].shape[1:3])
        fwd = count_fwd_flops(gmax, hw, self.cfg.num_classes,
                              self.cfg.template)
        n_train_pad = int(self._train[0].shape[0])
        n_val_pad = int(self._val[0].shape[0])
        return pop * fwd * (3 * n_train_pad + n_val_pad)

    def _est_epoch_seconds(self, pop: int, spec: BucketSpec) -> float:
        """Estimated seconds of one lockstep epoch of a ``pop``-lane launch
        of ``spec`` on the card."""
        return self._epoch_flops(pop, spec) / self._SUSTAINED_FLOPS_PER_S

    # The split rule: under the adaptive policy a bucket of several lanes
    # trains one launch per genome when one lane's whole run is estimated
    # at this many seconds or more. A launch that long is long beside the
    # per-launch cost every population pays (its init and the host's reads
    # of each epoch's stop flags), while lockstep fusion bills every lane
    # until the bucket's slowest model stops; one-lane launches also
    # specialize to their own genome's depth. chip_smoke.py's split phase
    # measures what the rule does to trainings per hour on the card.
    _MIN_SPLIT_PROGRAM_SECONDS = 2.0

    def _should_split_lanes(self, f: int, k: int, sub: List[Genome]) -> bool:
        """Whether a bucket's genomes train in one-lane launches rather
        than fused: only under ``compaction_chunk=-1`` and never on a mesh
        (the pop axis is the sharded dimension there)."""
        if self.mesh is not None or self.settings.compaction_chunk >= 0:
            return False
        spec = self._bucket_spec(
            f, k, max(int(g["residual_blocks"]) for g in sub)
        )
        return (
            self._est_epoch_seconds(1, spec) * self.settings.epochs
            >= self._MIN_SPLIT_PROGRAM_SECONDS
        )

    def _effective_chunk(self, pop: int, spec: BucketSpec) -> int:
        """Resolve ``TrainConfig.compaction_chunk`` for a launch of ``pop``
        padded lanes of ``spec``. -1 = adaptive, two terms (the smaller
        wins when both engage):

        * lane compaction — pays only when enough lanes can be dropped
          (pop >= 8) and the epoch budget dwarfs the chunk quantum;
          2*patience epochs (at least 10) between compactions let stopping
          decisions settle;
        * launch-duration bound — a launch whose estimated time exceeds
          ``launch_seconds_budget`` (> 0) runs in chunks of at most that
          many estimated seconds.

        An explicit non-negative ``compaction_chunk`` is honored verbatim
        (0 = always one-shot, which also disables the duration bound).
        Chunk boundaries alone leave the results bit for bit; dropping
        lanes changes the population's group count, which on CUDA runs
        other kernels (chip_smoke.py's planner phase measures the drift).
        A device mesh forces one-shot."""
        if self.mesh is not None:
            return 0
        chunk = self.settings.compaction_chunk
        if chunk >= 0:
            return chunk
        lane_chunk = 0
        if (
            pop >= 8
            and self.settings.epochs >= 8 * max(self.settings.patience, 1)
        ):
            lane_chunk = max(2 * self.settings.patience, 10)
        dur_chunk = 0
        budget = self.cfg.launch_seconds_budget
        if budget and budget > 0:
            est = self._est_epoch_seconds(pop, spec)
            if est * self.settings.epochs > budget:
                dur_chunk = max(int(budget / est), 1)
        if lane_chunk and dur_chunk:
            return min(lane_chunk, dur_chunk)
        return lane_chunk or dur_chunk

    # -- launches -------------------------------------------------------------

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
        """Train one launch's (padded) population: in one segment, or in
        chunks with lane compaction. Returns per-lane numpy ``acc``,
        ``fpr`` and ``epochs`` and the ``lanes`` of each segment."""
        pop = len(padded)
        acc_key = "acc_eval" if self.cfg.accuracy_from == "best" else "acc_last"
        trainer = PopulationTrainer(spec, self.settings, self.cfg.num_classes)
        cap = self.settings.epochs
        if self.mesh is not None:
            return self._run_on_mesh(trainer, padded, seed, acc_key)
        chunk = self._effective_chunk(pop, spec)
        if chunk <= 0:
            out, _ = trainer.run_full(padded, self._train, self._val, seed, cap)
            self._launch_count += 1
            return {
                "acc": host_read(out[acc_key], acc_key),
                "fpr": host_read(out["fpr"], "fpr"),
                "epochs": host_read(out["epochs_ran"], "epochs_ran"),
                "lanes": [pop],
            }

        # Chunked training with lane compaction: between chunks, lanes whose
        # models early-stopped are finalized and dropped, and the survivors
        # go on as a population of the next power of two — lockstep training
        # otherwise bills every lane for the SLOWEST model's epochs. The
        # shuffle and dropout streams are keyed by global epoch and genome
        # uid, so chunk boundaries and lane positions do not show in the
        # results (bit for bit on the CPU).
        with span("trainer.init", pop=pop):
            params, state, flags = init_population(seed, spec, padded,
                                                   self.device)
            carry = trainer.init_carry(params, state, flags)
        train_key = train_key_of(seed)
        lane_map = list(range(pop))  # current lane -> original padded index
        acc = np.zeros(pop)
        fpr = np.zeros(pop)
        epochs = np.zeros(pop, np.int32)
        lanes = []

        def record(out, lane_ids):
            for li in lane_ids:
                oi = lane_map[li]
                if oi < 0:  # compaction padding lane
                    continue
                acc[oi] = out[acc_key][li]
                fpr[oi] = out["fpr"][li]
                epochs[oi] = out["epochs_ran"][li]

        def final(c):
            return {k: host_read(v, k) for k, v in
                    trainer.finalize(c, self._val).items()}

        while True:
            lanes.append(len(lane_map))
            carry = trainer.run_chunk(carry, self._train, self._val,
                                      train_key,
                                      min(carry["epoch"] + chunk, cap))
            self._launch_count += 1
            stopped = host_read(carry["stopped"], "stopped")
            if stopped.all() or carry["epoch"] >= cap:
                record(final(carry), range(len(lane_map)))
                break
            active = np.nonzero(~stopped)[0]
            target_pop = _next_pow2(len(active))
            if target_pop <= len(lane_map) // 2:
                record(final(carry), np.nonzero(stopped)[0])
                keep = list(active) + [int(active[0])] * (
                    target_pop - len(active))
                carry = gather_lanes(carry, keep)
                lane_map = [lane_map[i] for i in active] + [-1] * (
                    target_pop - len(active))
        return {"acc": acc, "fpr": fpr, "epochs": epochs, "lanes": lanes}

    def _run_on_mesh(self, trainer, padded, seed, acc_key):
        """One launch on the mesh, one-shot. Data axis 1: each owned pop
        shard trains its lanes on its device (``trainer.run_full``) with no
        collective; padding lanes repeat ``padded[0]`` and are never read.
        Data axis > 1: the population is initialized once, each owned pop
        shard's slice goes to its first data device and trains with its
        batch rows split over its data devices. Every process then gathers
        the shards' results."""
        mesh = self.mesh
        n_pop, n_data = mesh.shape["pop"], mesh.shape["data"]
        k = len(padded) // n_pop
        cap = self.settings.epochs
        outs = {}
        if n_data == 1:
            for i in mesh.local_pop_shards():
                train, val = self._data_on[pop_sharding(mesh)[i]]
                outs[i], _ = trainer.run_full(
                    padded[i * k:(i + 1) * k], train, val, seed, cap)
            self._launch_count += 1
        else:
            params, state, flags = init_population(seed, trainer.spec,
                                                   padded)
            shards = shard_population(
                {"params": params, "state": state, "flags": flags}, mesh)
            for i, tree in shards.items():
                devs = batch_sharding(mesh, i)
                train = SplitData([self._data_on[d][0] for d in devs])
                val = SplitData([self._data_on[d][1] for d in devs])
                carry = trainer.init_carry(tree["params"], tree["state"],
                                           tree["flags"])
                carry = trainer.run_chunk(carry, train, val,
                                          train_key_of(seed), cap)
                outs[i] = trainer.finalize(carry, val)
            self._launch_count += 4  # init_pop + carry + chunk + final
        fits = self._gather_replicated({
            i: {"acc": host_read(out[acc_key], acc_key),
                "fpr": host_read(out["fpr"], "fpr"),
                "epochs": host_read(out["epochs_ran"], "epochs_ran")}
            for i, out in outs.items()})
        out = {name: np.concatenate([fits[i][name] for i in range(n_pop)])
               for name in ("acc", "fpr", "epochs")}
        out["lanes"] = [len(padded)]
        return out

    def _gather_replicated(self, shards: Dict[int, Dict]) -> Dict[int, Dict]:
        """Every process ends with every pop shard's results: one
        all-gather of the host results after a launch's training (a no-op
        in one process)."""
        if not self._multiproc:
            return shards
        import torch.distributed as dist

        parts: List[Optional[Dict]] = [None] * dist.get_world_size()
        dist.all_gather_object(parts, shards)
        return {i: r for part in parts for i, r in part.items()}

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
