"""Command-line entry point of the PyTorch port.

Every reference script is a preset name, as in the JAX package's CLI:

    python -m cmoop_audio_processing_torch.cli.main --preset nsga_penalty \
        --source npy --data-path /data/KWS_npy --out results/

    python -m cmoop_audio_processing_torch.cli.main --preset sa_nsga_penalty \
        --source npy --data-path /data/birdclef_npy --out results/

    python -m cmoop_audio_processing_torch.cli.nsga_penalty --fake-eval

The parser is the JAX CLI's plus ``--device {cuda,cpu}`` (default cuda;
without a GPU the run raises unless ``--device cpu`` is given). Emits the
reference's artifact set into <out>/<preset>/: per-generation records,
periodic + final Pareto CSVs, all-generations workbook, progress JSONL,
checkpoint (resumable with --resume).

Every preset runs: plain NSGA-II, the surrogate-assisted SA-NSGA-II ones
and MOBO; the GP fits of the last two run on ``--device``. Every real run
records its finished trainings in <out>/<preset>/fitness_cache.jsonl (a
fresh run truncates it, ``--resume`` replays it). ``--mesh N`` shards each
launch's lanes over N devices and ``--mesh-data M`` each pop shard's batch
over M (parallel/mesh.py): the first N*M visible GPUs, or with ``--device
cpu`` N*M virtual CPU entries. The CLI runs one process; a caller that
runs several joins them with ``parallel.mesh.distributed_init`` first.
``--launch-budget`` sets ``TrainConfig.launch_seconds_budget``, the
evaluator's per-launch duration bound (0 disables it).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Optional

from ..core.config import PRESETS, ExperimentConfig, get_preset


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cmoop-torch",
        description="Constrained multi-objective NAS for audio classification "
                    "(PyTorch / CUDA)",
    )
    p.add_argument("--preset", required=True, choices=sorted(PRESETS),
                   help="reference-script preset to run")
    p.add_argument("--source", choices=["npy", "hdf5", "synthetic"],
                   help="dataset source (default: preset's)")
    p.add_argument("--data-path", help="path to .npy dir or .h5 file")
    p.add_argument("--out", default="results", help="output directory")
    p.add_argument("--seed", type=int, help="run seed")
    p.add_argument("--pop-size", type=int)
    p.add_argument("--max-gen", type=int, help="generations / MOBO iterations")
    p.add_argument("--epochs", type=int, help="per-candidate training epoch cap")
    p.add_argument("--psi-seed-file", help="stage-1 Pareto file for PSI presets")
    p.add_argument("--resume", action="store_true",
                   help="resume from the run's checkpoint if present")
    p.add_argument("--fitness-cache", metavar="PATH",
                   help="durable (genome, seed) -> fitness JSONL: finished "
                        "trainings survive a mid-generation crash and are "
                        "replayed on resume. Defaults to <out>/<preset>/"
                        "fitness_cache.jsonl for every real run (a fresh "
                        "run truncates it, --resume replays it); pass "
                        "'off' to disable")
    p.add_argument("--fake-eval", action="store_true",
                   help="use the deterministic closed-form evaluator (no training)")
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"])
    p.add_argument("--parallel-impl", choices=["grouped", "vmap"],
                   help="the JAX CLI's population forward choice; both "
                        "run the one grouped network in this port")
    p.add_argument("--compaction-chunk", type=int,
                   help="epochs between early-stop lane compactions: -1 "
                        "adaptive (default), 0 always one-shot, N fixed")
    p.add_argument("--launch-budget", type=float, metavar="SECONDS",
                   help="estimated seconds on the card a training launch "
                        "may run; over-budget launches run chunked (the "
                        "same results as one-shot). 0 disables the bound")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard the population over N devices (0 = no "
                        "mesh); this one process trains the shards one "
                        "after another, so it is not faster than no mesh")
    p.add_argument("--mesh-data", type=int, default=1,
                   help="additionally shard each training batch over M "
                        "devices (total devices = mesh * mesh_data)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the training engine and the GP fits "
                        "(default cuda)")
    return p


def check_supported(args) -> None:
    """Exit with a clear message for options that need another."""
    if args.mesh_data > 1 and not args.mesh:
        raise SystemExit(
            "--mesh-data requires --mesh (total devices = mesh * mesh_data)"
        )


def config_from_args(args) -> ExperimentConfig:
    cfg = get_preset(args.preset)
    data = cfg.data
    if args.source:
        data = dataclasses.replace(data, source=args.source)
    if args.data_path:
        data = dataclasses.replace(data, path=args.data_path)
    train = cfg.train
    if args.epochs is not None:
        train = dataclasses.replace(train, epochs=args.epochs)
    if args.compute_dtype:
        train = dataclasses.replace(train, compute_dtype=args.compute_dtype)
    if args.compaction_chunk is not None:
        train = dataclasses.replace(
            train, compaction_chunk=args.compaction_chunk
        )
    if args.parallel_impl:
        train = dataclasses.replace(train, parallel_impl=args.parallel_impl)
    if args.launch_budget is not None:
        train = dataclasses.replace(
            train, launch_seconds_budget=args.launch_budget
        )
    search = cfg.search
    if args.seed is not None:
        search = dataclasses.replace(search, seed=args.seed)
    if args.pop_size:
        search = dataclasses.replace(search, pop_size=args.pop_size)
    if args.max_gen:
        search = dataclasses.replace(search, max_gen=args.max_gen)
    if args.psi_seed_file:
        search = dataclasses.replace(search, psi_seed_file=args.psi_seed_file)
    mobo = cfg.mobo
    if mobo is not None:
        if args.seed is not None:
            mobo = dataclasses.replace(mobo, seed=args.seed)
        if args.max_gen:
            mobo = dataclasses.replace(mobo, max_iterations=args.max_gen)
        if args.psi_seed_file:
            mobo = dataclasses.replace(mobo, psi_seed_file=args.psi_seed_file)
    return cfg.replace(
        data=data, train=train, search=search, mobo=mobo, output_dir=args.out
    )


def make_evaluator(cfg: ExperimentConfig, fake: bool, device="cuda",
                   fitness_cache_path: Optional[str] = None,
                   mesh_devices: int = 0, mesh_data: int = 1):
    if fake:
        from ..engine.evaluator import FakeEvaluator

        return FakeEvaluator(
            num_classes=cfg.train.num_classes, template=cfg.train.template
        )
    from ..data.pipeline import prepare_dataset
    from ..engine.evaluator import PopulationEvaluator

    mesh = None
    if mesh_devices:
        from ..parallel.mesh import population_mesh

        n = mesh_devices * mesh_data
        mesh = population_mesh(
            mesh_devices, mesh_data,
            devices=["cpu"] * n if device == "cpu" else None)
    return PopulationEvaluator(prepare_dataset(cfg.data), cfg.train,
                               device=device, mesh=mesh,
                               fitness_cache_path=fitness_cache_path)


def _emit_artifact_aliases(reporter, suffix: Optional[str]) -> None:
    """Copy the canonical final artifacts under the reference script's
    literal names (ExperimentConfig.artifact_suffix: final_pareto_<suffix>
    .csv / all_generations_<suffix>.xlsx, e.g. sa_nsga_penalty.py:647,664).
    Only artifacts THIS run wrote are aliased — a no-op run (e.g. empty PSI
    init) must not re-publish a previous run's stale files under fresh
    timestamps."""
    if not suffix:
        return
    import shutil

    for canonical, alias in (
        ("final_pareto.csv", f"final_pareto_{suffix}.csv"),
        ("all_generations.xlsx", f"all_generations_{suffix}.xlsx"),
    ):
        src = os.path.join(reporter.dir, canonical)
        if canonical in reporter.artifacts_written and os.path.exists(src):
            shutil.copy(src, os.path.join(reporter.dir, alias))


def run(cfg: ExperimentConfig, evaluator, resume: bool = False,
        device="cuda"):
    from ..utils.reporting import RunReporter

    reporter = RunReporter(
        cfg.output_dir, cfg.name,
        # MOBO gates its own schedule (mobo.py passes force=True with
        # cfg.mobo.periodic_save_every), so the reporter's gate only ever
        # applies to the EA drivers
        periodic_every=cfg.search.periodic_save_every,
        resume=resume,
    )
    ck = os.path.join(reporter.dir, "checkpoint.json")
    if not resume and os.path.exists(ck):
        os.unlink(ck)

    if cfg.algorithm == "nsga2":
        from ..algorithms.nsga2 import run_nsga2

        result = run_nsga2(cfg.search, evaluator, reporter, checkpoint_path=ck)
    elif cfg.algorithm == "sa_nsga2":
        from ..algorithms.sa_nsga2 import run_sa_nsga2

        result = run_sa_nsga2(
            cfg.search, evaluator, reporter, checkpoint_path=ck, device=device
        )
    elif cfg.algorithm == "mobo":
        from ..algorithms.mobo import run_mobo

        result = run_mobo(
            cfg.mobo, evaluator, reporter, checkpoint_path=ck, device=device
        )
    else:
        raise ValueError(f"unknown algorithm {cfg.algorithm!r}")
    _emit_artifact_aliases(reporter, cfg.artifact_suffix)
    return result


def main(argv: Optional[list] = None, preset: Optional[str] = None) -> int:
    if preset is not None:
        argv = ["--preset", preset] + list(argv if argv is not None else sys.argv[1:])
    args = build_parser().parse_args(argv)
    check_supported(args)
    cfg = config_from_args(args)
    # The durable fitness cache is on for every real (non-fake) run, so a
    # first run that crashes mid-generation already has its finished
    # trainings on disk for --resume to replay. A fresh (non-resume) run
    # means "start over": any existing cache is truncated; --resume opens
    # it (and refuses a fingerprint mismatch). Explicit path wins, 'off'
    # disables.
    cache_path = args.fitness_cache
    if args.fake_eval:
        if cache_path not in (None, "off"):
            raise SystemExit(
                "--fitness-cache requires a real evaluator; the closed-form "
                "--fake-eval path records nothing (and must never touch a "
                "real run's cache file)"
            )
        cache_path = None
    elif cache_path is None:
        cache_path = os.path.join(
            cfg.output_dir, cfg.name, "fitness_cache.jsonl"
        )
    if cache_path == "off":
        cache_path = None
    if cache_path and not args.resume and os.path.exists(cache_path):
        os.remove(cache_path)
    evaluator = make_evaluator(cfg, args.fake_eval, args.device,
                               fitness_cache_path=cache_path,
                               mesh_devices=args.mesh,
                               mesh_data=args.mesh_data)
    pareto, _ = run(cfg, evaluator, resume=args.resume, device=args.device)
    print(f"\nFinal Pareto-optimal feasible solutions ({len(pareto)}):")
    for sol in pareto:
        m = sol["metrics"]
        print(
            f"  Acc={m['acc']:.4f}, Size={m['size']:.3f}MB, FPR={m['fpr']:.4f},"
            f" HParams={sol['hparams']}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
