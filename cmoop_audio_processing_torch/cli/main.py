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

This port carries the plain NSGA-II presets and the surrogate-assisted
SA-NSGA-II ones (``algorithm == "sa_nsga2"``; their GP fits run on
``--device``). Options it does not carry yet exit with a message naming
their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Optional

from ..core.config import PRESETS, ExperimentConfig, get_preset


SUPPORTED_ALGORITHMS = ("nsga2", "sa_nsga2")


def _not_yet(what: str) -> str:
    return (f"{what} is not in the PyTorch port yet (ROADMAP.md, "
            "'Left out of the port so far')")


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
                   help="durable (genome, seed) -> fitness JSONL; not in this "
                        "port yet ('off' is accepted)")
    p.add_argument("--fake-eval", action="store_true",
                   help="use the deterministic closed-form evaluator (no training)")
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"])
    p.add_argument("--parallel-impl", choices=["grouped", "vmap"],
                   help="population forward implementation (this port has "
                        "only 'grouped')")
    p.add_argument("--compaction-chunk", type=int,
                   help="early-stop lane compaction; not in this port yet")
    p.add_argument("--launch-budget", type=float, metavar="SECONDS",
                   help="per-launch duration bound; not in this port yet")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard the population over N devices; not in this "
                        "port yet")
    p.add_argument("--mesh-data", type=int, default=1,
                   help="shard each training batch over M devices; not in "
                        "this port yet")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the training engine and the GP fits "
                        "(default cuda)")
    return p


def check_supported(args) -> None:
    """Exit with a clear message for options this port does not carry."""
    cfg = get_preset(args.preset)
    if cfg.algorithm not in SUPPORTED_ALGORITHMS:
        raise SystemExit(
            _not_yet(f"preset {args.preset!r} (driver {cfg.algorithm!r})")
            + "; the presets it carries are "
            + ", ".join(sorted(n for n, c in PRESETS.items()
                               if c.algorithm in SUPPORTED_ALGORITHMS))
        )
    if args.mesh or args.mesh_data != 1:
        raise SystemExit(_not_yet("--mesh/--mesh-data (multi-GPU)"))
    if args.fitness_cache not in (None, "off"):
        raise SystemExit(_not_yet("--fitness-cache"))
    if args.compaction_chunk is not None:
        raise SystemExit(_not_yet("--compaction-chunk (lane compaction)"))
    if args.launch_budget is not None:
        raise SystemExit(_not_yet("--launch-budget"))
    if args.parallel_impl == "vmap":
        raise SystemExit(_not_yet("--parallel-impl vmap"))


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
    search = cfg.search
    if args.seed is not None:
        search = dataclasses.replace(search, seed=args.seed)
    if args.pop_size:
        search = dataclasses.replace(search, pop_size=args.pop_size)
    if args.max_gen:
        search = dataclasses.replace(search, max_gen=args.max_gen)
    if args.psi_seed_file:
        search = dataclasses.replace(search, psi_seed_file=args.psi_seed_file)
    return cfg.replace(
        data=data, train=train, search=search, output_dir=args.out
    )


def make_evaluator(cfg: ExperimentConfig, fake: bool, device="cuda"):
    if fake:
        from ..engine.evaluator import FakeEvaluator

        return FakeEvaluator(
            num_classes=cfg.train.num_classes, template=cfg.train.template
        )
    from ..data.pipeline import prepare_dataset
    from ..engine.evaluator import PopulationEvaluator

    return PopulationEvaluator(prepare_dataset(cfg.data), cfg.train,
                               device=device)


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
    else:
        raise ValueError(_not_yet(f"driver {cfg.algorithm!r}"))
    _emit_artifact_aliases(reporter, cfg.artifact_suffix)
    return result


def main(argv: Optional[list] = None, preset: Optional[str] = None) -> int:
    if preset is not None:
        argv = ["--preset", preset] + list(argv if argv is not None else sys.argv[1:])
    args = build_parser().parse_args(argv)
    check_supported(args)
    cfg = config_from_args(args)
    evaluator = make_evaluator(cfg, args.fake_eval, args.device)
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
