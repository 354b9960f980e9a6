"""Plain constrained NSGA-II driver (no surrogate).

Reproduces the generation loop of nsga_penalty.py:610-776 and the
bi-objective stage-1 variants (acc_size_nsga_1.py:424-515): per-generation
adaptive lambda, NDS + crowding bookkeeping, binary tournaments, crossover/
mutation, true evaluation of all offspring, (mu+lambda) environmental
selection, per-generation logging, periodic + final feasible-Pareto
extraction.

The difference from the reference is WHERE fitness happens:
``evaluator.evaluate`` trains the whole offspring population as bucketed
grouped-conv populations on the GPU instead of 15 serial Keras fits — the EA bookkeeping here is deliberately host-side
Python over tiny dict lists (SURVEY.md §2.3 host/device split).

Supports per-generation checkpoint/resume (absent in the reference;
SURVEY.md §5 gap-fill).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..core.config import SearchConfig
from ..core.genome import Genome
from ..core.records import Individual, make_individual
from ..core.rng import RunRng
from ..utils.checkpoint import _restore_individual, load_checkpoint, save_checkpoint
from ..utils.reporting import RunReporter, StageTimer
from . import ea
from .initializers import lhs_init, psi_init, random_init


def evaluate_genomes(
    evaluator, genomes: Sequence[Genome], cfg: SearchConfig, seed: int = 0
) -> List[Individual]:
    """True evaluation -> individual records (the objective+constraint
    wrapper, sa_nsga_penalty.py:231-253). ``cfg.eval_seed`` (common random
    numbers) overrides the caller's per-generation seed when set."""
    if cfg.eval_seed is not None:
        seed = cfg.eval_seed
    fits = evaluator.evaluate(list(genomes), seed=seed)
    return [
        make_individual(g, acc, size, fpr, cfg.constraints, cfg.objectives)
        for g, (acc, size, fpr) in zip(genomes, fits)
    ]


def initialize(
    cfg: SearchConfig, rng: RunRng, evaluator
) -> List[Individual]:
    """Dispatch to the configured initializer; PSI seeds arrive
    pre-evaluated (psi_init_sa_nsga.py:365-379)."""
    if cfg.initializer == "random":
        genomes = random_init(cfg.pop_size, rng.host)
        return evaluate_genomes(evaluator, genomes, cfg, seed=cfg.seed)
    if cfg.initializer == "lhs":
        genomes = lhs_init(cfg.pop_size, rng.numpy)
        return evaluate_genomes(evaluator, genomes, cfg, seed=cfg.seed)
    if cfg.initializer == "psi":
        if not cfg.psi_seed_file:
            raise ValueError("initializer='psi' requires psi_seed_file")
        return psi_init(cfg.psi_seed_file, cfg.constraints, cfg.objectives)
    raise ValueError(f"unknown initializer {cfg.initializer!r}")


def run_nsga2(
    cfg: SearchConfig,
    evaluator,
    reporter: Optional[RunReporter] = None,
    checkpoint_path: Optional[str] = None,
) -> Tuple[List[Individual], List]:
    """Full NSGA-II run; returns (final feasible Pareto set, per-gen
    row lists)."""
    rng = RunRng(cfg.seed)
    start_gen = 0
    pop_data: List[Individual] = []

    ckpt = load_checkpoint(checkpoint_path) if checkpoint_path else None
    if ckpt is not None and ckpt.get("algorithm") == "nsga2":
        pop_data = [_restore_individual(r) for r in ckpt["population"]]
        rng.load_state_dict(ckpt["rng"])
        start_gen = ckpt["generation"] + 1
        if reporter:
            reporter.log("resume", generation=start_gen)
    else:
        with StageTimer(reporter, "init_eval"):
            pop_data = initialize(cfg, rng, evaluator)
        if not pop_data:
            # PSI seed file missing/empty: clean no-op run, mirroring the
            # reference's message-and-return handling (psi_mobo_2.py:365-369)
            if reporter:
                reporter.log("empty_init", initializer=cfg.initializer)
            return [], []

    for gen in range(start_gen, cfg.max_gen):
        lam = cfg.penalty.lam(gen, cfg.max_gen)
        with StageTimer(reporter, "generation", gen=gen):
            # selection bookkeeping (fronts computed for parity with the
            # reference's loop, nsga_penalty.py:623-629)
            ea.fast_non_dominated_sort(pop_data, lam)
            parents = [
                ea.tournament_selection(pop_data, lam, rng.host)
                for _ in range(cfg.pop_size)
            ]
            offspring = ea.make_offspring(
                pop_data,
                parents,
                rng.host,
                crossover_prob=cfg.crossover_prob,
                mutation_prob=cfg.mutation_prob,
                pairing=cfg.pairing,
                pop_size=cfg.pop_size,
            )
            with StageTimer(reporter, "offspring_eval", gen=gen):
                off_data = evaluate_genomes(
                    evaluator, offspring, cfg, seed=cfg.seed + gen + 1
                )
            pop_data = ea.environmental_selection(
                pop_data + off_data, cfg.pop_size, lam
            )

        if reporter:
            reporter.record_generation(gen, pop_data)
            pareto_now = ea.extract_final_pareto(
                pop_data, cfg.penalty.final_sort_lambda
            )
            reporter.periodic_pareto(gen, pareto_now)
        if checkpoint_path:
            save_checkpoint(
                checkpoint_path,
                {
                    "algorithm": "nsga2",
                    "generation": gen,
                    "population": pop_data,
                    "rng": rng.state_dict(),
                },
            )

    pareto = ea.extract_final_pareto(pop_data, cfg.penalty.final_sort_lambda)
    if reporter:
        reporter.final_pareto(pareto)
        reporter.all_generations()
    return pareto, (reporter.gen_rows if reporter else [])
