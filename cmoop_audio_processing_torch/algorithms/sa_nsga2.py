"""Surrogate-assisted NSGA-II driver (SA-NSGA-II), with optional Lamarckian
LCB local search — the paper's headline algorithm family.

Reproduces the loop of sa_nsga_penalty.py:522-637 (+ local-search variant
init_sa_nsga_local.py:388-470):

    init (random/LHS/PSI) -> true-eval -> surrogate fit
    per generation:
      tournament -> offspring (crossover+mutate)
      [local search on surrogate LCB]                 (variants only)
      surrogate-predict all offspring
      select_infill_points -> true-eval max(1, pop*infill_percent)
      surrogate update; true results overwrite predictions
      (mu+lambda) environmental selection on the mixed population

Infill selection (sa_nsga_penalty.py:472-518): predicted-feasible first
ranked by equal-weight normalized objective sum, then infeasible by
predicted CV, take top N.

A copy of cmoop_audio_processing_tpu/algorithms/sa_nsga2.py; the GP fits
run on ``device`` (default cuda).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.config import SearchConfig
from ..core.records import Individual
from ..core.rng import RunRng
from ..surrogate.gp import GPConfig
from ..surrogate.manager import SurrogateManager
from ..utils.checkpoint import _restore_individual, load_checkpoint, save_checkpoint
from ..utils.reporting import RunReporter, StageTimer
from . import ea
from .local_search import perform_local_search
from .nsga2 import evaluate_genomes, initialize


def select_infill_points(
    predicted: Sequence[Individual], num_to_select: int, epsilon: float = 1e-6
) -> Tuple[List[int], List]:
    """Rank predicted offspring for true evaluation
    (sa_nsga_penalty.py:472-518). Returns (indices, genomes)."""
    feasible: List[Tuple[int, Individual]] = []
    infeasible: List[Tuple[int, Individual]] = []
    for i, res in enumerate(predicted):
        (feasible if res["CV"] < epsilon else infeasible).append((i, res))

    if feasible:
        objs = np.array([res["objs"] for _, res in feasible], np.float64)
        lo = objs.min(axis=0)
        hi = objs.max(axis=0)
        rng_ = hi - lo
        rng_[rng_ < epsilon] = 1.0
        scores = ((objs - lo) / rng_).sum(axis=1)
        feasible_sorted = [
            idx
            for idx, _ in sorted(
                zip([f[0] for f in feasible], scores), key=lambda p: p[1]
            )
        ]
    else:
        feasible_sorted = []

    infeasible_sorted = [
        idx for idx, _ in sorted(infeasible, key=lambda item: item[1]["CV"])
    ]

    selected = (feasible_sorted + infeasible_sorted)[:num_to_select]
    return selected, [predicted[i]["hparams"] for i in selected]


def _use_analytic_size(predicted: List[Individual], evaluator, cfg) -> None:
    """Replace GP-predicted sizes with the exact analytic size.

    The reference fits a GP even for model size (sa_nsga_penalty.py:283 —
    its surrogate code is target-generic), so its predicted records can
    carry impossible sizes (negative MB) into infill ranking and even the
    exported final front. Size is a deterministic function of the genome
    (models/genome_arch.py), so we substitute the true value — a documented
    deviation that can only reduce surrogate noise (PARITY.md). CV is
    recomputed against the corrected size."""
    from ..models.genome_arch import model_size_mb

    num_classes = getattr(evaluator, "num_classes", None) or getattr(
        getattr(evaluator, "cfg", None), "num_classes", 10
    )
    template = getattr(evaluator, "template", None) or getattr(
        getattr(evaluator, "cfg", None), "template", "A"
    )
    max_size = cfg.constraints.max_model_size_mb
    for rec in predicted:
        true_size = model_size_mb(rec["hparams"], num_classes, template)
        rec["objs"][1] = true_size
        rec["metrics"]["size"] = true_size
        # the cv-GP's prediction keeps covering acc/fpr, but a known size
        # violation must never be masked by an optimistic predicted CV
        if max_size is not None:
            rec["CV"] = max(rec["CV"], max(0.0, true_size - max_size))


def run_sa_nsga2(
    cfg: SearchConfig,
    evaluator,
    reporter: Optional[RunReporter] = None,
    checkpoint_path: Optional[str] = None,
    gp_config: Optional[GPConfig] = None,
    device="cuda",
) -> Tuple[List[Individual], List]:
    if cfg.infill_percent is None:
        raise ValueError("SA-NSGA-II requires cfg.infill_percent")
    rng = RunRng(cfg.seed)
    surrogate = SurrogateManager(gp_config, seed=cfg.seed, device=device)
    start_gen = 0

    ckpt = load_checkpoint(checkpoint_path) if checkpoint_path else None
    if ckpt is not None and ckpt.get("algorithm") == "sa_nsga2":
        pop_data = [_restore_individual(r) for r in ckpt["population"]]
        rng.load_state_dict(ckpt["rng"])
        surrogate.load_state_dict(ckpt["surrogate"])
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
        with StageTimer(reporter, "surrogate_init"):
            surrogate.update([d["hparams"] for d in pop_data], pop_data)

    num_infill = max(1, int(cfg.pop_size * cfg.infill_percent))

    for gen in range(start_gen, cfg.max_gen):
        lam = cfg.penalty.lam(gen, cfg.max_gen)
        with StageTimer(reporter, "generation", gen=gen):
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

            if cfg.local_search:
                with StageTimer(reporter, "local_search", gen=gen):
                    offspring = perform_local_search(
                        offspring,
                        surrogate,
                        rng.host,
                        k_lcb=cfg.lcb_k,
                        rounds=cfg.local_search_rounds,
                    )

            with StageTimer(reporter, "surrogate_predict", gen=gen):
                off_predicted = surrogate.predict_and_structure(offspring)
                _use_analytic_size(off_predicted, evaluator, cfg)
                # surrogate predicts (acc,size,fpr); restrict to the active
                # objective subset for bi-objective variants
                if cfg.objectives != ("acc", "size", "fpr"):
                    idx_map = {"acc": 0, "size": 1, "fpr": 2}
                    for rec in off_predicted:
                        rec["objs"] = [
                            rec["objs"][idx_map[o]] for o in cfg.objectives
                        ]
                        rec["objective_names"] = tuple(cfg.objectives)

            infill_idx, infill_genomes = select_infill_points(
                off_predicted, num_infill, cfg.epsilon
            )
            with StageTimer(reporter, "infill_eval", gen=gen, n=len(infill_genomes)):
                infill_true = evaluate_genomes(
                    evaluator, infill_genomes, cfg, seed=cfg.seed + gen + 1
                )
            with StageTimer(reporter, "surrogate_update", gen=gen):
                surrogate.update(infill_genomes, infill_true)

            # true results overwrite predictions (sa_nsga_penalty.py:576-583)
            off_data = list(off_predicted)
            for i, true_res in enumerate(infill_true):
                off_data[infill_idx[i]] = true_res

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
                    "algorithm": "sa_nsga2",
                    "generation": gen,
                    "population": pop_data,
                    "rng": rng.state_dict(),
                    "surrogate": surrogate.state_dict(),
                },
            )

    pareto = ea.extract_final_pareto(pop_data, cfg.penalty.final_sort_lambda)
    if reporter:
        # surrogate-predicted individuals can survive into the final front
        # (the reference exports them too); surface the count so consumers
        # know which rows carry predicted rather than measured acc/fpr
        n_pred = sum(1 for rec in pareto if rec.get("predicted"))
        reporter.log("final_front", n=len(pareto), predicted=n_pred)
        reporter.final_pareto(pareto)
        reporter.all_generations()
    return pareto, (reporter.gen_rows if reporter else [])
