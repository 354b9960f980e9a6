"""Penalty-scalarized multi-objective Bayesian optimization (MOBO).

Reproduces run_mobo (mobo_penalty.py:343-487), optionally PSI-seeded
(psi_mobo_2.py:357-404):

    init: INITIAL_SAMPLES random genomes (or stage-1 Excel seeds),
          encode to [0,1]^6, true-evaluate
    per iteration:
      fit per-output GPs (Matern nu=2.5, normalize_y) on (X, objs) and CV
      500 random candidate vectors -> penalized acquisition
      argmax -> decode -> ONE true evaluation -> append
    final: O(n^2) feasible Pareto filter on raw objectives

A copy of cmoop_audio_processing_tpu/algorithms/mobo.py without pandas: an
iteration's archive table is a list of row dicts (the reporter's
``gen_rows``), written with the csv module and the stdlib xlsx writer. The
GP fits run on ``device`` (default cuda); candidate scoring is host
float64. Each true evaluation trains one genome, a population of one lane.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.config import MoboConfig
from ..core.genome import from_vector, random_genome, to_vector
from ..core.records import Individual, make_individual
from ..core.rng import RunRng
from ..surrogate.acquisition import penalized_acquisition, train_gps
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.reporting import RunReporter, StageTimer
from .ea import nondominated_mask
from .initializers import psi_init

FEAS_TOL = 1e-8  # mobo_penalty.py:471 feasibility tolerance


def _archive_rows(
    all_genomes, y_objs, y_cv, n: int, initial_samples: int
) -> List[Dict]:
    """First ``n`` archive rows as the reference's per-iteration table
    (mobo_penalty.py:408-425: row label = index for the initial design,
    ``init+k`` for acquisition picks)."""
    return [
        {
            "Iteration": j if j < initial_samples
            else f"init+{j - initial_samples + 1}",
            "Accuracy": float(-y_objs[j, 0]),
            "Size_MB": float(y_objs[j, 1]),
            "FPR": float(y_objs[j, 2]),
            "CV": float(y_cv[j, 0]),
            **all_genomes[j],
        }
        for j in range(n)
    ]


def _true_eval(evaluator, genome, cfg: MoboConfig, seed: int):
    if cfg.eval_seed is not None:  # common random numbers (SearchConfig doc)
        seed = cfg.eval_seed
    acc, size, fpr = evaluator.evaluate([genome], seed=seed)[0]
    cv = cfg.constraints.violation(acc, size, fpr)
    return np.array([-acc, size, fpr]), cv


def run_mobo(
    cfg: MoboConfig,
    evaluator,
    reporter: Optional[RunReporter] = None,
    checkpoint_path: Optional[str] = None,
    device="cuda",
) -> Tuple[List[Individual], List[List[Dict]]]:
    rng = RunRng(cfg.seed)
    gen_rows: List[List[Dict]] = []
    start_iter = 0

    ckpt = load_checkpoint(checkpoint_path) if checkpoint_path else None
    if ckpt is not None and ckpt.get("algorithm") == "mobo":
        x_vec = np.asarray(ckpt["x_vec"], np.float64)
        y_objs = np.asarray(ckpt["y_objs"], np.float64)
        y_cv = np.asarray(ckpt["y_cv"], np.float64)
        all_genomes = [
            {k: (bool(v) if k in ("use_bn", "use_dropout") else int(v)) for k, v in g.items()}
            for g in ckpt["genomes"]
        ]
        rng.load_state_dict(ckpt["rng"])
        start_iter = ckpt["iteration"] + 1
        # the PSI branch resizes initial_samples to the seed-file row count
        # at init; recover it from the restored archive (one acquisition row
        # was appended per completed iteration), then rebuild the completed
        # iterations' sheets so the final workbook keeps them
        cfg = dataclasses.replace(
            cfg, initial_samples=len(all_genomes) - start_iter
        )
        for past in range(start_iter):
            gen_rows.append(
                _archive_rows(
                    all_genomes, y_objs, y_cv,
                    cfg.initial_samples + past + 1, cfg.initial_samples,
                )
            )
        if reporter:
            reporter.gen_rows = list(gen_rows)
            reporter.log("resume", iteration=start_iter)
    else:
        # initial design: random samples or PSI stage-1 seeds (no retraining)
        with StageTimer(reporter, "init_eval"):
            if cfg.psi_seed_file:
                seeds = psi_init(cfg.psi_seed_file, cfg.constraints)
                if not seeds:
                    # missing/empty seed file: clean no-op, like the
                    # reference's `return [], [], 0.0` (psi_mobo_2.py:365-369)
                    if reporter:
                        reporter.log("empty_init", initializer="psi")
                    return [], []
                all_genomes = [s["hparams"] for s in seeds]
                x_vec = np.stack([to_vector(g) for g in all_genomes])
                y_objs = np.array([s["objs"] for s in seeds], np.float64)
                y_cv = np.array([[s["CV"]] for s in seeds], np.float64)
                # the seed file decides the initial design size
                # (psi_mobo_2.py:357-404 reads however many rows exist)
                cfg = dataclasses.replace(cfg, initial_samples=len(seeds))
            else:
                all_genomes = [
                    random_genome(rng.host) for _ in range(cfg.initial_samples)
                ]
                rows, cvs = [], []
                for i, g in enumerate(all_genomes):
                    objs, cv = _true_eval(evaluator, g, cfg, cfg.seed + i)
                    rows.append(objs)
                    cvs.append([cv])
                x_vec = np.stack([to_vector(g) for g in all_genomes])
                y_objs = np.array(rows, np.float64)
                y_cv = np.array(cvs, np.float64)

    for it in range(start_iter, cfg.max_iterations):
        lam = cfg.penalty.lam(it, cfg.max_iterations)
        with StageTimer(reporter, "iteration", it=it):
            with StageTimer(reporter, "gp_fit", it=it):
                gp_objs = train_gps(x_vec, y_objs, seed=cfg.seed + it,
                                    device=device)
                gp_cv = train_gps(x_vec, y_cv, seed=cfg.seed + 1000 + it,
                                  device=device)[0]

            candidates = rng.numpy.random((cfg.candidate_batch, 6))
            acq = penalized_acquisition(candidates, gp_objs, gp_cv, lam)
            x_next = candidates[int(np.argmax(acq))]
            g_next = from_vector(x_next)

            with StageTimer(reporter, "true_eval", it=it):
                objs_n, cv_n = _true_eval(
                    evaluator, g_next, cfg, cfg.seed + 100 + it
                )

            x_vec = np.vstack([x_vec, x_next[None]])
            y_objs = np.vstack([y_objs, objs_n[None]])
            y_cv = np.vstack([y_cv, [[cv_n]]])
            all_genomes.append(g_next)

        # per-iteration full-archive table (mobo_penalty.py:408-425)
        gen_rows.append(
            _archive_rows(
                all_genomes, y_objs, y_cv, x_vec.shape[0], cfg.initial_samples
            )
        )

        if reporter:
            reporter.gen_rows = gen_rows
            reporter.log("mobo_iteration", it=it, archive=len(all_genomes))
            if (it + 1) % cfg.periodic_save_every == 0 or it == cfg.max_iterations - 1:
                pareto_now = _pareto_individuals(all_genomes, y_objs, y_cv, cfg)
                # force=True: this driver's own every-N gate (above) is the
                # schedule of record; without it the reporter would re-gate on
                # ITS periodic_every and silently drop saves whenever the two
                # knobs disagree
                reporter.periodic_pareto(
                    it, pareto_now, include_cv=True, prefix="mobo", force=True,
                )
        if checkpoint_path:
            save_checkpoint(
                checkpoint_path,
                {
                    "algorithm": "mobo",
                    "iteration": it,
                    "x_vec": x_vec,
                    "y_objs": y_objs,
                    "y_cv": y_cv,
                    "genomes": all_genomes,
                    "rng": rng.state_dict(),
                },
            )

    pareto = _pareto_individuals(all_genomes, y_objs, y_cv, cfg)
    if reporter:
        reporter.final_pareto(pareto, include_cv=True, filename="mobo_pareto.csv")
        reporter.all_generations()
        if gen_rows:
            # the reference's single-sheet archive workbook
            # (mobo_penalty.py:495-498: all_data.to_excel('mobo_iterations
            # .xlsx')) — the final iteration's table IS the full archive
            from ..utils.xlsx import write_xlsx

            last = gen_rows[-1]
            write_xlsx(
                os.path.join(reporter.dir, "mobo_iterations.xlsx"),
                [("Sheet1", (list(last[0]), [list(r.values()) for r in last]))],
            )
    return pareto, gen_rows


def _pareto_individuals(genomes, y_objs, y_cv, cfg: MoboConfig) -> List[Individual]:
    """Feasible (CV <= 1e-8) nondominated archive entries as individual
    records (mobo_penalty.py:470-487)."""
    feas = [i for i in range(len(genomes)) if y_cv[i, 0] <= FEAS_TOL]
    if not feas:
        return []
    mask = nondominated_mask(y_objs[feas])
    out = []
    for sel, i in enumerate(feas):
        if mask[sel]:
            out.append(
                make_individual(
                    genomes[i],
                    -y_objs[i, 0],
                    y_objs[i, 1],
                    y_objs[i, 2],
                    cfg.constraints,
                )
            )
    return out
