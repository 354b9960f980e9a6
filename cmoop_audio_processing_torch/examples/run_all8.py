"""Distributional quality-parity harness: all 8 published method variants.

The port's copy of examples/run_all8.py. The reference paper's quality
claim (BASELINE.md / compare.ipynb cell-1 outputs) is an ORDERING of 8
method variants by HV/IGD on one dataset — the 2-stage (PSI) variants
dominate plain SA-NSGA-II. This harness reproduces the comparison
distributionally: seeded runs of every method preset with REAL candidate
training on ONE shared synthetic KWS dataset (DataConfig defaults, data
seed 1234), then the compare pipeline (cli/compare.py = compare.ipynb
semantics) over the 8 fronts.

    python -m cmoop_audio_processing_torch.examples.run_all8
        [--out /tmp/all8] [--pop 10] [--gen 8] [--epochs 30] [--seed 7]
        [--fake-eval] [--device cuda|cpu] [--plots DIR]
        [--compaction-chunk N] [--resume] [--export DIR]
        [--compare-to DIR] [--table-eval [DIR]]

Produces <out>/compare_report_all8.json and exits 0 when the paper's
ordering (every 2-stage variant >= plain SA-NSGA-II on HV and <= on IGD)
holds, else 1.

Method -> preset map (BASELINE.md names on the left):

    SA_NSGA-II            sa_nsga_penalty's algorithm constants (infill 0.2,
                          template B; sa_nsga_penalty.py:114-124) re-hosted on
                          the shared KWS dataset/constraints so all 8 fronts
                          are comparable (the preset itself is BirdCLEF)
    SA_NSGA-II_LS         sa_nsga_local
    INIT_SA_NSGA-II       sa_nsga_init        (LHS init)
    INIT_SA_NSGA-II_LS    init_sa_nsga_local  (memetic)
    2_stage_SA_NSGA-II    psi_init_sa_nsga    (PSI seed from stage 1)
    2_stage_SA-NSGA-II_LS psi_sa_nsga_local
    MOBO                  mobo_penalty
    2_stage_MOBO          psi_mobo_2

Stage 1 (the PSI seed) is the three bi-objective presets
(acc_size/acc_fpr/size_fpr_nsga_1) merged via cli/psi_merge — the merge the
reference performed by hand (SURVEY.md §3.4).

Common random numbers: one fixed eval_seed per replica is shared by all
methods, and a shared per-(replica, evaluation-semantics) fitness cache
replays any genome's first materialized draw everywhere it re-appears —
within a replica, a genome's fitness is one number for every method that
measures fitness the same way (the mobo/stage-1/template-B preset groups
each share one file; see run_one).

Everything runs in one process, on ``--device`` (default cuda; raises
without a GPU unless given cpu): the trainings and the GP fits. Plots need
matplotlib and are drawn only when ``--plots DIR`` is given.

Beyond the JAX script's options:

* ``--compaction-chunk N`` is handed to every search's evaluator, as
  ``cli/main.py --compaction-chunk`` does (0: fused launches of up to
  ``max_models_per_program`` lanes, no heavy-lane split); the default is
  each preset's own plan;
* after each search has written its front, an entry for it is appended to
  the run record ``<out>/all8_run.json`` (``search_record``: wall seconds,
  trainings and cache hits, launches, mean epochs ran, GP-refit seconds,
  the launch plan and the card). ``--resume`` keeps the fitness caches
  instead of deleting them: a search with an entry is not run again (its
  front is read from disk), any other runs from its start with the shared
  cache open, so each training it already finished is replayed (the cache
  is made durable per launch). A resume under other settings than the
  record's is refused, and so is a cache written under another plan;
* ``--export DIR`` trains nothing: it copies ``--out``'s fronts, under
  examples/all8/'s names (``front_<preset>.csv``), with ``Final.csv``, the
  report, the caches and the run record into DIR;
* ``--compare-to DIR`` trains nothing: it holds ``--out``'s artifacts
  against the JAX package's replica reports in DIR and both packages'
  exhaustive truths, and writes ``<out>/meta.json`` (``compare_to_jax``);
* ``--table-eval [DIR]`` (DIR default examples/exhaustive) trains nothing
  either: every search reads its fitnesses from the sweep table of its
  template in DIR (``run_exhaustive.TableEvaluator``: A for stage 1 and
  MOBO, B for the SA family), so the searches, their GP fits on
  ``--device`` included, are the only thing that differs between two
  runs. It excludes ``--fake-eval`` and writes no fitness cache.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import hashlib
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from ..cli import compare as compare_cli
from ..cli import psi_merge
from ..cli.main import make_evaluator, run
from ..core.config import Constraints, DataConfig, get_preset
from .run_exhaustive import ALL8 as JAX_ALL8
from .run_exhaustive import REPO, TableEvaluator, device_record

JAX_TRUTH = os.path.join(REPO, "examples", "exhaustive")
PORT_TRUTH = os.path.join(REPO, "cmoop_audio_processing_torch", "examples",
                          "artifacts", "exhaustive_h100")

STAGE1 = ["acc_size_nsga_1", "acc_fpr_nsga_1", "size_fpr_nsga_1"]
RUN_RECORD = "all8_run.json"
# the settings a resume must share with the run record it continues
RESUME_KEYS = ("pop", "gen", "epochs", "seed", "fake_eval", "device",
               "compaction_chunk", "table_eval")
# the search stages whose seconds are GP (re)fits (progress.jsonl)
GP_STAGES = ("surrogate_init", "surrogate_update", "gp_fit")

# method display name (compare.ipynb labels) -> (preset, needs_psi_seed)
METHODS = [
    ("SA_NSGA-II", "sa_nsga_penalty", False),
    ("SA_NSGA-II_LS", "sa_nsga_local", False),
    ("INIT_SA_NSGA-II", "sa_nsga_init", False),
    ("INIT_SA_NSGA-II_LS", "init_sa_nsga_local", False),
    ("2_stage_SA_NSGA-II", "psi_init_sa_nsga", True),
    ("2_stage_SA-NSGA-II_LS", "psi_sa_nsga_local", True),
    ("MOBO", "mobo_penalty", False),
    ("2_stage_MOBO", "psi_mobo_2", True),
]


def build_cfg(preset: str, args, seed_file: str | None = None):
    cfg = get_preset(preset)
    if preset == "sa_nsga_penalty":
        # Re-host the plain SA-NSGA-II algorithm on the shared KWS dataset so
        # its front is comparable with the other 7 (see module docstring).
        cfg = cfg.replace(
            data=DataConfig(num_classes=10),
            train=dataclasses.replace(cfg.train, num_classes=10),
            search=dataclasses.replace(
                cfg.search, constraints=Constraints(0.90, 2.5, 0.09)
            ),
        )
    train = dataclasses.replace(cfg.train, epochs=args.epochs)
    if args.compaction_chunk is not None:
        train = dataclasses.replace(train,
                                    compaction_chunk=args.compaction_chunk)
    # Common random numbers: one fixed eval seed per replica shared by all
    # 8 methods (and all generations), so any genome gets the IDENTICAL
    # fitness draw wherever it appears — the methods are compared on
    # search behavior, not on evaluation-noise luck.
    search = dataclasses.replace(
        cfg.search, seed=args.seed, pop_size=args.pop, max_gen=args.gen,
        eval_seed=args.seed,
        psi_seed_file=seed_file if cfg.algorithm != "mobo" else None,
    )
    mobo = cfg.mobo
    if mobo is not None:
        mobo = dataclasses.replace(
            mobo, seed=args.seed, initial_samples=args.pop,
            max_iterations=args.gen * 3,  # ~match SA's per-gen infill budget
            eval_seed=args.seed,
            psi_seed_file=seed_file,
        )
    return cfg.replace(
        data=dataclasses.replace(cfg.data, source="synthetic"),
        train=train, search=search, mobo=mobo, output_dir=args.out,
    )


def cache_path(cfg, args) -> Optional[str]:
    """The replica's shared fitness cache for ``cfg``'s evaluation
    semantics, None for the closed-form evaluator.

    One shared fitness cache per (replica, evaluation semantics): every
    method whose TrainConfig produces identical fitnesses appends to the
    same file, so a genome re-appearing in ANY of those methods replays
    the identical draw. With eval_seed fixed (CRN) this makes the
    cross-method comparison EXACT per genome, and neutralizes the drift
    between launch plans (another lane count runs other kernels on the
    card, utils/fitness_cache.py), since the first materialized value
    wins everywhere. The filename tag hashes every config field of the
    JAX package's cache fingerprint so methods with different evaluation
    semantics (template A/B; the mobo presets' restore_best vs the
    stage-1 presets' last-epoch accuracy) get separate files instead of
    a fingerprint-mismatch crash; the dataset hash — the one field not
    in the tag — is shared by construction (one dataset per replica).
    The launch plan is not in the tag either: every search of a replica
    runs under one plan, and the cache's own fingerprint refuses another.
    None under ``--table-eval`` too: a table needs no cache."""
    if args.fake_eval or getattr(args, "table_eval", None):
        return None
    fp = {
        f: getattr(cfg.train, f)
        for f in ("epochs", "batch_size", "patience", "learning_rate",
                  "num_classes", "restore_best_weights", "accuracy_from",
                  "template", "dropout_rate", "compute_dtype")
    }
    tag = hashlib.sha1(
        json.dumps(fp, sort_keys=True, default=str).encode()
    ).hexdigest()[:8]
    return os.path.join(args.out, f"fitness_cache_{tag}.jsonl")


def front_path(cfg, out: str) -> str:
    return os.path.join(
        out, cfg.name,
        "mobo_pareto.csv" if cfg.algorithm == "mobo" else "final_pareto.csv",
    )


def search_record(method: str, cfg, evaluator, wall: float,
                  stages: List[Dict], cache: Optional[str],
                  device=None) -> Dict:
    """One search's entry in the run record: its wall seconds, the
    trainings it ran and the cache hits it replayed, its launches (one-lane
    ones apart) and their lanes, the mean epochs its trainings ran, the
    seconds of its GP fits (``stages``: its progress.jsonl's stage events),
    the launch plan, and on CUDA the card and its power limit: the
    evaluator's device, else ``device`` (where the GP fits ran)."""
    timings = evaluator.timings
    chunks = [c for t in timings for c in t.get("chunks", [])]
    ran = list(getattr(evaluator, "_epoch_history", {}).values())
    evaluate_s = sum(t.get("seconds", 0.0) for t in timings)
    trainings = getattr(evaluator, "_eval_count",
                        getattr(evaluator, "total_true_evals", 0))
    gp = [s["seconds"] for s in stages if s.get("stage") in GP_STAGES]
    train = cfg.train
    rec = {
        "method": method, "preset": cfg.name, "wall_s": wall,
        "evaluations": len(timings),
        "trainings": int(trainings),
        "cache_hits": int(sum(t.get("cache_hits", 0) for t in timings)),
        "evaluate_s": evaluate_s,
        "trainings_per_h": (trainings * 3600.0 / evaluate_s
                            if evaluate_s and trainings else 0.0),
        "launches": len(chunks),
        "one_lane_launches": sum(c["pop"] == 1 for c in chunks),
        "lanes": [c["pop"] for c in chunks],
        "mean_epochs_ran": float(np.mean(ran)) if ran else None,
        "gp_refits": len(gp),
        "gp_refit_s": float(sum(gp)) if gp else None,
        "plan": {
            "compaction_chunk": int(train.compaction_chunk),
            "launch_seconds_budget": float(train.launch_seconds_budget),
            "max_models_per_program": int(train.max_models_per_program),
            "parallel_impl": str(train.parallel_impl),
            "compute_dtype": str(train.compute_dtype),
        },
        "fitness_cache": os.path.basename(cache) if cache else None,
        **device_record(getattr(evaluator, "device", None) or device),
    }
    return rec


def _read_stages(path: str, offset: int) -> List[Dict]:
    """The stage events appended to ``path`` from byte ``offset`` on."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        f.seek(offset)
        events = [json.loads(line) for line in f.read().splitlines() if line]
    return [e for e in events if e.get("event") == "stage"]


def run_one(cfg, args, method: Optional[str] = None):
    """Run one search; returns its front's path and its run record entry."""
    t0 = time.perf_counter()
    cache = cache_path(cfg, args)
    progress = os.path.join(args.out, cfg.name, "progress.jsonl")
    offset = os.path.getsize(progress) if os.path.exists(progress) else 0
    if args.table_eval:
        evaluator = TableEvaluator(args.table_eval, cfg.train.template,
                                   cfg.train.num_classes)
    else:
        evaluator = make_evaluator(cfg, args.fake_eval, args.device,
                                   fitness_cache_path=cache)
    pareto, _ = run(cfg, evaluator, device=args.device)
    wall = time.perf_counter() - t0
    print(f"[all8] {cfg.name}: {len(pareto)} front rows, {wall:.1f}s",
          file=sys.stderr)
    return front_path(cfg, args.out), search_record(
        method or cfg.name, cfg, evaluator, wall,
        _read_stages(progress, offset), cache, args.device)


def _settings(args) -> Dict:
    """The run's RESUME_KEYS; a ``--table-eval`` directory relative to the
    repo, so that a record does not depend on where the checkout lies."""
    settings = {k: getattr(args, k) for k in RESUME_KEYS}
    if settings["table_eval"]:
        settings["table_eval"] = os.path.relpath(
            os.path.abspath(settings["table_eval"]), REPO)
    return settings


def load_record(args) -> Dict:
    """The run record to continue: a fresh one without ``--resume`` (the
    stale caches are deleted then), else the one on disk, refused if its
    settings differ from ``args``'."""
    path = os.path.join(args.out, RUN_RECORD)
    fresh = {"settings": _settings(args), "searches": []}
    if not args.resume:
        # a fresh harness run starts over (CLI semantics): stale caches from
        # a previous run in the same --out must not replay into this replica
        for stale in glob.glob(os.path.join(args.out,
                                            "fitness_cache_*.jsonl")):
            os.unlink(stale)
        if os.path.exists(path):
            os.unlink(path)
        return fresh
    if not os.path.exists(path):
        return fresh
    with open(path) as f:
        record = json.load(f)
    if record["settings"] != fresh["settings"]:
        raise SystemExit(
            f"[all8] --resume refused: {path} was written under "
            f"{record['settings']}, this run asks for {fresh['settings']}")
    return record


def save_record(record: Dict, out: str) -> None:
    """Write the run record whole, then move it into place."""
    path = os.path.join(out, RUN_RECORD)
    with open(path + ".tmp", "w") as f:
        json.dump(record, f, indent=2)
    os.replace(path + ".tmp", path)


def run_or_skip(method: str, cfg, args, record: Dict) -> str:
    """The search's front: read from disk when the run record has its
    entry and the front is there, else run it and append its entry."""
    front = front_path(cfg, args.out)
    done = {e["preset"] for e in record["searches"]}
    if cfg.name in done and os.path.exists(front):
        print(f"[all8] {cfg.name}: in the run record, not run again",
              file=sys.stderr)
        return front
    front, entry = run_one(cfg, args, method)
    record["searches"] = [e for e in record["searches"]
                          if e["preset"] != cfg.name] + [entry]
    save_record(record, args.out)
    return front


def verdict(rep: Optional[Dict]) -> tuple:
    """The harness's ordering verdict on a compare report (None: none was
    written): ``(holds, missing two-stage methods, exit code)``."""
    two_stage = ("2_stage_SA_NSGA-II", "2_stage_SA-NSGA-II_LS", "2_stage_MOBO")
    if rep is None or "SA_NSGA-II" not in rep.get("hypervolume", {}):
        return False, list(two_stage), 1
    sa_hv = rep["hypervolume"]["SA_NSGA-II"]
    sa_igd = rep["igd"]["SA_NSGA-II"]
    present = [m for m in two_stage if m in rep["hypervolume"]]
    missing = [m for m in two_stage if m not in rep["hypervolume"]]
    ok = bool(present) and all(
        rep["hypervolume"][m] >= sa_hv and rep["igd"][m] <= sa_igd
        for m in present
    )
    return ok, missing, 0 if ok and not missing else 1


# -- holding a replica against the JAX package's -------------------------------

TWO_STAGE_SA = ("2_stage_SA_NSGA-II", "2_stage_SA-NSGA-II_LS")
# bounds on |d accuracy| (median, p90) between the port's exhaustive truth
# and the JAX package's, from the seed-7-against-seed-11 pairs of
# exhaustive_h100/: template B's, and template A's own
TRUTH_BOUNDS = {"B": {"median": 0.0050, "p90": 0.0329},
                "A": {"median": 0.0110, "p90": 0.0929}}
# the family -> the preset whose TrainConfig its exhaustive table used
# (run_exhaustive.FAMILIES), and the stage-1 presets' semantics
CACHE_PRESETS = {"B": "sa_nsga_local", "A": "mobo_penalty",
                 "stage1": STAGE1[0]}


def ordering_properties(rep: Dict) -> Dict[str, bool]:
    """The JAX package's per-seed properties (tests/test_examples_artifacts
    .py): each 2-stage SA-family variant >= SA_NSGA-II on HV and <= on IGD,
    and 2_stage_MOBO <= SA_NSGA-II on IGD. A method without a front fails
    its property."""
    hv, igd = rep.get("hypervolume", {}), rep.get("igd", {})
    base = "SA_NSGA-II"

    def cmp(metric, m, ge):
        if m not in metric or base not in metric:
            return False
        return bool(metric[m] >= metric[base] if ge else
                    metric[m] <= metric[base])

    props = {}
    for m in TWO_STAGE_SA:
        props[f"{m} HV >= {base}"] = cmp(hv, m, True)
        props[f"{m} IGD <= {base}"] = cmp(igd, m, False)
    props[f"2_stage_MOBO IGD <= {base}"] = cmp(igd, "2_stage_MOBO", False)
    return props


def ratios(rep: Dict) -> Dict[str, Dict[str, float]]:
    """Each method's HV and IGD over SA_NSGA-II's in one report: raw values
    are not comparable across reports (each has its own reference point)."""
    out = {}
    for metric in ("hypervolume", "igd"):
        vals = rep.get(metric, {})
        base = vals.get("SA_NSGA-II")
        for m, v in vals.items():
            if base:
                out.setdefault(m, {})[metric] = v / base
    return out


def hold_against_replicas(rep: Optional[Dict], jax_reports: Dict[str, Dict]
                          ) -> Dict:
    """(a) each method's HV and IGD ratio to SA_NSGA-II in ``rep`` beside
    the min, mean and max of the same ratio over ``jax_reports``, flagged
    where it falls outside; (b) ``ordering_properties`` on ``rep``, beside
    how many of the JAX reports hold each, and the harness's verdict and
    exit code on ``rep``."""
    rep = rep or {}
    got = ratios(rep)
    jax = [ratios(r) for r in jax_reports.values()]
    table, flags = {}, []
    for m in sorted(set(got) | {m for r in jax for m in r}):
        for metric in ("hypervolume", "igd"):
            vals = [r[m][metric] for r in jax if metric in r.get(m, {})]
            card = got.get(m, {}).get(metric)
            row = {"card": card,
                   "jax_min": min(vals) if vals else None,
                   "jax_mean": float(np.mean(vals)) if vals else None,
                   "jax_max": max(vals) if vals else None}
            row["outside_jax_range"] = bool(
                card is None or not vals or not min(vals) <= card <= max(vals))
            table.setdefault(m, {})[metric] = row
            if row["outside_jax_range"]:
                flags.append(f"{m} {metric}")
    props = ordering_properties(rep)
    jax_props = [ordering_properties(r) for r in jax_reports.values()]
    ok, missing, rc = verdict(rep if rep else None)
    return {
        "jax_reports": sorted(jax_reports),
        "ratios_to_SA_NSGA-II": table,
        "ratio_flags": flags,
        "ordering": {
            "properties": props,
            "all_hold": all(props.values()),
            "jax_held": {k: f"{sum(p[k] for p in jax_props)} of "
                            f"{len(jax_props)}" for k in props},
            "verdict": "HOLDS" if rc == 0 else "VIOLATED/INCOMPLETE",
            "missing": missing,
            "exit_code": rc,
        },
    }


def _read_json(path: str) -> Optional[Dict]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _read_cache(path: str):
    """A fitness cache's header fingerprint and its (genome, seed) lines."""
    with open(path) as f:
        lines = f.read().split("\n")
    header = json.loads(lines[0])["fingerprint"]
    recs = []
    for line in lines[1:]:
        try:
            recs.append(json.loads(line))
        except json.JSONDecodeError:
            continue  # blank, or a torn tail
    return header, recs


def truth_table(truth_dir: str, template: str, seed=None) -> str:
    """A truth directory's table of ``template`` at the eval seed ``seed``:
    ``exhaustive_<T>_288_seed<s>.csv`` where the directory holds one (the
    port's other seeds in exhaustive_h100/), else its main table."""
    at_seed = os.path.join(truth_dir, f"exhaustive_{template}_288_seed{seed}"
                                      ".csv")
    if seed is not None and os.path.exists(at_seed):
        return at_seed
    return os.path.join(truth_dir, f"exhaustive_{template}_288.csv")


def hold_caches_against_truth(out: str, truth_dir: str, settings: Dict
                              ) -> Dict:
    """(d) the replica's fitnesses against the exhaustive tables of the same
    data, eval seed and training semantics: template B's SA-family cache
    against exhaustive_B_288.csv, template A's MOBO cache against
    exhaustive_A_288.csv; ``Size_MB`` string for string, |d accuracy| and
    |d FPR| (median, p90, max) and the share within 0.01, beside
    ``TRUTH_BOUNDS``. The stage-1 cache has no table: its genomes are counted. Skipped
    when the caches' dataset differs from the sweep's."""
    from ..core.genome import GENE_ORDER
    from ..data.pipeline import prepare_dataset
    from ..utils.fitness_cache import dataset_fingerprint
    from .run_exhaustive import (genome_key_of_row, share_close, spread,
                                 text_table)

    args = argparse.Namespace(**settings, out=out)
    caches = {k: cache_path(build_cfg(p, args), args)
              for k, p in CACHE_PRESETS.items()}
    read = {k: _read_cache(c) for k, c in caches.items()
            if c and os.path.exists(c)}
    sweep_data = dataset_fingerprint(prepare_dataset(DataConfig(
        num_classes=10)))
    seen = sorted({h["dataset"] for h, _ in read.values()})
    res = {"dataset_fingerprint": {"replica": seen, "sweep": sweep_data,
                                   "equal": seen == [sweep_data]},
           "caches": {k: os.path.basename(c) for k, c in caches.items()
                      if k in read},
           "bounds_abs_d_accuracy": TRUTH_BOUNDS}
    if "stage1" in read:
        res["stage1_genomes"] = len(read.pop("stage1")[1])
    if not res["dataset_fingerprint"]["equal"]:
        res["skipped"] = "the replica's dataset is not the sweep's"
        return res
    for t in ("B", "A"):
        if t not in read:
            continue
        table = text_table(truth_table(truth_dir, t, settings["seed"]))
        recs = [r for r in read[t][1] if r["seed"] == settings["seed"]]
        rows = [(r, table[genome_key_of_row(dict(zip(GENE_ORDER, r["g"])))])
                for r in recs]
        d_acc = np.array([abs(r["acc"] - float(w["Accuracy"]))
                          for r, w in rows])
        d_fpr = np.array([abs(r["fpr"] - float(w["FPR"])) for r, w in rows])
        res[t] = {
            "genomes": len(rows),
            "size_equal": sum(repr(float(r["size"])) == w["Size_MB"]
                              for r, w in rows),
            "abs_d_accuracy": spread(d_acc) if rows else None,
            "abs_d_fpr": spread(d_fpr) if rows else None,
            "share_within_0.01_accuracy": share_close(d_acc) if rows else None,
            "share_within_0.01_fpr": share_close(d_fpr) if rows else None,
        }
        if rows:
            res[t]["within_bound"] = {
                q: bool(res[t]["abs_d_accuracy"][q] <= b)
                for q, b in TRUTH_BOUNDS[t].items()}
    return res


def compare_to_jax(out: str, jax_dir: str, truth_dir: str = PORT_TRUTH,
                   jax_truth_dir: str = JAX_TRUTH,
                   jax_all8_dir: str = JAX_ALL8) -> Dict:
    """A replica's artifacts in ``out`` (the harness's fronts under the
    names of examples/all8/, its report, caches and run record) held
    against the JAX package. Trains nothing.

    (a) and (b): ``hold_against_replicas`` against the reports
    compare_report_all8*.json in ``jax_dir``; (c) the fronts scored against
    the port's exhaustive truth in ``truth_dir`` (its tables at the
    replica's seed where it holds them, ``truth_table``) by
    ``run_exhaustive.report_on``, beside the JAX package's fronts in
    ``jax_all8_dir`` scored against its truth in ``jax_truth_dir``, each
    with whether 2_stage_MOBO's GD and IGD stay below MOBO's; (d)
    ``hold_caches_against_truth``. ``misses`` lists each (a) flag, each
    (b) property that fails, and each (d) size or bound that misses."""
    from .run_exhaustive import _mobo_ordering_holds, read_table, report_on

    record = _read_json(os.path.join(out, RUN_RECORD)) or {}
    settings = record.get("settings", {})
    jax_reports = {}
    for p in sorted(glob.glob(os.path.join(jax_dir,
                                           "compare_report_all8*.json"))):
        jax_reports[os.path.basename(p)] = _read_json(p)
    meta = {"settings": settings}
    meta.update(hold_against_replicas(
        _read_json(os.path.join(out, "compare_report_all8.json")),
        jax_reports))

    def scored(truth, fronts, seed=None):
        rep = report_on({t: read_table(truth_table(truth, t, seed))
                         for t in ("B", "A")},
                        fronts, settings.get("epochs"), settings.get("seed"))
        holds = (_mobo_ordering_holds(rep)
                 if {"MOBO", "2_stage_MOBO"} <= set(rep["methods"]) else None)
        return {"report": rep, "mobo_ordering_holds": holds}

    meta["truth"] = {"card": scored(truth_dir, out, settings.get("seed")),
                     "jax": scored(jax_truth_dir, jax_all8_dir),
                     "dirs": {k: os.path.relpath(d, REPO) for k, d in (
                         ("card_truth", truth_dir), ("jax_truth",
                                                     jax_truth_dir),
                         ("jax_all8", jax_all8_dir))}}
    meta["fitness_vs_exhaustive"] = (
        hold_caches_against_truth(out, truth_dir, settings)
        if settings else {"skipped": f"no {RUN_RECORD}"})
    fit = meta["fitness_vs_exhaustive"]
    misses = [f"(a) {f}" for f in meta["ratio_flags"]]
    misses += [f"(b) {k}" for k, v in meta["ordering"]["properties"].items()
               if not v]
    for t in ("B", "A"):
        if t in fit:
            if fit[t]["size_equal"] != fit[t]["genomes"]:
                misses.append(f"(d) {t} Size_MB")
            misses += [f"(d) {t} |d accuracy| {q}"
                       for q, ok in fit[t].get("within_bound", {}).items()
                       if not ok]
    if "skipped" in fit:
        misses.append(f"(d) skipped: {fit['skipped']}")
    meta["misses"] = misses
    return meta


def export(out: str, dest: str) -> List[str]:
    """Copy a harness run's artifacts from ``out`` into ``dest`` under the
    file names of examples/all8/: each search's front as
    ``front_<preset>.csv``, ``Final.csv``, the report, the fitness caches
    and the run record. Returns the names copied."""
    import shutil

    os.makedirs(dest, exist_ok=True)
    names = {os.path.relpath(front_path(get_preset(p), out), out):
             f"front_{p}.csv"
             for p in STAGE1 + [p for _, p, _ in METHODS]}
    for name in ["Final.csv", "compare_report_all8.json", RUN_RECORD] + [
            os.path.basename(c) for c in sorted(glob.glob(os.path.join(
                out, "fitness_cache_*.jsonl")))]:
        names[name] = name
    copied = []
    for src, dst in names.items():
        if os.path.exists(os.path.join(out, src)):
            shutil.copyfile(os.path.join(out, src), os.path.join(dest, dst))
            copied.append(dst)
    return copied


def write_meta(out: str, jax_dir: str, truth_dir: str = PORT_TRUTH,
               jax_truth_dir: str = JAX_TRUTH,
               jax_all8_dir: str = JAX_ALL8) -> Dict:
    """``compare_to_jax`` written to ``out``/meta.json."""
    meta = compare_to_jax(out, jax_dir, truth_dir, jax_truth_dir,
                          jax_all8_dir)
    with open(os.path.join(out, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="/tmp/all8")
    p.add_argument("--pop", type=int, default=10)
    p.add_argument("--gen", type=int, default=8)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--fake-eval", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--plots", metavar="DIR",
                   help="draw the fronts here (needs matplotlib)")
    p.add_argument("--compaction-chunk", type=int,
                   help="every search's launch plan (0: fused launches); "
                        "default: each preset's own")
    p.add_argument("--resume", action="store_true",
                   help=f"keep the fitness caches and skip the searches "
                        f"--out/{RUN_RECORD} records as done")
    p.add_argument("--export", metavar="DIR",
                   help="copy --out's fronts (as front_<preset>.csv), "
                        "Final.csv, report, caches and run record into DIR "
                        "(no training)")
    p.add_argument("--compare-to", metavar="DIR",
                   help="compare only: hold --out's artifacts against the "
                        "JAX replica reports compare_report_all8*.json in "
                        "DIR and write --out/meta.json (no training)")
    p.add_argument("--table-eval", metavar="DIR", nargs="?", const=JAX_TRUTH,
                   help="read every fitness from DIR's exhaustive_<T>_288"
                        ".csv of the search's template instead of training "
                        "(default DIR: examples/exhaustive)")
    args = p.parse_args(argv)
    if args.table_eval and args.fake_eval:
        p.error("--table-eval excludes --fake-eval")
    if args.export:
        copied = export(args.out, args.export)
        print(f"[all8] {len(copied)} files -> {args.export}", file=sys.stderr)
        return 0
    if args.compare_to:
        meta = write_meta(args.out, args.compare_to)
        print(f"[all8] meta -> {os.path.join(args.out, 'meta.json')}",
              file=sys.stderr)
        print(json.dumps(meta["ordering"]))
        return 0
    from ..core.device import resolve_device

    resolve_device(args.device)  # raises for cuda without a GPU
    os.makedirs(args.out, exist_ok=True)
    record = load_record(args)

    # ---- stage 1: three bi-objective runs -> merged PSI seed -------------
    stage1_fronts = [run_or_skip(s, build_cfg(s, args), args, record)
                     for s in STAGE1]
    seed_file = os.path.join(args.out, "Final.csv")
    psi_merge.write_table(seed_file, psi_merge.merge(
        stage1_fronts, dedup=True, limit=args.pop, interleave=True))
    print(f"[all8] PSI seed merged -> {seed_file}", file=sys.stderr)

    # ---- stage 2: the 8 method variants ----------------------------------
    fronts = {}
    for name, preset, needs_seed in METHODS:
        cfg = build_cfg(preset, args, seed_file if needs_seed else None)
        fronts[name] = run_or_skip(name, cfg, args, record)

    # ---- compare (compare.ipynb pipeline) ---------------------------------
    report_path = os.path.join(args.out, "compare_report_all8.json")
    compare_argv = []
    for name, path in fronts.items():
        compare_argv += ["--front", f"{name}={path}"]
    compare_argv += ["--out", report_path]
    if args.plots:
        compare_argv += ["--plots", args.plots]
    compare_cli.main(compare_argv)

    # compare_cli skips empty fronts (and writes no report if ALL were
    # empty), so every lookup below must tolerate absent methods — reach
    # the INCOMPLETE verdict instead of a traceback.
    if not os.path.exists(report_path):
        print("[all8] no report written (every front was empty) — "
              "ordering check incomplete", file=sys.stderr)
        return 1
    with open(report_path) as f:
        rep = json.load(f)
    if "SA_NSGA-II" not in rep.get("hypervolume", {}):
        print("[all8] plain SA_NSGA-II front empty/missing — "
              "ordering check incomplete", file=sys.stderr)
        return 1
    print("[all8] HV:", {k: round(v, 7) for k, v in rep["hypervolume"].items()},
          file=sys.stderr)
    print("[all8] IGD:", {k: round(v, 6) for k, v in rep["igd"].items()},
          file=sys.stderr)
    ok, missing, rc = verdict(rep)
    if missing:
        print(f"[all8] WARNING: empty/missing fronts for {missing} — "
              f"ordering check incomplete", file=sys.stderr)
    print(f"[all8] paper ordering (2-stage >= plain SA on HV and IGD): "
          f"{'HOLDS' if rc == 0 else 'VIOLATED/INCOMPLETE'}",
          file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
