"""Exhaustive ground truth: train the ENTIRE 288-genome search space.

The port's copy of examples/run_exhaustive.py. The reference's search
space is fully enumerable (SURVEY.md §4 item 4), so training every genome
gives the EXACT Pareto front of the space under the real trained
objectives, and every method's search quality can be scored against
absolute truth instead of the union-of-method-fronts approximation
(compare.ipynb's `true_front`).

Two sweeps cover the all-8 harness's method families exactly (same shared
dataset, same per-family TrainConfig, same evaluator seed):

* template B / accuracy_from=best  — the six (SA-)NSGA-II variants
* template A / accuracy_from=last_epoch — the two MOBO variants

    python -m cmoop_audio_processing_torch.examples.run_exhaustive
        [--out /tmp/exhaustive] [--epochs 30] [--seed 7] [--device cuda|cpu]
        [--fitness-cache DIR] [--template A|B] [--compaction-chunk N]
        [--compare-to DIR [--yardstick CSV ...] [--beside CSV ...]]

Outputs: exhaustive_{A,B}_288.csv (all genomes + objectives + CV +
true-front membership) and exhaustive_report.json (exact GD/IGD/coverage
of each committed all-8 method front vs the combined exhaustive truth,
plus how many true-Pareto genomes each method actually found), written
without pandas, byte for byte as the JAX script's pandas writes them. A
trained sweep also writes exhaustive_{T}_run.json: its seconds, launches
(one-lane ones apart), stop epochs and trainings per hour on the device
it ran on.

Beyond the JAX script's options:

* ``--device`` (default cuda; raises without a GPU unless given cpu);
* ``--fitness-cache DIR`` hands each template's sweep the evaluator's
  durable cache, ``DIR/fitness_cache_<T>.jsonl``, so a cut sweep resumes
  where it stopped;
* ``--template T`` sweeps one template and reads the other's table from
  ``--out``; the report is written once both tables are there;
* ``--compaction-chunk N`` overrides the presets' launch policy (0: fused
  launches of up to ``max_models_per_program`` lanes, no split);
* ``--compare-to DIR`` trains nothing and writes no report: it holds the
  tables in ``--out`` against another run's (the JAX package's committed
  examples/exhaustive/, say) with ``compare_truths`` and writes meta.json
  (the commit, the run records, the comparison). Each ``--yardstick CSV``
  is another table of this device (another seed), the measure of its own
  seed-to-seed spread, and a template may have several; each ``--beside
  CSV`` (another launch plan, say) is held against ``--out``'s table of
  its template. A table's run record is
  read from beside it: exhaustive_B_288<sfx>.csv ->
  exhaustive_B_run<sfx>.json.

A run's own report scores its truth as trained (the floats in memory);
``--report-only`` and ``compare_truths`` score truths read back from CSV,
whose parser (pandas' default one, which utils/xlsx.read_rows copies) does
not round-trip every 17-digit float. Coverage compares floats exactly, so
the two can differ where a method's genome and a true genome share a size
(the JAX script behaves the same).
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from ..algorithms.ea import nondominated_mask
from ..core.config import Constraints, DataConfig, get_preset
from ..core.genome import GENE_ORDER, all_genomes
from ..metrics.hypervolume import hypervolume, reference_point
from ..metrics.quality import (
    coverage_metric,
    generational_distance,
    inverted_gd,
    to_min_space,
)
from ..utils.reporting import write_csv
from ..utils.xlsx import read_rows

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
ALL8 = os.path.join(REPO, "examples", "all8")

# family -> (representative preset for TrainConfig, committed method fronts)
FAMILIES = {
    "B": ("sa_nsga_local",
          ["SA_NSGA-II=front_sa_nsga_penalty.csv",
           "SA_NSGA-II_LS=front_sa_nsga_local.csv",
           "INIT_SA_NSGA-II=front_sa_nsga_init.csv",
           "INIT_SA_NSGA-II_LS=front_init_sa_nsga_local.csv",
           "2_stage_SA_NSGA-II=front_psi_init_sa_nsga.csv",
           "2_stage_SA-NSGA-II_LS=front_psi_sa_nsga_local.csv"]),
    "A": ("mobo_penalty",
          ["MOBO=front_mobo_penalty.csv",
           "2_stage_MOBO=front_psi_mobo_2.csv"]),
}
CONSTRAINTS = Constraints(0.90, 2.5, 0.09)  # the harness's shared set
OBJECTIVES = ["Accuracy", "Size_MB", "FPR"]
FAILED_ACC = 0.5  # a training below this accuracy failed (chance is 0.1)
CLOSE_ACC = 0.01  # 5 of the 500 validation samples


def sweep(template: str, epochs: int, seed: int, fake: bool,
          device="cuda", fitness_cache: Optional[str] = None,
          compaction_chunk: Optional[int] = None):
    """Train (or, with ``fake``, score in closed form) all 288 genomes under
    the template's family config. Returns the table's rows (the JAX
    script's columns, without the two membership columns) and the
    evaluator, whose ``timings[-1]`` describes the launches."""
    preset, _ = FAMILIES[template]
    cfg = get_preset(preset)
    train = dataclasses.replace(cfg.train, epochs=epochs, num_classes=10)
    if compaction_chunk is not None:
        train = dataclasses.replace(train, compaction_chunk=compaction_chunk)
    # sorted by bucket, as the JAX script sorts for depth-uniform launches
    genomes = sorted(
        all_genomes(),
        key=lambda g: (g["filters"], g["kernel_size"], g["residual_blocks"]),
    )
    if fake:
        from ..engine.evaluator import FakeEvaluator

        ev = FakeEvaluator(num_classes=10, template=template)
    else:
        from ..data.pipeline import prepare_dataset
        from ..engine.evaluator import PopulationEvaluator

        ev = PopulationEvaluator(
            prepare_dataset(DataConfig(num_classes=10)), train, device=device,
            fitness_cache_path=fitness_cache)
    fits = ev.evaluate(genomes, seed=seed)
    rows = [
        {"Accuracy": acc, "Size_MB": size, "FPR": fpr,
         "CV": CONSTRAINTS.violation(acc, size, fpr),
         **{k: g[k] for k in GENE_ORDER}}
        for g, (acc, size, fpr) in zip(genomes, fits)
    ]
    return rows, ev


def mark_front(rows: List[Dict]) -> None:
    """Add the ``feasible`` and ``on_true_front`` columns in place."""
    feasible = [r["CV"] == 0 for r in rows]
    on_front = np.zeros(len(rows), bool)
    idx = np.nonzero(feasible)[0]
    if len(idx):
        pts = to_min_space(objectives(rows))
        on_front[idx[nondominated_mask(pts[idx])]] = True
    for r, f, t in zip(rows, feasible, on_front):
        r["feasible"] = bool(f)
        r["on_true_front"] = bool(t)


def objectives(rows: List[Dict]) -> np.ndarray:
    """(n, 3) accuracy, size and FPR of ``rows``, n may be 0."""
    return np.array([[r[k] for k in OBJECTIVES] for r in rows],
                    dtype=np.float64).reshape(-1, 3)


def read_table(path: str) -> List[Dict]:
    """A table as row dicts, with ``pd.read_csv``'s values."""
    columns, rows = read_rows(path)
    return [dict(zip(columns, r)) for r in rows]


def genome_key_of_row(row) -> tuple:
    return tuple(
        bool(row[k]) if k in ("use_bn", "use_dropout") else int(row[k])
        for k in GENE_ORDER
    )


def run_record(template: str, ev, seconds: float, args) -> Dict:
    """What a trained sweep measured: its launches, stop epochs and rate,
    beside the device it ran on."""
    t = ev.timings[-1]
    chunks = t["chunks"]
    trained = t["n_genomes"] - t["cache_hits"]
    ran = [ev._epoch_history[k] for k in sorted(ev._epoch_history)]
    exec_flops = sum(
        ev._epoch_flops(c["pop"], ev._bucket_spec(c["filters"], c["kernel"],
                                                  c["max_blocks"]))
        * max(c["epochs"]) for c in chunks)
    rec = {
        "template": template, "epochs": args.epochs, "seed": args.seed,
        "compaction_chunk": ev.cfg.compaction_chunk,
        "device": str(ev.device), "card": None, "nvidia_smi": None,
        "sweep_seconds": seconds, "evaluate_seconds": t["seconds"],
        "trained": trained, "cache_hits": t["cache_hits"],
        "trainings_per_h": (trained * 3600.0 / t["seconds"]
                            if t["seconds"] else 0.0),
        "launches": len(chunks),
        "one_lane_launches": sum(c["pop"] == 1 for c in chunks),
        "segments": t["launches"],
        "lanes": [c["pop"] for c in chunks],
        "mean_epochs_ran": float(np.mean(ran)) if ran else 0.0,
        "ran_to_cap": int(sum(e >= args.epochs for e in ran)),
        "executed_tflop": exec_flops / 1e12,
        "executed_tflop_per_s": (exec_flops / 1e12 / t["seconds"]
                                 if t["seconds"] else 0.0),
        "plan_flops_per_s": ev._SUSTAINED_FLOPS_PER_S,
    }
    rec.update(device_record(ev.device))
    return rec


def device_record(device) -> Dict:
    """``{"card", "nvidia_smi"}``: on CUDA the card's name and
    ``nvidia-smi --query-gpu=name,power.limit``'s line for it, else None."""
    import torch

    rec = {"card": None, "nvidia_smi": None}
    if device is not None and torch.device(device).type == "cuda":
        rec["card"] = torch.cuda.get_device_name(device)
        rec["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    return rec


def _empty(path: str) -> bool:
    """An empty front: the search wrote a blank file (no feasible row)."""
    with open(path) as f:
        return not f.read().strip()


def report_on(truths: Dict[str, List[Dict]], all8_dir: str, epochs: int,
              seed: int) -> Dict:
    """Score the committed all-8 method fronts against the combined truth
    of both templates (the attainable front of the whole method family
    space)."""
    both = [dict(r, template=t) for t in ("B", "A") for r in truths[t]]
    feas = [r for r in both if r["CV"] == 0]
    pts = to_min_space(objectives(feas))
    mask = nondominated_mask(pts)
    combined = [r for r, m in zip(feas, mask) if m]
    combined_pts = pts[mask]
    true_keys = {(r["template"], genome_key_of_row(r)) for r in combined}

    # one SHARED reference point (union of truth + every method front, the
    # compare.ipynb rule) so hypervolumes — including the attainable
    # optimum's — are directly comparable
    method_fronts = {}
    for template, (_, fronts) in FAMILIES.items():
        for spec_str in fronts:
            name, fname = spec_str.split("=")
            fpath = os.path.join(all8_dir, fname)
            if not os.path.exists(fpath) or _empty(fpath):
                print(f"[exhaustive] missing or empty front {fpath}, "
                      "skipping", file=sys.stderr)
                continue
            fr = read_table(fpath)
            method_fronts[name] = (template, fr,
                                   to_min_space(objectives(fr)))
    ref = reference_point(
        [combined_pts] + [pts for _, _, pts in method_fronts.values()]
    )
    hv_truth = hypervolume(combined_pts, ref)

    report = {
        "epochs": epochs, "seed": seed,
        "combined_true_front_size": len(combined),
        "per_template_front_size": {
            t: sum(bool(r["on_true_front"]) for r in truths[t]) for t in truths
        },
        "attainable_hypervolume": hv_truth,
        "methods": {},
    }
    for name, (template, fr, pts_m) in method_fronts.items():
        found = sum(
            (template, genome_key_of_row(r)) in true_keys for r in fr
        )
        hv_m = hypervolume(pts_m, ref)
        report["methods"][name] = {
            "template": template,
            "front_rows": len(fr),
            "gd_vs_truth": generational_distance(pts_m, combined_pts),
            "igd_vs_truth": inverted_gd(pts_m, combined_pts),
            "truth_covers_method": coverage_metric(combined_pts, pts_m),
            "true_pareto_genomes_found": int(found),
            # fraction of the ATTAINABLE hypervolume this method's exported
            # front realizes — the paper's missing "optimality gap" number
            "hv_fraction_of_attainable": hv_m / hv_truth if hv_truth else 0.0,
        }
    return report


# -- holding one run's truth against another's --------------------------------

def text_table(path: str) -> Dict[tuple, Dict[str, str]]:
    """A sweep table keyed by genome, cells as written."""
    with open(path, newline="") as f:
        return {genome_key_of_row({k: (v == "True" if v in ("True", "False")
                                       else v) for k, v in r.items()}): r
                for r in csv.DictReader(f)}


def spread(d: np.ndarray) -> Dict[str, float]:
    """Median, p90 and max of ``d``."""
    return {"median": float(np.median(d)),
            "p90": float(np.percentile(d, 90)), "max": float(d.max())}


def share_close(d_acc: np.ndarray) -> float:
    """The share of ``d_acc`` within ``CLOSE_ACC``; 1e-6 absorbs float32
    accuracies (0.9420000314712524)."""
    return float(np.mean(d_acc <= CLOSE_ACC + 1e-6))


def compare_tables(got_csv: str, want_csv: str) -> Dict:
    """One template's sweep against another run's, genome by genome:
    ``Size_MB`` string for string, the spread of |d accuracy| and |d FPR|
    (median, p90, max), the share within ``CLOSE_ACC``, failed trainings
    (accuracy below ``FAILED_ACC``) in each and in both, and each true
    front's size and the genomes the two fronts share."""
    got, want = text_table(got_csv), text_table(want_csv)
    keys = sorted(set(got) & set(want))

    def col(t, name):
        return np.array([float(t[k][name]) for k in keys])

    d_acc = np.abs(col(got, "Accuracy") - col(want, "Accuracy"))
    d_fpr = np.abs(col(got, "FPR") - col(want, "FPR"))
    failed_got = col(got, "Accuracy") < FAILED_ACC
    failed_want = col(want, "Accuracy") < FAILED_ACC
    front_got = {k for k in keys if got[k]["on_true_front"] == "True"}
    front_want = {k for k in keys if want[k]["on_true_front"] == "True"}
    return {
        "genomes": len(got), "genomes_ref": len(want), "matched": len(keys),
        "size_equal": sum(got[k]["Size_MB"] == want[k]["Size_MB"]
                          for k in keys),
        "abs_d_accuracy": spread(d_acc),
        "abs_d_fpr": spread(d_fpr),
        "share_within_0.01_accuracy": share_close(d_acc),
        "failed": int(failed_got.sum()), "failed_ref": int(failed_want.sum()),
        "failed_both": int((failed_got & failed_want).sum()),
        "true_front": len(front_got), "true_front_ref": len(front_want),
        "true_front_shared": len(front_got & front_want),
    }


def _template_of(table: str) -> str:
    """"B" for .../exhaustive_B_288<sfx>.csv."""
    return os.path.basename(table).split("_")[1]


def _mobo_ordering_holds(report: Dict) -> bool:
    """tests/test_examples_artifacts.py's ordering against absolute
    truth: 2_stage_MOBO's GD and IGD below plain MOBO's."""
    m = report["methods"]
    return bool(m["2_stage_MOBO"]["gd_vs_truth"] < m["MOBO"]["gd_vs_truth"]
                and m["2_stage_MOBO"]["igd_vs_truth"]
                < m["MOBO"]["igd_vs_truth"])


def compare_truths(out_dir: str, ref_dir: str, yardsticks=(),
                   all8_dir: str = ALL8) -> Dict:
    """The tables in ``out_dir`` against those in ``ref_dir``.

    Per template, ``compare_tables``. Both truths score the all-8 fronts of
    ``all8_dir`` through ``report_on`` from their CSVs (the same fronts and
    the same parsing on both sides), method by method, with whether
    2_stage_MOBO's GD and IGD stay below MOBO's against each truth
    (reported, not gated). ``yardsticks`` are more tables of ``out_dir``'s
    device (other seeds), exhaustive_<T>_288*.csv, each held against
    ``out_dir``'s table of its template: a template's bound on the distance
    to ``ref_dir`` is 1.5x the largest median and the largest p90 of
    |d accuracy| over its pairs, plus 0.002 (one validation sample).
    Template B's bound is held for B and recorded for A; template-A
    yardsticks add A's own bound beside it. ``yardstick`` holds each
    template's pair, or with several pairs for a template, each pair by
    its table's name."""
    tables = {tag: {t: os.path.join(d, f"exhaustive_{t}_288.csv")
                    for t in ("B", "A")}
              for tag, d in (("run", out_dir), ("ref", ref_dir))}
    cmp = {"templates": {t: compare_tables(tables["run"][t],
                                           tables["ref"][t])
                         for t in ("B", "A")}}
    reports = {tag: report_on({t: read_table(p) for t, p in tt.items()},
                              all8_dir, None, None)
               for tag, tt in tables.items()}
    keys = ("gd_vs_truth", "igd_vs_truth", "truth_covers_method",
            "true_pareto_genomes_found", "hv_fraction_of_attainable")
    cmp["report"] = {
        name: {k: [m[k], reports["ref"]["methods"][name][k]] for k in keys}
        for name, m in reports["run"]["methods"].items()
    }
    cmp["mobo_ordering_holds"] = {tag: _mobo_ordering_holds(r)
                                  for tag, r in reports.items()}

    def bound_of(pairs):
        return {q: 1.5 * max(y["abs_d_accuracy"][q] for y in pairs) + 0.002
                for q in ("median", "p90")}

    def against(bound, templates):
        return ({t: {q: bool(cmp["templates"][t]["abs_d_accuracy"][q]
                             <= bound[q]) for q in bound} for t in templates},
                {t: {q: cmp["templates"][t]["abs_d_accuracy"][q] - bound[q]
                     for q in bound} for t in templates})

    yard: Dict[str, Dict[str, Dict]] = {}
    for y in yardsticks:
        t = _template_of(y)
        yard.setdefault(t, {})[os.path.basename(y)] = compare_tables(
            tables["run"][t], y)
    if yard:
        cmp["yardstick"] = {t: next(iter(p.values())) if len(p) == 1 else p
                            for t, p in yard.items()}
    yard = {t: list(p.values()) for t, p in yard.items()}
    if "B" in yard:
        bound = bound_of(yard["B"])
        cmp["bound_abs_d_accuracy"] = bound
        cmp["within_bound"], cmp["gap_to_bound"] = against(bound, ("B", "A"))
    if "A" in yard:
        own = bound_of(yard["A"])
        cmp["own_bound_A"] = own
        within, gap = against(own, ("A",))
        cmp["within_own_bound_A"], cmp["gap_to_own_bound_A"] = within["A"], \
            gap["A"]
    return cmp


def run_record_of(table: str) -> Optional[Dict]:
    """The run record written beside a sweep table, if there is one."""
    d, name = os.path.split(table)
    path = os.path.join(d, name.replace("_288", "_run", 1)[:-len(".csv")]
                        + ".json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def write_meta(out_dir: str, ref_dir: str, yardsticks=(), beside=(),
               all8_dir: str = ALL8) -> Dict:
    """meta.json in ``out_dir``: the commit of this checkout (and whether
    its tree differs from it), the run records of the sweeps and of the
    yardsticks, ``compare_truths``, and each ``beside`` table (another
    launch plan, say) with its run record and its distance from
    ``out_dir``'s table of its template."""
    def git(*cmd):
        try:
            return subprocess.run(["git", "-C", REPO, *cmd],
                                  capture_output=True, text=True, check=True,
                                  ).stdout.strip()
        except (OSError, subprocess.CalledProcessError):
            return None

    def own(table):
        return os.path.join(out_dir, f"exhaustive_{_template_of(table)}_288.csv")

    meta = {
        "commit": git("rev-parse", "HEAD"),
        "tree_differs_from_commit": bool(git("status", "--porcelain")),
        "runs": {t: run_record_of(os.path.join(out_dir,
                                               f"exhaustive_{t}_288.csv"))
                 for t in ("B", "A")},
        "yardstick_runs": {os.path.basename(y): run_record_of(y)
                           for y in yardsticks},
        "comparison": compare_truths(out_dir, ref_dir, yardsticks, all8_dir),
        "beside": {os.path.basename(b): {
            "run": run_record_of(b),
            "against_this_run": compare_tables(b, own(b))} for b in beside},
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="/tmp/exhaustive")
    p.add_argument("--epochs", type=int, default=30)  # the all-8 budget
    p.add_argument("--seed", type=int, default=7)     # the all-8 run seed
    p.add_argument("--all8-dir", default=ALL8)
    p.add_argument("--fake-eval", action="store_true")
    p.add_argument("--report-only", action="store_true",
                   help="recompute the report from existing sweep CSVs in "
                        "--out (no training)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--fitness-cache", metavar="DIR",
                   help="keep each template's fitness cache in "
                        "DIR/fitness_cache_<T>.jsonl and replay it")
    p.add_argument("--template", choices=["A", "B"],
                   help="sweep only this template; read the other's table "
                        "from --out")
    p.add_argument("--compaction-chunk", type=int,
                   help="override the presets' launch policy (0: fused)")
    p.add_argument("--compare-to", metavar="DIR",
                   help="compare only: hold --out's tables against DIR's "
                        "and write --out/meta.json (no training, no report)")
    p.add_argument("--yardstick", metavar="CSV", action="append", default=[],
                   help="a second exhaustive_<T>_288*.csv of this device")
    p.add_argument("--beside", metavar="CSV", action="append", default=[],
                   help="another exhaustive_<T>_288*.csv to hold against "
                        "--out's")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.compare_to:
        cmp = write_meta(args.out, args.compare_to, args.yardstick,
                         args.beside, args.all8_dir)["comparison"]
        print(f"[exhaustive] meta -> {os.path.join(args.out, 'meta.json')}",
              file=sys.stderr)
        print(json.dumps({k: v for k, v in cmp.items()
                          if k not in ("templates", "report", "yardstick")}))
        return 0
    if not args.report_only:
        from ..core.device import resolve_device

        resolve_device(args.device)  # raises for cuda without a GPU

    # ---- the two 288-genome sweeps ---------------------------------------
    truths = {}
    swept = [] if args.report_only else (
        [args.template] if args.template else ["B", "A"])
    for template in ("B", "A"):
        path = os.path.join(args.out, f"exhaustive_{template}_288.csv")
        if template not in swept:
            if os.path.exists(path):
                truths[template] = read_table(path)
            continue
        t0 = time.perf_counter()
        cache = (os.path.join(args.fitness_cache,
                              f"fitness_cache_{template}.jsonl")
                 if args.fitness_cache and not args.fake_eval else None)
        rows, ev = sweep(template, args.epochs, args.seed, args.fake_eval,
                         args.device, cache, args.compaction_chunk)
        seconds = time.perf_counter() - t0
        mark_front(rows)
        write_csv(path, rows)
        truths[template] = rows
        if not args.fake_eval:
            rec = run_record(template, ev, seconds, args)
            with open(os.path.join(args.out, f"exhaustive_{template}_run.json"),
                      "w") as f:
                json.dump(rec, f, indent=2)
            print(f"[exhaustive] template {template}: {rec['launches']} "
                  f"launches ({rec['one_lane_launches']} one-lane), "
                  f"{rec['trainings_per_h']:.1f} trainings/h on "
                  f"{rec['card'] or rec['device']}", file=sys.stderr)
        print(f"[exhaustive] template {template}: {len(rows)} trainings in "
              f"{seconds:.0f}s; {sum(r['feasible'] for r in rows)} "
              f"feasible, {sum(r['on_true_front'] for r in rows)} on the "
              f"template's true front -> {path}", file=sys.stderr)

    if len(truths) == 2:
        report = report_on(truths, args.all8_dir, args.epochs, args.seed)
        rpath = os.path.join(args.out, "exhaustive_report.json")
        with open(rpath, "w") as f:
            json.dump(report, f, indent=2)
        print(f"[exhaustive] report -> {rpath}", file=sys.stderr)
        print(json.dumps({k: v for k, v in report.items() if k != "methods"}))
    else:
        print(f"[exhaustive] no report: tables for {sorted(truths)} only",
              file=sys.stderr)

    return 0


if __name__ == "__main__":
    sys.exit(main())
