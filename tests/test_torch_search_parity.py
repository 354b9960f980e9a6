"""The port's search layer held against the JAX package's on one fitness
table (ROADMAP §3.8).

Both packages' all-8 harnesses run with every fitness read from the JAX
package's committed exhaustive tables (``run_exhaustive.TableEvaluator``:
template A for stage 1 and MOBO, B for the SA family), so nothing is
trained and the searches, their GP fits included, are the only thing
that differs between the two. The study runs both at the committed volume
(pop 10, 8 generations, seed and eval seed = the seed) over ten seeds and
compares them paired over the seeds; the port also runs alone on the card
(no JAX there) and is compared with its own CPU runs.

    python tests/test_torch_search_parity.py --out DIR [--seeds S ...]
                                      # both packages on the CPU
    python tests/test_torch_search_parity.py --port-only --device cuda
        --out DIR                     # the port alone, on the card
    python tests/test_torch_search_parity.py --summarize --out DIR
        [--cuda-from DIR]             # summary.json from the seed files

The committed study is ``cmoop_audio_processing_torch/examples/artifacts/
search_parity/``: ``seed_<s>.json`` (each package's report, its 16 ratios
to SA_NSGA-II, each method's GD, IGD and HV fraction against the tables'
own truth, the GP refits and their seconds, plain SA_NSGA-II's true
evaluations call by call) and ``summary.json`` (the card's runs as
``port_cuda``, the paired tests and the decision). The decision rule:
five primary statistics (plain SA_NSGA-II's GD and IGD against the truth,
the IGD ratios of SA_NSGA-II_LS, INIT_SA_NSGA-II and INIT_SA_NSGA-II_LS),
each compared paired over the seeds, port-CPU against JAX and port-cuda
against port-CPU, by an exact two-sided Wilcoxon signed-rank test with
``zero_method="zsplit"``; a statistic flags at p < 0.01. The other ratios
and the other methods' GD and IGD get the same test and do not decide.

Torch runs on one thread and JAX on the CPU, so a seed's record is the
same on every rerun, less its seconds; JAX's floats may depend on the
CPU's thread pool, so the rerun is held on the machine that wrote it.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import importlib.util
import io
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # run as a script from anywhere
    sys.path.insert(0, ROOT)

from cmoop_audio_processing_torch.core.genome import (  # noqa: E402
    GENE_ORDER,
    all_genomes,
)
from cmoop_audio_processing_torch.examples import run_all8 as t_all8  # noqa: E402
from cmoop_audio_processing_torch.examples import run_exhaustive as t_exh  # noqa: E402

# the test workers share the CPU's cores: one intra-op thread per worker
# keeps PyTorch's thread pool from oversubscribing them
torch.set_num_threads(1)

EXAMPLES = os.path.join(ROOT, "examples")
TRUTH = os.path.join(EXAMPLES, "exhaustive")
ARTIFACT = os.path.join(ROOT, "cmoop_audio_processing_torch", "examples",
                        "artifacts", "search_parity")
# the JAX replicas' five seeds, then five more
SEEDS = (7, 11, 23, 31, 41, 53, 61, 71, 83, 97)
POP, GEN = 10, 8
PLAIN = "SA_NSGA-II"
PLAIN_PRESET = "sa_nsga_penalty"
PRESETS = t_all8.STAGE1 + [p for _, p, _ in t_all8.METHODS]
METHOD_NAMES = [m for m, _, _ in t_all8.METHODS]
PRIMARY = [(PLAIN, "gd_vs_truth"), (PLAIN, "igd_vs_truth"),
           ("SA_NSGA-II_LS", "igd_ratio"), ("INIT_SA_NSGA-II", "igd_ratio"),
           ("INIT_SA_NSGA-II_LS", "igd_ratio")]
ALPHA = 0.01
COMPARISONS = {"port_cpu_vs_jax": ("port_cpu", "jax"),
               "port_cuda_vs_port_cpu": ("port_cuda", "port_cpu")}


# -- running one harness ------------------------------------------------------

def _jax_script(name):
    """examples/<name>.py, the JAX package's script, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_examples_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _logging_run(real_run, log):
    """``run`` that logs the genomes of each of plain SA_NSGA-II's true
    evaluations (the initial population, then each generation's infill)."""
    def run(cfg, evaluator, **kw):
        if cfg.name == PLAIN_PRESET:
            evaluate = evaluator.evaluate

            def logged(genomes, seed=0):
                log.append([[g[k] for k in GENE_ORDER] for g in genomes])
                return evaluate(genomes, seed)
            evaluator.evaluate = logged
        return real_run(cfg, evaluator, **kw)
    return run


@contextlib.contextmanager
def _patched(module, **attrs):
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def _argv(seed, out, pop, gen):
    return ["--pop", str(pop), "--gen", str(gen), "--seed", str(seed),
            "--out", out]


def run_jax(seed, out, pop=POP, gen=GEN):
    """The JAX package's examples/run_all8.py with ``--fake-eval`` and its
    ``make_evaluator`` returning the port's ``TableEvaluator`` for the
    config's template. Returns (exit code, plain SA's evaluations)."""
    mod = _jax_script("run_all8")
    log = []

    def make_evaluator(cfg, fake, fitness_cache_path=None):
        return t_exh.TableEvaluator(TRUTH, cfg.train.template,
                                    cfg.train.num_classes)

    mod.make_evaluator = make_evaluator
    mod.run = _logging_run(mod.run, log)
    with _quiet():
        rc = mod.main(["--fake-eval"] + _argv(seed, out, pop, gen))
    return rc, log


def run_port(seed, out, device="cpu", pop=POP, gen=GEN):
    """The port's ``run_all8 --table-eval`` on ``device``. Returns (exit
    code, plain SA's evaluations)."""
    log = []
    with _patched(t_all8, run=_logging_run(t_all8.run, log)), _quiet():
        rc = t_all8.main(["--table-eval", TRUTH, "--device", device]
                         + _argv(seed, out, pop, gen))
    return rc, log


@contextlib.contextmanager
def _quiet():
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        yield


# -- one package's record -------------------------------------------------------

def score(out):
    """Each method's GD, IGD and HV fraction against the tables' own truth
    (``run_exhaustive.report_on`` on the JAX tables, the same for both
    packages), from the fronts in a harness's ``out``."""
    truths = {t: t_exh.read_table(os.path.join(TRUTH, f"exhaustive_{t}_288.csv"))
              for t in ("B", "A")}
    with tempfile.TemporaryDirectory() as fronts, _quiet():
        t_all8.export(out, fronts)
        rep = t_exh.report_on(truths, fronts, None, None)
    return {m: {k: v[k] for k in ("gd_vs_truth", "igd_vs_truth",
                                  "hv_fraction_of_attainable")}
            for m, v in rep["methods"].items()}


def package_record(out, rc, log, wall):
    """What one harness run gives the study."""
    report = t_all8._read_json(os.path.join(out, "compare_report_all8.json"))
    refits, seconds = {}, {}
    for p in PRESETS:
        stages = t_all8._read_stages(os.path.join(out, p, "progress.jsonl"), 0)
        gp = [s["seconds"] for s in stages if s.get("stage") in t_all8.GP_STAGES]
        refits[p] = len(gp)
        seconds[p] = float(sum(gp))
    return {
        "rc": rc,
        "report": report,
        "ratios": t_all8.ratios(report) if report else {},
        "truth": score(out),
        "gp_refits": refits,
        "plain_sa_evaluations": log,
        "seconds": {"wall_s": wall, "gp_refit_s": float(sum(seconds.values())),
                    "gp_refit_s_by_search": seconds},
    }


def timed(fn, seed, out, **kw):
    t0 = time.perf_counter()
    rc, log = fn(seed, out, **kw)
    return package_record(out, rc, log, time.perf_counter() - t0)


def seed_record(seed, pop=POP, gen=GEN):
    """Both packages on the CPU at one seed."""
    with tempfile.TemporaryDirectory() as d:
        return {"seed": seed, "pop": pop, "gen": gen,
                "jax": timed(run_jax, seed, os.path.join(d, "jax"),
                             pop=pop, gen=gen),
                "port_cpu": timed(run_port, seed, os.path.join(d, "port"),
                                  pop=pop, gen=gen)}


def port_record(seed, device, pop=POP, gen=GEN):
    with tempfile.TemporaryDirectory() as d:
        return timed(run_port, seed, d, device=device, pop=pop, gen=gen)


# -- the paired tests -----------------------------------------------------------

def statistic(rec, name):
    """A package record's value of ``(method, key)``: an IGD or HV ratio to
    SA_NSGA-II, or the method's GD or IGD against the truth; None when the
    method has no front."""
    method, key = name
    if key.endswith("_ratio"):
        metric = {"igd_ratio": "igd", "hv_ratio": "hypervolume"}[key]
        return rec["ratios"].get(method, {}).get(metric)
    return rec["truth"].get(method, {}).get(key)


def secondary():
    ratios = [(m, k) for m in METHOD_NAMES if m != PLAIN
              for k in ("hv_ratio", "igd_ratio")]
    truth = [(m, k) for m in METHOD_NAMES if m != PLAIN
             for k in ("gd_vs_truth", "igd_vs_truth")]
    return [n for n in ratios if n not in PRIMARY] + truth


def paired(a, b):
    """An exact two-sided Wilcoxon signed-rank test of a against b over the
    seeds where both have a value, zero differences split."""
    import warnings

    from scipy import stats

    pairs = [(x, y) for x, y in zip(a, b) if x is not None and y is not None]
    res = {"n": len(pairs), "a": a, "b": b}
    if not pairs:
        return dict(res, statistic=None, p=None, flag=False,
                    median_difference=None)
    x, y = (np.array(v, np.float64) for v in zip(*pairs))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        w = stats.wilcoxon(x, y, zero_method="zsplit", method="exact")
    p = float(w.pvalue)
    return dict(res, statistic=float(w.statistic), p=p, flag=bool(p < ALPHA),
                median_difference=float(np.median(x - y)))


def summarize(seeds, port_cuda=None):
    """summary.json from the seed records (``{seed: record}``) and the
    card's runs (``{seed: package record}``)."""
    seeds = {int(s): r for s, r in seeds.items()}
    order = sorted(seeds)
    packages = {"jax": {s: seeds[s]["jax"] for s in order},
                "port_cpu": {s: seeds[s]["port_cpu"] for s in order}}
    if port_cuda:
        packages["port_cuda"] = {int(s): r for s, r in port_cuda.items()}

    def test(name, a, b):
        common = [s for s in order if s in packages[a] and s in packages[b]]
        return dict(paired([statistic(packages[a][s], name) for s in common],
                           [statistic(packages[b][s], name) for s in common]),
                    seeds=common)

    tests, flags = {}, []
    for comp, (a, b) in COMPARISONS.items():
        if a not in packages or b not in packages:
            continue
        prim = {f"{m} {k}": test((m, k), a, b) for m, k in PRIMARY}
        tests[comp] = {
            "primary": prim,
            "secondary": {f"{m} {k}": test((m, k), a, b)
                          for m, k in secondary()},
        }
        flags += [f"{comp}: {n}" for n, t in prim.items() if t["flag"]]
    seconds = {pkg: {str(s): r["seconds"] for s, r in recs.items()}
               for pkg, recs in packages.items()}
    return {
        "seeds": order,
        "pop": sorted({seeds[s]["pop"] for s in order}),
        "gen": sorted({seeds[s]["gen"] for s in order}),
        "alpha": ALPHA,
        "test": "scipy.stats.wilcoxon(a, b, zero_method='zsplit', "
                "method='exact'), two-sided, paired over the seeds",
        "tests": tests,
        "decision": {
            "primary_flags": flags,
            "comparisons": sorted(tests),
            "branch": "b" if flags else "a",
        },
        "seconds": seconds,
        "port_cuda": ({str(s): r for s, r in sorted(packages["port_cuda"]
                                                     .items())}
                      if "port_cuda" in packages else None),
    }


def _read(path):
    with open(path) as f:
        return json.load(f)


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
        f.write("\n")


def read_seeds(d):
    return {_read(p)["seed"]: _read(p)
            for p in sorted(glob.glob(os.path.join(d, "seed_*.json")))}


def run_study(seeds, out):
    """Both packages at each seed on the CPU, one seed after another (JAX
    processes side by side oversubscribe the cores): ``out/seed_<s>.json``,
    then summary.json (with the card's runs kept from an earlier
    summary.json in ``out``)."""
    os.makedirs(out, exist_ok=True)
    for seed in seeds:
        rec = seed_record(seed)
        _write(os.path.join(out, f"seed_{seed}.json"), rec)
        print(f"[parity] seed {seed}: jax "
              f"{rec['jax']['seconds']['wall_s']:.1f} s, port "
              f"{rec['port_cpu']['seconds']['wall_s']:.1f} s",
              file=sys.stderr)
    return write_summary(out)


def write_summary(out, cuda_from=None):
    old = os.path.join(out, "summary.json")
    cuda = None
    if cuda_from:
        cuda = {_read(p)["seed"]: _read(p)["port_cuda"] for p in sorted(
            glob.glob(os.path.join(cuda_from, "port_cuda_seed_*.json")))}
    elif os.path.exists(old):
        cuda = _read(old)["port_cuda"]
    summary = summarize(read_seeds(out), cuda)
    _write(old, summary)
    return summary


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=ARTIFACT)
    p.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    p.add_argument("--port-only", action="store_true",
                   help="run the port alone (no JAX): port_<device>_seed_"
                        "<s>.json in --out")
    p.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    p.add_argument("--summarize", action="store_true",
                   help="only write summary.json from --out's seed files")
    p.add_argument("--cuda-from", metavar="DIR",
                   help="take port_cuda from DIR's port_cuda_seed_*.json")
    args = p.parse_args(argv)
    # the JAX package on the CPU as its tests run it (tests/conftest.py)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    os.environ.setdefault("JAX_ENABLE_X64", "0")
    if args.port_only:
        os.makedirs(args.out, exist_ok=True)
        for s in args.seeds:
            rec = port_record(s, args.device)
            rec["device"] = t_exh.device_record(args.device)
            _write(os.path.join(args.out, f"port_{args.device}_seed_{s}.json"),
                   {"seed": s, "pop": POP, "gen": GEN,
                    f"port_{args.device}": rec})
            print(f"[parity] seed {s} on {args.device}: "
                  f"{rec['seconds']['wall_s']:.1f} s, GP refits "
                  f"{rec['seconds']['gp_refit_s']:.1f} s", file=sys.stderr)
        return 0
    if args.summarize:
        summary = write_summary(args.out, args.cuda_from)
    else:
        summary = run_study(args.seeds, args.out)
    print(json.dumps(summary["decision"]))
    return 0


# -- tests ----------------------------------------------------------------------

@pytest.mark.parametrize("template", ["A", "B"])
def test_table_evaluator_returns_the_tables_rows(template):
    """All 288 genomes give their table rows, whatever the seed; a genome
    outside the space raises ``KeyError`` naming it."""
    rows = t_exh.read_table(os.path.join(TRUTH,
                                         f"exhaustive_{template}_288.csv"))
    ev = t_exh.TableEvaluator(TRUTH, template)
    by_key = {t_exh.genome_key_of_row(r): r for r in rows}
    genomes = all_genomes()
    got = ev.evaluate(genomes, seed=3)
    assert len(by_key) == 288 and got == ev.evaluate(genomes[::-1], 99)[::-1]
    for g, fit in zip(genomes, got):
        r = by_key[t_exh.genome_key_of_row(g)]
        assert fit == (r["Accuracy"], r["Size_MB"], r["FPR"])
    assert ev.total_true_evals == 576 and len(ev.timings) == 2
    assert ev.timings[0] == {"n_genomes": 288, "cache_hits": 0}
    assert ev.device is None and (ev.template, ev.num_classes) == (template, 10)
    outside = dict(genomes[0], filters=17)
    with pytest.raises(KeyError, match="'filters': 17"):
        ev.evaluate([genomes[1], outside])
    assert ev.total_true_evals == 576


def _stub_mobo(mobo_module):
    """Closed-form stand-ins for MOBO's GP fits and acquisition: the "GP"
    remembers its archive, and a candidate's score is a fixed linear form
    shifted by the archive's mean."""
    def train_gps(x, y, seed=0, **kw):
        y = np.atleast_2d(np.asarray(y, np.float64))
        if y.shape[0] != np.asarray(x).shape[0]:
            y = y.T
        return [float(y[:, d].mean()) for d in range(y.shape[1])]

    def penalized_acquisition(cands, obj_gps, cv_gp, lam):
        w = np.array([0.3, -0.2, 0.5, 0.1, -0.4, 0.25])
        return -(np.asarray(cands) @ w + sum(obj_gps) + lam * cv_gp)

    return {"train_gps": train_gps,
            "penalized_acquisition": penalized_acquisition}


def _outputs(out):
    names = [t_all8.front_path(_cfg(p), out) for p in PRESETS]
    names += [os.path.join(out, "Final.csv"),
              os.path.join(out, "compare_report_all8.json")]
    res = {}
    for n in names:
        with open(n, "rb") as f:
            res[os.path.relpath(n, out)] = f.read()
    return res


def _cfg(preset):
    from cmoop_audio_processing_torch.core.config import get_preset

    return get_preset(preset)


def test_harnesses_equal_under_the_oracle_with_stub_surrogates(
        tmp_path, monkeypatch):
    """At pop 4 and 2 generations under the oracle, with the closed-form
    stub surrogate of tests/test_torch_sa_nsga2.py in both packages'
    SA-NSGA-II and a shared closed-form stand-in for MOBO's GP fits and
    acquisition: every front, ``Final.csv`` and the compare report are
    byte-equal, and so are plain SA_NSGA-II's evaluations and the exit
    codes."""
    from test_torch_sa_nsga2 import _stub

    from cmoop_audio_processing_torch.algorithms import mobo as tmobo
    from cmoop_audio_processing_torch.algorithms import sa_nsga2 as tsa
    from cmoop_audio_processing_torch.surrogate import manager as tmanager
    from cmoop_audio_processing_tpu.algorithms import mobo as jmobo
    from cmoop_audio_processing_tpu.algorithms import sa_nsga2 as jsa
    from cmoop_audio_processing_tpu.surrogate import manager as jmanager

    monkeypatch.setattr(jsa, "SurrogateManager", _stub(jmanager))
    monkeypatch.setattr(tsa, "SurrogateManager", _stub(tmanager))
    for mod in (jmobo, tmobo):
        for k, v in _stub_mobo(mod).items():
            monkeypatch.setattr(mod, k, v)
    j_rc, j_log = run_jax(11, str(tmp_path / "jax"), pop=4, gen=2)
    t_rc, t_log = run_port(11, str(tmp_path / "port"), pop=4, gen=2)
    assert (t_rc, t_log) == (j_rc, j_log)
    assert len(t_log) == 3  # the initial population and two infills
    got, want = _outputs(str(tmp_path / "port")), _outputs(str(tmp_path / "jax"))
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    rep = json.loads(want["compare_report_all8.json"])
    assert sorted(rep["hypervolume"]) == sorted(METHOD_NAMES)
    record = _read(tmp_path / "port" / t_all8.RUN_RECORD)
    assert record["settings"]["table_eval"] == "examples/exhaustive"
    for e in record["searches"]:
        assert (e["launches"], e["trainings_per_h"], e["card"]) == (0, 0.0, None)
        assert e["fitness_cache"] is None and e["trainings"] > 0
    assert not glob.glob(str(tmp_path / "port" / "fitness_cache_*"))


def jax_restart_draws(seeds, updates=range(100)):
    """The port's ``make_inits`` returning the JAX package's ``_make_inits``
    draws for the same fold-in: the port's restart seed ``fold_in(seed_key
    (s), n)`` maps to ``jax.random.fold_in(jax.random.key(s), n)`` (the
    surrogate manager's and MOBO's keys) for each s of ``seeds``."""
    import jax

    from cmoop_audio_processing_torch.core.rng import fold_in, seed_key
    from cmoop_audio_processing_tpu.surrogate import gp as jgp

    keys = {fold_in(seed_key(s), n): (s, n) for s in seeds for n in updates}

    def make_inits(cfg, seed):
        s, n = keys[int(seed)]
        draws = jgp._make_inits(
            jgp.GPConfig(**{f: getattr(cfg, f) for f in
                            jgp.GPConfig.__dataclass_fields__}),
            jax.random.fold_in(jax.random.key(s), n))
        return {k: np.asarray(v, np.float32) for k, v in draws.items()}
    return make_inits


def _log_calls(ev):
    """The genomes of each of ``ev``'s evaluations, from now on."""
    log, evaluate = [], ev.evaluate

    def logged(genomes, seed=0):
        log.append([dict(g) for g in genomes])
        return evaluate(genomes, seed)
    ev.evaluate = logged
    return log


@pytest.mark.parametrize("local_search", [False, True],
                         ids=["plain", "local_search"])
def test_jax_restart_draws_give_the_jax_infill(tmp_path, monkeypatch,
                                               local_search):
    """With the JAX package's restart draws injected into the port's
    ``make_inits``, SA_NSGA-II (and SA_NSGA-II_LS) at pop 8, 3 generations
    and ``GPConfig(n_restarts=2, steps=60)`` on the template-B table pick
    the JAX package's true evaluations in every generation."""
    from cmoop_audio_processing_torch.algorithms import sa_nsga2 as tsa
    from cmoop_audio_processing_torch.core import config as tconfig
    from cmoop_audio_processing_torch.surrogate import gp as tgp
    from cmoop_audio_processing_tpu.algorithms import sa_nsga2 as jsa
    from cmoop_audio_processing_tpu.core import config as jconfig
    from cmoop_audio_processing_tpu.surrogate import gp as jgp

    seed = 11
    monkeypatch.setattr(tgp, "make_inits", jax_restart_draws([seed]))
    logs = {}
    for tag, sa, config, gp, kw in (
            ("jax", jsa, jconfig, jgp, {}),
            ("port", tsa, tconfig, tgp, {"device": "cpu"})):
        search = config.SearchConfig(
            constraints=config.Constraints(0.90, 2.5, 0.09), pop_size=8,
            max_gen=3, infill_percent=0.334, seed=seed,
            local_search=local_search, local_search_rounds=3)
        ev = t_exh.TableEvaluator(TRUTH, "B")
        logs[tag] = _log_calls(ev)
        sa.run_sa_nsga2(search, ev, gp_config=gp.GPConfig(n_restarts=2,
                                                          steps=60), **kw)
    assert len(logs["jax"]) == 4
    assert logs["port"] == logs["jax"]


def test_summary_recomputes_from_the_committed_seeds():
    """summary.json is what ``summarize`` computes from the committed
    seed_<s>.json files and its own ``port_cuda`` records: every test, its
    p-value and flag, and the decision."""
    summary = _read(os.path.join(ARTIFACT, "summary.json"))
    seeds = read_seeds(ARTIFACT)
    assert sorted(seeds) == list(SEEDS) == summary["seeds"]
    got = summarize(seeds, summary["port_cuda"])
    assert json.dumps(got, sort_keys=True) == json.dumps(summary,
                                                         sort_keys=True)
    assert sorted(summary["tests"]) == sorted(COMPARISONS)
    for comp in COMPARISONS:
        prim = summary["tests"][comp]["primary"]
        assert sorted(prim) == sorted(f"{m} {k}" for m, k in PRIMARY)
        for t in prim.values():
            assert t["n"] == len(SEEDS) and t["p"] is not None
    flags = [f"{c}: {n}" for c in COMPARISONS
             for n, t in summary["tests"][c]["primary"].items()
             if t["p"] < ALPHA]
    assert summary["decision"]["primary_flags"] == flags
    assert summary["decision"]["branch"] == ("b" if flags else "a")


def _strip_seconds(obj):
    if isinstance(obj, dict):
        return {k: _strip_seconds(v) for k, v in obj.items()
                if k != "seconds"}
    if isinstance(obj, list):
        return [_strip_seconds(v) for v in obj]
    return obj


def _assert_close(got, want, path=""):
    """Equal structure, ints, strings and bools; floats within 1e-12
    (a hypervolume may be summed by the native core or by numpy)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{path}/{i}")
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=1e-12, abs_tol=0.0), \
            (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.slow
def test_seed_7_reruns_to_its_committed_record():
    """Both packages at seed 7 give the committed record again, less the
    seconds (~2 min on one core)."""
    want = _read(os.path.join(ARTIFACT, "seed_7.json"))
    got = json.loads(json.dumps(seed_record(7)))
    _assert_close(_strip_seconds(got), _strip_seconds(want))


if __name__ == "__main__":
    sys.exit(main())
