"""One run of one cell: set-up, the measured window, the check.

Everything that belongs to a configuration, a traffic mix or a metric is
found by name: ``configs/<config>.json``, the architecture module its
``"reference"`` key names (``reference/<module>.py``: the frozen init and
counts and the plain forward pass), ``traffic/<mix>.json``,
``limits/<cell>.json``, ``end_to_end/<metric>.py`` and
``metrics/<metric>.py`` (each reader a ``read(ctx)`` that returns a
number, or None when it finds nothing to read), so a cell, a mix, a
metric or an architecture is added with files and entries alone.

The window drives ``PopulationEvaluator.evaluate(genomes, seed)``, the
entry every search driver calls: call i with eval seed ``traffic.
eval_seed(run seed, i)``, a new call started while less than ``seconds``
have passed, every call whole. A traced run makes two calls: the first
untraced (the step time the profiler does not slow), the second under
the profiler (``devtrace``).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

from . import check, data, devtrace, reference, traffic

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_json(*parts) -> Dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def bench(path: Optional[str] = None) -> Dict:
    """BENCHMARK.json at the checkout's root, or ``path``."""
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def resolve(workload: str, bench_path: Optional[str] = None) -> Dict:
    """The cell of ``workload`` with its configuration, mix, limits and
    metrics, from BENCHMARK.json and the files named there. Loads the
    configuration's architecture module, so that a missing one fails
    here, before any set-up."""
    spec = bench(bench_path)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    config = _load_json(os.path.relpath(os.path.join(ROOT, conf["file"]),
                                        HERE))
    reference.load(config.get("reference"))
    return {
        "name": workload,
        "chips": w["chips"],
        "config": config,
        "traffic": _load_json("traffic", f"{w['traffic']}.json"),
        "limits": _load_json("limits", f"{workload}.json"),
        "end_to_end": [m for m in spec["end_to_end"] if applies(m)],
        "per_layer": [m for m in spec["per_layer"] if applies(m)],
    }


def reader(kind: str, name: str):
    """The ``read`` function of ``<kind>/<name>.py``."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card(device) -> Dict:
    """The card's name, power limit, clocks and temperature (nvidia-smi)."""
    if torch.device(device).type != "cuda":
        return {}
    q = "name,power.limit,power.draw,clocks.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi failed: {e}"
    return {"nvidia_smi": out.splitlines()[0] if out else ""}


def program_config(config: Dict, mix: Dict):
    """The preset's TrainConfig with the configuration's epoch cap (its
    ``reduced`` key) and the mix's launch plan; every other setting the
    configuration states has to be the preset's."""
    from cmoop_audio_processing_torch.core.config import get_preset

    base = get_preset(config["preset"]).train
    t = config["train"]
    cfg = dataclasses.replace(
        base, epochs=t["epochs"], compaction_chunk=mix["compaction_chunk"])
    for key in ("batch_size", "patience", "learning_rate", "num_classes",
                "template", "dropout_rate", "compute_dtype",
                "restore_best_weights", "accuracy_from"):
        if getattr(cfg, key) != t[key]:
            raise ValueError(f"the preset's {key} is {getattr(cfg, key)!r}, "
                             f"the configuration says {t[key]!r}")
    return cfg


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell: Dict, seed: int, seconds: float, traced: bool, device="cuda",
        t_start: Optional[float] = None, log=None) -> Dict:
    """One run of ``cell``: the result line's fields and the checks."""
    from cmoop_audio_processing_torch.engine.evaluator import \
        PopulationEvaluator
    from cmoop_audio_processing_torch.engine.trainer import PopulationTrainer

    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    config, mix = cell["config"], cell["traffic"]
    genomes = traffic.genomes(mix)
    cfg = program_config(config, mix)
    marks = [("start", t_start), ("imports", time.perf_counter())]
    cells_data = data.cell_data(config, seed)
    n_train = cells_data["x_train"].shape[0]
    marks.append(("data", time.perf_counter()))

    # warm-up: the cell's genomes, on a slice of the train rows large
    # enough that the launch plan is the window's, and the whole
    # validation split (the window's eval batches)
    warm_rows = max(cfg.batch_size, n_train // 8)
    warm_data = dict(cells_data, x_train=cells_data["x_train"][:warm_rows],
                     y_train=cells_data["y_train"][:warm_rows])
    warm = PopulationEvaluator(warm_data, cfg, device=device)
    warm.evaluate(genomes, seed=traffic.eval_seed(seed, 2 ** 31))
    warm_plan = _plan(warm.timings[-1])
    del warm
    marks.append(("warm-up", time.perf_counter()))
    evaluator = PopulationEvaluator(cells_data, cfg, device=device)
    gc.collect()
    _sync(device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    before = card(device)
    marks.append(("evaluator", time.perf_counter()))
    setup_s = time.perf_counter() - t_start

    calls: List[Dict] = []
    answers: List[List] = []
    summary = None
    with check.Recorder(PopulationTrainer) as recorder:
        recorder.record_steps = True
        w0 = time.perf_counter()
        while True:
            i = len(calls)
            recorder.finals = []  # keep the last call's only
            recorder.keep_final = True
            s = traffic.eval_seed(seed, i)
            t0 = time.perf_counter()
            if traced and i == 1:
                ans, summary = devtrace.traced(
                    lambda: evaluator.evaluate(genomes, seed=s))
            else:
                ans = evaluator.evaluate(genomes, seed=s)
            _sync(device)
            t1 = time.perf_counter()
            recorder.record_steps = False
            answers.append(ans)
            calls.append({"start": t0 - w0, "end": t1 - w0, "eval_seed": s,
                          "timings": evaluator.timings[-1]})
            if (i == 1) if traced else (t1 - w0 >= seconds):
                break
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        after = card(device)
        eval_seed_first = calls[0]["eval_seed"]
        del evaluator
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        window_plan = _plan(calls[0]["timings"])
        log(f"[bench] {cell['name']} seed {seed}: {len(calls)} calls, "
            f"window {calls[-1]['end']:.4f} s, setup {setup_s:.4f} s")
        log("[bench] setup: " + ", ".join(
            f"{n} {b - a:.3f} s" for (_, a), (n, b) in zip(marks, marks[1:])))
        log(f"[bench] card before: {before.get('nvidia_smi', '')}")
        log(f"[bench] card after:  {after.get('nvidia_smi', '')}")
        log(f"[bench] plan: warm-up {warm_plan}, window {window_plan}"
            + ("" if warm_plan == window_plan else "  (DIFFER)"))
        log(f"[bench] peak memory {peak} bytes")

        failed = sum(1 for a in answers for fit in a
                     if not all(math.isfinite(v) for v in fit))
        t_check = time.perf_counter()
        reference = check.Reference(config, cells_data, device)
        judged = check.judge(reference, genomes, recorder, answers[-1],
                             eval_seed_first,
                             config["train"]["restore_best_weights"],
                             answers)
    ok, checks = check.verdict(judged["numbers"], cell["limits"],
                               judged["notes"], failed)
    for note in judged["notes"]:
        log(f"[bench] check: {note}")
    for name, value in judged["numbers"].items():
        if name not in checks:
            log(f"[bench] read, not compared: {name} {value!r}")
    log(f"[bench] reference check {time.perf_counter() - t_check:.1f} s")

    ctx = {
        "config": config, "traffic": mix, "genomes": genomes,
        "n_train": n_train, "n_val": cells_data["x_val"].shape[0],
        "calls": calls, "setup_s": setup_s, "peak_bytes": peak,
        "trace": summary, "card": after,
        "peaks": _load_json("peaks.json"),
        "device_name": (torch.cuda.get_device_name(0) if cuda else "cpu"),
    }
    metrics = {}
    wanted = cell["per_layer"] if traced else cell["end_to_end"]
    kind = "metrics" if traced else "end_to_end"
    for m in wanted:
        value = reader(kind, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_rec = {"platform": "gpu" if cuda else "cpu",
                  "kind": ctx["device_name"],
                  "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": ok, "attempted": len(genomes) * len(calls),
              "failed": failed, "metrics": metrics, "device": device_rec}
    if traced and summary is not None:
        device_rec["busy_s"] = summary["busy_s"]
        device_rec["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["top_device_ops"],
                               "idle_gaps": summary["idle_by_host_op"]}
        by_name = summary["ops_by_name"]
        log(f"[bench] trace: {summary['kernels']} kernels, "
            f"{summary['device_ops']} device ops ("
            f"{sum(v['launches'] for v in by_name.values())} launches of "
            f"{len(by_name)} names), busy "
            f"{summary['busy_s']:.4f} s of {summary['window_s']:.4f} s, "
            f"read in {summary['read_s']:.1f} s")
    for c in calls:
        t = c["timings"]
        log(f"[bench] call {c['start']:.4f}-{c['end']:.4f} s: "
            f"{t['launches']} launches, lanes "
            f"{[ch['lanes'] for ch in t['chunks']]}, epochs "
            f"{sorted({e for ch in t['chunks'] for e in ch['epochs']})}")
    result["read"] = judged["numbers"]
    result["checks"] = checks
    return result


def _plan(timings: Dict) -> List:
    return [(ch["pop"], ch["max_blocks"], ch["lanes"])
            for ch in timings["chunks"]]
