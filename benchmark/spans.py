"""The program's own spans (``cmoop_audio_processing_torch/utils/profiling``)
in a traced run, for the readers of ``metrics/trainer.*`` and
``metrics/engine.*``.

The first such reader of a ``--trace 1`` run starts a process of its own
(``python -m benchmark.spans``), after the window and the check, which
builds the cell's evaluator (its configuration, mix and shapes; the data
and the eval seed from the traced call's eval seed), warms it up as the
window's set-up does and makes two calls:

* the recorded call: spans recorded, no profiler. It runs in a process
  that has not yet run the profiler, since a process that has runs its
  host side slower afterwards (a KWS call 38.9 s against 26.4 s on the
  H100's host): the host's view undistorted;
* the profiled call: spans recorded under ``torch.profiler`` (device
  activity and runtime calls), read into the device's idle gaps and each
  device operation's interval with the start of the runtime call that
  launched it (matched by correlation id).

Both land in ``ctx["spans"]``, which every later reader of the run reads:
``{"recorded": [...], "profiled": [...], "device": {...}}``, spans as
dicts, stamps in ns on the clock of the profiler's events (Unix ns). A
program without spans leaves ``ctx["spans"]`` None and starts nothing,
so the readers find nothing. The window's calls, and with them every
other metric, never run with recording on.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTSIDE = "(outside spans)"


def collect(ctx: Dict) -> Optional[Dict]:
    """``ctx["spans"]``, measured by the first reader that asks."""
    if "spans" not in ctx:
        ctx["spans"] = _measure(ctx)
    return ctx["spans"]


def named(records: Sequence[Dict], name: str) -> List[Dict]:
    return [r for r in records if r["name"] == name]


def gap_time_before(gaps: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Idle ns before each instant of ``t``, given sorted disjoint ``gaps``
    ((n, 2) start and end ns)."""
    t = np.asarray(t, np.int64)
    if len(gaps) == 0:
        return np.zeros(t.shape, np.int64)
    starts, ends = gaps[:, 0], gaps[:, 1]
    cum = np.concatenate([[0], np.cumsum(ends - starts)])
    i = np.searchsorted(ends, t, side="right")  # gaps ended by t
    part = np.where(i < len(gaps),
                    np.clip(t - starts[np.minimum(i, len(gaps) - 1)], 0,
                            None), 0)
    return cum[i] + part


def idle_within(gaps: np.ndarray, spans: Sequence[Dict]) -> int:
    """Idle ns inside the spans (disjoint spans, such as the steps)."""
    if not spans:
        return 0
    s = np.array([r["start_ns"] for r in spans], np.int64)
    e = np.array([r["end_ns"] for r in spans], np.int64)
    return int((gap_time_before(gaps, e) - gap_time_before(gaps, s)).sum())


def launched_within(launch: np.ndarray, spans: Sequence[Dict]) -> np.ndarray:
    """Whether each launch instant falls inside one of the (disjoint)
    spans."""
    if not spans:
        return np.zeros(len(launch), bool)
    iv = np.array(sorted((r["start_ns"], r["end_ns"]) for r in spans),
                  np.int64)
    i = np.searchsorted(iv[:, 0], launch, side="right") - 1
    ok = i >= 0
    j = np.maximum(i, 0)
    return ok & (launch <= iv[j, 1]) & (launch >= 0)


def idle_by_innermost(gaps: np.ndarray, records: Sequence[Dict],
                      window) -> Dict[str, float]:
    """Idle seconds under each innermost span (a span's time less its
    children's), and outside every span, within ``window``."""
    lo, hi = window
    kids = defaultdict(list)
    roots = []
    for r in records:
        (kids[r["parent"]] if r["parent"] is not None else roots).append(r)
    out: Dict[str, float] = defaultdict(float)

    def own(name, a, b, children):
        t = a
        for c in sorted(children, key=lambda c: c["start_ns"]):
            add(name, t, c["start_ns"])
            own(c["name"], c["start_ns"], c["end_ns"], kids[c["id"]])
            t = c["end_ns"]
        add(name, t, b)

    def add(name, a, b):
        a, b = max(a, lo), min(b, hi)
        if b > a:
            g = gap_time_before(gaps, np.array([a, b]))
            out[name] += (g[1] - g[0]) / 1e9

    own(OUTSIDE, lo, hi, roots)
    return dict(out)


def _measure(ctx: Dict) -> Optional[Dict]:
    if ctx.get("trace") is None:
        return None
    try:
        from cmoop_audio_processing_torch.utils.profiling import \
            recording  # noqa: F401
    except ImportError:  # a program without spans
        return None
    job = {"config": ctx["config"], "traffic": ctx["traffic"],
           "seed": ctx["calls"][-1]["eval_seed"],
           "device": "cuda" if ctx["device_name"] != "cpu" else "cpu"}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "job.json"), "w") as f:
            json.dump(job, f)
        subprocess.run([sys.executable, "-m", "benchmark.spans", tmp],
                       cwd=ROOT, stdout=sys.stderr, check=True)
        with open(os.path.join(tmp, "spans.json")) as f:
            out = json.load(f)
        with np.load(os.path.join(tmp, "device.npz")) as z:
            out["device"].update(gaps=z["gaps"], ops=z["ops"])
    dev = out["device"]
    w0 = ctx["calls"][0]
    log(f"[bench] spans: recorded call {out['recorded_s']:.4f} s (the "
        f"window's untraced call {w0['end'] - w0['start']:.4f} s), "
        f"{len(out['recorded'])} spans; profiled call {dev['wall_s']:.4f} "
        f"s, {len(out['profiled'])} spans, {len(dev['ops'])} device ops "
        f"({dev['unmatched']} without a launch), stopped in "
        f"{dev['stop_s']:.1f} s, read in {dev['read_s']:.1f} s; the "
        f"process {time.perf_counter() - t0:.1f} s")
    idle = idle_by_innermost(dev["gaps"], out["profiled"], dev["window"])
    log("[bench] idle by span: " + ", ".join(
        f"{n} {t:.4f} s" for n, t in sorted(idle.items(),
                                            key=lambda kv: -kv[1])))
    return out


def _record_calls(job_dir: str):
    """The process of ``_measure``: the recorded call and the profiled
    call, written to ``job_dir``."""
    from cmoop_audio_processing_torch.engine.evaluator import \
        PopulationEvaluator
    from cmoop_audio_processing_torch.utils.profiling import recording

    from benchmark import cell, data, traffic

    with open(os.path.join(job_dir, "job.json")) as f:
        job = json.load(f)
    config, mix, seed = job["config"], job["traffic"], job["seed"]
    cfg = cell.program_config(config, mix)
    genomes = traffic.genomes(mix)
    cells_data = data.cell_data(config, seed)
    # the window's warm-up: every shape, on an eighth of the train rows
    rows = max(cfg.batch_size, cells_data["x_train"].shape[0] // 8)
    warm = PopulationEvaluator(
        dict(cells_data, x_train=cells_data["x_train"][:rows],
             y_train=cells_data["y_train"][:rows]), cfg, device=job["device"])
    warm.evaluate(genomes, seed=traffic.eval_seed(seed, 2 ** 31))
    del warm
    evaluator = PopulationEvaluator(cells_data, cfg, device=job["device"])
    _sync()
    t0 = time.perf_counter()
    with recording() as recorded:
        evaluator.evaluate(genomes, seed=seed)
        _sync()
    recorded_s = time.perf_counter() - t0
    with recording() as profiled:
        dev = _profiled_call(lambda: evaluator.evaluate(genomes, seed=seed))
    np.savez(os.path.join(job_dir, "device.npz"), gaps=dev.pop("gaps"),
             ops=dev.pop("ops"))
    with open(os.path.join(job_dir, "spans.json"), "w") as f:
        json.dump({"recorded": [dataclasses.asdict(r) for r in recorded],
                   "profiled": [dataclasses.asdict(r) for r in profiled],
                   "recorded_s": recorded_s, "device": dev}, f)


def log(line: str):
    print(line, file=sys.stderr, flush=True)


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _profiled_call(fn) -> Dict:
    """One call of ``fn`` under the profiler, read into the window (Unix
    ns), the idle gaps and every device operation as (start, end, launch
    start; -1 without a matched launch). The profiler records the device's
    activity and the runtime calls only, not every host operation as
    ``devtrace`` does: that stretched a KWS call 1.79x against 1.27x, and
    its stop and read took 108 s against 65 s (on the H100's host)."""
    from torch.profiler import ProfilerActivity, profile

    activities = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                  else [ProfilerActivity.CPU])
    _sync()
    with profile(activities=activities) as prof:
        lo = time.time_ns()
        fn()
        _sync()
        hi = time.time_ns()
    t1 = time.perf_counter()
    stop_s = (time.time_ns() - hi) / 1e9
    cuda = torch.autograd.DeviceType.CUDA
    dev, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                dev.append((e.start_ns(), e.end_ns(), e.correlation_id()))
        elif e.name().startswith("cu"):  # CUDA API: cudaLaunchKernel, ...
            launches[e.correlation_id()] = e.start_ns()
    ops = np.array([(s, e, launches.get(c, -1)) for s, e, c in dev],
                   np.int64).reshape(-1, 3)
    ops = ops[np.argsort(ops[:, 0], kind="stable")]
    return {"window": (lo, hi), "gaps": _gaps(ops, lo, hi), "ops": ops,
            "unmatched": int((ops[:, 2] < 0).sum()), "wall_s": (hi - lo) / 1e9,
            "stop_s": stop_s, "read_s": time.perf_counter() - t1}


def _gaps(ops: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Sorted disjoint (start, end) ns in [lo, hi] in which no device
    operation ran (``ops`` sorted by start)."""
    s = np.clip(ops[:, 0], lo, hi)
    e = np.clip(ops[:, 1], lo, hi)
    keep = e > s
    s, e = s[keep], e[keep]
    if len(s) == 0:
        return np.array([[lo, hi]], np.int64) if hi > lo else np.zeros(
            (0, 2), np.int64)
    reach = np.maximum.accumulate(e)  # the busy front after each op
    starts = np.concatenate([[lo], reach[:-1]])
    ends = s
    gaps = np.stack([starts, ends], 1)
    tail = np.array([[reach[-1], hi]], np.int64)
    gaps = np.concatenate([gaps, tail])
    return gaps[gaps[:, 1] > gaps[:, 0]]


if __name__ == "__main__":
    _record_calls(sys.argv[1])
