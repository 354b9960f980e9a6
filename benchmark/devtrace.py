"""One call under ``torch.profiler``, read into what the per-layer readers
take: device busy time, kernel count, the device operations that took most
time, every device operation's total time and launch count by name, and
the device's idle time by the host operation it fell in.

The profiler keeps its events in memory; they are read straight from its
results (``kineto_results.events()``), not through ``key_averages``,
whose post-processing of a million kernel events takes minutes, and no
trace file is written. The arithmetic is ``profile_torch.py``'s (device
busy time against the profiled wall time), with the busy time taken as
the union of the device operations' intervals, so that overlapping
operations count once.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict

import torch

WINDOW = "bench.traced_call"
TOP = 10


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def traced(fn: Callable):
    """(fn(), summary) of one call of ``fn`` under the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            out = fn()
            _sync()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    summary = summarize(prof.profiler.kineto_results.events())
    summary["wall_s"] = wall
    summary["read_s"] = time.perf_counter() - t1
    return out, summary


def summarize(events) -> Dict:
    """The summary of a list of kineto events."""
    dev, cpu = [], []
    lo = hi = None
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.name() != WINDOW:  # the annotation's span on the device
                dev.append((e.start_ns(), e.end_ns(), e.name()))
        else:
            name = e.name()
            if name == WINDOW:
                lo, hi = e.start_ns(), e.end_ns()
            else:
                cpu.append((e.start_ns(), e.end_ns(), name,
                            e.start_thread_id()))
    if lo is None:
        lo = min([s for s, _, _ in dev] + [s for s, _, _, _ in cpu])
        hi = max([e for _, e, _ in dev] + [e for _, e, _, _ in cpu])
    kernels = sum(1 for _, _, n in dev
                  if not n.startswith(("Memcpy", "Memset")))
    by_name: Dict[str, float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    for s, e, n in dev:
        by_name[n] += (e - s) / 1e9
        launches[n] += 1
    dev.sort()
    busy = 0
    gaps = []
    cur_s = cur_e = None
    for s, e, _ in dev:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None:
            if s > lo:
                gaps.append((lo, s))
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if hi > cur_e:
            gaps.append((cur_e, hi))
    else:
        gaps.append((lo, hi))
    return {
        "device_ops": len(dev),
        "kernels": kernels,
        "busy_s": busy / 1e9,
        "window_s": (hi - lo) / 1e9,
        "top_device_ops": sorted(([n, t] for n, t in by_name.items()),
                                 key=lambda kv: -kv[1])[:TOP],
        # every device operation of the call, whatever its rank: a
        # kernel's roofline reader finds its time and launches here
        "ops_by_name": {n: {"seconds": t, "launches": launches[n]}
                        for n, t in by_name.items()},
        "idle_by_host_op": _idle_by_host_op(gaps, cpu),
    }


def _idle_by_host_op(gaps, cpu):
    """Idle device seconds by the innermost host operation running at each
    gap's midpoint (per thread, the latest-started open operation)."""
    cpu.sort()
    mids = sorted(((s + e) // 2, e - s) for s, e in gaps)
    stacks: Dict[int, list] = {}
    j = 0
    out: Dict[str, float] = defaultdict(float)
    for mid, length in mids:
        while j < len(cpu) and cpu[j][0] <= mid:
            s, e, n, tid = cpu[j]
            st = stacks.setdefault(tid, [])
            while st and st[-1][1] < s:
                st.pop()
            st.append((s, e, n))
            j += 1
        best = None
        for st in stacks.values():
            while st and st[-1][1] < mid:
                st.pop()
            if st and (best is None or st[-1][0] > best[0]):
                best = st[-1]
        out[best[2] if best else "(no host op)"] += length / 1e9
    return sorted(([n, t] for n, t in out.items()),
                  key=lambda kv: -kv[1])[:TOP]
