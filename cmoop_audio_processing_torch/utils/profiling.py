"""Profiling: structured stage timers (utils/reporting.StageTimer) plus
optional torch.profiler traces (the port's copy of
cmoop_audio_processing_tpu/utils/profiling.py, on torch.profiler instead
of jax.profiler).

* ``trace()`` wraps a stage in a ``torch.profiler.profile`` that records
  host and, with a GPU, device activity and writes a Chrome trace
  (``<trace_dir>/<name>.json``, viewable in Perfetto or chrome://tracing)
  when a trace directory is configured — set CMOOP_TRACE_DIR or pass
  trace_dir explicitly; otherwise it is a no-op;
* ``annotate()`` names a region inside an active trace;
* ``device_memory_stats()`` snapshots each CUDA device's allocator
  statistics for leak checks.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(name: str, trace_dir: Optional[str] = None) -> Iterator[None]:
    """Profile a stage with torch.profiler when a trace dir is configured;
    otherwise a no-op."""
    trace_dir = trace_dir or os.environ.get("CMOOP_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with annotate(name):
            yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside an active trace (cheap; safe without a trace)."""
    with torch.profiler.record_function(name):
        yield


def device_memory_stats() -> Dict[str, Dict]:
    """Per-device allocator statistics (``torch.cuda.memory_stats``, with
    ``allocated_bytes.all.current`` etc.) keyed by ``str(torch.device)``
    for each visible CUDA device; an empty dict without one."""
    if not torch.cuda.is_available():
        return {}
    return {
        str(torch.device("cuda", i)): dict(torch.cuda.memory_stats(i))
        for i in range(torch.cuda.device_count())
    }
