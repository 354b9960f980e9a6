"""Profiling: in-memory spans at the port's layer boundaries, and
torch.profiler traces (the port's counterpart of
cmoop_audio_processing_tpu/utils/profiling.py, on torch.profiler instead
of jax.profiler). Stage timing is utils/reporting.StageTimer's.

* ``span(name, **attrs)`` marks one region of the program. With recording
  off (the default) it returns one shared no-op context: no clock read, no
  record, no ``record_function``. The program's spans and what reads
  them are listed in PERF.md §3;
* ``recording()`` turns recording on for its body, in the current thread
  (and context), and yields the list of ``Span`` records, in the order the
  spans opened. Records stay in memory; a span's count is its number of
  records, and counts that belong to a boundary go into its ``attrs``;
* ``trace()`` wraps a stage in a ``torch.profiler.profile`` that records
  host and, with a GPU, device activity, with recording on so that every
  span shows as a region, and writes a Chrome trace
  (``<trace_dir>/<name>.json``, viewable in Perfetto or chrome://tracing)
  when a trace directory is configured — set CMOOP_TRACE_DIR or pass
  trace_dir explicitly; otherwise it is a no-op.

Stamps are ``time.perf_counter_ns()`` plus one offset to the wall clock,
read when recording starts, so they fall on the clock of the profiler's
(kineto's) events, Unix nanoseconds, and line up with a device trace
without matching by name. While recording is on under a running
profiler, each span also opens a ``record_function`` of its name.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import time
from typing import Any, Dict, Iterator, List, Optional

import torch


@dataclasses.dataclass
class Span:
    """One recorded span. ``call`` is the id of the outermost span open
    when it opened (its own id if none was): on the program's paths, the
    ``evaluator.call`` it belongs to. ``end_ns`` is 0 while it is open."""

    name: str
    id: int
    parent: Optional[int]
    call: int
    start_ns: int
    end_ns: int
    attrs: Dict[str, Any]


class _Recorder:
    def __init__(self):
        self.records: List[Span] = []
        self.open: List[Span] = []
        self.offset = time.time_ns() - time.perf_counter_ns()


class _Open:
    """The context of one span while recording is on."""

    __slots__ = ("rec", "name", "attrs", "record", "region")

    def __init__(self, rec: _Recorder, name: str, attrs: Dict[str, Any]):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        rec = self.rec
        outer = rec.open[-1] if rec.open else None
        n = len(rec.records)
        self.record = Span(
            self.name, n, outer.id if outer else None,
            outer.call if outer else n,
            time.perf_counter_ns() + rec.offset, 0, self.attrs)
        rec.records.append(self.record)
        rec.open.append(self.record)
        # the region opens inside the span's stamps: its own set-up (about
        # a millisecond the first time in a process) comes after the stamp
        # and the region's start alike
        self.region = None
        if torch._C._autograd._profiler_enabled():
            self.region = torch.profiler.record_function(self.name)
            self.region.__enter__()
        return self.record

    def __exit__(self, *exc):
        if self.region is not None:
            self.region.__exit__(*exc)
        self.record.end_ns = time.perf_counter_ns() + self.rec.offset
        self.rec.open.pop()
        return False


class _Off:
    """The shared context of every span while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()
_ACTIVE: contextvars.ContextVar[Optional[_Recorder]] = contextvars.ContextVar(
    "cmoop_span_recorder", default=None)


def span(name: str, **attrs):
    """A context that records the region ``name`` with ``attrs`` while
    recording is on; the shared no-op context otherwise."""
    rec = _ACTIVE.get()
    if rec is None:
        return _OFF
    return _Open(rec, name, attrs)


@contextlib.contextmanager
def recording() -> Iterator[List[Span]]:
    """Record every span opened in the body; yields the records' list."""
    rec = _Recorder()
    token = _ACTIVE.set(rec)
    try:
        yield rec.records
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def trace(name: str, trace_dir: Optional[str] = None) -> Iterator[None]:
    """Profile a stage with torch.profiler, spans recorded, when a trace
    dir is configured; otherwise a no-op."""
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
        with recording(), span(name):
            yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))
