"""trainer.step_host_ms: the median host time of one optimizer step, the
``trainer.step`` spans of the recorded call (``benchmark/spans.py``: spans
on, no profiler), in ms. On a host that launches faster than the card
runs, a full launch queue makes the host wait inside the step, so the
device's pace shows here too."""

import statistics

from benchmark import spans


def read(ctx):
    s = spans.collect(ctx)
    if s is None:
        return None
    steps = [(r["end_ns"] - r["start_ns"]) / 1e6
             for r in spans.named(s["recorded"], "trainer.step")]
    return statistics.median(steps) if steps else None
