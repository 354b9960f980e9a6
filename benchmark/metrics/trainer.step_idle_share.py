"""trainer.step_idle_share: the device's idle time inside the
``trainer.step`` spans of the profiled call (``benchmark/spans.py``: the
gaps between the union of device operations, as ``devtrace``), over that
call's window, in percent: the idle that the host's step work leaves."""

from benchmark import spans


def read(ctx):
    s = spans.collect(ctx)
    if s is None:
        return None
    steps = spans.named(s["profiled"], "trainer.step")
    lo, hi = s["device"]["window"]
    if not steps or hi <= lo or not len(s["device"]["ops"]):
        return None
    return 100.0 * spans.idle_within(s["device"]["gaps"], steps) / (hi - lo)
