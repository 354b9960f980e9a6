"""engine.host_reads_per_call: the points at which the program blocked on
the device to read a value (``engine.host_read`` spans) per
``evaluator.call`` span, in the recorded call (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    s = spans.collect(ctx)
    if s is None:
        return None
    calls = len(spans.named(s["recorded"], "evaluator.call"))
    if not calls:
        return None
    return len(spans.named(s["recorded"], "engine.host_read")) / calls
