"""grouped.depthwise_busy_share: the device time of the operations
launched inside ``grouped.depthwise`` spans (each depthwise conv's
forward, input gradient and weight gradient; ``pass`` "fwd", "dgrad",
"wgrad"), over all device operations' time, in the profiled call
(``benchmark/spans.py``; an operation's launch is the start of the
runtime call that launched it, on whichever host thread), in percent. A
program without the span reads nothing."""

from benchmark import spans


def read(ctx):
    s = spans.collect(ctx)
    if s is None:
        return None
    ops = s["device"]["ops"]
    dw = spans.named(s["profiled"], "grouped.depthwise")
    if not dw or not len(ops):
        return None
    took = ops[:, 1] - ops[:, 0]
    inside = spans.launched_within(ops[:, 2], dw)
    return 100.0 * float(took[inside].sum()) / float(took.sum())
