"""trainer.validation_busy_share: the device time of the operations
launched inside ``trainer.validate`` spans (each epoch's validation and
the final one), over all device operations' time, in the profiled call
(``benchmark/spans.py``; an operation's launch is the start of the
runtime call that launched it), in percent."""

from benchmark import spans


def read(ctx):
    s = spans.collect(ctx)
    if s is None:
        return None
    ops = s["device"]["ops"]
    val = spans.named(s["profiled"], "trainer.validate")
    if not val or not len(ops):
        return None
    took = ops[:, 1] - ops[:, 0]
    inside = spans.launched_within(ops[:, 2], val)
    return 100.0 * float(took[inside].sum()) / float(took.sum())
