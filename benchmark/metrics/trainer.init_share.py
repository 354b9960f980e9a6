"""trainer.init_share: the ``trainer.init`` spans' time (population init
and the training carry) over the ``evaluator.call`` spans' time, in the
recorded call (``benchmark/spans.py``), in percent."""

from benchmark import spans


def read(ctx):
    s = spans.collect(ctx)
    if s is None:
        return None
    rec = s["recorded"]
    calls = sum(r["end_ns"] - r["start_ns"]
                for r in spans.named(rec, "evaluator.call"))
    if not calls or not spans.named(rec, "trainer.init"):
        return None
    init = sum(r["end_ns"] - r["start_ns"]
               for r in spans.named(rec, "trainer.init"))
    return 100.0 * init / calls
