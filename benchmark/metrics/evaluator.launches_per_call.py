"""evaluator.launches_per_call: the training segments the evaluator ran
in the traced call (its own ``timings[-1]["launches"]``)."""


def read(ctx):
    if ctx["trace"] is None:
        return None
    return ctx["calls"][-1]["timings"]["launches"]
