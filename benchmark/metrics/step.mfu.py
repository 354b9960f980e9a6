"""step.mfu: the conv and dense FLOPs the call's genomes need (the frozen
``count_fwd_flops`` of the configuration's architecture module,
``benchmark/reference/<module>.py``: 3x a forward for each training row,
1x for each validation row evaluated, the epoch's and the final
validation) over the wall time of the traced run's untraced call (the
profiler slows the traced one) at the card's dense peak in the
configuration's compute dtype, in percent."""

from benchmark import reference


def read(ctx):
    if ctx["trace"] is None:
        return None
    call = ctx["calls"][0]
    wall = call["end"] - call["start"]
    peak = None
    for key, peaks in ctx["peaks"]["cards"].items():
        if key in ctx["device_name"]:
            peak = peaks[ctx["config"]["train"]["compute_dtype"]]
    if peak is None:
        return None
    d, t = ctx["config"]["data"], ctx["config"]["train"]
    arch = reference.load(ctx["config"]["reference"])
    epochs = t["epochs"]
    flops = sum(
        arch.count_fwd_flops(g, (d["time_steps"], d["features"]),
                             t["num_classes"], t["template"])
        * (3 * ctx["n_train"] * epochs + ctx["n_val"] * (epochs + 1))
        for g in ctx["genomes"])
    return 100.0 * flops / (wall * peak)
