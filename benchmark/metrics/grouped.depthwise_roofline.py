"""grouped.depthwise_roofline: the least time the card could take for the
depthwise convs of the profiled call, over the device time of the
operations launched inside its ``grouped.depthwise`` spans
(``benchmark/spans.py``), in percent.

The work comes from shapes, not from kernel names: the configuration's
architecture module's ``depthwise_work`` (``benchmark/reference/
<module>.py``) over the call's genomes, its three passes for each
training row and the forward for each validation row evaluated, the rows
``step.mfu`` counts. The least time is max(FLOPs at the card's float32
peak, bytes at its memory bandwidth) (``peaks.json``). An architecture
without depthwise convs, or a program without the span, reads nothing."""

from benchmark import reference, spans


def read(ctx):
    s = spans.collect(ctx)
    if s is None:
        return None
    arch = reference.load(ctx["config"]["reference"])
    work = getattr(arch, "depthwise_work", None)
    peaks = None
    for key, p in ctx["peaks"]["cards"].items():
        if key in ctx["device_name"]:
            peaks = p
    ops = s["device"]["ops"]
    dw = spans.named(s["profiled"], "grouped.depthwise")
    if work is None or peaks is None or not dw or not len(ops):
        return None
    took = ops[:, 1] - ops[:, 0]
    seconds = float(took[spans.launched_within(ops[:, 2], dw)].sum()) / 1e9
    if seconds <= 0:
        return None
    d, t = ctx["config"]["data"], ctx["config"]["train"]
    hw = (d["time_steps"], d["features"])
    flops = nbytes = 0
    for g in ctx["genomes"]:
        for rows, passes in (
                (ctx["n_train"] * t["epochs"], ("fwd", "dgrad", "wgrad")),
                (ctx["n_val"] * (t["epochs"] + 1), ("fwd",))):
            f, b = work(g, hw, rows, passes)
            flops += f
            nbytes += b
    bound = max(flops / peaks["float32"], nbytes / peaks["hbm_bytes_per_s"])
    return 100.0 * bound / seconds
