"""trainer.adam_kernel_share: the share of the recorded call's
``trainer.adam`` spans (each optimizer update; ``route`` "kernel" for the
fused per-lane Adam kernel, "plain" for PyTorch's ops) that took the
kernel, in percent (``benchmark/spans.py``). A program without the span
reads nothing."""

from benchmark import spans


def read(ctx):
    s = spans.collect(ctx)
    if s is None:
        return None
    adam = spans.named(s["recorded"], "trainer.adam")
    if not adam:
        return None
    kernel = sum(r["attrs"].get("route") == "kernel" for r in adam)
    return 100.0 * kernel / len(adam)
