"""trainer.kernels_per_step: device kernels of the traced call over the
optimizer steps it ran, each launch ceil(train rows / batch) steps an
epoch for its longest lane's epochs (validation and init kernels count
in the numerator)."""

import math


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["kernels"]:
        return None
    per_epoch = math.ceil(ctx["n_train"] / ctx["config"]["train"]["batch_size"])
    steps = sum(per_epoch * max(ch["epochs"])
                for ch in ctx["calls"][-1]["timings"]["chunks"])
    return tr["kernels"] / steps if steps else None
