"""train_samples_per_s: training rows times real lanes times epochs, over
the window from the first call's start to the last call's end (whole
calls: their init, validation and final validation included)."""


def read(ctx):
    calls = ctx["calls"]
    if not calls:
        return None
    epochs = ctx["config"]["train"]["epochs"]
    samples = ctx["n_train"] * len(ctx["genomes"]) * epochs * len(calls)
    return samples / (calls[-1]["end"] - calls[0]["start"])
