"""setup_s: from the process's start to the window's: data, the
evaluator, the warm-up call."""


def read(ctx):
    return ctx["setup_s"]
