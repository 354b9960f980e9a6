"""The benchmark's plain reference: ``training`` (loss, Adam, the step
loop, validation, the control's rounding) and one module an architecture,
``<module>.py``, that a configuration names by its ``"reference"`` key."""

from __future__ import annotations

import importlib.util
import os
import re
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# What the harness takes from an architecture module.
FUNCTIONS = ("init_params", "reference_params", "forward", "count_params",
             "model_size_mb", "count_fwd_flops")
_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def load(name: str):
    """The architecture module ``benchmark/reference/<name>.py``, loaded
    from its file once a process; raises, naming it, where the file is
    missing or lacks one of ``FUNCTIONS``."""
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"{name!r} names no architecture module")
    qual = f"{__name__}.{name}"
    mod = sys.modules.get(qual)
    if mod is None:
        path = os.path.join(HERE, f"{name}.py")
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"no architecture module {name!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(qual, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[qual] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[qual]
            raise
    missing = [f for f in FUNCTIONS if not callable(getattr(mod, f, None))]
    if missing:
        raise AttributeError(f"architecture module {name!r} lacks "
                             f"{', '.join(missing)}")
    return mod
