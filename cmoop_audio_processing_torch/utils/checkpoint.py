"""Per-generation checkpoint/resume.

The reference has no resume path: a crashed run loses everything except the
every-5-generations CSV dumps (SURVEY.md §5 "Failure detection"). Here every
generation atomically persists the full driver state — population records,
surrogate archive, RNG streams, generation counter — so a run resumes
exactly where it stopped.

Format: JSON (genomes and fitness records are tiny host data; the surrogate
refits from its archive on load, which is its normal update path anyway).
Atomic via write-to-temp + rename.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional


def _default(o):
    import numpy as np

    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, bytes):
        return o.decode("utf-8", "replace")
    raise TypeError(f"not JSON serializable: {type(o)}")


def save_checkpoint(path: str, state: Dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(path)), suffix=".tmp"
    )
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(state, f, default=_default)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str) -> Optional[Dict]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _restore_individual(rec: Dict) -> Dict:
    """JSON round-trip restores lists; individuals need their tuple/bool
    field types back."""
    out = dict(rec)
    if "objective_names" in out:
        out["objective_names"] = tuple(out["objective_names"])
    hp = dict(out["hparams"])
    for k, v in hp.items():
        if isinstance(v, bool):
            continue
        if k in ("use_bn", "use_dropout"):
            hp[k] = bool(v)
        else:
            hp[k] = int(v)
    out["hparams"] = hp
    return out
