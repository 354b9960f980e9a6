"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Prints the checks on standard error and, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` (and with ``--trace
1`` ``breakdown``), ``read`` (every number the check read) and, last,
``checks``: each number compared, with its limit.

Exits non-zero, printing no result, without a CUDA card (nothing falls
back to the CPU), or when a JAX module is loaded once the window closed.
Build and kernel caches go to fixed directories under ``.bench_cache/``
in the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "cmoop_audio_processing_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.setdefault("USE_FLAX", "0")
    # the checkout's root, not this script's folder, heads the path: the
    # benchmark's modules are reached as ``benchmark.<name>`` only
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != here]

    import torch

    from benchmark import cell

    spec = cell.resolve(args.workload)
    if not torch.cuda.is_available():
        print("[bench] no CUDA card: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec["chips"]:
        print(f"[bench] the cell needs {spec['chips']} cards, "
              f"{torch.cuda.device_count()} are visible", file=sys.stderr)
        return 2
    result = cell.run(spec, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"[bench] loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(f"[bench] correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"[bench] check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
