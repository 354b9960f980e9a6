"""Offline Pareto-front comparison CLI — the reference's compare.ipynb as a
command.

    python -m cmoop_audio_processing_torch.cli.compare \
        --front SA_NSGA-II=results/sa_nsga_penalty/final_pareto.csv \
        --front MOBO=results/mobo_penalty/mobo_pareto.csv \
        --out report.json [--plots report_dir]

Loads named fronts (CSV or Excel with Accuracy/Size_MB/FPR columns,
compare.ipynb cell 1 "Load each front" semantics), computes HV (shared
reference point = per-axis union max + 1e-3), GD, IGD, Spread and pairwise
Coverage, prints the same report lines, and optionally renders the 3D
scatter + 2D projection plots. --rank additionally emits the Tchebycheff
ranking ("Tchebycheff s_rank.ipynb") for each front.

A copy of cmoop_audio_processing_tpu/cli/compare.py that runs without
pandas: fronts are read by utils/xlsx.read_rows (the csv module, or the
stdlib xlsx reader) and the rankings written by the csv module and the
stdlib xlsx writer. The report lines and the JSON report are the JAX
command's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

import numpy as np


def load_front(path: str) -> np.ndarray:
    # read_rows: no pandas; every parse failure normalized to one loud
    # UnreadableTableError
    from ..utils.xlsx import read_rows

    columns, rows = read_rows(path)
    cols = ["Accuracy", "Size_MB", "FPR"]
    missing = [c for c in cols if c not in columns]
    if missing:
        raise ValueError(f"{path} missing columns {missing}")
    idx = [columns.index(c) for c in cols]
    return np.array([[r[i] for i in idx] for r in rows],
                    dtype=np.float64).reshape(-1, 3)


def render_plots(fronts: Dict[str, np.ndarray], out_dir: str) -> None:
    """3D scatter (size, FPR, acc) + 2D projection colored by FPR
    (compare.ipynb cell 1 sections 11-12)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    markers = ["o", "^", "s", "d", "+", "*", "p", "h", "x", "v"]

    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection="3d")
    for i, (name, arr) in enumerate(fronts.items()):
        ax.scatter(
            arr[:, 1], arr[:, 2], arr[:, 0],
            label=name, marker=markers[i % len(markers)], s=80,
            edgecolor="k", alpha=0.8,
        )
    ax.set_xlabel("Model Size (MB)")
    ax.set_ylabel("FPR")
    ax.set_zlabel("Accuracy")
    ax.set_title("3D Pareto Front Comparison")
    ax.legend()
    ax.view_init(elev=20, azim=45)
    plt.tight_layout()
    fig.savefig(os.path.join(out_dir, "pareto_3d.png"))
    plt.close(fig)

    fig2 = plt.figure(figsize=(9, 7))
    sc = None
    for i, (name, arr) in enumerate(fronts.items()):
        sc = plt.scatter(
            arr[:, 1], arr[:, 0], c=arr[:, 2], cmap="viridis",
            label=name, marker=markers[i % len(markers)], edgecolor="k",
            s=100, alpha=0.8,
        )
    if sc is not None:
        plt.colorbar(sc, label="False Positive Rate (FPR)")
    plt.xlabel("Model Size (MB)")
    plt.ylabel("Accuracy")
    plt.title("2D Pareto Projection (Accuracy vs. Size)")
    plt.legend()
    plt.grid(True, linestyle="--", alpha=0.6)
    plt.tight_layout()
    fig2.savefig(os.path.join(out_dir, "pareto_2d.png"))
    plt.close(fig2)


def main(argv=None) -> int:
    from ..metrics.quality import compare_fronts
    from ..metrics.tchebycheff import rank_front

    p = argparse.ArgumentParser(prog="cmoop-torch-compare")
    p.add_argument(
        "--front", action="append", required=True, metavar="NAME=PATH",
        help="named front file (repeatable)",
    )
    p.add_argument("--out", help="write the full JSON report here")
    p.add_argument("--plots", help="directory for 3D/2D Pareto plots")
    p.add_argument("--rank", action="store_true",
                   help="emit Tchebycheff rankings per front")
    args = p.parse_args(argv)

    fronts: Dict[str, np.ndarray] = {}
    for spec in args.front:
        name, _, path = spec.partition("=")
        if not path:
            raise SystemExit(f"--front expects NAME=PATH, got {spec!r}")
        try:
            arr = load_front(path)
            if len(arr) == 0:
                print(f"Warning: '{path}' contains no solutions. Skipping '{name}'.")
                continue
            fronts[name] = arr
        except FileNotFoundError:
            print(f"Warning: file '{path}' not found. Skipping method '{name}'.")
        except Exception as e:  # unreadable/empty/missing-column files
            print(f"Error loading {path}: {e}")
    if not fronts:
        print("No valid data loaded. Exiting.")
        return 1

    report = compare_fronts(fronts)

    print("--- Performance Metrics ---")
    for name in fronts:
        print(f"Hypervolume ({name}): {report['hypervolume'][name]:.6f}")
    print("-" * 25)
    for name in fronts:
        print(f"GD ({name}):  {report['gd'][name]:.6f}")
        print(f"IGD({name}): {report['igd'][name]:.6f}")
    print("-" * 25)
    for name in fronts:
        print(f"Spread ({name}): {report['spread'][name]:.6f}")
    print("-" * 25)
    print("Coverage (C-Metric):")
    for key, val in report["coverage"].items():
        print(f"  {key}: {val:.3f}")

    if args.rank:
        # rankings land next to the report (or CWD when no --out given)
        rank_dir = os.path.dirname(os.path.abspath(args.out)) if args.out else "."
        from ..utils.reporting import write_csv
        from ..utils.xlsx import write_xlsx

        for name, arr in fronts.items():
            ranked = rank_front([
                {"Accuracy": float(a), "Size_MB": float(s), "FPR": float(f)}
                for a, s, f in arr
            ])
            out_path = os.path.join(rank_dir, f"ranked_{name}.csv")
            write_csv(out_path, ranked)
            # the reference notebook's literal artifact is an .xlsx
            # (Tchebycheff s_rank.ipynb: output_file = "ranked_MOBO.xlsx")
            xlsx_path = os.path.join(rank_dir, f"ranked_{name}.xlsx")
            write_xlsx(xlsx_path, {"Sheet1": (
                list(ranked[0]), [list(r.values()) for r in ranked])})
            print(f"Tchebycheff ranking for {name} -> {out_path} (+ .xlsx)")

    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    if args.plots:
        render_plots(fronts, args.plots)
    return 0


if __name__ == "__main__":
    sys.exit(main())
