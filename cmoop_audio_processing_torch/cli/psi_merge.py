"""PSI stage-1 merge: combine bi-objective Pareto fronts into the stage-2
seed file.

The reference's two-stage (PSI) pipeline runs three bi-objective NSGA-II
scripts (acc_size / acc_fpr / size_fpr) and then MANUALLY merges their
exported fronts into Final.xlsx, which the stage-2 scripts read
(SURVEY.md §3.4: "manual merge into Final.xlsx — NOT in repo"). This command
automates that missing step:

    python -m cmoop_audio_processing_torch.cli.psi_merge \
        results/acc_size_nsga_1/final_pareto.csv \
        results/acc_fpr_nsga_1/final_pareto.csv \
        results/size_fpr_nsga_1/final_pareto.csv \
        --out Final.csv [--dedup] [--limit 15]

The merged file keeps the stage-2 loader's expected columns (Accuracy,
Size_MB, FPR + the six genome columns; psi_init_sa_nsga.py:365-379).
``--dedup`` drops duplicate genomes keeping the first occurrence; ``--limit``
truncates to the stage-2 population size. A ``.xlsx`` output filename
produces a real workbook even without an Excel engine (utils/xlsx.py).

A copy of cmoop_audio_processing_tpu/cli/psi_merge.py. It is an offline tool
that needs pandas, imported inside its functions, so the rest of the package
imports without it.
"""

from __future__ import annotations

import argparse
import sys

from ..core.genome import GENE_ORDER

REQUIRED = ["Accuracy", "Size_MB", "FPR", *GENE_ORDER]


def merge(paths, dedup: bool = False, limit: int | None = None,
          interleave: bool = False):
    """Concatenate stage-1 fronts into the stage-2 seed table.

    ``interleave`` picks rows round-robin across the fronts instead of
    front-by-front, so a ``--limit`` keeps members of every bi-objective
    front rather than exhausting the first file (the reference's manual
    merge is unspecified; balanced selection keeps the 2-stage seed diverse
    when the stage-2 population is smaller than the union). Returns a
    pandas DataFrame."""
    import pandas as pd

    from ..utils.xlsx import UnreadableTableError, read_rows

    frames = []
    for path in paths:
        try:
            columns, rows = read_rows(path)
            df = pd.DataFrame(rows, columns=columns)
        except UnreadableTableError:
            # Zero-byte/corrupt workbook, torn sheet XML, empty CSV, or any
            # other parse error — read_rows normalizes them all,
            # so one bad stage-1 export degrades to a skip, not a crash
            # (a missing file still raises: that is a caller typo, not a
            # degraded export).
            df = None
        if df is None or len(df.columns) == 0:
            # An infeasible stage-1 run exports an empty front (the reference
            # warns and continues, nsga_penalty.py:768-770); skip it.
            print(f"psi-merge: {path} is empty (no feasible front), skipping",
                  file=sys.stderr)
            continue
        missing = [c for c in REQUIRED if c not in df.columns]
        if missing:
            raise ValueError(f"{path} missing columns {missing}")
        if len(df) == 0:
            print(f"psi-merge: {path} has no rows, skipping", file=sys.stderr)
            continue
        frames.append(df[REQUIRED])
    if not frames:
        raise ValueError(f"no non-empty stage-1 fronts among {list(paths)}")
    if interleave:
        order = []
        for i in range(max(len(f) for f in frames)):
            for f in frames:
                if i < len(f):
                    order.append(f.iloc[i])
        out = pd.DataFrame(order).reset_index(drop=True)
    else:
        out = pd.concat(frames, ignore_index=True)
    if dedup:
        out = out.drop_duplicates(subset=list(GENE_ORDER), keep="first")
    if limit is not None:
        out = out.head(limit)
    return out.reset_index(drop=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cmoop-torch-psi-merge")
    p.add_argument("fronts", nargs="+", help="stage-1 final Pareto files")
    p.add_argument("--out", required=True)
    p.add_argument("--dedup", action="store_true")
    p.add_argument("--limit", type=int)
    p.add_argument("--interleave", action="store_true",
                   help="pick rows round-robin across fronts (balanced seed)")
    args = p.parse_args(argv)

    df = merge(args.fronts, args.dedup, args.limit, args.interleave)
    if args.out.endswith((".xlsx", ".xls")):
        try:
            df.to_excel(args.out, index=False)
        except ImportError:
            # no Excel engine installed: stdlib OOXML writer, so the
            # stage-2 seed is a REAL Final.xlsx (psi_init_sa_nsga.py:365)
            from ..utils.xlsx import write_xlsx

            write_xlsx(args.out, [("Sheet1", (
                list(df.columns),
                [list(t) for t in df.itertuples(index=False, name=None)],
            ))])
    else:
        df.to_csv(args.out, index=False)
    print(f"merged {len(df)} stage-1 solutions -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
