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

The port's copy of cmoop_audio_processing_tpu/cli/psi_merge.py, without
pandas: tables are read by utils/xlsx.read_rows (pandas' names and values)
and merged as row lists, and the output has the bytes pandas writes, so the
merge runs where pandas is not installed.
"""

from __future__ import annotations

import argparse
import csv
import sys
from typing import Dict, List

from ..core.genome import GENE_ORDER

REQUIRED = ["Accuracy", "Size_MB", "FPR", *GENE_ORDER]


def merge(paths, dedup: bool = False, limit: int | None = None,
          interleave: bool = False) -> List[Dict]:
    """Concatenate stage-1 fronts into the stage-2 seed table.

    ``interleave`` picks rows round-robin across the fronts instead of
    front-by-front, so a ``--limit`` keeps members of every bi-objective
    front rather than exhausting the first file (the reference's manual
    merge is unspecified; balanced selection keeps the 2-stage seed diverse
    when the stage-2 population is smaller than the union). Returns the
    rows as dicts of the ``REQUIRED`` columns."""
    from ..utils.xlsx import UnreadableTableError, read_rows

    frames = []
    for path in paths:
        try:
            columns, rows = read_rows(path)
        except UnreadableTableError:
            # Zero-byte/corrupt workbook, torn sheet XML, empty CSV, or any
            # other parse error — read_rows normalizes them all,
            # so one bad stage-1 export degrades to a skip, not a crash
            # (a missing file still raises: that is a caller typo, not a
            # degraded export).
            columns = []
        if not columns:
            # An infeasible stage-1 run exports an empty front (the reference
            # warns and continues, nsga_penalty.py:768-770); skip it.
            print(f"psi-merge: {path} is empty (no feasible front), skipping",
                  file=sys.stderr)
            continue
        missing = [c for c in REQUIRED if c not in columns]
        if missing:
            raise ValueError(f"{path} missing columns {missing}")
        if not rows:
            print(f"psi-merge: {path} has no rows, skipping", file=sys.stderr)
            continue
        at = [columns.index(c) for c in REQUIRED]
        frames.append([dict(zip(REQUIRED, (r[j] for j in at))) for r in rows])
    if not frames:
        raise ValueError(f"no non-empty stage-1 fronts among {list(paths)}")
    if interleave:
        out = [f[i] for i in range(max(len(f) for f in frames))
               for f in frames if i < len(f)]
    else:
        out = [r for f in frames for r in f]
    if dedup:
        seen = set()
        kept = []
        for r in out:
            key = tuple(r[g] for g in GENE_ORDER)
            if key not in seen:
                seen.add(key)
                kept.append(r)
        out = kept
    if limit is not None:
        out = out[:limit]
    return out


def write_table(path: str, rows: List[Dict]) -> None:
    """The merged rows as ``DataFrame.to_csv(index=False)`` or, for an
    ``.xlsx``/``.xls`` name, a workbook (utils/xlsx.py) would hold them. A
    missing cell (NaN) is written empty, as pandas writes it."""
    body = [[r[c] for c in REQUIRED] for r in rows]
    if path.endswith((".xlsx", ".xls")):
        from ..utils.xlsx import write_xlsx

        # the stage-2 seed is a REAL Final.xlsx (psi_init_sa_nsga.py:365)
        write_xlsx(path, [("Sheet1", (list(REQUIRED), body))])
        return
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(REQUIRED)
        for r in body:
            w.writerow(["" if v != v else v for v in r])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cmoop-torch-psi-merge")
    p.add_argument("fronts", nargs="+", help="stage-1 final Pareto files")
    p.add_argument("--out", required=True)
    p.add_argument("--dedup", action="store_true")
    p.add_argument("--limit", type=int)
    p.add_argument("--interleave", action="store_true",
                   help="pick rows round-robin across fronts (balanced seed)")
    args = p.parse_args(argv)

    rows = merge(args.fronts, args.dedup, args.limit, args.interleave)
    write_table(args.out, rows)
    print(f"merged {len(rows)} stage-1 solutions -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
