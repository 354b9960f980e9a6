"""Run reporting: the reference's CSV/Excel output contract.

Schemas (the compatibility contract, SURVEY.md §5 "Metrics/logging"):

* per-generation rows {Generation, Accuracy, Size_MB, FPR, CV, filters,
  kernel_size, use_bn, residual_blocks, fc_layers, use_dropout}
  (sa_nsga_penalty.py:606-612)
* periodic Pareto CSV every N generations (nsga_penalty.py:737-763)
* final Pareto CSV {Accuracy, Size_MB, FPR, **hparams}
  (nsga_penalty.py:800-821; MOBO adds CV, mobo_penalty.py:513-528)
* all-generations Excel workbook, one sheet per generation
  (nsga_penalty.py:785-788), plus a combined CSV.

Also emits a structured JSONL timing/progress log (the reference's ad-hoc
perf_counter prints, sa_nsga_penalty.py:537-542,602-603, made machine-
readable).

The JAX package writes these through pandas DataFrames. Here a table is a
list of row dicts written with the ``csv`` module in the same column order
and the same cell text as ``DataFrame.to_csv(index=False)`` (floats as
their shortest round-trip repr, booleans as True/False, "\\n" line ends),
so the files are byte-identical and the main path needs no pandas.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.records import Individual, generation_row, pareto_row

Rows = List[Dict]

# column types of the per-generation schema, for reading rows back on resume
_GENERATION_TYPES = {
    "Generation": int, "Accuracy": float, "Size_MB": float, "FPR": float,
    "CV": float, "filters": int, "kernel_size": int,
    "use_bn": lambda s: s == "True", "residual_blocks": int,
    "fc_layers": int, "use_dropout": lambda s: s == "True",
}


def write_csv(path: str, rows: Sequence[Dict]) -> None:
    """``pd.DataFrame(rows).to_csv(path, index=False)`` for rows that share
    one schema: header from the first row's keys, then one line per row."""
    header = list(rows[0]) if rows else []
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        for r in rows:
            w.writerow([r[k] for k in header])


class RunReporter:
    def __init__(
        self, output_dir: str, run_name: str, periodic_every: int = 5,
        resume: bool = False,
    ):
        self.dir = os.path.join(output_dir, run_name)
        os.makedirs(self.dir, exist_ok=True)
        self.run_name = run_name
        self.periodic_every = periodic_every
        self.gen_rows: List[Rows] = []
        self._gen_ids: List[int] = []
        # basenames of final artifacts THIS process wrote — the alias step
        # must not re-alias a previous run's stale files after a no-op run
        self.artifacts_written: set = set()
        self._combined_path = os.path.join(self.dir, "all_generations.csv")
        self._log_path = os.path.join(self.dir, "progress.jsonl")
        self._t0 = time.perf_counter()
        if resume:
            self._restore_generations()
        elif os.path.exists(self._combined_path):
            # fresh run into an existing dir: stale per-generation rows from
            # a previous run must not leak into this run's workbook
            os.unlink(self._combined_path)

    def _restore_generations(self) -> None:
        """Reload the per-generation rows flushed by a previous (crashed or
        completed) process so a resumed run's final ``all_generations``
        workbook still contains the pre-resume generations instead of
        clobbering them."""
        if not os.path.exists(self._combined_path):
            return
        try:
            with open(self._combined_path, newline="") as f:
                rows = [
                    {k: _GENERATION_TYPES[k](v) for k, v in r.items()}
                    for r in csv.DictReader(f)
                ]
        except (KeyError, TypeError, ValueError):
            # torn (a short row reads as None) or foreign file; the resumed
            # loop re-records its generations
            return
        for r in rows:
            gen = r["Generation"]
            if not self._gen_ids or self._gen_ids[-1] != gen:
                self.gen_rows.append([])
                self._gen_ids.append(gen)
            self.gen_rows[-1].append(r)

    # -- structured progress log ----------------------------------------------

    def log(self, event: str, **fields) -> None:
        rec = {"t": time.perf_counter() - self._t0, "event": event, **fields}
        with open(self._log_path, "a") as f:
            f.write(json.dumps(rec, default=float) + "\n")

    # -- per-generation -------------------------------------------------------

    def record_generation(self, gen: int, pop_data: Sequence[Individual]) -> Rows:
        rows = [generation_row(ind, gen) for ind in pop_data]
        if gen in self._gen_ids:
            # a crash landed between this generation's flush and its
            # checkpoint: the resumed loop re-runs it, superseding the row set
            cut = self._gen_ids.index(gen)
            del self.gen_rows[cut:]
            del self._gen_ids[cut:]
        self.gen_rows.append(rows)
        self._gen_ids.append(gen)
        self._flush_combined()
        feasibles = [ind for ind in pop_data if ind["CV"] == 0]
        self.log(
            "generation",
            gen=gen,
            frac_feasible=len(feasibles) / max(len(pop_data), 1),
            avg_cv=float(np.mean([ind["CV"] for ind in pop_data])) if pop_data else 0.0,
        )
        return rows

    def periodic_pareto(
        self,
        gen: int,
        pareto_set: Sequence[Individual],
        include_cv: bool = False,
        prefix: str = "pareto",
        force: bool = False,
    ) -> Optional[str]:
        """Write the every-N-generations Pareto CSV
        (nsga_penalty.py:738-763: filename pattern *_iteration_{gen+1}.csv)."""
        if not force and (gen + 1) % self.periodic_every != 0:
            return None
        path = os.path.join(self.dir, f"{prefix}_iteration_{gen + 1}.csv")
        write_csv(path, [pareto_row(ind, include_cv) for ind in pareto_set])
        return path

    # -- final artifacts ------------------------------------------------------

    def final_pareto(
        self, pareto_set: Sequence[Individual], include_cv: bool = False,
        filename: str = "final_pareto.csv",
    ) -> str:
        path = os.path.join(self.dir, filename)
        write_csv(path, [pareto_row(ind, include_cv) for ind in pareto_set])
        self.artifacts_written.add(filename)
        self.log("final_pareto", n=len(pareto_set), path=path)
        return path

    def all_generations(self, filename: str = "all_generations.xlsx") -> str:
        """Excel workbook with one sheet per generation — the literal
        artifact format of nsga_penalty.py:785-788 (sheet names ``Gen_{i}``),
        written by the stdlib writer (utils/xlsx.py); a combined CSV twin is
        emitted alongside for grep-ability."""
        from .xlsx import write_xlsx

        path = os.path.join(self.dir, filename)
        sheets = [
            (f"Gen_{i}", (list(rows[0]) if rows else [], [list(r.values()) for r in rows]))
            for i, rows in enumerate(self.gen_rows)
        ]
        write_xlsx(path, sheets or [("Gen_0", ([], []))])
        self.artifacts_written.add(filename)
        self._flush_combined()
        return path

    def _flush_combined(self) -> None:
        """Rewrite the combined per-generation CSV after every recorded
        generation — both the grep-able twin of the workbook and the durable
        store ``_restore_generations`` reloads on ``--resume``."""
        if self.gen_rows:
            write_csv(
                self._combined_path, [r for rows in self.gen_rows for r in rows]
            )


class StageTimer:
    """Context-manager stage timing feeding the reporter's JSONL log — the
    structured equivalent of the reference's bracketing perf_counter prints
    (sa_nsga_local.py:452-467)."""

    def __init__(self, reporter: Optional[RunReporter], stage: str, **fields):
        self.reporter = reporter
        self.stage = stage
        self.fields = fields
        self.seconds: float = 0.0

    def __enter__(self):
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t
        if self.reporter is not None:
            self.reporter.log("stage", stage=self.stage, seconds=self.seconds, **self.fields)
        return False
