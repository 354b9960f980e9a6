"""The port's validation scripts (cmoop_audio_processing_torch/examples/)
against the JAX package's scripts under examples/: the exhaustive sweep's
tables and report, the two corpus makers' wav trees and the all-8
harness's stage 1, byte for byte; the comparison of two sweeps' tables;
and the real-evaluator path of the exhaustive sweep (one template at a
time, its run record and its resumable fitness cache) at a tiny size."""

import argparse
import csv
import importlib.util
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from cmoop_audio_processing_torch.core.config import Constraints, DataConfig
from cmoop_audio_processing_torch.data import pipeline as t_pipeline
from cmoop_audio_processing_torch.examples import make_birdclef_corpus as t_bird
from cmoop_audio_processing_torch.examples import make_kws_corpus as t_kws
from cmoop_audio_processing_torch.examples import run_all8 as t_all8
from cmoop_audio_processing_torch.examples import run_exhaustive as t_exh
from cmoop_audio_processing_torch.utils.reporting import write_csv

# the test workers share the CPU's cores: one intra-op thread per worker
# keeps PyTorch's thread pool from oversubscribing them
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
COMMITTED = os.path.join(EXAMPLES, "exhaustive")
# examples/exhaustive/exhaustive_report.json scores the all-8 fronts as they
# were when it was written; examples/all8/ was regenerated afterwards
# (common random numbers), so its report is pinned against those fronts
REPORT_FRONTS = os.path.join(ROOT, "tests", "data",
                             "all8_fronts_of_exhaustive_report")


def _jax_script(name):
    """examples/<name>.py, the JAX package's script, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_examples_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_close(got, want, rel=1e-12, path=""):
    """Same keys, equal ints, strings and bools, floats within ``rel``."""
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_close(got[k], want[k], rel, f"{path}/{k}")
    elif isinstance(want, float):
        assert isinstance(got, float) and math.isclose(
            got, want, rel_tol=rel, abs_tol=0.0), (path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _read(path):
    with open(path) as f:
        return json.load(f)


def test_fake_sweep_tables_and_report_equal_jax(tmp_path, capsys):
    """``--fake-eval``: the closed-form evaluator of both packages gives
    byte-identical tables and the same report (floats within 1e-12: either
    package may sum hypervolumes in its native core)."""
    assert _jax_script("run_exhaustive").main(
        ["--fake-eval", "--out", str(tmp_path / "jax")]) == 0
    assert t_exh.main(["--fake-eval", "--device", "cpu",
                       "--out", str(tmp_path / "torch")]) == 0
    for t in ("A", "B"):
        name = f"exhaustive_{t}_288.csv"
        assert (tmp_path / "torch" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    _assert_close(_read(tmp_path / "torch" / "exhaustive_report.json"),
                  _read(tmp_path / "jax" / "exhaustive_report.json"))
    assert not (tmp_path / "torch" / "exhaustive_B_run.json").exists()
    capsys.readouterr()


@pytest.mark.parametrize("fronts", ["of_the_report", "current_all8"])
def test_report_only_on_the_committed_tables(tmp_path, capsys, fronts):
    """``--report-only`` on the committed tables: against the all-8 fronts
    the committed report scored, it reproduces the committed report; against
    the current examples/all8/ fronts, it equals the JAX script's
    ``--report-only`` (floats within 1e-12)."""
    for tag in ("torch", "jax"):
        (tmp_path / tag).mkdir()
        for t in ("A", "B"):
            shutil.copy(os.path.join(COMMITTED, f"exhaustive_{t}_288.csv"),
                        tmp_path / tag)
    all8 = REPORT_FRONTS if fronts == "of_the_report" else os.path.join(
        EXAMPLES, "all8")
    assert t_exh.main(["--report-only", "--out", str(tmp_path / "torch"),
                       "--all8-dir", all8]) == 0
    got = _read(tmp_path / "torch" / "exhaustive_report.json")
    if fronts == "of_the_report":
        want = _read(os.path.join(COMMITTED, "exhaustive_report.json"))
    else:
        assert _jax_script("run_exhaustive").main(
            ["--report-only", "--out", str(tmp_path / "jax")]) == 0
        want = _read(tmp_path / "jax" / "exhaustive_report.json")
    _assert_close(got, want)
    capsys.readouterr()


@pytest.mark.parametrize("name", ["make_kws_corpus", "make_birdclef_corpus"])
def test_corpus_makers_write_the_jax_scripts_wavs(tmp_path, monkeypatch,
                                                  capsys, name):
    """Two clips a class from each package's corpus maker: the same files,
    byte for byte."""
    port = {"make_kws_corpus": t_kws, "make_birdclef_corpus": t_bird}[name]
    for tag, main in (("jax", _jax_script(name).main), ("torch", port.main)):
        monkeypatch.setattr("sys.argv", [name, str(tmp_path / tag), "2"])
        main()
    trees = {}
    for tag in ("jax", "torch"):
        base = tmp_path / tag
        trees[tag] = sorted(
            os.path.relpath(os.path.join(d, f), base)
            for d, _, files in os.walk(base) for f in files)
    n_classes = len(t_kws.WORDS) if name == "make_kws_corpus" else len(
        t_bird.GRAMMAR)
    assert trees["torch"] == trees["jax"] and len(trees["jax"]) == 2 * n_classes
    for rel in trees["jax"]:
        assert (tmp_path / "torch" / rel).read_bytes() == \
            (tmp_path / "jax" / rel).read_bytes(), rel
    capsys.readouterr()


def test_all8_stage1_equals_jax_and_the_harness_reaches_its_verdict(
        tmp_path, capsys):
    """``run_all8 --fake-eval --pop 4 --gen 1`` (seed 11, where every
    method's front holds a feasible genome): the three stage-1 fronts and
    the merged ``Final.csv`` equal the JAX harness's byte for byte (its
    stage 1 run through its own ``build_cfg``/``run_one``/``psi_merge``);
    the port's whole harness writes the compare report for all 8 methods
    and exits with the ordering verdict that report gives. The SA and MOBO
    fronts are not compared: their GP restarts draw from other streams."""
    out = tmp_path / "torch"
    rc = t_all8.main(["--fake-eval", "--pop", "4", "--gen", "1", "--seed",
                      "11", "--device", "cpu", "--out", str(out)])
    jall8 = _jax_script("run_all8")
    args = argparse.Namespace(out=str(tmp_path / "jax"), pop=4, gen=1,
                              epochs=30, seed=11, fake_eval=True, cpu=False)
    fronts = [jall8.run_one(jall8.build_cfg(s, args), args)
              for s in jall8.STAGE1]
    jall8.psi_merge.merge(fronts, dedup=True, limit=4, interleave=True).to_csv(
        tmp_path / "jax" / "Final.csv", index=False)
    for preset in t_all8.STAGE1:
        rel = os.path.join(preset, "final_pareto.csv")
        assert (out / rel).read_bytes() == \
            (tmp_path / "jax" / rel).read_bytes(), rel
    assert (out / "Final.csv").read_bytes() == \
        (tmp_path / "jax" / "Final.csv").read_bytes()
    rep = _read(out / "compare_report_all8.json")
    assert sorted(rep["hypervolume"]) == sorted(m for m, _, _ in t_all8.METHODS)
    holds = all(
        rep["hypervolume"][m] >= rep["hypervolume"]["SA_NSGA-II"]
        and rep["igd"][m] <= rep["igd"]["SA_NSGA-II"]
        for m in ("2_stage_SA_NSGA-II", "2_stage_SA-NSGA-II_LS",
                  "2_stage_MOBO"))
    assert rc == (0 if holds else 1)
    capsys.readouterr()


GENES = ["filters", "kernel_size", "use_bn", "residual_blocks", "fc_layers",
         "use_dropout"]


def _table(path, accs, fprs, sizes, front):
    """A hand-made sweep table over four genomes of the (16, 3, 1) bucket."""
    rows = []
    for i, (a, f, s, t) in enumerate(zip(accs, fprs, sizes, front)):
        g = dict(zip(GENES, (16, 3, bool(i % 2), 1, 1 + i // 2, False)))
        rows.append({"Accuracy": a, "Size_MB": s, "FPR": f, "CV": 0.0, **g,
                     "feasible": True, "on_true_front": t})
    write_csv(str(path), rows)


def test_compare_tables_on_hand_made_tables(tmp_path):
    """|d accuracy| [0, 0.004, 0.02, 0.5]: median 0.012, p90 0.356 (linear
    between the third and fourth), max 0.5, two of four within 0.01; |d
    FPR| [0.01, 0, 0, 0]; one size differs; one failed training (accuracy
    0.4) in the first table, none in the second; fronts {0, 1} and {1, 2}
    share one genome. Against a yardstick whose median and p90 are 0.01,
    the bound is 0.017 for both: B's median 0.012 is within it, its p90
    0.356 is not."""
    _table(tmp_path / "got.csv", [0.9, 0.904, 0.92, 0.4],
           [0.05, 0.04, 0.03, 0.02], [0.5, 0.25, 0.125, 1.0],
           [True, True, False, False])
    _table(tmp_path / "want.csv", [0.9, 0.9, 0.9, 0.9],
           [0.04, 0.04, 0.03, 0.02], [0.5, 0.25, 0.125, 1.0000001],
           [False, True, True, False])
    c = t_exh.compare_tables(str(tmp_path / "got.csv"),
                             str(tmp_path / "want.csv"))
    assert c["matched"] == c["genomes"] == c["genomes_ref"] == 4
    assert c["size_equal"] == 3
    np.testing.assert_allclose(
        [c["abs_d_accuracy"][q] for q in ("median", "p90", "max")],
        [0.012, 0.356, 0.5], rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        [c["abs_d_fpr"][q] for q in ("median", "p90", "max")],
        [0.0, 0.007, 0.01], rtol=0, atol=1e-12)
    assert c["share_within_0.01_accuracy"] == 0.5
    assert (c["failed"], c["failed_ref"], c["failed_both"]) == (1, 0, 0)
    assert (c["true_front"], c["true_front_ref"],
            c["true_front_shared"]) == (2, 2, 1)

    # compare_truths over both templates, with a yardstick table for B
    for tag, src in (("run", "got.csv"), ("ref", "want.csv")):
        (tmp_path / tag).mkdir()
        for t in ("A", "B"):
            shutil.copy(tmp_path / src, tmp_path / tag / f"exhaustive_{t}_288.csv")
    yard = tmp_path / "exhaustive_B_288_seed11.csv"
    _table(yard, [0.91, 0.914, 0.93, 0.41], [0.05, 0.04, 0.03, 0.02],
           [0.5, 0.25, 0.125, 1.0], [True, True, False, False])
    cmp = t_exh.compare_truths(str(tmp_path / "run"), str(tmp_path / "ref"),
                               [str(yard)])
    assert sorted(cmp["templates"]) == ["A", "B"]
    assert cmp["templates"]["B"] == c
    for q in ("median", "p90"):
        assert math.isclose(cmp["bound_abs_d_accuracy"][q], 0.017,
                            abs_tol=1e-12)
    assert cmp["within_bound"]["B"] == {"median": True, "p90": False}
    assert math.isclose(cmp["gap_to_bound"]["B"]["p90"], 0.339, abs_tol=1e-12)
    assert "own_bound_A" not in cmp  # no template-A yardstick
    # both truths score the committed all-8 fronts, method by method
    assert sorted(cmp["report"]) == sorted(
        n.split("=")[0] for _, fronts in t_exh.FAMILIES.values() for n in fronts)
    assert sorted(cmp["mobo_ordering_holds"]) == ["ref", "run"]

    # write_meta: the run records found beside the tables, and a table of
    # another launch plan held against this run's table of its template
    with open(tmp_path / "run" / "exhaustive_B_run.json", "w") as f:
        json.dump({"launches": 1}, f)
    meta = t_exh.write_meta(str(tmp_path / "run"), str(tmp_path / "ref"),
                            [str(yard)], [str(yard)])
    assert meta == _read(tmp_path / "run" / "meta.json")
    assert meta["runs"] == {"B": {"launches": 1}, "A": None}
    assert meta["yardstick_runs"] == {yard.name: None}
    assert meta["comparison"] == json.loads(json.dumps(cmp))
    assert meta["beside"][yard.name]["against_this_run"] == \
        t_exh.compare_tables(str(yard),
                             str(tmp_path / "run" / "exhaustive_B_288.csv"))


def test_real_sweep_one_template_at_a_time_resumes_from_its_cache(
        tmp_path, monkeypatch, capsys):
    """The real evaluator at a tiny size (four genomes, 64 rows of 8x8, one
    epoch, on the CPU): ``--template B`` writes B's table and run record
    and no report; ``--template A`` then trains A, reads B's table and
    writes the report; a rerun of B replays its fitness cache (nothing
    trained) into the same table bytes. The constraints admit every genome,
    so that one epoch on 64 rows still gives a truth to score."""
    tiny = DataConfig(num_classes=10, synthetic_train=64, synthetic_eval=32,
                      time_steps=8, features=8)
    real = t_pipeline.prepare_dataset
    monkeypatch.setattr(t_pipeline, "prepare_dataset", lambda cfg: real(tiny))
    four = [g for g in t_exh.all_genomes()
            if (g["filters"], g["kernel_size"], g["residual_blocks"],
                g["fc_layers"]) == (16, 3, 1, 1)]
    monkeypatch.setattr(t_exh, "all_genomes", lambda: list(four))
    monkeypatch.setattr(t_exh, "CONSTRAINTS", Constraints(0.0, 2.5, 1.0))
    out, cache = tmp_path / "out", tmp_path / "cache"
    base = ["--device", "cpu", "--epochs", "1", "--out", str(out),
            "--fitness-cache", str(cache)]
    assert t_exh.main(base + ["--template", "B"]) == 0
    assert not (out / "exhaustive_report.json").exists()
    table_b = (out / "exhaustive_B_288.csv").read_bytes()
    with open(out / "exhaustive_B_288.csv") as f:
        assert len(list(csv.DictReader(f))) == 4
    rec = _read(out / "exhaustive_B_run.json")
    assert (rec["trained"], rec["cache_hits"], rec["device"]) == (4, 0, "cpu")
    assert rec["launches"] == len(rec["lanes"]) >= 1
    assert rec["card"] is None and rec["trainings_per_h"] > 0

    assert t_exh.main(base + ["--template", "A"]) == 0
    report = _read(out / "exhaustive_report.json")
    assert report["epochs"] == 1 and sorted(report["per_template_front_size"]) \
        == ["A", "B"]
    assert (cache / "fitness_cache_A.jsonl").exists()

    assert t_exh.main(base + ["--template", "B"]) == 0
    rec = _read(out / "exhaustive_B_run.json")
    assert (rec["trained"], rec["cache_hits"], rec["launches"]) == (0, 4, 0)
    assert (out / "exhaustive_B_288.csv").read_bytes() == table_b
    capsys.readouterr()
