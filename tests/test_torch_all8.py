"""The port's all-8 harness (cmoop_audio_processing_torch/examples/
run_all8.py) beyond the JAX script: ``--resume`` and its run record,
``--compaction-chunk``, the comparison of a replica with the JAX package's
five committed replicas and both exhaustive truths, ``compare_truths``
with several yardsticks per template, and the replica trained on the card
(cmoop_audio_processing_torch/examples/artifacts/all8_h100/) pinned."""

import dataclasses
import glob
import json
import math
import os
import shutil

import pytest
import torch

from cmoop_audio_processing_torch.cli import compare as tcompare
from cmoop_audio_processing_torch.core.config import Constraints
from cmoop_audio_processing_torch.examples import run_all8 as t_all8
from cmoop_audio_processing_torch.examples import run_exhaustive as t_exh
from cmoop_audio_processing_tpu.cli import compare as jcompare

# the test workers share the CPU's cores: one intra-op thread per worker
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
ARTIFACTS = os.path.join(ROOT, "cmoop_audio_processing_torch", "examples",
                         "artifacts")
CARD = os.path.join(ARTIFACTS, "all8_h100")
TRUTH = os.path.join(ARTIFACTS, "exhaustive_h100")
JAX_REPORTS = sorted(glob.glob(os.path.join(EXAMPLES,
                                            "compare_report_all8*.json")))
PRESETS = t_all8.STAGE1 + [p for _, p, _ in t_all8.METHODS]
# a tiny real CPU replica: pop 4, one generation, one epoch
ARGV = ["--pop", "4", "--gen", "1", "--epochs", "1", "--seed", "7",
        "--device", "cpu"]


def _read(path):
    with open(path) as f:
        return json.load(f)


def _tiny(build_cfg):
    """``build_cfg`` on 64 training and 32 validation rows of 16x9, with
    every genome feasible so that the fronts and the report are not
    empty."""
    loose = Constraints(0.0, 100.0, 1.0)

    def build(preset, args, seed_file=None):
        cfg = build_cfg(preset, args, seed_file)
        mobo = cfg.mobo and dataclasses.replace(cfg.mobo, constraints=loose)
        return cfg.replace(
            data=dataclasses.replace(cfg.data, synthetic_train=64,
                                     synthetic_eval=32, time_steps=16,
                                     features=9),
            search=dataclasses.replace(cfg.search, constraints=loose),
            mobo=mobo)
    return build


def _outputs(out):
    """The bytes of every front, Final.csv and the report in ``out``."""
    from cmoop_audio_processing_torch.core.config import get_preset

    paths = [t_all8.front_path(get_preset(p), str(out)) for p in PRESETS]
    paths += [os.path.join(out, "Final.csv"),
              os.path.join(out, "compare_report_all8.json")]
    with_bytes = {}
    for p in paths:
        with open(p, "rb") as f:
            with_bytes[os.path.relpath(p, out)] = f.read()
    return with_bytes


@pytest.fixture(scope="module")
def uncut(tmp_path_factory):
    out = tmp_path_factory.mktemp("uncut")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_all8, "build_cfg", _tiny(t_all8.build_cfg))
        t_all8.main(ARGV + ["--out", str(out)])
    return out


class Cut(Exception):
    pass


def test_resume_after_a_cut_equals_an_uncut_run(tmp_path, monkeypatch,
                                                 uncut, capsys):
    """A tiny real CPU run cut in its fifth search (its evaluator fails on
    its second evaluation), then resumed: the four finished searches are
    not run again, the fifth replays its first evaluation from the shared
    cache, and the fronts, ``Final.csv`` and the report are the uncut
    run's byte for byte."""
    monkeypatch.setattr(t_all8, "build_cfg", _tiny(t_all8.build_cfg))
    real_run = t_all8.run
    ran, cut = [], []

    def cutting(cfg, evaluator, **kw):
        ran.append(cfg.name)
        if len(ran) == 5 and not cut:
            evaluate = evaluator.evaluate

            def failing(genomes, seed=0):
                if cut:
                    raise Cut
                cut.append(len(genomes))
                return evaluate(genomes, seed)
            evaluator.evaluate = failing
        return real_run(cfg, evaluator, **kw)

    monkeypatch.setattr(t_all8, "run", cutting)
    out = tmp_path / "cut"
    with pytest.raises(Cut):
        t_all8.main(ARGV + ["--out", str(out)])
    record = _read(out / t_all8.RUN_RECORD)
    assert [e["preset"] for e in record["searches"]] == PRESETS[:4]
    caches = {p: open(p, "rb").read()
              for p in glob.glob(str(out / "fitness_cache_*.jsonl"))}
    assert caches
    ran.clear()
    t_all8.main(ARGV + ["--out", str(out), "--resume"])
    assert ran == PRESETS[4:]
    for p, before in caches.items():  # kept, and only appended to
        assert open(p, "rb").read().startswith(before), p
    entry = _read(out / t_all8.RUN_RECORD)["searches"][4]
    assert entry["preset"] == PRESETS[4] and entry["cache_hits"] >= cut[0]
    assert _outputs(out) == _outputs(uncut)
    uncut_rec = _read(uncut / t_all8.RUN_RECORD)
    assert [e["preset"] for e in uncut_rec["searches"]] == PRESETS
    for e in uncut_rec["searches"]:
        assert e["card"] is None and e["plan"]["compaction_chunk"] == -1
        assert e["trainings"] + e["cache_hits"] > 0, e["preset"]
    capsys.readouterr()


@pytest.mark.parametrize("chunk", [None, 0, 3])
def test_compaction_chunk_reaches_every_search(tmp_path, monkeypatch, chunk,
                                               capsys):
    """``--compaction-chunk N`` is every search's evaluator's
    ``compaction_chunk`` (each preset's own, -1, without it), and the run
    record's plan says so. The searches themselves are stubbed: each
    writes the JAX package's committed front of its preset."""
    seen = []
    real = t_all8.make_evaluator

    def recording(cfg, *a, **k):
        seen.append((cfg.name, cfg.train.compaction_chunk))
        return real(cfg, *a, **k)

    def stub_search(cfg, evaluator, **kw):
        front = t_all8.front_path(cfg, cfg.output_dir)
        os.makedirs(os.path.dirname(front), exist_ok=True)
        shutil.copyfile(os.path.join(EXAMPLES, "all8",
                                     f"front_{cfg.name}.csv"), front)
        return [], None

    monkeypatch.setattr(t_all8, "make_evaluator", recording)
    monkeypatch.setattr(t_all8, "run", stub_search)
    flag = [] if chunk is None else ["--compaction-chunk", str(chunk)]
    t_all8.main(["--fake-eval", "--pop", "4", "--gen", "1", "--seed", "11",
                 "--device", "cpu", "--out", str(tmp_path)] + flag)
    want = -1 if chunk is None else chunk
    assert seen == [(p, want) for p in PRESETS]
    record = _read(tmp_path / t_all8.RUN_RECORD)
    assert record["settings"]["compaction_chunk"] == chunk
    assert [e["plan"]["compaction_chunk"] for e in record["searches"]] == \
        [want] * len(PRESETS)
    capsys.readouterr()


def test_a_resume_under_another_plan_is_refused(tmp_path, monkeypatch,
                                                uncut, capsys):
    """By the run record while it is there; with the record gone, by the
    fitness cache, whose fingerprint holds the plan."""
    monkeypatch.setattr(t_all8, "build_cfg", _tiny(t_all8.build_cfg))
    out = tmp_path / "run"
    shutil.copytree(uncut, out)
    with pytest.raises(SystemExit, match="--resume refused"):
        t_all8.main(ARGV + ["--out", str(out), "--resume",
                            "--compaction-chunk", "0"])
    os.unlink(out / t_all8.RUN_RECORD)
    with pytest.raises(ValueError, match="different training config") as e:
        t_all8.main(ARGV + ["--out", str(out), "--resume",
                            "--compaction-chunk", "0"])
    assert "'compaction_chunk': -1" in str(e.value)
    assert "'compaction_chunk': 0" in str(e.value)
    capsys.readouterr()


@pytest.mark.parametrize("report", JAX_REPORTS, ids=os.path.basename)
def test_a_jax_replica_against_the_five(report):
    """One JAX replica fed as the card's report: every ratio lies in the
    JAX range (no flag), and the JAX test's per-seed properties hold."""
    assert len(JAX_REPORTS) == 5
    held = t_all8.hold_against_replicas(
        _read(report), {os.path.basename(p): _read(p) for p in JAX_REPORTS})
    assert held["ratio_flags"] == []
    assert held["ordering"]["all_hold"]
    assert set(held["ordering"]["jax_held"].values()) == {"5 of 5"}
    ratios = held["ratios_to_SA_NSGA-II"]
    assert sorted(ratios) == sorted(m for m, _, _ in t_all8.METHODS)
    assert ratios["SA_NSGA-II"]["igd"]["card"] == 1.0


# the comparison with one yardstick per template (seed 7 against JAX; B and
# A at seed 11), as first committed: the parts that rest on template A's
# yardstick
ONE_A_YARDSTICK = {
    "own_bound_A": {"median": 0.01099997353553772,
                    "p90": 0.09289999198913579},
    "within_own_bound_A": {"median": True, "p90": True},
    "gap_to_own_bound_A": {"median": -0.004999931573867798,
                           "p90": -0.036299987554550196},
}


def test_compare_truths_recomputes_the_committed_meta():
    """``compare_truths`` on the committed exhaustive_h100/ tables and
    meta.json's yardsticks (B at seed 11, A at seeds 11 and 23) gives its
    comparison exactly; with one yardstick per template it gives the
    comparison first committed with seed 11 alone: the same parts, and
    A's own bound from seed 11 alone."""
    meta = _read(os.path.join(TRUTH, "meta.json"))
    yards = [os.path.join(TRUTH, y) for y in meta["yardstick_runs"]]
    got = t_exh.compare_truths(TRUTH, os.path.join(EXAMPLES, "exhaustive"),
                               yards)
    assert json.dumps(got, sort_keys=True) == \
        json.dumps(meta["comparison"], sort_keys=True)
    one = [y for y in yards if not y.endswith("_seed23.csv")]
    assert len(one) == 2
    first = t_exh.compare_truths(
        TRUTH, os.path.join(EXAMPLES, "exhaustive"), one)
    assert sorted(first) == sorted(got)
    for k in first:
        if k in ONE_A_YARDSTICK:
            assert first[k] == ONE_A_YARDSTICK[k], k
        elif k == "yardstick":
            assert first[k]["B"] == got[k]["B"]
            assert first[k]["A"] == \
                got[k]["A"]["exhaustive_A_288_seed11.csv"]
        else:
            assert first[k] == got[k], k


def test_compare_truths_several_yardsticks_per_template(tmp_path):
    """Two template-A yardsticks, one made 0.2 lower on every other genome:
    each pair recorded by its table's name, and A's own bound from the
    larger median and the larger p90; template B's parts are those of one
    B yardstick."""
    seed11 = os.path.join(TRUTH, "exhaustive_A_288_seed11.csv")
    wider = tmp_path / "exhaustive_A_288_seed99.csv"
    with open(seed11) as f:
        lines = f.read().splitlines()
    col = lines[0].split(",").index("Accuracy")
    for i in range(1, len(lines), 2):  # every other genome 0.2 lower
        cells = lines[i].split(",")
        cells[col] = repr(float(cells[col]) - 0.2)
        lines[i] = ",".join(cells)
    wider.write_text("\n".join(lines) + "\n")
    b = os.path.join(TRUTH, "exhaustive_B_288_seed11.csv")
    one = t_exh.compare_truths(TRUTH, os.path.join(EXAMPLES, "exhaustive"),
                               [b, seed11])
    two = t_exh.compare_truths(TRUTH, os.path.join(EXAMPLES, "exhaustive"),
                               [b, seed11, str(wider)])
    pairs = two["yardstick"]["A"]
    assert sorted(pairs) == [os.path.basename(seed11), wider.name]
    assert pairs[os.path.basename(seed11)] == one["yardstick"]["A"]
    for q in ("median", "p90"):
        big = max(p["abs_d_accuracy"][q] for p in pairs.values())
        assert two["own_bound_A"][q] == 1.5 * big + 0.002
        assert two["own_bound_A"][q] >= one["own_bound_A"][q]
    assert pairs[wider.name]["abs_d_accuracy"]["p90"] > \
        one["yardstick"]["A"]["abs_d_accuracy"]["p90"]
    for k in ("bound_abs_d_accuracy", "within_bound", "gap_to_bound",
              "templates", "report", "mobo_ordering_holds"):
        assert two[k] == one[k], k
    assert two["yardstick"]["B"] == one["yardstick"]["B"]


def _assert_close(got, want, path=""):
    """Same keys, equal ints, strings and bools, floats within 1e-12."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{path}/{i}")
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=1e-12, abs_tol=0.0), \
            (path, got, want)
    else:
        assert got == want, (path, got, want)


def test_committed_card_replica_meta_recomputes():
    """all8_h100/meta.json is what ``compare_to_jax`` computes from the
    committed files: the card's replica, the JAX reports, both truths."""
    got = t_all8.compare_to_jax(CARD, EXAMPLES)
    _assert_close(got, _read(os.path.join(CARD, "meta.json")))
    assert got["settings"] == {"pop": 10, "gen": 8, "epochs": 30, "seed": 7,
                               "fake_eval": False, "device": "cuda",
                               "compaction_chunk": 0}
    fit = got["fitness_vs_exhaustive"]
    assert fit["dataset_fingerprint"]["equal"]
    for t in ("B", "A"):
        if t in fit:
            assert fit[t]["size_equal"] == fit[t]["genomes"] > 0, t


def test_committed_card_replica_record_names_the_card():
    record = _read(os.path.join(CARD, t_all8.RUN_RECORD))
    assert record["searches"]
    for e in record["searches"]:
        assert e["card"] == "NVIDIA H100 80GB HBM3", e["preset"]
        assert e["nvidia_smi"].startswith("NVIDIA H100 80GB HBM3, ")
        assert e["plan"]["compaction_chunk"] == 0
        assert os.path.exists(os.path.join(CARD, f"front_{e['preset']}.csv"))


def test_compare_cli_on_the_card_fronts_equals_jax(tmp_path, capsys):
    """The port's ``cli.compare`` on the committed card fronts prints and
    writes the JAX package's ``cli/compare.py`` report on the same files."""
    names = {p: m for m, p, _ in t_all8.METHODS}
    fronts = [f"--front={names[p]}={os.path.join(CARD, f'front_{p}.csv')}"
              for _, p, _ in t_all8.METHODS
              if os.path.exists(os.path.join(CARD, f"front_{p}.csv"))]
    assert fronts
    outs = {}
    for tag, main in (("jax", jcompare.main), ("torch", tcompare.main)):
        d = tmp_path / tag
        d.mkdir()
        assert main(fronts + ["--out", str(d / "r.json")]) == 0
        outs[tag] = capsys.readouterr().out.replace(str(d), "<out>")
    assert outs["torch"] == outs["jax"]
    assert (tmp_path / "torch" / "r.json").read_bytes() == \
        (tmp_path / "jax" / "r.json").read_bytes()
