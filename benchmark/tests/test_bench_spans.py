"""The readers of the program's spans (``benchmark/spans.py`` and the five
``metrics/`` readers that use it) on hand-made spans, gaps and device
operations with known overlaps; each finds nothing without spans."""

import numpy as np
import pytest

from benchmark import cell, spans

READERS = ("trainer.step_host_ms", "trainer.init_share",
           "engine.host_reads_per_call", "trainer.step_idle_share",
           "trainer.validation_busy_share")
MS = 1_000_000  # ns


def _span(name, i, parent, start, end, **attrs):
    return {"name": name, "id": i, "parent": parent, "call": 0,
            "start_ns": start * MS, "end_ns": end * MS, "attrs": attrs}


def _tree():
    """One call of 1000 ms: init 50 ms, three steps (100, 100, 120 ms), an
    epoch's validation and the final one, four host reads."""
    return [
        _span("evaluator.call", 0, None, 0, 1000, n_genomes=16, seed=1),
        _span("evaluator.launch", 1, 0, 5, 995, pop=16),
        _span("trainer.init", 2, 1, 10, 60, pop=16),
        _span("engine.host_read", 3, 1, 60, 62, what="stopped"),
        _span("trainer.step", 4, 1, 100, 200, epoch=0),
        _span("trainer.step", 5, 1, 200, 300, epoch=0),
        _span("trainer.step", 6, 1, 310, 430, epoch=0),
        _span("trainer.validate", 7, 1, 600, 700, final=False),
        _span("trainer.validate", 8, 1, 800, 900, final=True),
        _span("engine.host_read", 9, 1, 950, 951, what="acc_last"),
        _span("engine.host_read", 10, 1, 951, 952, what="fpr"),
        _span("engine.host_read", 11, 1, 952, 953, what="epochs_ran"),
    ]


def _ctx():
    gaps = np.array([[50, 120], [250, 260], [400, 500], [990, 1000]],
                    np.int64) * MS
    # (start, end, launch): two launched in the epoch's validation (30 +
    # 20 ms), one in the final validation (10 ms), one in a step (50 ms),
    # one with no matched launch (90 ms)
    ops = np.array([[615, 645, 610], [660, 680, 650], [810, 820, 805],
                    [130, 180, 120], [520, 610, -1]], np.int64) * MS
    return {"trace": {"device_ops": 1}, "spans": {
        "recorded": _tree(), "profiled": _tree(),
        "device": {"window": (0, 1000 * MS), "gaps": gaps, "ops": ops}}}


def _read(name, ctx):
    return cell.reader("metrics", name)(ctx)


def test_readers_on_known_spans():
    ctx = _ctx()
    assert _read("trainer.step_host_ms", ctx) == 100.0
    assert _read("trainer.init_share", ctx) == pytest.approx(5.0)
    assert _read("engine.host_reads_per_call", ctx) == 4
    # steps overlap the gaps by 0 + 20 (100-120) + 0, 10 (250-260), 30
    # (400-430): 60 of 1000 ms
    assert _read("trainer.step_idle_share", ctx) == pytest.approx(6.0)
    # 30 + 20 + 10 of 30 + 20 + 10 + 50 + 90 ms
    assert _read("trainer.validation_busy_share", ctx) == pytest.approx(
        100 * 60 / 200)


def test_readers_find_nothing_without_spans(monkeypatch):
    for ctx in ({"trace": {"device_ops": 1}, "spans": None},
                {"trace": None}):
        for name in READERS:
            assert _read(name, dict(ctx)) is None
    # a program without ``recording`` (the parent of the spans): no call
    import cmoop_audio_processing_torch.utils.profiling as prof

    monkeypatch.delattr(prof, "recording")
    ctx = {"trace": {"device_ops": 1}}
    assert spans.collect(ctx) is None and ctx["spans"] is None
    for name in READERS:
        assert _read(name, ctx) is None


def test_readers_find_nothing_without_their_spans():
    ctx = _ctx()
    for r in ctx["spans"]["recorded"] + ctx["spans"]["profiled"]:
        r["name"] = "other"
    for name in READERS:
        assert _read(name, ctx) is None, name


def _brute(ops, lo, hi):
    busy = np.zeros(hi - lo, bool)
    for s, e in ops:
        busy[max(s, lo) - lo:max(min(e, hi), lo) - lo] = True
    return ~busy


def test_gaps_and_gap_time_against_a_brute_force():
    rng = np.random.default_rng(5)
    for _ in range(50):
        n = int(rng.integers(0, 12))
        s = rng.integers(0, 200, n)
        ops = np.stack([s, s + rng.integers(0, 40, n), np.zeros(n)], 1)
        ops = ops[np.argsort(ops[:, 0], kind="stable")].astype(np.int64)
        lo, hi = 20, 180
        gaps = spans._gaps(ops, lo, hi)
        idle = _brute(ops[:, :2], lo, hi)
        want = np.zeros(hi - lo, bool)
        for a, b in gaps:
            want[a - lo:b - lo] = True
        np.testing.assert_array_equal(want, idle)
        assert (np.diff(gaps.ravel()) > 0).all()  # sorted and disjoint
        t = rng.integers(lo, hi + 1, 20)
        np.testing.assert_array_equal(
            spans.gap_time_before(gaps, t),
            [idle[:x - lo].sum() for x in t])


def test_idle_by_innermost_splits_the_gaps():
    ctx = _ctx()
    dev = ctx["spans"]["device"]
    got = spans.idle_by_innermost(dev["gaps"], ctx["spans"]["profiled"],
                                  (0, 1000 * MS))
    # 50-60 init, 60-62 read, 62-100 launch, 100-120 step, 250-260 step,
    # 400-430 step, 430-500 launch, 990-995 launch, 995-1000 call
    want = {"trainer.init": 10, "engine.host_read": 2,
            "evaluator.launch": 38 + 70 + 5, "trainer.step": 60,
            "evaluator.call": 5}
    assert {k: round(v * 1e3, 6) for k, v in got.items() if v} == want
    assert sum(got.values()) == pytest.approx(
        float((dev["gaps"][:, 1] - dev["gaps"][:, 0]).sum()) / 1e9)


def test_a_traced_cpu_run_reads_the_program_spans():
    """The whole path at a toy size on the CPU: the span process runs,
    the program-span readers read it; the device-trace readers find no
    device operation there."""
    c = cell.resolve("bird_sa_nsga_penalty.fused16")
    c["config"]["data"] = {"time_steps": 20, "features": 8, "n_train": 70,
                           "n_val": 30}
    c["traffic"]["genomes"]["grid"]["filters"] = [16]
    c["traffic"]["genomes"]["grid"]["fc_layers"] = [1]
    m = cell.run(c, 3, 0.0, True, device="cpu", log=lambda s: None)[
        "metrics"]
    # one epoch: one ``stopped`` read before it, three result reads
    assert m["engine.host_reads_per_call"]["value"] == 4
    assert m["trainer.step_host_ms"]["value"] > 0
    assert 0 < m["trainer.init_share"]["value"] < 100
    assert "trainer.step_idle_share" not in m
    assert "trainer.validation_busy_share" not in m
