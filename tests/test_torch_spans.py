"""The port's spans (utils/profiling.py) and where the program opens them:
off, ``span`` is one shared no-op and records nothing; on, a tiny
``PopulationEvaluator.evaluate`` gives the same fitness bit for bit and
the span tree its code predicts (an optimizer update inside each step),
on the one-shot and on the compacted path; the stamps fall on the clock
of the profiler's events; and ``CMOOP_LOG_LAUNCHES=1`` prints the launch
lines it always printed."""

import re
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from cmoop_audio_processing_torch.core.config import DataConfig, TrainConfig
from cmoop_audio_processing_torch.data.pipeline import prepare_dataset
from cmoop_audio_processing_torch.engine import evaluator as tev
from cmoop_audio_processing_torch.utils.profiling import recording, span

# the test workers share the CPU's cores: one intra-op thread per worker
# keeps PyTorch's thread pool from oversubscribing them
torch.set_num_threads(1)

# one (16, 3) bucket of mixed depth, BN and FC entry; at learning rate
# 1e-2 and patience 1 they stop after 2-5 of 6 epochs, so the compacted
# path drops lanes
GENOMES = [
    dict(filters=16, kernel_size=3, use_bn=False, residual_blocks=1,
         fc_layers=1, use_dropout=False),
    dict(filters=16, kernel_size=3, use_bn=True, residual_blocks=2,
         fc_layers=2, use_dropout=False),
    dict(filters=16, kernel_size=3, use_bn=False, residual_blocks=2,
         fc_layers=4, use_dropout=False),
    dict(filters=16, kernel_size=3, use_bn=True, residual_blocks=1,
         fc_layers=3, use_dropout=False),
]
EPOCHS = 6
BATCH = 32
FINAL_KEYS = 6  # the entries of PopulationTrainer.finalize's result


@pytest.fixture(scope="module")
def data():
    return prepare_dataset(
        DataConfig(synthetic_train=96, synthetic_eval=32, time_steps=16,
                   features=8, num_classes=4)
    )


def _ev(data, chunk, epochs=EPOCHS):
    cfg = TrainConfig(epochs=epochs, batch_size=BATCH, patience=1,
                      num_classes=4, compute_dtype="float32",
                      learning_rate=1e-2, compaction_chunk=chunk,
                      bucket_genes=("filters", "kernel_size"))
    return tev.PopulationEvaluator(data, cfg, device="cpu")


def _host_reads(launch, chunk):
    """The ``engine.host_read`` spans of one launch, from the code: the
    trainer reads ``stopped`` before each epoch it runs, and once more when
    every lane stopped inside a chunk; the one-shot path then reads three
    results; the compacted path reads ``stopped`` after each segment and
    every entry of ``finalize`` at each compaction and at the end."""
    ran = max(launch["epochs"])
    seg = chunk if chunk else EPOCHS
    stopped_inside = ran < EPOCHS and ran % seg != 0
    reads = ran + stopped_inside
    if not chunk:
        return reads + 3
    lanes = launch["lanes"]
    compactions = sum(b < a for a, b in zip(lanes, lanes[1:]))
    return reads + len(lanes) + FINAL_KEYS * (1 + compactions)


def test_span_off_is_the_shared_noop():
    a = span("trainer.step", epoch=0)
    b = span("evaluator.call")
    assert a is b
    with a as got:
        assert got is None
    with recording() as recs:
        pass
    with span("trainer.step", epoch=1):
        pass
    assert recs == []


def test_recording_keeps_the_tree_and_restores_the_outer_recorder():
    with recording() as outer:
        with span("root", n=1):
            with span("child"):
                with recording() as inner:
                    with span("alone"):
                        pass
                with span("leaf", what="x"):
                    time.sleep(0.001)
        with span("second"):
            pass
    assert [(r.name, r.id, r.parent, r.call) for r in outer] == [
        ("root", 0, None, 0), ("child", 1, 0, 0), ("leaf", 2, 1, 0),
        ("second", 3, None, 3)]
    assert outer[0].attrs == {"n": 1} and outer[2].attrs == {"what": "x"}
    assert [(r.name, r.parent, r.call) for r in inner] == [("alone", None, 0)]
    for r in outer:
        assert 0 < r.start_ns <= r.end_ns
    root, child, leaf, _ = outer
    assert root.start_ns <= child.start_ns <= leaf.start_ns
    assert leaf.end_ns <= child.end_ns <= root.end_ns
    assert leaf.end_ns - leaf.start_ns >= 1_000_000


@pytest.mark.parametrize("chunk", [0, 2], ids=["one_shot", "compacted"])
def test_evaluate_spans(data, chunk):
    ev = _ev(data, chunk)
    off = ev.evaluate(GENOMES, seed=3)
    with recording() as recs:
        on = ev.evaluate(GENOMES, seed=3)
    assert on == off  # the same fitness, bit for bit
    (launch,) = ev.timings[-1]["chunks"]
    assert launch["compacted"] == bool(chunk)
    if chunk:
        assert launch["lanes"][-1] < launch["lanes"][0]  # lanes dropped

    by = {}
    for r in recs:
        by.setdefault(r.name, []).append(r)
    (call,) = by["evaluator.call"]
    (ln,) = by["evaluator.launch"]
    (init,) = by["trainer.init"]
    assert call.parent is None and call.attrs == {"n_genomes": 4, "seed": 3}
    assert ln.parent == call.id
    assert ln.attrs == {"filters": 16, "kernel": 3, "blocks": 2, "pop": 4}
    assert init.attrs == {"pop": 4}
    ran = max(launch["epochs"])
    steps = -(-96 // BATCH) * ran
    assert len(by["trainer.step"]) == steps
    assert sorted({r.attrs["epoch"] for r in by["trainer.step"]}) == list(
        range(ran))
    finals = [r for r in by["trainer.validate"] if r.attrs["final"]]
    assert len(by["trainer.validate"]) - len(finals) == ran
    lanes = launch["lanes"]
    assert len(finals) == 1 + sum(b < a for a, b in zip(lanes, lanes[1:]))
    assert len(by["engine.host_read"]) == _host_reads(launch, chunk)
    assert set(by) == {"evaluator.call", "evaluator.launch", "trainer.init",
                       "trainer.step", "trainer.adam", "trainer.validate",
                       "engine.host_read"}
    # one optimizer update inside each step, on the CPU's plain route
    step_ids = {r.id for r in by["trainer.step"]}
    assert len(by["trainer.adam"]) == steps
    for r in by["trainer.adam"]:
        assert r.parent in step_ids and r.attrs == {"route": "plain"}
    for r in recs:
        assert r.call == call.id and r.end_ns >= r.start_ns
        if r is not call and r is not ln and r.name != "trainer.adam":
            assert r.parent == ln.id, r
            assert ln.start_ns <= r.start_ns and r.end_ns <= ln.end_ns


def test_stamps_fall_on_the_profilers_clock():
    """Each span's stamps and its ``record_function`` event agree to a few
    microseconds. The first region a process opens under the profiler
    pays the profiler's own set-up (0.2-0.5 ms on one CPU) after the span's
    stamp: a warm-up region pays it here."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):
            pass
        with recording() as recs:
            with span("outer"):
                for i in range(3):
                    with span("inner", i=i):
                        torch.ones(64).sum()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() in ("outer", "inner")]
    events.sort(key=lambda e: e.start_ns())
    assert [e.name() for e in events] == [r.name for r in recs]
    for r, e in zip(recs, events):
        assert abs(r.start_ns - e.start_ns()) <= 100_000, (r, e.start_ns())
        assert abs(r.end_ns - e.end_ns()) <= 100_000, (r, e.end_ns())


@pytest.mark.parametrize("log", ["1", None], ids=["on", "off"])
def test_log_launches_prints_the_lines_it_printed(data, capsys, monkeypatch,
                                                  log):
    if log is None:
        monkeypatch.delenv("CMOOP_LOG_LAUNCHES", raising=False)
    else:
        monkeypatch.setenv("CMOOP_LOG_LAUNCHES", log)
    ev = _ev(data, 0, epochs=1)
    ev.evaluate(GENOMES, seed=3)
    with recording():
        ev.evaluate(GENOMES, seed=3)
    err = capsys.readouterr().err.splitlines()
    if log is None:
        assert err == []
        return
    start = re.compile(r"\[launch 1/1\] f=16 k=3 blocks=2 pop=4 "
                       r"start t\+\d+\.\ds$")
    done = re.compile(r"\[launch 1/1\] done t\+\d+\.\ds$")
    assert len(err) == 4
    for line, want in zip(err, (start, done, start, done)):
        assert want.match(line), line
