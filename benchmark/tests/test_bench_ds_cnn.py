"""Template D's architecture module (``reference/ds_cnn.py``) and the
``bird_dscnn_sa_nsga_penalty`` cell: the frozen init and counts equal the
port's over the whole search space, ``depthwise_work`` equals a hand
count, the two depthwise readers read known numbers from hand-made spans
and device operations (and nothing without them), and at a toy size the
reference agrees with the port in float32 while the control and every
fault fail the cell's committed limits."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from benchmark import cell, check, data, frozen, reference, traffic
from benchmark.reference import ds_cnn
from cmoop_audio_processing_torch.engine import evaluator as pevaluator
from cmoop_audio_processing_torch.engine import trainer as ptrainer
from cmoop_audio_processing_torch.models import genome_arch, supernet

CELL = "bird_dscnn_sa_nsga_penalty.fused16"
GENOMES = frozen.all_genomes()
SEED = 2 ** 31 + 101
MS = 1_000_000  # ns


def test_the_configuration_names_this_module():
    c = cell.resolve(CELL)
    assert c["config"]["reference"] == "ds_cnn"
    assert reference.load("ds_cnn") is reference.load(
        c["config"]["reference"])
    # the preset exists in the program and agrees with the configuration
    cell.program_config(c["config"], c["traffic"])


@pytest.mark.parametrize("hw", [(501, 40), (45, 13)])
def test_frozen_counts_and_init_equal_the_ports(hw):
    for g in GENOMES:
        assert ds_cnn.count_params(g, 11, "D") == \
            genome_arch.count_params(g, 11, "D")
        assert ds_cnn.model_size_mb(g, 11, "D") == \
            genome_arch.model_size_mb(g, 11, "D")
        assert ds_cnn.count_fwd_flops(g, hw, 11, "D") == \
            genome_arch.count_fwd_flops(g, hw, 11, "D")
    for g in GENOMES[hw[0] % 2::2]:  # each half of the space at one shape
        spec = supernet.BucketSpec(template="D", filters=g["filters"],
                                   kernel=g["kernel_size"], num_classes=11,
                                   max_blocks=g["residual_blocks"])
        for a, b in zip(supernet.init_params(SEED, spec, g),
                        ds_cnn.init_params(SEED, "D", g["filters"],
                                           g["kernel_size"], 11,
                                           g["residual_blocks"], g)):
            la, lb = supernet.tree_leaves(a), supernet.tree_leaves(b)
            assert len(la) == len(lb)
            assert all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("function", reference.FUNCTIONS)
def test_another_template_raises(function):
    g = GENOMES[0]
    calls = {
        "init_params": lambda t: ds_cnn.init_params(1, t, 16, 3, 10, 1, g),
        "reference_params": lambda t: ds_cnn.reference_params(
            *ds_cnn.init_params(1, "D", 16, 3, 10, 1, g), g, t),
        "forward": lambda t: ds_cnn.forward(
            *ds_cnn.reference_params(
                *ds_cnn.init_params(1, "D", 16, 3, 10, 1, g), g, "D"),
            g, t, torch.zeros(2, 8, 8, 1), train=False),
        "count_params": lambda t: ds_cnn.count_params(g, 10, t),
        "model_size_mb": lambda t: ds_cnn.model_size_mb(g, 10, t),
        "count_fwd_flops": lambda t: ds_cnn.count_fwd_flops(
            g, (45, 13), 10, t),
    }
    calls[function]("D")
    for t in ("A", "B"):
        with pytest.raises(ValueError, match=f"unknown template '{t}'"):
            calls[function](t)


def test_depthwise_work_by_hand():
    """(64, 5, 3 blocks) at 501x40: maps 251x20 (64 channels), 126x10
    (128), 63x5 (256) after the stride-2 stem; 5,140,480 + 2,580,480 +
    1,290,240 elements a row of 16 lanes, 577 M in a 64-row step."""
    g = dict(filters=64, kernel_size=5, use_bn=True, residual_blocks=3,
             fc_layers=4, use_dropout=False)
    elems = 64 * 251 * 20 + 128 * 126 * 10 + 256 * 63 * 5  # one lane, row
    weights = 25 * (64 + 128 + 256)
    assert 16 * 64 * elems == 576_716_800
    flops, nbytes = ds_cnn.depthwise_work(g, (501, 40), 64)
    assert flops == 3 * 2 * 25 * elems * 64
    assert nbytes == 3 * (2 * elems * 64 + weights) * 2
    # 6.92 GB a 16-lane step: 2.07 ms at 3.35 TB/s, above its 1.29 ms
    # at 67 TFLOP/s
    assert 16 * nbytes == pytest.approx(6.9217e9, rel=1e-4)
    assert 16 * flops == pytest.approx(86.508e9, rel=1e-4)
    assert ds_cnn.depthwise_work(g, (501, 40), 64, ("fwd",)) == (
        flops // 3, nbytes // 3)
    with pytest.raises(ValueError, match="unknown passes"):
        ds_cnn.depthwise_work(g, (501, 40), 64, ("bwd",))


def _span(name, i, start, end, **attrs):
    return {"name": name, "id": i, "parent": 0, "call": 0,
            "start_ns": start * MS, "end_ns": end * MS, "attrs": attrs}


def _ctx():
    """One call of 1000 ms: three depthwise spans (a forward, an input and
    a weight gradient) among others; two of the five device operations
    launched inside them (4 + 6 ms of 100 ms)."""
    config = copy.deepcopy(cell.resolve(CELL)["config"])
    config["data"] = {"time_steps": 501, "features": 40, "n_train": 64,
                      "n_val": 32}
    profiled = [
        _span("evaluator.call", 0, 0, 1000),
        _span("grouped.depthwise", 1, 100, 110, **{"pass": "fwd"}),
        _span("trainer.step", 2, 120, 300),
        _span("grouped.depthwise", 3, 200, 210, **{"pass": "dgrad"}),
        _span("grouped.depthwise", 4, 210, 220, **{"pass": "wgrad"}),
    ]
    ops = np.array([[105, 109, 101], [130, 170, 125], [215, 221, 212],
                    [400, 440, 120], [500, 510, -1]], np.int64) * MS
    return {"trace": {"device_ops": 5}, "config": config,
            "genomes": [dict(filters=64, kernel_size=5, use_bn=True,
                             residual_blocks=3, fc_layers=4,
                             use_dropout=False)],
            "n_train": 64, "n_val": 32,
            "peaks": {"cards": {"H100": {"float32": 67e12,
                                         "hbm_bytes_per_s": 3.35e12}}},
            "device_name": "NVIDIA H100 80GB HBM3",
            "spans": {"recorded": profiled, "profiled": profiled,
                      "device": {"window": (0, 1000 * MS), "ops": ops,
                                 "gaps": np.zeros((0, 2), np.int64)}}}


def _read(name, ctx):
    return cell.reader("metrics", name)(ctx)


def test_depthwise_readers_on_known_spans():
    ctx = _ctx()
    assert _read("grouped.depthwise_busy_share", ctx) == pytest.approx(
        100 * 10 / 100)
    g = ctx["genomes"][0]
    f1, b1 = ds_cnn.depthwise_work(g, (501, 40), 64)
    f2, b2 = ds_cnn.depthwise_work(g, (501, 40), 2 * 32, ("fwd",))
    bound = max((f1 + f2) / 67e12, (b1 + b2) / 3.35e12)
    assert bound == (b1 + b2) / 3.35e12  # memory-bound
    assert _read("grouped.depthwise_roofline", ctx) == pytest.approx(
        100 * bound / 0.010)


def test_depthwise_readers_find_nothing_without_their_spans():
    for name in ("grouped.depthwise_busy_share",
                 "grouped.depthwise_roofline"):
        ctx = _ctx()
        for r in ctx["spans"]["profiled"]:
            r["name"] = "other"
        assert _read(name, ctx) is None
        assert _read(name, {"trace": None}) is None
    # another architecture (no ``depthwise_work``), another card
    ctx = _ctx()
    ctx["config"]["reference"] = "keras_cnn"
    assert _read("grouped.depthwise_roofline", ctx) is None
    ctx = _ctx()
    ctx["device_name"] = "cpu"
    assert _read("grouped.depthwise_roofline", ctx) is None


# -- the check at a toy size ---------------------------------------------------

def toy_cell():
    """The cell at a toy size: a 20x8 map, few rows, 16-filter 3x3
    genomes of the mix's other genes."""
    c = copy.deepcopy(cell.resolve(CELL))
    c["config"]["data"] = {"time_steps": 20, "features": 8, "n_train": 150,
                           "n_val": 70}
    grid = dict(c["traffic"]["genomes"]["grid"], filters=[16],
                kernel_size=[3])
    grid["fc_layers"] = grid["fc_layers"][::3]
    c["traffic"]["genomes"] = {"grid": grid}
    return c


@pytest.fixture
def f32(monkeypatch):
    orig = cell.program_config
    monkeypatch.setattr(cell, "program_config", lambda c, m: dataclasses.replace(
        orig(c, m), compute_dtype="float32"))


def run(c):
    return cell.run(c, SEED, 0.0, False, device="cpu", log=lambda s: None)


def test_reference_agrees_with_the_port_in_f32(f32):
    r = run(toy_cell())
    n = r["read"]
    assert r["correct"] and r["failed"] == 0
    assert n["logit_gap"] < 1e-4 and n["grad_gap"] < 1e-4
    assert n["loss_gap"] < 1e-4 and n["bn_gap"] < 1e-3
    assert n["val_loss_gap"] < 1e-5 and n["size_gap"] == 0.0
    assert n["change_gap"] < 0.05  # Adam's first steps amplify round-off


def _frozen_adam(self, params, grads, opt, active):
    return params, opt


def _half_batch_loss(orig):
    def pop_loss(self, params, state, flags, xb, yb, wb, dkey):
        parts = [t if isinstance(t, list) else [t] for t in (xb, yb, wb)]
        half = [[p[: p.shape[0] // 2] for p in ps] for ps in parts]
        return orig(self, params, state, flags, *half, dkey)
    return pop_loss


def _answers_mixed_up(orig):
    def evaluate(self, genomes, seed=0):
        return orig(self, genomes, seed)[::-1]
    return evaluate


FAULTS = {
    "state_unchanged": (ptrainer.PopulationTrainer, "adam_step",
                        lambda orig: _frozen_adam),
    "half_batch": (ptrainer.PopulationTrainer, "pop_loss", _half_batch_loss),
    "answer_altered": (pevaluator.PopulationEvaluator, "evaluate",
                       _answers_mixed_up),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_turns_correct_false(fault, f32, monkeypatch):
    cls, method, make = FAULTS[fault]
    monkeypatch.setattr(cls, method, make(getattr(cls, method)))
    r = run(toy_cell())
    assert not r["correct"], r["checks"]


def test_the_control_fails_the_limits():
    c = toy_cell()
    genomes = traffic.genomes(c["traffic"])
    d = data.cell_data(c["config"], SEED)
    ref = check.Reference(c["config"], d, "cpu")
    es = traffic.eval_seed(SEED, 0)
    rows = []
    for g in genomes:
        p0, s0 = ref.init(g, es)
        r32, _ = ref.steps(g, es)
        ctl, _ = ref.steps(g, es, precision="control")
        rows.append(check.step_numbers(ctl, r32))
        rows.append(check.val_numbers(
            ref.validate(g, p0, s0, precision="control"),
            ref.validate(g, p0, s0)))
    numbers = check.worst(rows)
    numbers["size_gap"] = 0.0
    ok, _ = check.verdict(numbers, c["limits"], [], 0)
    assert not ok, numbers
