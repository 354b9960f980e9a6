"""The check against the port's CPU path at a toy size: the reference
agrees with the program run in float32; every fault the cells can have
turns ``correct`` false, and so does the lower-precision control; an
architecture module is added with files alone, and the check reads the one
the configuration names."""

import copy
import dataclasses
import json
import os
import uuid

import pytest

from benchmark import cell, check, data, traffic
from cmoop_audio_processing_torch.engine import evaluator as pevaluator
from cmoop_audio_processing_torch.engine import trainer as ptrainer

CELLS = [w["name"] for w in cell.bench()["workloads"]]
TOY_DATA = {"kws_nsga_penalty": {"time_steps": 16, "features": 8,
                                 "n_train": 150, "n_val": 70},
            "bird_sa_nsga_penalty": {"time_steps": 20, "features": 8,
                                     "n_train": 150, "n_val": 70}}
SEED = 2 ** 31 + 101


def toy_cell(name, bench_path=None, toy_data=None):
    """The cell at a toy size: its configuration and mix with a small
    map, few rows and 16-filter genomes of the same genes."""
    c = cell.resolve(name, bench_path)
    c = copy.deepcopy(c)
    c["config"]["data"] = toy_data or TOY_DATA[c["config"]["name"]]
    grid = dict(c["traffic"]["genomes"]["grid"], filters=[16],
                kernel_size=[3])
    grid["fc_layers"] = grid["fc_layers"][::3]
    c["traffic"]["genomes"] = {"grid": grid}
    return c


@pytest.fixture
def f32(monkeypatch):
    """The program in float32, where it and the reference agree to
    rounding."""
    orig = cell.program_config
    monkeypatch.setattr(cell, "program_config", lambda c, m: dataclasses.replace(
        orig(c, m), compute_dtype="float32"))


def run(c):
    return cell.run(c, SEED, 0.0, False, device="cpu", log=lambda s: None)


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port_in_f32(name, f32):
    r = run(toy_cell(name))
    n = r["read"]
    assert r["correct"] and r["failed"] == 0
    assert n["logit_gap"] < 1e-4 and n["grad_gap"] < 1e-4
    assert n["loss_gap"] < 1e-4 and n["bn_gap"] < 1e-3
    assert n["val_loss_gap"] < 1e-5 and n["val_fpr_gap"] < 1e-5
    assert n["val_acc_gap"] < 1e-6 and n["size_gap"] == 0.0
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


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_turns_correct_false(name, fault, f32, monkeypatch):
    """Each fault a one-chip training cell can have, planted in the
    program under a whole run with the cell's committed limits: the
    optimizer step returns its state unchanged; each batch's loss over
    half its rows; the answers handed to the wrong genomes. (The
    exchange between chips does not exist on one chip.)"""
    cls, method, make = FAULTS[fault]
    monkeypatch.setattr(cls, method, make(getattr(cls, method)))
    r = run(toy_cell(name))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits(name):
    """The reference in the control's precision in the program's place
    fails one of the cell's numbers at its committed limit."""
    c = toy_cell(name)
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


def _added_architecture(tmp_path, source, base="kws_nsga_penalty.fused16"):
    """The files a new architecture's cell adds, written beside the real
    ones: ``reference/<module>.py`` holding ``source``, a configuration
    that names it (``base``'s otherwise), its limits, and a BENCHMARK.json
    with the entries. Returns (module file, limits file, cell, bench)."""
    module = f"arch_{uuid.uuid4().hex[:12]}"
    spec = cell.bench()
    w = {x["name"]: x for x in spec["workloads"]}[base]
    conf = {x["name"]: x for x in spec["configs"]}[w["config"]]
    with open(os.path.join(cell.ROOT, conf["file"])) as f:
        config = dict(json.load(f), name=module, reference=module)
    tmp_path.mkdir()
    (tmp_path / "config.json").write_text(json.dumps(config))
    name = f"{module}.{w['traffic']}"
    bench = dict(
        spec, configs=spec["configs"] + [dict(conf, name=module, file=str(
            tmp_path / "config.json"))],
        workloads=spec["workloads"] + [dict(w, name=name, config=module)])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mod_path = os.path.join(cell.HERE, "reference", f"{module}.py")
    limits = os.path.join(cell.HERE, "limits", f"{name}.json")
    assert not os.path.exists(mod_path) and not os.path.exists(limits)
    with open(mod_path, "w") as f:
        f.write(source)
    with open(limits, "w") as f:
        json.dump(cell.resolve(base)["limits"], f)
    return mod_path, limits, name, str(tmp_path / "BENCHMARK.json")


SKIP = "        h = F.relu(pool(y) + skip)\n"


def test_an_architecture_is_added_with_files_alone(tmp_path, f32):
    """A copy of the templates' module under another name, and a
    configuration naming it, make a cell without a change to any harness
    file; the check of a toy run reads exactly the original's numbers.
    With the skip projection left out of a second copy's forward pass, the
    same run is not correct: the check reads the module the configuration
    names."""
    with open(os.path.join(cell.HERE, "reference", "keras_cnn.py")) as f:
        source = f.read()
    assert source.count(SKIP) == 1
    toy = TOY_DATA["kws_nsga_penalty"]
    got = {}
    for planted in (False, True):
        src = source.replace(SKIP, "        h = F.relu(pool(y))\n") \
            if planted else source
        mod_path, limits, name, bench = _added_architecture(
            tmp_path / str(planted), src)
        try:
            got[planted] = run(toy_cell(name, bench, toy))
        finally:
            os.remove(mod_path)
            os.remove(limits)
    want = run(toy_cell("kws_nsga_penalty.fused16"))
    assert want["correct"]
    assert got[False]["correct"] and got[False]["read"] == want["read"]
    assert not got[True]["correct"], got[True]["checks"]
    assert (got[True]["read"]["logit_gap"]
            > want["checks"]["logit_gap"]["limit"])
