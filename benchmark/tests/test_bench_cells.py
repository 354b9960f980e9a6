"""Every cell resolves from its files by name, and BENCHMARK.json keeps to
the contract's shape."""

import json
import os
import re

import pytest

from benchmark import cell, check, frozen, traffic

ROOT = cell.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_from_its_files(name):
    c = cell.resolve(name)
    assert c["limits"] and set(c["limits"]) <= set(check.NAMES)
    genomes = traffic.genomes(c["traffic"])
    assert genomes and len({frozen.genome_uid(g) for g in genomes}) == len(
        genomes)
    for kind, metrics in (("end_to_end", c["end_to_end"]),
                          ("metrics", c["per_layer"])):
        assert metrics
        for m in metrics:
            assert callable(cell.reader(kind, m["name"]))
    cfg = cell.program_config(c["config"], c["traffic"])
    assert cfg.epochs == c["config"]["train"]["epochs"]
    assert cfg.compaction_chunk == c["traffic"]["compaction_chunk"]


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
    for c in BENCH["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["reduced"] == c["reduced"]
        assert len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_a_cell_is_added_with_files_alone(tmp_path):
    """The files ``kws_nsga_penalty.generation15`` would add (a mix, a
    limits file, an entry) resolve without a change to any harness file."""
    mix = {"genomes": {"grid": {g: list(v) for g, v in
                                frozen.HPARAM_SPACE.items()},
                       "sample": {"count": 15, "draw_seed": 15}},
           "compaction_chunk": -1}
    (tmp_path / "generation15.json").write_text(json.dumps(mix))
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "kws_nsga_penalty.generation15", "config": "kws_nsga_penalty",
         "traffic": "generation15", "chips": 1, "why": "x"}])
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    real = os.path.join(cell.HERE, "traffic", "generation15.json")
    limits = os.path.join(cell.HERE, "limits",
                          "kws_nsga_penalty.generation15.json")
    assert not os.path.exists(real) and not os.path.exists(limits)
    try:
        os.symlink(tmp_path / "generation15.json", real)
        with open(limits, "w") as f:
            json.dump({k: 1.0 for k in check.NAMES}, f)
        c = cell.resolve("kws_nsga_penalty.generation15", str(path))
        g = traffic.genomes(c["traffic"])
        assert len(g) == 15 and g == traffic.genomes(c["traffic"])
    finally:
        os.remove(real)
        os.remove(limits)
