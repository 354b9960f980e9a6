"""The architecture module that a configuration names: a name with no
module fails when the cell resolves, the templates' module raises on a
template it does not know, and no file of the harness outside
``reference/`` branches on a template."""

import ast
import json
import os
import re

import pytest
import torch

from benchmark import cell, frozen, reference
from benchmark.reference import keras_cnn


def test_a_missing_module_fails_when_the_cell_resolves(tmp_path):
    spec = cell.bench()
    conf = spec["configs"][0]
    with open(os.path.join(cell.ROOT, conf["file"])) as f:
        config = dict(json.load(f), reference="no_such_architecture")
    (tmp_path / "config.json").write_text(json.dumps(config))
    w = next(x for x in spec["workloads"] if x["config"] == conf["name"])
    bench = dict(spec, workloads=[w], configs=[
        dict(conf, file=str(tmp_path / "config.json"))])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(FileNotFoundError, match="no_such_architecture"):
        cell.resolve(w["name"], str(tmp_path / "BENCHMARK.json"))


@pytest.mark.parametrize("name,error", [
    ("../frozen", ValueError), ("", ValueError), (None, ValueError),
    ("training", AttributeError)])
def test_a_name_that_is_no_module_is_refused(name, error):
    with pytest.raises(error):
        reference.load(name)


def test_each_configuration_names_a_module():
    for c in cell.bench()["configs"]:
        with open(os.path.join(cell.ROOT, c["file"])) as f:
            mod = reference.load(json.load(f)["reference"])
        assert all(callable(getattr(mod, n)) for n in reference.FUNCTIONS)


GENOME = frozen.all_genomes()[0]
CALLS = {
    "init_params": lambda t: keras_cnn.init_params(
        1, t, 16, 3, 10, 1, GENOME),
    "reference_params": lambda t: keras_cnn.reference_params(
        *keras_cnn.init_params(1, "A", 16, 3, 10, 1, GENOME), GENOME, t),
    "forward": lambda t: keras_cnn.forward(
        *keras_cnn.reference_params(
            *keras_cnn.init_params(1, "A", 16, 3, 10, 1, GENOME), GENOME,
            "A"), GENOME, t, torch.zeros(2, 8, 8, 1), train=False),
    "count_params": lambda t: keras_cnn.count_params(GENOME, 10, t),
    "model_size_mb": lambda t: keras_cnn.model_size_mb(GENOME, 10, t),
    "count_fwd_flops": lambda t: keras_cnn.count_fwd_flops(
        GENOME, (45, 13), 10, t),
}


@pytest.mark.parametrize("function", reference.FUNCTIONS)
def test_an_unknown_template_raises(function):
    for template in keras_cnn.TEMPLATES:
        CALLS[function](template)
    with pytest.raises(ValueError, match="unknown template 'C'"):
        CALLS[function]("C")


ONE_LETTER = re.compile(r"^[A-Z]$")


def _is_template(node) -> bool:
    """A name or attribute called ``template``, or a subscript by the key
    "template"."""
    return ((isinstance(node, ast.Name) and node.id == "template")
            or (isinstance(node, ast.Attribute) and node.attr == "template")
            or (isinstance(node, ast.Subscript)
                and isinstance(node.slice, ast.Constant)
                and node.slice.value == "template"))


def _is_letter(node) -> bool:
    """A one-letter capital string, or a tuple, list or set of them."""
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return any(_is_letter(e) for e in node.elts)
    return (isinstance(node, ast.Constant) and isinstance(node.value, str)
            and bool(ONE_LETTER.match(node.value)))


def _branches_on_a_template(tree):
    """Comparisons with a one-letter string or with a template, lookups
    keyed by a template, and ``match`` cases on a one-letter string."""
    for n in ast.walk(tree):
        if isinstance(n, ast.Compare):
            if any(_is_letter(e) or _is_template(e)
                   for e in [n.left] + n.comparators):
                yield n.lineno
        elif isinstance(n, ast.Subscript) and _is_template(n.slice):
            yield n.lineno
        elif isinstance(n, ast.MatchValue) and _is_letter(n.value):
            yield n.lineno


def test_no_harness_file_outside_reference_branches_on_a_template():
    skip = os.path.join(cell.HERE, "reference")
    found, scanned = [], 0
    for root, _, files in os.walk(cell.HERE):
        if root == skip or root.startswith(skip + os.sep):
            continue
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as f:
                    tree = ast.parse(f.read(), path)
                scanned += 1
                found += [f"{os.path.relpath(path, cell.HERE)}:{line}"
                          for line in _branches_on_a_template(tree)]
    assert scanned > 20 and not found, found


@pytest.mark.parametrize("code", [
    'if template == "A":\n    pass',
    'x = "B" != t',
    'y = TOY[c["config"]["train"]["template"]]',
    'z = self.template in ("A", "B")',
    'match t:\n    case "A":\n        pass',
])
def test_the_scan_finds_a_branch_on_a_template(code):
    assert list(_branches_on_a_template(ast.parse(code)))
