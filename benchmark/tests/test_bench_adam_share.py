"""``metrics/trainer.adam_kernel_share`` on hand-made spans: the share of
the recorded call's ``trainer.adam`` spans whose ``route`` is "kernel";
nothing without spans, or without the span (a program that predates it)."""

import pytest

from benchmark import cell

MS = 1_000_000  # ns


def _span(name, i, parent, start, end, **attrs):
    return {"name": name, "id": i, "parent": parent, "call": 0,
            "start_ns": start * MS, "end_ns": end * MS, "attrs": attrs}


def _ctx(routes):
    """One call of len(routes) steps, each with its update's span."""
    recs = [_span("evaluator.call", 0, None, 0, 1000),
            _span("evaluator.launch", 1, 0, 5, 995, pop=16)]
    for k, route in enumerate(routes):
        step = len(recs)
        recs.append(_span("trainer.step", step, 1, 100 + 10 * k,
                          108 + 10 * k, epoch=0))
        recs.append(_span("trainer.adam", step + 1, step, 105 + 10 * k,
                          107 + 10 * k, route=route))
    return {"trace": {"device_ops": 1},
            "spans": {"recorded": recs, "profiled": recs, "device": {}}}


def _read(ctx):
    return cell.reader("metrics", "trainer.adam_kernel_share")(ctx)


@pytest.mark.parametrize("routes,want", [
    (["kernel"] * 3, 100.0),
    (["plain"] * 2, 0.0),
    (["kernel", "plain", "kernel", "kernel"], 75.0),
])
def test_share_of_updates_on_the_kernel(routes, want):
    assert _read(_ctx(routes)) == pytest.approx(want)


def test_nothing_to_read():
    assert _read({"trace": None}) is None
    assert _read({"trace": {"device_ops": 1}, "spans": None}) is None
    assert _read(_ctx([])) is None  # spans, but none of the update
