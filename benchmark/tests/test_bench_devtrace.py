"""``devtrace.summarize`` on synthetic profiler events: every device
operation's total time and launch count by name, past the ten that the
breakdown keeps, beside the breakdown's own lists."""

import pytest
import torch

from benchmark import devtrace

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class Event:
    """The part of a kineto event that ``summarize`` reads."""

    def __init__(self, device, name, start, end, thread=1):
        self._d, self._n, self._s, self._e, self._t = (device, name, start,
                                                       end, thread)

    def device_type(self):
        return self._d

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def start_thread_id(self):
        return self._t


# op_k runs k + 1 launches of 100 - 8k ns: totals 100, 184, 252, 304, 340,
# 360, 364, 352, 324, 280, 220, 144 ns, all different; op_11 ranks
# eleventh, op_0 twelfth
OPS = {f"op_{k}": (k + 1, 100 - 8 * k) for k in range(12)}


def _events():
    """A 100 us window; the ops back to back from 1 us, with a gap to 24 us
    after op_5 under a host op."""
    evs = [Event(CPU, devtrace.WINDOW, 0, 100_000),
           Event(CPU, "aten::host_work", 5_000, 30_000)]
    t = 1000
    for name, (n, d) in OPS.items():
        for _ in range(n):
            evs.append(Event(CUDA, name, t, t + d))
            t += d
        if name == "op_5":
            t = 24_000
    return evs


def _seconds(name):
    """The op's total, added launch by launch as the trace adds it."""
    n, d = OPS[name]
    total = 0.0
    for _ in range(n):
        total += d / 1e9
    return total


def test_every_device_op_is_kept_by_name():
    s = devtrace.summarize(_events())
    by_name = s["ops_by_name"]
    assert by_name == {name: {"seconds": _seconds(name), "launches": n}
                       for name, (n, _) in OPS.items()}
    assert sum(v["launches"] for v in by_name.values()) == s["device_ops"]
    ranked = sorted(OPS, key=lambda name: -_seconds(name))
    assert ranked[10] == "op_11"
    assert "op_11" not in [name for name, _ in s["top_device_ops"]]
    assert by_name["op_11"] == {"seconds": _seconds("op_11"), "launches": 12}


def test_the_breakdown_keeps_its_form():
    s = devtrace.summarize(_events())
    ranked = sorted(OPS, key=lambda name: -_seconds(name))
    assert s["top_device_ops"] == [[name, _seconds(name)]
                                   for name in ranked[:devtrace.TOP]]
    assert s["device_ops"] == s["kernels"] == sum(n for n, _ in OPS.values())
    assert s["window_s"] == 100_000 / 1e9
    busy = sum(n * d for n, d in OPS.values())
    assert s["busy_s"] == busy / 1e9
    idle = dict(s["idle_by_host_op"])
    assert set(idle) == {"(no host op)", "aten::host_work"}
    assert [t for _, t in s["idle_by_host_op"]] == sorted(idle.values(),
                                                          reverse=True)
    assert sum(idle.values()) == pytest.approx(s["window_s"] - s["busy_s"])
