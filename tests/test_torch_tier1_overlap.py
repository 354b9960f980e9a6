"""Which test files ran on other pytest-xdist workers while one file ran
(ROADMAP §3.2), and a test of that reconstruction.

    python3 tests/test_torch_tier1_overlap.py LOG XML
        [--file tests/test_distributed.py]
        [--test test_two_process_training_step_equality]

LOG is the output of the repository's tier-1 pytest command run with ``-v``
(its ``[gwN] [ nn%] PASSED <node>`` lines give each worker's tests in the
order it ran them); XML is that run's ``--junitxml`` (each test's seconds,
setup and teardown included). A worker's timeline is rebuilt by summing its
tests' seconds in that order, so a file's span is from the sum before its
first test to the sum after its last; collection and idle gaps are not
counted. Prints the span of ``--test`` in ``--file``, then each file of the
other workers that overlapped it, with its worker-seconds and the overlap,
then each worker's schedule.
"""

from __future__ import annotations

import argparse
import collections
import re
import sys
import xml.etree.ElementTree as ET

LINE = re.compile(r"\[(gw\d+)\] \[\s*\d+%\] (?:PASSED|FAILED|SKIPPED|ERROR|XFAIL|XPASS) "
                  r"(\S+?)::(\S+)")


def schedule(log: str, xml: str):
    """({(worker, file): [start, end]}, {(file, test): seconds}, {worker:
    [(file, test), ...]})."""
    seconds = {}
    for tc in ET.parse(xml).getroot().iter("testcase"):
        path = tc.get("classname").replace(".", "/") + ".py"
        seconds[(path, tc.get("name"))] = float(tc.get("time"))
    order = collections.defaultdict(list)
    with open(log, errors="replace") as f:
        for line in f:
            m = LINE.match(line)
            if m:
                order[m.group(1)].append((m.group(2), m.group(3)))
    spans = {}
    for worker, tests in order.items():
        t = 0.0
        for path, name in tests:
            span = spans.setdefault((worker, path), [t, t])
            t += seconds.get((path, name), 0.0)
            span[1] = t
    return spans, seconds, order


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("log")
    p.add_argument("xml")
    p.add_argument("--file", default="tests/test_distributed.py")
    p.add_argument("--test", default="test_two_process_training_step_equality")
    args = p.parse_args(argv)
    spans, seconds, order = schedule(args.log, args.xml)
    (worker, _), = [k for k in spans if k[1] == args.file]
    t = spans[(worker, args.file)][0]
    for path, name in order[worker]:
        if path == args.file:
            if name == args.test:
                a, b = t, t + seconds[(path, name)]
            t += seconds[(path, name)]
    print(f"{args.file}::{args.test} on {worker}: {a:.0f}-{b:.0f} s")
    rows = sorted(((min(e, b) - max(s, a), w, f, s, e)
                   for (w, f), (s, e) in spans.items()
                   if w != worker and min(e, b) > max(s, a)), reverse=True)
    for overlap, w, f, s, e in rows:
        print(f"  {w} {f}: {s:.0f}-{e:.0f} s, {e - s:.0f} worker-s, "
              f"overlap {overlap:.0f} s")
    for w in sorted(order):
        files = sorted((s, f) for (ww, f), (s, _) in spans.items() if ww == w)
        print(w, " ".join(f"{f.split('/')[-1]}@{s:.0f}" for s, f in files))
    return 0


def test_overlap_rebuilds_worker_timelines(tmp_path, capsys):
    """Two workers: gw0 runs a.py (3 s, 2 s) then d.py (1 s, 4 s), gw1 runs
    b.py (6 s) then c.py (5 s); d.py's second test spans 6-10 s, beside
    c.py (6-11 s) and not b.py (0-6 s)."""
    times = {("tests/a.py", "t1"): 3, ("tests/a.py", "t2"): 2,
             ("tests/d.py", "init"): 1, ("tests/d.py", "slow"): 4,
             ("tests/b.py", "t"): 6, ("tests/c.py", "t"): 5}
    order = {"gw0": ["tests/a.py::t1", "tests/a.py::t2", "tests/d.py::init",
                     "tests/d.py::slow"],
             "gw1": ["tests/b.py::t", "tests/c.py::t"]}
    log = tmp_path / "t1.log"
    log.write_text("".join(f"[{w}] [ 50%] PASSED {n}\n"
                           for w, nodes in order.items() for n in nodes))
    xml = tmp_path / "t1.xml"
    xml.write_text("<testsuites><testsuite>" + "".join(
        f'<testcase classname="{f[:-3].replace("/", ".")}" name="{n}" '
        f'time="{t}"/>' for (f, n), t in times.items())
        + "</testsuite></testsuites>")
    spans, _, _ = schedule(str(log), str(xml))
    assert spans == {("gw0", "tests/a.py"): [0.0, 5.0],
                     ("gw0", "tests/d.py"): [5.0, 10.0],
                     ("gw1", "tests/b.py"): [0.0, 6.0],
                     ("gw1", "tests/c.py"): [6.0, 11.0]}
    assert main([str(log), str(xml), "--file", "tests/d.py",
                 "--test", "slow"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "tests/d.py::slow on gw0: 6-10 s"
    assert out[1] == "  gw1 tests/c.py: 6-11 s, 5 worker-s, overlap 4 s"
    assert not any("b.py:" in line for line in out[:3])


if __name__ == "__main__":
    sys.exit(main())
