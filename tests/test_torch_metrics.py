"""The PyTorch port's front-comparison tools against the JAX package's:
hypervolume, GD/IGD/Spread/Coverage and the Tchebycheff ranking on the
committed all-8 fronts, the compare and psi_merge commands, and the
pandas-free table reader they and the PSI initializer read through."""

import glob
import os

import numpy as np
import pandas as pd
import pytest
import torch

from cmoop_audio_processing_torch.cli import compare as tcompare
from cmoop_audio_processing_torch.cli import psi_merge as tmerge
from cmoop_audio_processing_torch.metrics import hypervolume as TH
from cmoop_audio_processing_torch.metrics import quality as TQ
from cmoop_audio_processing_torch.metrics.tchebycheff import rank_front as t_rank
from cmoop_audio_processing_torch.utils.xlsx import UnreadableTableError, read_rows
from cmoop_audio_processing_tpu.cli import compare as jcompare
from cmoop_audio_processing_tpu.cli import psi_merge as jmerge
from cmoop_audio_processing_tpu.metrics import hypervolume as JH
from cmoop_audio_processing_tpu.metrics import quality as JQ
from cmoop_audio_processing_tpu.metrics.tchebycheff import rank_front as j_rank
from cmoop_audio_processing_tpu.utils.xlsx import read_xlsx

# the test workers share the CPU's cores: one intra-op thread per worker
# keeps PyTorch's thread pool from oversubscribing them
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL8 = os.path.join(ROOT, "examples", "all8")
FRONTS = sorted(glob.glob(os.path.join(ALL8, "front_*.csv")))
STAGE1 = [os.path.join(ALL8, f"front_{n}_nsga_1.csv")
          for n in ("acc_size", "acc_fpr", "size_fpr")]


def _name(path):
    return os.path.basename(path)[len("front_"):-len(".csv")]


def _same(a, b):
    """Equal values, NaN equal to NaN, through nested dicts and lists."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b or (a != a and b != b)


def test_load_front_reads_the_jax_packages_values():
    for path in FRONTS:
        got = tcompare.load_front(path)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, jcompare.load_front(path))


def test_compare_fronts_on_the_all8_fronts_equals_jax():
    fronts = {_name(p): jcompare.load_front(p) for p in FRONTS}
    got, want = TQ.compare_fronts(fronts), JQ.compare_fronts(fronts)
    assert got["true_front_size"] > 0 and all(v > 0 for v in got["hypervolume"].values())
    assert _same(got, want)


@pytest.mark.parametrize("d", [2, 3, 4])
def test_hypervolume_equals_jax_on_seeded_fronts(d):
    rng = np.random.default_rng(d)
    for _ in range(5):
        pts = np.round(rng.random((int(rng.integers(1, 9)), d)) * 8) / 8
        ref = np.ones(d) * (1.0 + rng.random())
        assert TH.hypervolume(pts, ref) == pytest.approx(
            JH.hypervolume(pts, ref), rel=1e-14, abs=1e-15)
        assert TH.hypervolume(pts, ref) == {2: JH._hv2d, 3: JH._hv3d,
                                            4: JH._hv_wfg}[d](pts, ref)
    np.testing.assert_array_equal(TH.reference_point([pts, pts + 1.0]),
                                  JH.reference_point([pts, pts + 1.0]))


@pytest.mark.parametrize("path", FRONTS, ids=_name)
def test_tchebycheff_ranking_equals_jax(path):
    arr = jcompare.load_front(path)
    cols = ["Accuracy", "Size_MB", "FPR"]
    want = j_rank(pd.DataFrame(arr, columns=cols))
    got = t_rank([dict(zip(cols, map(float, r))) for r in arr])
    assert [list(r) for r in got] == [list(want.columns)] * len(got)
    assert _same([list(r.values()) for r in got],
                 [list(t) for t in want.itertuples(index=False, name=None)])


def _run(main, argv, capsys, out_dir):
    assert main(argv) == 0
    return capsys.readouterr().out.replace(str(out_dir), "<out>")


def test_compare_cli_report_equals_jax(tmp_path, capsys):
    fronts = [f"--front={_name(p)}={p}" for p in FRONTS]
    fronts.append(f"--front=missing={tmp_path / 'nope.csv'}")
    outs = {}
    for tag, main in (("jax", jcompare.main), ("torch", tcompare.main)):
        d = tmp_path / tag
        d.mkdir()
        outs[tag] = _run(main, fronts + ["--rank", "--out", str(d / "r.json")],
                         capsys, d)
    assert outs["torch"] == outs["jax"]
    assert "Hypervolume (mobo_penalty):" in outs["torch"]
    for name in ["r.json"] + [f"ranked_{_name(p)}.csv" for p in FRONTS]:
        assert (tmp_path / "torch" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    for p in FRONTS[:2]:
        book = f"ranked_{_name(p)}.xlsx"
        pd.testing.assert_frame_equal(read_xlsx(str(tmp_path / "torch" / book)),
                                      read_xlsx(str(tmp_path / "jax" / book)))


@pytest.mark.parametrize("out,flags", [
    ("Final.csv", []),
    ("Final.csv", ["--dedup", "--limit", "5", "--interleave"]),
    ("Final.xlsx", ["--dedup"]),
])
def test_psi_merge_output_equals_jax(tmp_path, capsys, out, flags):
    for tag, main in (("jax", jmerge.main), ("torch", tmerge.main)):
        (tmp_path / tag).mkdir()
        _run(main, STAGE1 + ["--out", str(tmp_path / tag / out)] + flags,
             capsys, tmp_path / tag)
    got, want = tmp_path / "torch" / out, tmp_path / "jax" / out
    if out.endswith(".csv"):
        assert got.read_bytes() == want.read_bytes()
    else:
        pd.testing.assert_frame_equal(read_xlsx(str(got)), read_xlsx(str(want)))


MESSY = ("A,B,C,D,,A,E,F\n"
         "1,2.5,True,x,,3,,0.9700000286102295\n"
         ",inf,False,,4,5,,1e-3\n"
         "\n"
         "2,1e-3,,y,5,6,,NA\n")


@pytest.mark.parametrize("path", FRONTS + [os.path.join(ALL8, "Final.csv"), "messy"],
                         ids=lambda p: os.path.basename(p))
def test_read_rows_holds_pandas_read_csv_names_and_values(tmp_path, path):
    """Column names (Unnamed, repeated), types and values, NaN where a cell
    is missing: the float parser is pandas' own, bit for bit."""
    if path == "messy":
        path = str(tmp_path / "messy.csv")
        with open(path, "w") as f:
            f.write(MESSY)
    columns, rows = read_rows(path)
    df = pd.read_csv(path)
    assert columns == list(df.columns)
    assert len(rows) == len(df)
    for j, name in enumerate(columns):
        for got, want in zip((r[j] for r in rows), df[name].tolist()):
            assert (type(got) is type(want) and got == want) or (
                got != got and want != want), (name, got, want)


def test_read_rows_reads_xlsx_and_normalizes_failures(tmp_path):
    from cmoop_audio_processing_torch.utils.xlsx import write_xlsx

    book = str(tmp_path / "t.xlsx")
    write_xlsx(book, {"Sheet1": (["Accuracy", None, "use_bn"],
                                 [[0.5, 1, True], [None, 2, False]])})
    columns, rows = read_rows(book)
    assert columns == ["Accuracy", "Unnamed: 1", "use_bn"]
    assert rows[0] == [0.5, 1, True] and rows[1][0] != rows[1][0]
    empty = tmp_path / "empty.csv"
    empty.write_bytes(b"")
    for bad in (str(empty), str(tmp_path / "torn.xlsx")):
        if bad.endswith(".xlsx"):
            (tmp_path / "torn.xlsx").write_bytes(b"PK\x03\x04 torn")
        with pytest.raises(UnreadableTableError):
            read_rows(bad)
    with pytest.raises(FileNotFoundError):
        read_rows(str(tmp_path / "nope.csv"))
