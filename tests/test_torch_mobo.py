"""The PyTorch port's MOBO path against the JAX package's.

* GP fits: given JAX's restart inits, the port's fit (``fit_gp_multi``
  with ``train_gps``' config and target layout) gives the same length
  scales, ``predict_gps`` scores a fitted state the same, and the
  acquisition picks the same candidate.
* Driver: the two packages' GP fits start from different random draws, so
  the drivers are compared with one closed-form stub of ``train_gps`` and
  ``penalized_acquisition`` patched into both modules (the pattern of
  test_torch_sa_nsga2.py): archives, fronts and artifacts must then be
  identical, through ``run_mobo`` and through each CLI.
* The port's own GP path on the CPU: resume, the periodic-save gate, the
  evaluation seed and the empty PSI init, as tests/test_drivers.py and
  tests/test_xlsx.py check the JAX driver."""

import dataclasses
import filecmp
import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from cmoop_audio_processing_torch.algorithms import mobo as tmobo
from cmoop_audio_processing_torch.cli import main as tcli
from cmoop_audio_processing_torch.core.config import Constraints as TCons
from cmoop_audio_processing_torch.core.config import MoboConfig as TMobo
from cmoop_audio_processing_torch.core.config import get_preset
from cmoop_audio_processing_torch.core.rng import fold_in, seed_key
from cmoop_audio_processing_torch.engine.evaluator import FakeEvaluator as TFake
from cmoop_audio_processing_torch.surrogate import acquisition as tacq
from cmoop_audio_processing_torch.surrogate import gp as tgp
from cmoop_audio_processing_torch.utils.reporting import RunReporter as TReporter
from cmoop_audio_processing_tpu.algorithms import mobo as jmobo
from cmoop_audio_processing_tpu.cli import main as jcli
from cmoop_audio_processing_tpu.core.config import Constraints as JCons
from cmoop_audio_processing_tpu.core.config import MoboConfig as JMobo
from cmoop_audio_processing_tpu.engine.evaluator import FakeEvaluator as JFake
from cmoop_audio_processing_tpu.surrogate import acquisition as jacq
from cmoop_audio_processing_tpu.surrogate import gp as jgp
from cmoop_audio_processing_tpu.utils.reporting import RunReporter as JReporter
from cmoop_audio_processing_tpu.utils.xlsx import read_xlsx, sheet_names

# the test workers share the CPU's cores: one intra-op thread per worker
# keeps PyTorch's thread pool from oversubscribing them
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FINAL_CSV = os.path.join(ROOT, "examples", "all8", "Final.csv")


# --- GP fits and acquisition ---------------------------------------------------

def _archive(n=20, seed=3):
    """A well-conditioned archive: distinct points in [0,1]^6, smooth
    targets (three objectives and a CV column)."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, 6))
    objs = np.column_stack([
        -(0.8 + 0.1 * np.sin(1.5 * x[:, 0]) + 0.05 * x[:, 2]),
        0.2 + 2.0 * x[:, 1] * x[:, 2] + 0.3 * x[:, 4],
        0.05 + 0.04 * np.cos(2 * x[:, 3] + x[:, 5]),
    ])
    cv = np.maximum(0.0, objs[:, 1:2] - 1.0)
    return x, objs, cv


def _jax_inits(n_cols, seed):
    keys = [jax.random.fold_in(jax.random.key(seed), d) for d in range(n_cols)]
    per = [jgp._make_inits(jacq.MOBO_GP_CONFIG, k) for k in keys]
    return {k: np.stack([np.asarray(p[k]) for p in per]) for k in per[0]}


def _fit_from_jax_inits(x, y, seed):
    """The port's ``train_gps`` fit, started from the restart inits JAX's
    ``train_gps(x, y, seed)`` draws."""
    cols = y.shape[1]
    seeds = [fold_in(seed_key(seed), d) for d in range(cols)]
    return tgp.fit_gp_multi(x, [y[:, d] for d in range(cols)],
                            tacq.MOBO_GP_CONFIG, seeds, normalize_y=True,
                            device="cpu", inits=_jax_inits(cols, seed))


def test_train_gps_given_jax_inits_matches_jax():
    x, objs, cv = _archive()
    for y, seed in ((objs, 7), (cv + 0.01 * x[:, :1], 1007)):
        want = jacq.train_gps(x, y, seed=seed)
        got = _fit_from_jax_inits(x, y, seed)
        assert len(got) == len(want) == y.shape[1]
        for g, w in zip(got, want):
            assert (g.log_c, g.log_n) == (w.log_c, w.log_n)
            assert g.log_l == pytest.approx(w.log_l, abs=1e-3)


def test_predict_gps_and_acquisition_argmax_match_jax():
    x, objs, cv = _archive()
    cands = np.random.default_rng(5).random((500, 6))
    j_objs = jacq.train_gps(x, objs, seed=7)
    j_cv = jacq.train_gps(x, cv, seed=1007)[0]
    # the same fitted states through both scorers
    np.testing.assert_allclose(tacq.predict_gps(j_objs + [j_cv], cands),
                               jacq.predict_gps(j_objs + [j_cv], cands),
                               rtol=0, atol=1e-6)
    # each package's own fit (the port's from JAX's inits) picks the same
    # candidate
    t_objs = _fit_from_jax_inits(x, objs, 7)
    t_cv = _fit_from_jax_inits(x, cv, 1007)[0]
    for lam in (0.5, 10.0):
        assert int(np.argmax(tacq.penalized_acquisition(cands, t_objs, t_cv, lam))) \
            == int(np.argmax(jacq.penalized_acquisition(cands, j_objs, j_cv, lam)))


def test_train_gps_seeds_each_column_and_repeats():
    x, objs, _ = _archive(12)
    a = tacq.train_gps(x, objs, seed=4, device="cpu")
    b = tacq.train_gps(x, objs, seed=4, device="cpu")
    assert [s.log_l for s in a] == [s.log_l for s in b]
    assert tacq.lcb(np.array([1.0, 2.0]), np.array([0.5, 1.0]), k=2.0).tolist() \
        == [0.0, 0.0]


# --- the driver with a shared stub surrogate ----------------------------------

_W = np.array([0.3, -0.2, 0.5, 0.1, -0.4, 0.25])


def _stub_train_gps(x, y, seed=0, device=None):
    """Closed-form "fits": each column's mean and the archive size."""
    y = np.atleast_2d(np.asarray(y, np.float64))
    if y.shape[0] != np.asarray(x).shape[0]:
        y = y.T
    return [(float(y[:, d].mean()), len(y), seed) for d in range(y.shape[1])]


def _stub_acquisition(cands, obj_gps, cv_gp, lam):
    shift = sum(m for m, _, _ in obj_gps) + lam * cv_gp[0]
    return -(cands @ _W) * (1.0 + 0.01 * obj_gps[0][1]) - 0.001 * shift


@pytest.fixture
def stub_surrogate(monkeypatch):
    for mod in (jmobo, tmobo):
        monkeypatch.setattr(mod, "train_gps", _stub_train_gps)
        monkeypatch.setattr(mod, "penalized_acquisition", _stub_acquisition)


def _mobo_cfg(config_cls, cons_cls, **kw):
    return config_cls(constraints=cons_cls(0.85, 2.5, 0.09), **kw)


def test_run_mobo_with_a_shared_stub_equals_the_jax_driver(tmp_path, stub_surrogate):
    kw = dict(initial_samples=6, max_iterations=5, candidate_batch=50, seed=3,
              periodic_save_every=2)
    jpareto, jdfs = jmobo.run_mobo(_mobo_cfg(JMobo, JCons, **kw), JFake(noise=0.01),
                                   JReporter(str(tmp_path / "jax"), "run"))
    tfake = TFake(noise=0.01)
    tpareto, trows = tmobo.run_mobo(_mobo_cfg(TMobo, TCons, **kw), tfake,
                                    TReporter(str(tmp_path / "torch"), "run"),
                                    device="cpu")
    assert tfake.total_true_evals == 6 + 5
    assert tpareto and len(trows) == len(jdfs) == 5
    assert [df.to_dict("records") for df in jdfs] == trows
    assert [(p["hparams"], list(map(float, p["objs"])), p["CV"]) for p in tpareto] \
        == [(p["hparams"], list(map(float, p["objs"])), p["CV"]) for p in jpareto]
    jdir, tdir = tmp_path / "jax" / "run", tmp_path / "torch" / "run"
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for name in ("mobo_pareto.csv", "mobo_iteration_2.csv", "mobo_iteration_4.csv",
                 "mobo_iteration_5.csv", "all_generations.csv"):
        assert filecmp.cmp(jdir / name, tdir / name, shallow=False), name
    for book in ("mobo_iterations.xlsx", "all_generations.xlsx"):
        names = sheet_names(str(jdir / book))
        assert sheet_names(str(tdir / book)) == names
        for sheet in names:
            pd.testing.assert_frame_equal(read_xlsx(str(tdir / book), sheet),
                                          read_xlsx(str(jdir / book), sheet))


@pytest.mark.parametrize("preset", ["mobo_penalty", "psi_mobo_2"])
def test_mobo_cli_fake_eval_artifacts_equal_the_jax_clis(tmp_path, preset,
                                                         stub_surrogate):
    args = ["--preset", preset, "--fake-eval", "--max-gen", "6", "--seed", "5"]
    if preset == "psi_mobo_2":
        args += ["--psi-seed-file", FINAL_CSV]
    assert jcli.main(args + ["--out", str(tmp_path / "jax")]) == 0
    assert tcli.main(args + ["--out", str(tmp_path / "torch"),
                             "--device", "cpu"]) == 0
    jdir, tdir = tmp_path / "jax" / preset, tmp_path / "torch" / preset
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    csvs = sorted(f for f in os.listdir(jdir) if f.endswith(".csv"))
    assert {"mobo_pareto.csv", "mobo_iteration_5.csv", "mobo_iteration_6.csv",
            "all_generations.csv"} <= set(csvs)
    for name in csvs:
        assert filecmp.cmp(jdir / name, tdir / name, shallow=False), name
    with open(tdir / "all_generations.csv") as f:
        rows = f.read().splitlines()
    n_init = 15 if preset == "mobo_penalty" else len(pd.read_csv(FINAL_CSV))
    assert len(rows) == 1 + sum(n_init + k for k in range(1, 7))


def test_cli_overrides_reach_the_mobo_config():
    """--seed, --max-gen and --psi-seed-file set cfg.mobo as the JAX CLI
    does."""
    argv = ["--preset", "psi_mobo_2", "--seed", "9", "--max-gen", "4",
            "--psi-seed-file", "stage1.csv"]
    got = tcli.config_from_args(tcli.build_parser().parse_args(argv)).mobo
    want = jcli.config_from_args(jcli.build_parser().parse_args(argv)).mobo
    assert (got.seed, got.max_iterations, got.psi_seed_file) == (9, 4, "stage1.csv")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert get_preset("mobo_penalty").mobo.max_iterations == 30


# --- the port's own GP path ---------------------------------------------------

CONS = TCons(0.85, 2.5, 0.09)


def test_mobo_checkpoint_resume_rebuilds_sheets(tmp_path):
    """tests/test_drivers.py::test_mobo_checkpoint_resume_rebuilds_sheets on
    the port, with its real GP fits on the CPU."""
    def mk_cfg(iters):
        return TMobo(initial_samples=5, max_iterations=iters,
                     candidate_batch=50, constraints=CONS, seed=4)

    pareto_full, rows_full = tmobo.run_mobo(mk_cfg(4), TFake(), device="cpu")
    ck = str(tmp_path / "ck.json")
    tmobo.run_mobo(mk_cfg(2), TFake(), checkpoint_path=ck, device="cpu")
    fake = TFake()
    pareto_res, rows_res = tmobo.run_mobo(
        mk_cfg(4), fake, TReporter(str(tmp_path), "mobo_resume"),
        checkpoint_path=ck, device="cpu")
    assert fake.total_true_evals == 2
    assert [p["hparams"] for p in pareto_res] == [p["hparams"] for p in pareto_full]
    assert rows_res == rows_full and len(rows_res) == 4
    wb = str(tmp_path / "mobo_resume" / "all_generations.xlsx")
    assert sheet_names(wb) == [f"Gen_{i}" for i in range(4)]
    assert len(read_xlsx(wb, "Gen_0")) == 6 and len(read_xlsx(wb, "Gen_3")) == 9


def test_mobo_periodic_gate_is_single_knob(tmp_path):
    cfg = TMobo(initial_samples=4, max_iterations=4, candidate_batch=50,
                constraints=CONS, seed=2, periodic_save_every=2)
    tmobo.run_mobo(cfg, TFake(), TReporter(str(tmp_path), "gate", periodic_every=5),
                   device="cpu")
    names = sorted(f for f in os.listdir(tmp_path / "gate") if "iteration" in f)
    assert names == ["mobo_iteration_2.csv", "mobo_iteration_4.csv",
                     "mobo_iterations.xlsx"]


class _SeedRecordingEvaluator(TFake):
    def __init__(self):
        super().__init__()
        self.seeds = []

    def evaluate(self, genomes, seed=0):
        assert len(genomes) == 1  # MOBO trains one genome at a time
        self.seeds.append(int(seed))
        return super().evaluate(genomes, seed=seed)


@pytest.mark.parametrize("eval_seed", [None, 42])
def test_eval_seed_fixes_mobo_true_evaluations(eval_seed):
    ev = _SeedRecordingEvaluator()
    tmobo.run_mobo(TMobo(initial_samples=4, max_iterations=2, seed=5,
                         eval_seed=eval_seed, constraints=CONS), ev, device="cpu")
    want = [42] * 6 if eval_seed else [5, 6, 7, 8, 105, 106]
    assert ev.seeds == want


def test_mobo_psi_missing_file_noop_run(tmp_path):
    cfg = dataclasses.replace(get_preset("psi_mobo_2").mobo,
                              psi_seed_file=str(tmp_path / "nope.xlsx"),
                              max_iterations=2)
    pareto, rows = tmobo.run_mobo(cfg, TFake(), device="cpu")
    assert pareto == [] and rows == []
