"""The PyTorch port's SA-NSGA-II driver against the JAX package's.

The GP fits of the two packages start from different random draws, so the
drivers are compared with one closed-form stub surrogate patched into both
modules: every other step (tournaments, offspring, local search, infill
ranking, analytic sizes, environmental selection, reporting) must then give
identical records. The port's own GP path is covered by a checkpoint/resume
run on the CPU."""

import dataclasses
import filecmp

import numpy as np
import pytest
import torch

from cmoop_audio_processing_torch.algorithms import sa_nsga2 as tsa
from cmoop_audio_processing_torch.core import config as tconfig
from cmoop_audio_processing_torch.engine.evaluator import FakeEvaluator as TFake
from cmoop_audio_processing_torch.surrogate import manager as tmanager
from cmoop_audio_processing_torch.surrogate.gp import GPConfig
from cmoop_audio_processing_torch.utils.reporting import RunReporter as TReporter
from cmoop_audio_processing_tpu.algorithms import sa_nsga2 as jsa
from cmoop_audio_processing_tpu.core import config as jconfig
from cmoop_audio_processing_tpu.engine.evaluator import FakeEvaluator as JFake
from cmoop_audio_processing_tpu.surrogate import manager as jmanager
from cmoop_audio_processing_tpu.utils.reporting import RunReporter as JReporter

# the test workers share the CPU's cores: one intra-op thread per worker
# keeps PyTorch's thread pool from oversubscribing them
torch.set_num_threads(1)

FAST_GP = GPConfig(n_restarts=2, steps=60)
# (filters, kernel, blocks, fc, bn no/yes, dropout no/yes) weights per target
_W = {
    "neg_acc": np.array([-0.002, -0.004, -0.03, -0.01, 0.01, -0.01, 0.004, 0.0]),
    "size": np.array([0.02, 0.05, 0.4, 0.1, 0.0, 0.01, 0.0, 0.0]),
    "fpr": np.array([-0.0005, 0.002, -0.02, 0.001, 0.01, -0.005, 0.0, 0.002]),
    "cv": np.array([0.01, 0.02, 0.3, 0.05, 0.05, 0.0, 0.0, 0.02]),
}
_B = {"neg_acc": -0.75, "size": -0.3, "fpr": 0.1, "cv": -1.0}


def _stub(manager_module):
    """A SurrogateManager of ``manager_module`` whose fits are a closed form
    (a linear map of the genome's features, shifted by the archive size)
    instead of GPs; archive, dedup, checkpoint state and record building
    stay the package's own."""

    class Stub(manager_module.SurrogateManager):
        def _refit(self, x):
            self._shift = 0.001 * len(self._archive)

        def predict(self, hparams_list, return_std=False):
            if not self.is_fitted:
                raise RuntimeError("not fitted")
            x = manager_module.encode_features(hparams_list)
            preds = {t: x @ _W[t] + _B[t] + self._shift for t in _W}
            stds = {t: 0.01 + 0.002 * x[:, 1] * (i + 1) for i, t in enumerate(_W)}
            return (preds, stds) if return_std else preds

    return Stub


def _search(config_module, **kw):
    return config_module.SearchConfig(
        constraints=config_module.Constraints(0.85, 2.5, 0.09), **kw)


@pytest.mark.parametrize("local_search", [False, True], ids=["plain", "local_search"])
def test_sa_nsga2_with_a_shared_stub_surrogate_equals_the_jax_driver(
        tmp_path, monkeypatch, local_search):
    monkeypatch.setattr(jsa, "SurrogateManager", _stub(jmanager))
    monkeypatch.setattr(tsa, "SurrogateManager", _stub(tmanager))
    kw = dict(pop_size=8, max_gen=4, infill_percent=0.334, seed=11,
              local_search=local_search, local_search_rounds=3)
    jpareto, _ = jsa.run_sa_nsga2(_search(jconfig, **kw), JFake(),
                                  JReporter(str(tmp_path / "jax"), "run"))
    tfake = TFake()
    tpareto, trows = tsa.run_sa_nsga2(_search(tconfig, **kw), tfake,
                                      TReporter(str(tmp_path / "torch"), "run"),
                                      device="cpu")
    assert tfake.total_true_evals == 8 + 4 * 2
    assert len(trows) == 4
    for name in ("all_generations.csv", "final_pareto.csv"):
        assert filecmp.cmp(tmp_path / "jax" / "run" / name,
                           tmp_path / "torch" / "run" / name, shallow=False), name
    assert [(p["hparams"], list(map(float, p["objs"])), p["CV"],
             p.get("predicted", False)) for p in tpareto] == \
        [(p["hparams"], list(map(float, p["objs"])), p["CV"],
          p.get("predicted", False)) for p in jpareto]


def test_select_infill_points_and_analytic_size_equal_the_jax_packages():
    rng = np.random.default_rng(1)
    from cmoop_audio_processing_torch.core.genome import all_genomes

    genomes = [all_genomes()[i] for i in rng.choice(288, 12, replace=False)]
    recs = [{"hparams": dict(g), "objs": list(rng.random(3)),
             "CV": float(rng.choice([0.0, 0.3, 1.2])),
             "metrics": {"acc": 0.9, "size": -1.0, "fpr": 0.05},
             "predicted": True} for g in genomes]
    assert tsa.select_infill_points(recs, 5) == jsa.select_infill_points(recs, 5)
    t_recs, j_recs = [dict(r, objs=list(r["objs"]), metrics=dict(r["metrics"]))
                      for r in recs], recs
    tsa._use_analytic_size(t_recs, TFake(num_classes=11, template="B"),
                           _search(tconfig))
    jsa._use_analytic_size(j_recs, JFake(num_classes=11, template="B"),
                           _search(jconfig))
    assert t_recs == j_recs


def test_sa_nsga2_checkpoint_resume_reevaluates_only_the_rest(tmp_path):
    """tests/test_drivers.py::test_sa_nsga2_checkpoint_resume on the port,
    with its real GP surrogate on the CPU: the resumed run re-evaluates only
    generations 2-3, and (the surrogate refit from the restored archive with
    the same seeds) ends on the uninterrupted run's front."""
    ck = str(tmp_path / "ck_sa.json")
    half = _search(tconfig, pop_size=6, max_gen=2, infill_percent=0.334, seed=13)
    full = dataclasses.replace(half, max_gen=4)
    tsa.run_sa_nsga2(half, TFake(), checkpoint_path=ck, gp_config=FAST_GP,
                     device="cpu")
    fake = TFake()
    resumed, _ = tsa.run_sa_nsga2(full, fake, checkpoint_path=ck,
                                  gp_config=FAST_GP, device="cpu")
    assert fake.total_true_evals == 2 * 2
    straight, _ = tsa.run_sa_nsga2(full, TFake(), gp_config=FAST_GP,
                                   device="cpu")
    assert resumed
    assert [(p["hparams"], p["objs"], p["CV"]) for p in resumed] == \
        [(p["hparams"], p["objs"], p["CV"]) for p in straight]


def test_sa_nsga2_requires_an_infill_fraction():
    with pytest.raises(ValueError, match="infill_percent"):
        tsa.run_sa_nsga2(_search(tconfig), TFake(), device="cpu")
