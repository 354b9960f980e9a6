"""SurrogateManager: four independent GPs (neg_acc, size, fpr, cv) over an
append-only, deduplicated evaluation archive.

Contract reproduced from the reference (sa_nsga_penalty.py:258-363; the
mean+std variant sa_nsga_local.py:169-234):

* Feature map: numerical passthrough [filters, kernel_size,
  residual_blocks, fc_layers] + one-hot [use_bn, use_dropout] (categories
  ordered False, True — sklearn OneHotEncoder ordering), giving 8 columns.
* Targets standardized per-GP (StandardScaler); predictions inverse-
  transformed; stds un-scaled by sqrt(scaler variance)
  (sa_nsga_local.py:223).
* Archive dedup: one entry per genome, keep the most recent evaluation
  (drop_duplicates keep='last', sa_nsga_penalty.py:325-327).
* Refit-from-scratch on every update (the archive is tiny: <= a few hundred
  points); all 4 GPs' multi-restart fits run as one batched computation on
  the manager's device (surrogate/gp.py).
* predict_and_structure returns the reference's individual records with
  predicted CV clamped >= 0 (sa_nsga_penalty.py:355-363).

A copy of cmoop_audio_processing_tpu/surrogate/manager.py with the same
archive, dedup and ``state_dict`` schema. Each update seeds target i's
restart draws with ``fold_in(seed_key(seed), update * 10 + i)``
(core/rng.py), where the JAX package folds the same numbers into a
``jax.random`` key.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.device import resolve_device
from ..core.genome import Genome, genome_key
from ..core.records import Individual
from ..core.rng import fold_in, seed_key
from .gp import GPConfig, GPState, fit_gp_multi, predict_gp

NUMERICAL = ("filters", "kernel_size", "residual_blocks", "fc_layers")
CATEGORICAL = ("use_bn", "use_dropout")
TARGETS = ("neg_acc", "size", "fpr", "cv")


def encode_features(genomes: Sequence[Genome]) -> np.ndarray:
    """Genome dicts -> (N, 8) float matrix: passthrough numerics then one-hot
    booleans with category order (False, True)."""
    rows = []
    for g in genomes:
        row = [float(g[k]) for k in NUMERICAL]
        for c in CATEGORICAL:
            v = bool(g[c])
            row.extend([1.0 if not v else 0.0, 1.0 if v else 0.0])
        rows.append(row)
    return np.asarray(rows, dtype=np.float64)


class _TargetScaler:
    def fit(self, y: np.ndarray):
        self.mean_ = float(np.mean(y))
        self.var_ = float(np.var(y))
        self.scale_ = np.sqrt(self.var_) if self.var_ > 0 else 1.0
        return self

    def transform(self, y):
        return (y - self.mean_) / self.scale_

    def inverse(self, y):
        return y * self.scale_ + self.mean_


class SurrogateManager:
    def __init__(self, gp_config: Optional[GPConfig] = None, seed: int = 0,
                 device="cuda"):
        self.cfg = gp_config or GPConfig(nu=1.5, n_restarts=10)
        self.device = resolve_device(device)
        self.is_fitted = False
        self._archive: "OrderedDict[tuple, Dict]" = OrderedDict()
        self._models: Dict[str, GPState] = {}
        self._scalers: Dict[str, _TargetScaler] = {}
        self._seed = seed
        self._update_count = 0

    # -- archive --------------------------------------------------------------

    def _targets_of(self, res: Individual) -> Dict[str, float]:
        from ..core.records import metrics_of

        m = metrics_of(res)
        return {
            "neg_acc": -m["acc"],
            "size": m["size"],
            "fpr": m["fpr"],
            "cv": res["CV"],
        }

    @property
    def archive_size(self) -> int:
        return len(self._archive)

    def archive_items(self) -> List[Dict]:
        return list(self._archive.values())

    # -- fit ------------------------------------------------------------------

    def update(self, hparams_list: Sequence[Genome], results_list: Sequence[Individual]):
        """Merge new evaluations into the archive (dedup keep-last) and refit
        all four GPs from scratch."""
        for g, res in zip(hparams_list, results_list):
            key = genome_key(g)
            self._archive.pop(key, None)
            self._archive[key] = {"genome": dict(g), **self._targets_of(res)}

        genomes = [e["genome"] for e in self._archive.values()]
        x = encode_features(genomes)
        self._update_count += 1
        self._refit(x)
        self.is_fitted = True

    def _refit(self, x) -> None:
        """All 4 targets' multi-restart GP fits in one batched computation."""
        ys, seeds = [], []
        for i, t in enumerate(TARGETS):
            y = np.array([e[t] for e in self._archive.values()], np.float64)
            scaler = _TargetScaler().fit(y)
            self._scalers[t] = scaler
            ys.append(scaler.transform(y))
            seeds.append(
                fold_in(seed_key(self._seed), self._update_count * 10 + i)
            )
        states = fit_gp_multi(x, ys, self.cfg, seeds, device=self.device)
        for t, st in zip(TARGETS, states):
            self._models[t] = st

    # -- predict --------------------------------------------------------------

    def predict(
        self, hparams_list: Sequence[Genome], return_std: bool = False
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]] | Dict[str, np.ndarray]:
        if not self.is_fitted:
            raise RuntimeError("Surrogate models must be fitted before prediction.")
        x = encode_features(hparams_list)
        preds: Dict[str, np.ndarray] = {}
        stds: Dict[str, np.ndarray] = {}
        for t in TARGETS:
            scaler = self._scalers[t]
            if return_std:
                mu, sd = predict_gp(self._models[t], x, self.cfg, return_std=True)
                # std un-scaled by sqrt(scaler.var_); zero-variance targets
                # yield zero std (sa_nsga_local.py:223)
                stds[t] = (
                    sd * np.sqrt(scaler.var_)
                    if scaler.var_ > 0
                    else np.zeros_like(sd)
                )
            else:
                mu = predict_gp(self._models[t], x, self.cfg)
            preds[t] = scaler.inverse(mu)
        return (preds, stds) if return_std else preds

    def predict_and_structure(self, hparams_list: Sequence[Genome]) -> List[Individual]:
        """Predictions as reference-shaped individual records with CV >= 0."""
        preds = self.predict(hparams_list)
        out: List[Individual] = []
        for i, g in enumerate(hparams_list):
            acc = -float(preds["neg_acc"][i])
            size = float(preds["size"][i])
            fpr = float(preds["fpr"][i])
            out.append(
                {
                    "hparams": dict(g),
                    "objs": [preds["neg_acc"][i], size, fpr],
                    "CV": max(0.0, float(preds["cv"][i])),
                    "metrics": {"acc": acc, "size": size, "fpr": fpr},
                    "predicted": True,
                }
            )
        return out

    # -- checkpointing --------------------------------------------------------

    def state_dict(self) -> Dict:
        return {
            "archive": [
                {"genome": e["genome"], **{t: e[t] for t in TARGETS}}
                for e in self._archive.values()
            ],
            "seed": self._seed,
            "update_count": self._update_count,
        }

    def load_state_dict(self, state: Dict) -> None:
        self._archive.clear()
        for e in state["archive"]:
            self._archive[genome_key(e["genome"])] = dict(e)
        self._seed = state["seed"]
        self._update_count = state["update_count"]
        if self._archive:
            # refit from the restored archive (same keys as the last update)
            genomes = [e["genome"] for e in self._archive.values()]
            self._refit(encode_features(genomes))
            self.is_fitted = True
