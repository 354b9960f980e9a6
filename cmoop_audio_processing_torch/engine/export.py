"""Train, persist and reload a single selected architecture.

The reference workflow ends at a Pareto front CSV: every trained Keras model
is discarded (`clear_session` per candidate, sa_nsga_penalty.py:211-212),
and the user is left to re-train the chosen genome by hand for deployment.
This module closes that gap, as cmoop_audio_processing_tpu/engine/export.py
does: train ONE genome with the exact search-time training semantics (same
genome-keyed init, same Adam/early-stop/restore-best loop —
engine/trainer.py), then save the weights in a plain-npz format that
reloads without pickle.

On-disk layout (one directory), the JAX package's, so a model saved by
either package loads in the other:
    model.npz   flattened params + BN state (keys are '/'-joined tree paths
                in sorted order, params under 'p/', state under 's/'), with
                weights in the JAX package's layout (conv kernels HWIO;
                models/supernet.params_to_jax)
    meta.json   genome, num_classes, template, metrics, train settings

``model.npz`` is written with a fixed member timestamp, so one (genome,
seed, dataset) training exports the same bytes every time.

The saved model reproduces the search's reported fitness: `predict` runs
the masked supernet forward (eval mode) of models/supernet.apply_model.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.config import TrainConfig
from ..core.device import resolve_device
from ..core.genome import Genome
from ..models.genome_arch import model_size_mb
from ..models.supernet import (
    BucketSpec,
    apply_model,
    params_from_jax,
    params_to_jax,
    stack_flags,
    tree_map,
)


def train_single(
    genome: Genome,
    data: Dict[str, np.ndarray],
    cfg: TrainConfig,
    seed: int = 0,
    device="cuda",
) -> Tuple[Dict, Dict, Dict]:
    """Train one genome on ``device`` exactly as the search evaluator would
    (same init, shuffle/dropout streams, early stopping and restore-best),
    but keep the trained parameters. Returns (params, state, metrics): this
    package's layout, the pop axis stripped."""
    from .evaluator import PopulationEvaluator

    ev = PopulationEvaluator(data, cfg, device=device)
    out, carry = ev.run_single_with_params(genome, seed)
    best = "best_" if cfg.restore_best_weights else ""
    acc_key = "acc_eval" if cfg.accuracy_from == "best" else "acc_last"
    metrics = {
        "accuracy": float(out[acc_key][0]),
        "size_mb": model_size_mb(genome, cfg.num_classes, cfg.template),
        "fpr": float(out["fpr"][0]),
        "val_loss": float(out["val_loss"][0]),
        "epochs_ran": int(out["epochs_ran"][0]),
    }

    def strip(t):
        return tree_map(lambda a: a[0], t)

    return strip(carry[best + "params"]), strip(carry[best + "state"]), metrics


def _flatten(tree: Dict, prefix: str) -> Dict[str, np.ndarray]:
    """'/'-joined paths in sorted key order, as jax.tree_util flattens."""
    flat = {}
    for key in sorted(tree):
        path = f"{prefix}/{key}"
        if isinstance(tree[key], dict):
            flat.update(_flatten(tree[key], path))
        else:
            flat[path] = np.asarray(tree[key])
    return flat


def _unflatten(flat: Dict[str, np.ndarray], prefix: str) -> Dict:
    tree: Dict = {}
    for key, arr in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        parts = key[len(prefix) + 1 :].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def _savez(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez`` with a fixed timestamp on every member."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for key, arr in arrays.items():
            info = zipfile.ZipInfo(f"{key}.npy", date_time=(1980, 1, 1, 0, 0, 0))
            with zf.open(info, "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr),
                                          allow_pickle=False)


def save_model(
    out_dir: str,
    genome: Genome,
    cfg: TrainConfig,
    params: Dict,
    state: Dict,
    metrics: Dict,
    seed: int,
    input_hw=None,
) -> None:
    """Write ``params``/``state`` (this package's layout, one model) in the
    JAX package's model directory format."""
    os.makedirs(out_dir, exist_ok=True)
    jparams, jstate = params_to_jax(params, state)
    _savez(os.path.join(out_dir, "model.npz"),
           {**_flatten(jparams, "p"), **_flatten(jstate, "s")})
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(
            {
                "genome": dict(genome),
                "num_classes": cfg.num_classes,
                "template": cfg.template,
                "compute_dtype": cfg.compute_dtype,
                "dropout_rate": cfg.dropout_rate,
                "seed": seed,
                "metrics": metrics,
                # (H, W) of the feature map — the Keras/TFLite realization
                # needs a concrete input signature (models/keras_export.py)
                "input_hw": list(input_hw) if input_hw is not None else None,
            },
            f,
            indent=2,
        )


def load_jax_layout(model_dir: str):
    """(meta, params, state) of a saved model, the weights as numpy arrays
    in the JAX package's layout (models/keras_export.py reads these)."""
    with open(os.path.join(model_dir, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(model_dir, "model.npz")) as npz:
        flat = dict(npz)
    return meta, _unflatten(flat, "p"), _unflatten(flat, "s")


def load_model(model_dir: str, device="cuda"):
    """Returns (genome, spec, params, state, meta): the first four feed
    ``predict`` directly, with params/state in this package's layout on
    ``device``; ``meta`` is the saved meta.json dict (template, metrics,
    seed, ...)."""
    meta, jparams, jstate = load_jax_layout(model_dir)
    genome = meta["genome"]
    spec = BucketSpec(
        template=meta["template"],
        filters=int(genome["filters"]),
        kernel=int(genome["kernel_size"]),
        num_classes=int(meta["num_classes"]),
        dropout_rate=float(meta.get("dropout_rate", 0.3)),
        compute_dtype=meta.get("compute_dtype", "float32"),
        max_blocks=int(genome["residual_blocks"]),
    )
    params, state = params_from_jax(jparams, jstate, resolve_device(device))
    return genome, spec, params, state, meta


@torch.no_grad()
def predict(spec: BucketSpec, genome: Genome, params, state, x,
            device="cuda") -> np.ndarray:
    """Eval-mode logits for a batch x (B, H, W, 1) on ``device`` (the
    forward the search scored), as a float32 numpy array."""
    dev = resolve_device(device)
    flags = {k: v[0] for k, v in stack_flags([genome], dev).items()}
    logits, _ = apply_model(
        spec,
        tree_map(lambda a: a.to(dev), params),
        tree_map(lambda a: a.to(dev), state),
        flags,
        torch.as_tensor(np.asarray(x, np.float32), device=dev),
        train=False,
    )
    return logits.float().cpu().numpy()
