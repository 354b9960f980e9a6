"""The PyTorch port's export path against the JAX package's: the same
model directory format both ways, a trained model that reproduces the
search's fitness, the committed exported models read through the port, the
Keras realization, and the train_final command."""

import json
import os

import numpy as np
import pytest
import torch

import jax
from cmoop_audio_processing_torch.cli import train_final as ttf
from cmoop_audio_processing_torch.core.config import DataConfig, TrainConfig
from cmoop_audio_processing_torch.data.loaders import save_npy_dir
from cmoop_audio_processing_torch.data.pipeline import prepare_dataset
from cmoop_audio_processing_torch.data.synthetic import make_synthetic
from cmoop_audio_processing_torch.engine import export as tex
from cmoop_audio_processing_torch.engine.evaluator import PopulationEvaluator
from cmoop_audio_processing_torch.models.supernet import params_from_jax
from cmoop_audio_processing_tpu.core.config import TrainConfig as JTrainConfig
from cmoop_audio_processing_tpu.engine import export as jex
from cmoop_audio_processing_tpu.models import supernet as jsn

# the test workers share the CPU's cores: one intra-op thread per worker
# keeps PyTorch's thread pool from oversubscribing them
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENOME = dict(filters=16, kernel_size=3, use_bn=True, residual_blocks=2,
              fc_layers=2, use_dropout=True)
METRICS = {"accuracy": 0.5, "size_mb": 0.25, "fpr": 0.125, "val_loss": 1.5,
           "epochs_ran": 3}


@pytest.fixture(scope="module")
def data():
    return prepare_dataset(DataConfig(synthetic_train=128, synthetic_eval=64,
                                      time_steps=12, features=8, num_classes=4))


def _cfg(**kw):
    return TrainConfig(**{**dict(epochs=6, batch_size=32, patience=3,
                                 num_classes=4, compute_dtype="float32"), **kw})


def test_train_single_equals_the_evaluators_fitness(data):
    """tests/test_export.py::test_train_single_matches_search_fitness on
    the port: the exported model's metrics are the evaluator's fitness for
    the same (genome, seed), bit for bit on the CPU."""
    cfg = _cfg()
    _, _, metrics = tex.train_single(GENOME, data, cfg, seed=5, device="cpu")
    acc, size, fpr = PopulationEvaluator(data, cfg, device="cpu").evaluate(
        [GENOME], seed=5)[0]
    assert (metrics["accuracy"], metrics["size_mb"], metrics["fpr"]) == (acc, size, fpr)
    assert 1 <= metrics["epochs_ran"] <= 6


@pytest.mark.parametrize("template", ["A", "B"])
def test_save_model_writes_the_jax_packages_files(tmp_path, template):
    """JAX parameters (BN state perturbed) saved by each package: the same
    npz keys in the same order with equal arrays, the same meta.json."""
    spec = jsn.BucketSpec(template, 16, 3, 4, max_blocks=2)
    jparams, jstate = jsn.init_params(jax.random.key(3), spec, GENOME)
    rng = np.random.default_rng(0)
    jstate = jax.tree.map(
        lambda a: np.asarray(a) + rng.random(a.shape).astype(np.float32), jstate)
    cfg = dict(num_classes=4, template=template, compute_dtype="bfloat16")
    jex.save_model(str(tmp_path / "jax"), GENOME, JTrainConfig(**cfg), jparams,
                   jstate, METRICS, seed=3, input_hw=(12, 8))
    tex.save_model(str(tmp_path / "torch"), GENOME, TrainConfig(**cfg),
                   *params_from_jax(jparams, jstate), METRICS, seed=3,
                   input_hw=(12, 8))
    with np.load(tmp_path / "jax" / "model.npz") as j, \
            np.load(tmp_path / "torch" / "model.npz") as t:
        assert list(t.keys()) == list(j.keys())
        for k in j.keys():
            assert t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k]), k
    assert (tmp_path / "torch" / "meta.json").read_bytes() == \
        (tmp_path / "jax" / "meta.json").read_bytes()


def test_a_port_saved_model_predicts_the_same_in_jax(tmp_path, data):
    """A model the port trained and saved: the port's load_model + predict
    reproduces the in-memory forward bit for bit and the reported
    accuracy, JAX's load_model + predict agree at 1e-4, and a second
    export writes the same bytes."""
    cfg = _cfg(epochs=3)
    params, state, metrics = tex.train_single(GENOME, data, cfg, seed=2,
                                              device="cpu")
    for out in ("a", "b"):
        tex.save_model(str(tmp_path / out), GENOME, cfg, params, state, metrics,
                       seed=2, input_hw=data["x_train"].shape[1:3])
    assert (tmp_path / "a" / "model.npz").read_bytes() == \
        (tmp_path / "b" / "model.npz").read_bytes()
    genome, spec, p2, s2, meta = tex.load_model(str(tmp_path / "a"), device="cpu")
    assert genome == GENOME and meta["metrics"] == metrics
    assert spec.max_blocks == GENOME["residual_blocks"]
    x = data["x_val"]
    mem = tex.predict(spec, GENOME, params, state, x, device="cpu")
    got = tex.predict(spec, genome, p2, s2, x, device="cpu")
    np.testing.assert_array_equal(got, mem)
    assert float((got.argmax(-1) == data["y_val"]).mean()) == \
        pytest.approx(metrics["accuracy"], abs=1e-6)
    jgenome, jspec, jp, js, _ = jex.load_model(str(tmp_path / "a"))
    np.testing.assert_allclose(jex.predict(jspec, jgenome, jp, js, x), got,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("model_dir", ["examples/kws_e2e/deployed/model",
                                       "examples/deployed/model"])
def test_committed_exported_models_predict_as_jax_does(model_dir):
    """The two committed bf16 models (saved by the JAX package) through the
    port: argmax agrees with JAX's predict on >= 98% of 64 seeded inputs,
    logits within 5e-2 of the largest |logit|."""
    path = os.path.join(ROOT, model_dir)
    genome, spec, params, state, meta = tex.load_model(path, device="cpu")
    assert spec.compute_dtype == "bfloat16"
    h, w = meta["input_hw"]
    x = np.random.default_rng(7).standard_normal((64, h, w, 1)).astype(np.float32)
    got = tex.predict(spec, genome, params, state, x, device="cpu")
    jgenome, jspec, jp, js, _ = jex.load_model(path)
    want = jex.predict(jspec, jgenome, jp, js, x)
    assert got.shape == want.shape == (64, meta["num_classes"])
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.98
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


@pytest.mark.parametrize("template", ["A", "B"])
def test_keras_realization_of_a_port_saved_model(tmp_path, data, template):
    """models/keras_export.py on a model the port saved: Keras's softmax
    equals the port's forward at 1e-4."""
    tf = pytest.importorskip("tensorflow")
    from cmoop_audio_processing_torch.models.keras_export import export_keras

    cfg = _cfg(epochs=2, template=template)
    genome = dict(GENOME, use_dropout=False, fc_layers=3)
    params, state, metrics = tex.train_single(genome, data, cfg, seed=4,
                                              device="cpu")
    mdir = str(tmp_path / "m")
    tex.save_model(mdir, genome, cfg, params, state, metrics, seed=4,
                   input_hw=data["x_val"].shape[1:3])
    model = export_keras(mdir, None)
    _, spec, p2, s2, _ = tex.load_model(mdir, device="cpu")
    logits = torch.as_tensor(tex.predict(spec, genome, p2, s2, data["x_val"],
                                         device="cpu"))
    np.testing.assert_allclose(model.predict(data["x_val"], verbose=0),
                               torch.softmax(logits, -1).numpy(),
                               rtol=1e-4, atol=1e-5)
    tf.keras.backend.clear_session()


def _front_csv(tmp_path, use_bn="True"):
    path = tmp_path / "front.csv"
    path.write_text(
        "Accuracy,Size_MB,FPR,CV,filters,kernel_size,use_bn,residual_blocks,"
        "fc_layers,use_dropout\n"
        f"0.9,0.1,0.01,0.0,16,3,{use_bn},1,1,False\n"
        "0.8,0.2,0.02,0.0,32,5,False,2,3,True\n")
    return str(path)


def test_train_final_cli_from_a_front_csv(tmp_path, capsys):
    raw = make_synthetic(num_classes=10, n_train=64, n_eval=32, time_steps=12,
                         features=9)
    save_npy_dir(raw, str(tmp_path / "npy"))
    out = str(tmp_path / "deployed")
    assert ttf.main(["--preset", "nsga_penalty", "--front", _front_csv(tmp_path),
                     "--row", "1", "--source", "npy", "--data-path",
                     str(tmp_path / "npy"), "--epochs", "2", "--seed", "1",
                     "--device", "cpu", "--out", out]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    genome, spec, _, _, meta = tex.load_model(out, device="cpu")
    assert genome == dict(filters=32, kernel_size=5, use_bn=False,
                          residual_blocks=2, fc_layers=3, use_dropout=True)
    assert spec.max_blocks == 2 and meta["input_hw"] == [12, 9]
    assert result["accuracy"] == meta["metrics"]["accuracy"]
    assert meta["compute_dtype"] == "bfloat16"  # the preset's


@pytest.mark.parametrize("use_bn,want", [("True", True), ("1", True),
                                         ("0.0", False), ("yes", None)])
def test_genome_from_row_keeps_the_strict_boolean_whitelist(tmp_path, use_bn, want):
    path = _front_csv(tmp_path, use_bn)
    if want is None:
        with pytest.raises(SystemExit, match="unrecognized boolean cell"):
            ttf.genome_from_row(path, 0)
    else:
        assert ttf.genome_from_row(path, 0)["use_bn"] is want
    with pytest.raises(SystemExit, match="out of range: .* has 2 rows"):
        ttf.genome_from_row(path, 2)
