"""The yardstick's frozen copies equal the port's originals, over the whole
search space at each configuration's shapes, reached through the
architecture module the configuration names, and the benchmark's data
equals the port's synthetic maps."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import cell, data, frozen, reference
from benchmark.reference import keras_cnn
from cmoop_audio_processing_torch.core import genome as pgenome
from cmoop_audio_processing_torch.core import rng as prng
from cmoop_audio_processing_torch.data.pipeline import Standardizer
from cmoop_audio_processing_torch.data.synthetic import make_synthetic
from cmoop_audio_processing_torch.engine import trainer as ptrainer
from cmoop_audio_processing_torch.models import genome_arch, supernet

GENOMES = frozen.all_genomes()


def _configurations():
    """(architecture module, template, classes, (H, W)) of each
    configuration in BENCHMARK.json, by its name."""
    out = []
    for c in cell.bench()["configs"]:
        with open(os.path.join(cell.ROOT, c["file"])) as f:
            conf = json.load(f)
        t, d = conf["train"], conf["data"]
        out.append(pytest.param(
            reference.load(conf["reference"]), t["template"],
            t["num_classes"], (d["time_steps"], d["features"]), id=c["name"]))
    return out


SHAPES = _configurations()


def test_space_is_the_ports():
    assert frozen.GENE_ORDER == pgenome.GENE_ORDER
    assert frozen.HPARAM_SPACE == pgenome.HPARAM_SPACE
    assert frozen.FC_CONFIGS == pgenome.FC_CONFIGS
    assert keras_cnn.FC_WIDTHS == supernet.FC_WIDTHS
    assert GENOMES == pgenome.all_genomes()
    assert [frozen.genome_uid(g) for g in GENOMES] == [
        supernet.genome_uid(g) for g in GENOMES]


@pytest.mark.parametrize("arch,template,classes,hw", SHAPES)
def test_counts_equal_the_ports(arch, template, classes, hw):
    for g in GENOMES:
        assert arch.count_params(g, classes, template) == \
            genome_arch.count_params(g, classes, template)
        assert arch.model_size_mb(g, classes, template) == \
            genome_arch.model_size_mb(g, classes, template)
        assert arch.count_fwd_flops(g, hw, classes, template) == \
            genome_arch.count_fwd_flops(g, hw, classes, template)


def test_counter_hash_equals_the_ports():
    r = np.random.default_rng(0)
    keys = [int(k) for k in r.integers(0, 2 ** 32, 200)]
    data_ = [int(k) for k in r.integers(0, 2 ** 40, 200)]
    for k, d in zip(keys, data_):
        assert frozen.fold_in(k, d) == prng.fold_in(k, d)
        assert frozen.seed_key(d) == prng.seed_key(d)
    t = torch.as_tensor(data_, dtype=torch.int64)
    assert torch.equal(frozen.fold_in(keys[0], t), prng.fold_in(keys[0], t))
    for seed in (0, 7, 2 ** 31 + 5, 3_000_000_001):
        assert frozen.train_key_of(seed) == ptrainer.train_key_of(seed)


@pytest.mark.parametrize("arch,template,classes,hw", SHAPES)
def test_init_equals_the_ports(arch, template, classes, hw):
    for g in GENOMES:
        spec = supernet.BucketSpec(template=template, filters=g["filters"],
                                   kernel=g["kernel_size"],
                                   num_classes=classes,
                                   max_blocks=g["residual_blocks"])
        pp, ps = supernet.init_params(2 ** 31 + 17, spec, g)
        fp, fs = arch.init_params(2 ** 31 + 17, template, g["filters"],
                                  g["kernel_size"], classes,
                                  g["residual_blocks"], g)
        for a, b in zip(supernet.tree_leaves(pp), supernet.tree_leaves(fp)):
            assert torch.equal(a, b)
        for a, b in zip(supernet.tree_leaves(ps), supernet.tree_leaves(fs)):
            assert torch.equal(a, b)


def test_dropout_and_shuffle_equal_the_ports():
    uids = torch.as_tensor([frozen.genome_uid(g) for g in GENOMES])
    for key in (0, 12345, 2 ** 32 - 1):
        for layer, units in enumerate(frozen.FC_CONFIGS[4]):
            a = frozen.dropout_mask(key, uids, layer, (64, units), 0.7)
            b = supernet.dropout_mask(key, uids, layer, (64, units), 0.7)
            assert torch.equal(a, b)
    tr = ptrainer.PopulationTrainer.__new__(ptrainer.PopulationTrainer)
    for key in (1, 99, 2 ** 31 + 3):
        assert torch.equal(frozen.permutation(key, 21056),
                           tr.permutation(key, 21056))
    x = np.arange(100 * 3, dtype=np.float32).reshape(100, 3)
    y = np.arange(100, dtype=np.int32)
    for a, b in zip(frozen.pad_dataset(x, y, 64),
                    ptrainer.pad_dataset(x, y, 64)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("t,f", [(45, 13), (501, 40)])
def test_data_equals_the_ports(t, f):
    seed = 2 ** 31 + 11
    ours = data.make_synthetic(11, 40, 20, t, f, seed)
    port = make_synthetic(num_classes=11, n_train=40, n_eval=20,
                          time_steps=t, features=f, seed=seed)
    for k in ("x_train", "y_train", "x_val", "y_val"):
        np.testing.assert_allclose(ours[k], port[k], rtol=0, atol=1e-6)
    st = data.standardize(ours)
    sc = Standardizer().fit(ours["x_train"])
    np.testing.assert_allclose(st["x_val"][..., 0],
                               sc.transform(ours["x_val"]), atol=1e-6)
    assert st["x_train"].shape == (40, t, f, 1)
