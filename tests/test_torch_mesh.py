"""The PyTorch port's device mesh (``parallel/mesh.py``) and the
evaluator's mesh branches, against the JAX package's on the CPU: the mesh
and the launch plan against JAX's (nothing trains, so exactly), training on
a mesh against the port's own no-mesh evaluator (which the other
``test_torch_*`` files hold against JAX), the collectives counted, a
two-process gloo world, and the CLI. The JAX mesh runs on the 8 virtual
CPU devices tests/conftest.py makes; the port's on 8 virtual CPU entries
(one device listed 8 times). JAX is imported only where it is compared."""

import ast
import dataclasses
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cmoop_audio_processing_torch.cli import main as tcli
from cmoop_audio_processing_torch.core.config import DataConfig, TrainConfig
from cmoop_audio_processing_torch.core.genome import all_genomes, genome_key
from cmoop_audio_processing_torch.data.pipeline import prepare_dataset
from cmoop_audio_processing_torch.engine import evaluator as tev
from cmoop_audio_processing_torch.engine import trainer as tt
from cmoop_audio_processing_torch.models import grouped as tg
from cmoop_audio_processing_torch.models import supernet as ts
from cmoop_audio_processing_torch.parallel import mesh as tm

# the test workers share the CPU's cores: one intra-op thread per worker
# keeps PyTorch's thread pool from oversubscribing them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8
G16 = [g for g in all_genomes() if g["filters"] == 16 and g["kernel_size"] == 3]


def _small_data(n_train=64, n_eval=32):
    return prepare_dataset(
        DataConfig(synthetic_train=n_train, synthetic_eval=n_eval,
                   time_steps=12, features=8, num_classes=4))


@pytest.fixture(scope="module")
def data():
    return _small_data()


# -- the mesh -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_population_mesh_axes_match_jax(shape):
    from cmoop_audio_processing_tpu.parallel import mesh as jm

    want = jm.population_mesh(*shape)
    got = tm.population_mesh(*shape, devices=CPU8)
    assert got.axis_names == want.axis_names == ("pop", "data")
    assert got.devices.shape == want.devices.shape == shape
    assert got.shape == dict(want.shape)
    assert (got.process_index == 0).all()
    assert got.local_pop_shards() == list(range(shape[0]))


def test_population_mesh_too_many_devices_matches_jax():
    from cmoop_audio_processing_tpu.parallel import mesh as jm

    with pytest.raises(ValueError) as want:
        jm.population_mesh(16, 1)
    with pytest.raises(ValueError) as got:
        tm.population_mesh(16, 1, devices=CPU8)
    assert str(got.value) == str(want.value)


def test_population_mesh_default_devices_are_the_visible_gpus(monkeypatch):
    """With no device list the mesh takes the visible CUDA devices, all on
    'pop' by default, as JAX's takes ``jax.devices()``; too few raise."""
    from cmoop_audio_processing_tpu.parallel import mesh as jm

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    got = tm.population_mesh()
    assert got.devices.shape == jm.population_mesh().devices.shape
    assert list(got.devices.flat) == [torch.device(f"cuda:{i}")
                                      for i in range(8)]
    assert tm.population_mesh(2, 2).devices.tolist() == [
        [torch.device("cuda:0"), torch.device("cuda:1")],
        [torch.device("cuda:2"), torch.device("cuda:3")]]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="needs 1 devices, have 0"):
        tm.population_mesh(1, 1)


def test_shard_population_places_leading_axis():
    """Each pop shard holds its 1/8 of the leading axis on its device, as
    JAX's ``shard_population`` shards it (tests/test_parallel.py)."""
    from cmoop_audio_processing_tpu.parallel import mesh as jm

    tree = {"w": np.arange(8 * 16, dtype=np.float32).reshape(8, 4, 4),
            "b": np.arange(8, dtype=np.float32)}
    jax_shards = jm.shard_population(tree, jm.population_mesh(8, 1))
    want = {k: v.sharding.shard_shape(v.shape) for k, v in jax_shards.items()}
    mesh = tm.population_mesh(8, 1, devices=CPU8)
    got = tm.shard_population(ts.tree_map(torch.as_tensor, tree), mesh)
    assert sorted(got) == list(range(8))
    for i, shard in got.items():
        assert {k: tuple(v.shape) for k, v in shard.items()} == want
        assert shard["w"].device == tm.pop_sharding(mesh)[i]
        np.testing.assert_array_equal(shard["w"].numpy(), tree["w"][i:i + 1])


def test_placement_helpers():
    mesh = tm.population_mesh(2, 2, devices=CPU8)
    assert tm.pop_sharding(mesh) == [torch.device("cpu")] * 2
    assert tm.batch_sharding(mesh, 1) == [torch.device("cpu")] * 2
    assert tm.replicated(mesh) == [torch.device("cpu")]


def test_distributed_init_noop_single_process():
    assert tm.distributed_init() is None
    assert tm.distributed_init(num_processes=1, process_id=0) is None
    assert not dist.is_initialized()


# -- the launch plan ----------------------------------------------------------

def _stub(calls, with_lanes):
    """A ``_run_bucket`` that trains nothing: it records the launch and
    answers with per-lane results derived from the genome alone."""
    def run_bucket(self, spec, padded, seed):
        keys = [genome_key(g) for g in padded]
        calls.append((spec.filters, spec.kernel, spec.max_blocks, keys))
        out = {
            "acc": np.array([0.5 + 0.01 * k[3] + 0.001 * k[4] for k in keys]),
            "fpr": np.array([0.1 - 0.01 * k[3] for k in keys]),
            "epochs": np.array([3 + 2 * k[4] + 5 * int(k[2]) for k in keys],
                               np.int32),
        }
        if with_lanes:
            out["lanes"] = [len(padded)]
        return out

    return run_bucket


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
@pytest.mark.parametrize("chunk", [-1, 3])
def test_launch_plan_on_mesh_equals_jax(data, monkeypatch, shape, chunk):
    """On a mesh the port plans the JAX evaluator's launches: lanes padded
    to a multiple of the pop width after the power-of-two rounding, every
    launch one-shot (compaction forced off), the same chunk records and
    fitness list; a data axis > 1 forces the vmap forward. Neither the
    heavy-lane split nor the duration bound applies on a mesh: both
    packages' sustained rate is set low enough that both would without
    one."""
    from cmoop_audio_processing_tpu.core.config import TrainConfig as JCfg
    from cmoop_audio_processing_tpu.engine import evaluator as jev
    from cmoop_audio_processing_tpu.parallel import mesh as jm

    for ev_cls in (jev.PopulationEvaluator, tev.PopulationEvaluator):
        monkeypatch.setattr(ev_cls, "_SUSTAINED_FLOPS_PER_S", 1e6)
    kw = dict(num_classes=4, compute_dtype="float32", batch_size=32,
              epochs=300, patience=5, compaction_chunk=chunk,
              max_models_per_program=16)
    jax_ev = jev.PopulationEvaluator(data, JCfg(**kw),
                                     mesh=jm.population_mesh(*shape))
    ev = tev.PopulationEvaluator(data, TrainConfig(**kw),
                                 mesh=tm.population_mesh(*shape, devices=CPU8))
    impl = "vmap" if shape[1] > 1 else "grouped"
    assert ev.settings.parallel_impl == jax_ev.settings.parallel_impl == impl
    rng = np.random.default_rng(5)
    space = all_genomes()
    genomes = [space[i] for i in rng.choice(len(space), 40, replace=False)]
    jcalls, tcalls = [], []
    monkeypatch.setattr(jev.PopulationEvaluator, "_run_bucket",
                        _stub(jcalls, False))
    monkeypatch.setattr(tev.PopulationEvaluator, "_run_bucket",
                        _stub(tcalls, True))
    for _ in range(2):  # the second call packs by the first's stop epochs
        assert ev.evaluate(genomes, seed=1) == jax_ev.evaluate(genomes, seed=1)
        assert tcalls == jcalls and tcalls
        assert all(len(c[3]) % shape[0] == 0 for c in tcalls)
        records = ev.timings[-1]["chunks"]
        assert [dict(r, lanes=None) for r in records] == [
            dict(r, lanes=None) for r in jax_ev.timings[-1]["chunks"]]
        assert not any(r["compacted"] for r in records)
        assert ev._effective_chunk(16, ev._bucket_spec(64, 5)) == 0
        assert not ev._should_split_lanes(64, 5, genomes)
        tcalls.clear()
        jcalls.clear()


def test_mesh_rejects_what_jax_rejects(data):
    """Batch sizes that do not divide by the data axis raise ValueError;
    a mesh across processes with a data axis > 1 raises
    NotImplementedError, with the JAX evaluator's messages."""
    bad = TrainConfig(epochs=1, batch_size=3, patience=1, num_classes=4)
    with pytest.raises(ValueError, match="must divide by the 'data' mesh"):
        tev.PopulationEvaluator(data, bad,
                                mesh=tm.population_mesh(4, 2, devices=CPU8))
    grid = np.empty((2, 2), dtype=object)
    grid[:] = [[torch.device("cpu")] * 2] * 2
    two_hosts = tm.Mesh(grid, np.array([[0, 0], [1, 1]]))
    with pytest.raises(NotImplementedError, match="data axis == 1"):
        tev.PopulationEvaluator(data, TrainConfig(num_classes=4),
                                mesh=two_hosts)


# -- training on a mesh -------------------------------------------------------

class _Counter:
    """Counts every call into torch.distributed's collectives and the
    multi-shard BN statistics (the data path's cross-device sums)."""

    COLLECTIVES = ("all_reduce", "all_gather", "all_gather_object",
                   "all_gather_into_tensor", "broadcast",
                   "broadcast_object_list", "reduce", "reduce_scatter",
                   "reduce_scatter_tensor", "all_to_all", "gather", "scatter",
                   "gather_object", "barrier", "send", "recv")

    def __init__(self, monkeypatch):
        self.calls = {}
        for name in self.COLLECTIVES:
            monkeypatch.setattr(dist, name, self._wrap(name))
        inner = tg.group_bn_shards

        def bn(hs, *args):
            if len(hs) > 1:
                self.calls["bn_shards"] = self.calls.get("bn_shards", 0) + 1
            return inner(hs, *args)

        monkeypatch.setattr(tg, "group_bn_shards", bn)

    def _wrap(self, name):
        def call(*a, **k):
            self.calls[name] = self.calls.get(name, 0) + 1
            raise AssertionError(f"torch.distributed.{name} called")

        return call


@pytest.mark.parametrize("n_pop, ref_lanes", [(8, 16), (4, 2)],
                         ids=["8x1", "4x1_vs_2_lanes"])
def test_pop_mesh_trains_like_no_mesh(data, monkeypatch, n_pop, ref_lanes):
    """An (8, 1) mesh trains tests/test_parallel.py's workload (6 genomes
    with dropout lanes, padded to 8, one lane a shard) to the no-mesh
    fitness: sizes equal, acc/fpr within atol 2e-3 and, on the CPU, bit
    for bit; one launch, no collective and no cross-shard sum. A (4, 1)
    mesh (2 lanes a shard) is held the same way against the no-mesh run
    whose launches hold 2 lanes (``max_models_per_program=2``), the
    launch plan that runs the same kernels as its shards on the card."""
    cfg = TrainConfig(epochs=3, batch_size=32, patience=2, num_classes=4,
                      compute_dtype="float32", parallel_impl="grouped")
    genomes = G16[:6]
    assert any(g["use_dropout"] for g in genomes)
    ref_cfg = dataclasses.replace(cfg, max_models_per_program=ref_lanes)
    ref = np.asarray(tev.PopulationEvaluator(data, ref_cfg, device="cpu")
                     .evaluate(genomes, seed=0))
    counter = _Counter(monkeypatch)
    ev = tev.PopulationEvaluator(
        data, cfg, mesh=tm.population_mesh(n_pop, 1, devices=CPU8))
    assert ev.settings.parallel_impl == "grouped"
    out = np.asarray(ev.evaluate(genomes, seed=0))
    assert counter.calls == {}
    assert ev.timings[-1]["launches"] == 1
    assert ev.timings[-1]["chunks"][0]["pop"] == 8
    np.testing.assert_array_equal(out[:, 1], ref[:, 1])
    np.testing.assert_allclose(out[:, 0], ref[:, 0], atol=2e-3)
    np.testing.assert_allclose(out[:, 2], ref[:, 2], atol=2e-3)
    np.testing.assert_array_equal(out, ref)


def _best_logits(ev, genomes, x_val):
    """The evaluator's one-shot bucket path again, keeping the trained
    carry: restored-best eval-mode logits over the (unpadded) val rows,
    computed by the no-mesh forward for both runs, in f64."""
    spec = ev._bucket_spec(16, 3, max(g["residual_blocks"] for g in genomes))
    trainer = tt.PopulationTrainer(spec, ev.settings, 4)
    key = tt.train_key_of(0)
    if ev.mesh is None:
        _, carry = trainer.run_full(genomes, ev._train, ev._val, 0,
                                    ev.settings.epochs)
        best = [(carry["best_params"], carry["best_state"], carry["flags"])]
    else:
        params, state, flags = ts.init_population(0, spec, genomes)
        best = []
        shards = tm.shard_population(
            {"params": params, "state": state, "flags": flags}, ev.mesh)
        for i, tree in shards.items():
            devs = tm.batch_sharding(ev.mesh, i)
            train = tm.SplitData([ev._data_on[d][0] for d in devs])
            val = tm.SplitData([ev._data_on[d][1] for d in devs])
            carry = trainer.init_carry(tree["params"], tree["state"],
                                       tree["flags"])
            carry = trainer.run_chunk(carry, train, val, key,
                                      ev.settings.epochs)
            best.append((carry["best_params"], carry["best_state"],
                         carry["flags"]))
    fwd = tt.PopulationTrainer(spec, tt.TrainSettings(parallel_impl="vmap"), 4)
    x = torch.as_tensor(x_val)
    with torch.no_grad():
        return torch.cat([fwd.forward(p, s, f, x, train=False)[0]
                          for p, s, f in best]).double().numpy()


def test_data_mesh_trains_like_no_mesh(data, monkeypatch):
    """A (4, 2) mesh (each batch's rows split over two entries, BN and the
    gradients over the global batch) against no mesh, on
    tests/test_parallel.py's ``test_population_evaluator_data_mesh_matches_
    no_mesh`` workload and bounds: sizes equal, each run's accuracy its own
    logits', logits within 5e-3 and every decisive validation sample
    predicted alike. The data path sums across shards and calls no
    collective."""
    cfg = TrainConfig(epochs=2, batch_size=32, patience=2, num_classes=4,
                      compute_dtype="float32", parallel_impl="vmap")
    genomes = G16[:4]
    ref_ev = tev.PopulationEvaluator(data, cfg, device="cpu")
    ref = np.asarray(ref_ev.evaluate(genomes, seed=0))
    counter = _Counter(monkeypatch)
    ev = tev.PopulationEvaluator(data, cfg,
                                 mesh=tm.population_mesh(4, 2, devices=CPU8))
    got = np.asarray(ev.evaluate(genomes, seed=0))
    assert set(counter.calls) == {"bn_shards"}
    assert ev.timings[-1]["launches"] == 4
    ref_lg = _best_logits(ref_ev, genomes, data["x_val"])
    got_lg = _best_logits(ev, genomes, data["x_val"])
    np.testing.assert_array_equal(got[:, 1], ref[:, 1])
    y = data["y_val"].astype(np.int64)
    for fits, lg in ((ref, ref_lg), (got, got_lg)):
        np.testing.assert_allclose(fits[:, 0], (lg.argmax(-1) == y).mean(1),
                                   atol=1e-6)
    np.testing.assert_allclose(got_lg, ref_lg, atol=5e-3, rtol=0)
    top2 = np.sort(ref_lg, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 1e-2
    assert decisive.mean() > 0.4
    np.testing.assert_array_equal(got_lg.argmax(-1)[decisive],
                                  ref_lg.argmax(-1)[decisive])


def test_data_axis_split_matches_unsplit_trainer():
    """tests/test_parallel.py's ``test_data_axis_sharding_matches_
    replicated`` workload on the port: 4 lanes, batch 8 and eval batch 8,
    16 train and 8 validation rows, 3 epochs, the vmap forward; a (2, 4)
    mesh (2 lanes a pop shard, each batch over 4 data entries) against one
    unsplit population, within its bounds (rtol 2e-4, atol 2e-5)."""
    spec = ts.BucketSpec("A", 16, 3, 10, compute_dtype="float32")
    genomes = [G16[i * 7 % len(G16)] for i in range(4)]
    settings = tt.TrainSettings(epochs=3, batch_size=8, patience=3,
                                eval_batch_size=8, parallel_impl="vmap")
    rng = np.random.default_rng(0)
    train = tt.pad_dataset(
        rng.standard_normal((16, 12, 9, 1)).astype(np.float32),
        rng.integers(0, 10, 16).astype(np.int64), 8)
    val = tt.pad_dataset(
        rng.standard_normal((8, 12, 9, 1)).astype(np.float32),
        rng.integers(0, 10, 8).astype(np.int64), 8)
    train, val = (tuple(torch.as_tensor(a) for a in d) for d in (train, val))
    trainer = tt.PopulationTrainer(spec, settings, 10)
    params, state, flags = ts.init_population(0, spec, genomes)
    ref = trainer.train(params, state, flags, train, val, 1)

    mesh = tm.population_mesh(2, 4, devices=CPU8)
    shards = tm.shard_population(
        {"params": params, "state": state, "flags": flags}, mesh)
    outs = [trainer.train(t["params"], t["state"], t["flags"],
                          tm.SplitData([train] * 4), tm.SplitData([val] * 4),
                          1) for t in shards.values()]
    for k in ("acc_eval", "acc_last", "fpr", "val_loss", "epochs_ran"):
        got = torch.cat([o[k] for o in outs]).numpy()
        np.testing.assert_allclose(got, ref[k].numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=k)


# -- two processes --------------------------------------------------------------

def train_workload(mesh, data=None):
    """tests/test_distributed.py's ``train_workload`` on the port: one
    mixed-depth (16, 3) bucket of 4 genomes, f32, 3 epochs, through the
    evaluator's public entry point. Every process derives the same data
    (``_small_data``, or the module's ``data``), genomes and seeds from
    constants."""
    cfg = TrainConfig(epochs=3, batch_size=32, patience=2, num_classes=4,
                      compute_dtype="float32",
                      bucket_genes=("filters", "kernel_size"))
    genomes = [
        {"filters": 16, "kernel_size": 3, "use_bn": True,
         "residual_blocks": 1, "fc_layers": 1, "use_dropout": True},
        {"filters": 16, "kernel_size": 3, "use_bn": False,
         "residual_blocks": 2, "fc_layers": 2, "use_dropout": False},
        {"filters": 16, "kernel_size": 3, "use_bn": True,
         "residual_blocks": 3, "fc_layers": 1, "use_dropout": False},
        {"filters": 16, "kernel_size": 3, "use_bn": False,
         "residual_blocks": 1, "fc_layers": 3, "use_dropout": True},
    ]
    ev = tev.PopulationEvaluator(_small_data() if data is None else data,
                                 cfg, mesh=mesh)
    return ev.evaluate(genomes, seed=7)


WORKER = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from cmoop_audio_processing_torch.parallel.mesh import (
        distributed_init, population_mesh,
    )
    pid = int(sys.argv[1])
    distributed_init(sys.argv[2], num_processes=2, process_id=pid,
                     device="cpu")
    calls = []
    for name in ("all_reduce", "all_gather", "broadcast", "barrier",
                 "all_gather_object", "reduce_scatter", "all_to_all"):
        def count(*a, _name=name, _f=getattr(dist, name), **k):
            calls.append(_name)
            return _f(*a, **k)
        setattr(dist, name, count)
    mesh = population_mesh(4, 1, devices=["cpu", "cpu"])
    assert mesh.local_pop_shards() == [2 * pid, 2 * pid + 1]
    from tests.test_torch_mesh import train_workload
    fits = train_workload(mesh)
    print("FITS " + repr([tuple(f) for f in fits]), flush=True)
    print("CALLS " + repr(calls), flush=True)
    dist.destroy_process_group()
""")


def test_two_process_pop_mesh_equals_one_process(data, tmp_path):
    """Two gloo ranks, each owning 2 CPU entries of a (4, 1) mesh, each
    train their pop shards; both print the full fitness vector, equal bit
    for bit to the one-process (4, 1) run, after one all-gather and no
    other collective."""
    want = [tuple(f) for f in
            train_workload(tm.population_mesh(4, 1, devices=["cpu"] * 4),
                           data)]
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{sock.getsockname()[1]}"
    sock.close()
    env = dict(os.environ, PYTHONPATH=REPO, GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), addr], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in (0, 1)]
    try:
        outs = [p.communicate(timeout=50) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, (out[-2000:], err[-4000:])
        lines = dict(line.split(" ", 1) for line in out.splitlines()
                     if line.startswith(("FITS ", "CALLS ")))
        assert ast.literal_eval(lines["FITS"]) == want
        assert ast.literal_eval(lines["CALLS"]) == ["all_gather_object"]


# -- the CLI --------------------------------------------------------------------

def _header(path):
    return path.read_text().splitlines()[:1]


def test_cli_mesh_runs(tmp_path):
    """``--mesh 2 --device cpu`` runs a fake and a tiny real search with
    the same CSV schema; ``--mesh-data 2`` without ``--mesh`` exits."""
    from cmoop_audio_processing_torch.data.loaders import save_npy_dir
    from cmoop_audio_processing_torch.data.synthetic import make_synthetic

    npy = tmp_path / "npy"
    save_npy_dir(make_synthetic(n_train=64, n_eval=32, time_steps=12,
                                features=9), str(npy))
    common = ["--preset", "nsga_penalty", "--device", "cpu", "--mesh", "2",
              "--pop-size", "4", "--max-gen", "2"]
    assert tcli.main(common + ["--fake-eval", "--out",
                               str(tmp_path / "fake")]) == 0
    assert tcli.main(common + ["--compute-dtype", "float32", "--epochs", "1",
                               "--source", "npy", "--data-path", str(npy),
                               "--mesh-data", "2",
                               "--out", str(tmp_path / "real")]) == 0
    fake, real = tmp_path / "fake" / "nsga_penalty", tmp_path / "real" / \
        "nsga_penalty"
    for name in ("all_generations.csv", "final_pareto.csv"):
        assert _header(real / name) == _header(fake / name), name
    assert len((real / "all_generations.csv").read_text().splitlines()) == 9
    with pytest.raises(SystemExit, match="requires --mesh"):
        tcli.main(["--preset", "nsga_penalty", "--fake-eval", "--device",
                   "cpu", "--mesh-data", "2"])
