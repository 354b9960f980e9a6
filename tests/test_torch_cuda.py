"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions, and the determinism of the CUDA evaluation path.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch; the JAX-importing tests/conftest.py is left out there:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from cmoop_audio_processing_torch.frontend import cuda_kernels as tk
from cmoop_audio_processing_torch.frontend import features as tf

pytestmark = pytest.mark.cuda

KWS = tf.FrontendConfig(hop_length=360, n_mels=40, n_mfcc=13)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    from cmoop_audio_processing_torch.core.device import resolve_device

    return resolve_device("cuda")


def _clips(n, n_samples, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / 16000.0
    f = rng.uniform(100.0, 7000.0, (n, 1))
    y = 0.4 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal((n, n_samples))
    return y.astype(np.float32)


def _launch(fn, name, y, cfg):
    """fn(y, cfg), asserting one launch of kernel `name` on its route."""
    key = f"{name}/{tk.dft_route(cfg.n_fft)}"
    before = tk.launch_counts[name], tk.route_counts[key]
    got = fn(y, cfg)
    assert (tk.launch_counts[name], tk.route_counts[key]) == (before[0] + 1,
                                                              before[1] + 1)
    return got


@pytest.mark.parametrize("n,n_samples,cfg", [
    (64, 16000, KWS),
    (3, 80000, tf.FrontendConfig()),
    (5, 16000, dataclasses.replace(KWS, center=False)),
    (2, 700, KWS),
    (4, 16000, dataclasses.replace(KWS, n_fft=256)),
    (4, 16000, dataclasses.replace(KWS, n_fft=1024)),
    (3, 16000, dataclasses.replace(KWS, n_fft=64, n_mels=20)),
    (3, 16000, dataclasses.replace(KWS, n_fft=2048, n_mels=64)),
    (3, 16000, dataclasses.replace(KWS, n_fft=400)),
    (3, 16000, dataclasses.replace(KWS, n_fft=401)),
    (3, 16000, dataclasses.replace(KWS, n_fft=402)),
    (3, 16000, dataclasses.replace(KWS, win_length=400)),
    (3, 16000, dataclasses.replace(KWS, hop_length=161)),
    (5, 12345, tf.FrontendConfig(n_mfcc=13)),
    (64, 16000, dataclasses.replace(KWS, n_fft=480)),
    (3, 16000, dataclasses.replace(KWS, n_fft=320)),
    (3, 16000, dataclasses.replace(KWS, n_fft=960, n_mels=64)),
    (5, 16000, dataclasses.replace(KWS, n_fft=400, hop_length=161,
                                   center=False)),
    (5, 12345, tf.FrontendConfig(n_fft=400, n_mfcc=13)),
], ids=["kws_64x16000", "birdclef_3x80000", "uncentred", "short_clip",
        "fft_256", "fft_1024", "fft_64", "fft_2048", "fft_mixed_400",
        "dense_401", "dense_402", "win_length_400", "fft_odd_hop_161",
        "ragged_5x12345", "fft_mixed_480_64x16000", "fft_mixed_320",
        "fft_mixed_960", "fft_mixed_400_uncentred_odd_hop_161",
        "fft_mixed_400_ragged_5x12345"])
def test_mfcc_fused_kernel_matches_its_plain_version(cuda, n, n_samples, cfg):
    """atol 3e-2 / rtol 1e-3: the JAX package's Pallas-vs-XLA tolerance
    (tests/test_frontend.py); both sides are full f32 and differ only in
    the order of their sums (an FFT on one side, a GEMM on the other)."""
    y = torch.as_tensor(_clips(n, n_samples), device=cuda)
    got = _launch(tk.mfcc_fused, "mfcc_fused", y, cfg)
    want = tk.mfcc_fused_reference(y, cfg)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n, cfg.n_frames(n_samples), cfg.n_mfcc)
    torch.testing.assert_close(got, want, atol=3e-2, rtol=1e-3)


@pytest.mark.parametrize("n,n_samples,cfg", [
    (3, 80000, tf.FrontendConfig(log="db", top_db=80.0)),
    (3, 80000, tf.FrontendConfig(log="natural")),
    (5, 16000, tf.FrontendConfig(center=False)),
    (2, 700, tf.FrontendConfig()),
    (7, 16000, tf.FrontendConfig(top_db=None)),
    (4, 16000, tf.FrontendConfig(n_fft=256)),
    (4, 16000, tf.FrontendConfig(n_fft=1024, log="natural")),
    (3, 16000, tf.FrontendConfig(n_fft=64, n_mels=20)),
    (3, 16000, tf.FrontendConfig(n_fft=2048, n_mels=64)),
    (3, 16000, tf.FrontendConfig(n_fft=400)),
    (3, 16000, tf.FrontendConfig(n_fft=400, log="natural")),
    (3, 16000, tf.FrontendConfig(n_fft=401)),
    (3, 16000, tf.FrontendConfig(win_length=400)),
    (3, 16000, tf.FrontendConfig(hop_length=161)),
    (3, 16000, tf.FrontendConfig(n_mels=39)),
    (5, 12345, tf.FrontendConfig(top_db=60.0)),
    (3, 16000, tf.FrontendConfig(n_fft=401, log="natural")),
    (3, 16000, tf.FrontendConfig(n_fft=402)),
    (3, 80000, tf.FrontendConfig(n_fft=480)),
    (3, 16000, tf.FrontendConfig(n_fft=800, n_mels=64)),
    (5, 12345, tf.FrontendConfig(n_fft=400, hop_length=161, top_db=60.0)),
    (2, 700, tf.FrontendConfig(n_fft=400)),
], ids=["birdclef_3x80000_db_top_db", "birdclef_3x80000_natural", "uncentred",
        "short_clip", "shared_blocks_7x16000_raw_db", "fft_256", "fft_1024",
        "fft_64", "fft_2048", "fft_mixed_400", "fft_mixed_400_natural",
        "dense_401", "win_length_400", "fft_odd_hop_161",
        "odd_clip_rows_39_mels", "ragged_5x12345_top_db_60",
        "dense_401_natural", "dense_402", "fft_mixed_480_3x80000",
        "fft_mixed_800", "fft_mixed_400_odd_hop_ragged_top_db_60",
        "fft_mixed_400_short_clip"])
def test_log_mel_fused_kernel_matches_its_plain_version(cuda, n, n_samples, cfg):
    """atol 3e-2 / rtol 1e-3, as for mfcc_fused. On the dense route 7 clips
    of 101 frames put frames of two clips in most 64-frame blocks; on the
    FFT route 12345 samples (78 frames at hop 160) leave a ragged last block
    in every clip (and, on the mixed plan, lane groups past the block's
    last frame), an odd hop takes the unaligned frame loads, and 101
    frames of 39 mels (a clip's output not a multiple of 4 floats) take the
    scalar top_db pass."""
    y = torch.as_tensor(_clips(n, n_samples), device=cuda)
    got = _launch(tk.log_mel_fused, "log_mel_fused", y, cfg)
    want = tk.log_mel_fused_reference(y, cfg)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n, cfg.n_frames(n_samples), cfg.n_mels)
    torch.testing.assert_close(got, want, atol=3e-2, rtol=1e-3)


@pytest.mark.parametrize("name", ["mfcc_fused", "log_mel_fused"])
@pytest.mark.parametrize("n_fft", [512, 400, 480, 401],
                         ids=["fft", "fft_mixed_400", "fft_mixed_480", "dense"])
def test_two_launches_give_identical_bits(cuda, name, n_fft):
    y = torch.as_tensor(_clips(6, 80000, seed=4), device=cuda)
    cfg = tf.FrontendConfig(n_fft=n_fft)
    fn = getattr(tk, name)
    first, second = fn(y, cfg), fn(y, cfg)
    assert torch.equal(first, second)


@pytest.mark.parametrize("n_fft,n_mels", [(512, 40), (401, 40), (512, 39),
                                         (400, 40), (480, 40), (400, 39)],
                         ids=["fft", "dense", "fft_scalar_pass",
                              "fft_mixed_400", "fft_mixed_480",
                              "fft_mixed_400_scalar_pass"])
def test_log_mel_top_db_is_the_wrappers_rule_on_the_raw_db(cuda, n_fft, n_mels):
    """The FFT route's in-kernel top_db step (atomic clip max, then one
    in-place pass, by float4 or, at 501 x 39 floats a clip, by float), on
    both plans, gives _top_db of the kernel's own raw dB, bit for bit."""
    y = torch.as_tensor(_clips(5, 80000, seed=6), device=cuda)
    cfg = tf.FrontendConfig(n_fft=n_fft, n_mels=n_mels, top_db=80.0)
    raw = tk.log_mel_fused(y, dataclasses.replace(cfg, top_db=None))
    got = tk.log_mel_fused(y, cfg)
    assert torch.equal(got, tk._top_db(raw, cfg))
    assert float(got.amax()) == 0.0 and float(got.amin()) >= -80.0


def test_every_n_fft_of_the_fft_route_launches(cuda):
    """dft_route's sizes (FFT_SIZES) and the sizes the kernels are built
    for (mel_fft.cuh with_plan) agree: each launches on the FFT route and
    matches the plain version."""
    y = torch.as_tensor(_clips(2, 8000, seed=3), device=cuda)
    for n_fft in tk.FFT_SIZES:
        cfg = tf.FrontendConfig(n_fft=n_fft, n_mels=20, n_mfcc=13)
        for name, ref in (("mfcc_fused", tk.mfcc_fused_reference),
                          ("log_mel_fused", tk.log_mel_fused_reference)):
            assert tk.dft_route(n_fft) == "fft"
            got = _launch(getattr(tk, name), name, y, cfg)
            torch.testing.assert_close(got, ref(y, cfg), atol=3e-2, rtol=1e-3)


@pytest.mark.parametrize("name", ["mfcc_fused", "log_mel_fused"])
def test_fft_route_kernels_spill_nothing(cuda, name):
    """ptxas fits every FFT-route instantiation (one per P of with_plan:
    *_fft_kernel<P> for the radix-2 plan, *_mixed_kernel<P> for the mixed
    one, whose registers mel_fft.cuh min_blocks caps): no spill stores or
    loads."""
    rows = {fn: rest for fn, *rest in tk.ptxas_summary(tk.ptxas_report(name))}
    stem = name.replace("_fused", "")
    points = sorted({tk.fft_plan(n)[0] for n in tk.FFT_SIZES})
    got = sorted(int(fn.split("<")[1][:-1]) for fn in rows
                 if fn.startswith((f"{stem}_fft_kernel<", f"{stem}_mixed_kernel<")))
    assert got == points
    for p in points:
        kernel = f"{stem}_{'fft' if p & (p - 1) == 0 else 'mixed'}_kernel"
        regs, _, stores, loads = rows[f"{kernel}<{p}>"]
        assert (stores, loads) == (0, 0), (p, regs, rows)


def test_extract_features_on_cuda_goes_through_the_kernel(cuda):
    ys = _clips(4, 16000, seed=1)
    before = tk.launch_counts["mfcc_fused"]
    got = tf.extract_features(ys, KWS, kind="mfcc", device="cuda")
    assert tk.launch_counts["mfcc_fused"] == before + 1
    want = tf.extract_features(ys, KWS, kind="mfcc", device="cpu")
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=1e-3)
    before = tk.launch_counts["log_mel_fused"]
    got = tf.extract_features(ys, KWS, kind="log_mel", device="cuda")
    assert tk.launch_counts["log_mel_fused"] == before + 1
    want = tf.extract_features(ys, KWS, kind="log_mel", device="cpu")
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=1e-3)


@pytest.mark.parametrize("n_fft,route", [(401, "dense"), (400, "fft")])
def test_extract_features_at_a_25_ms_window_takes_its_route(cuda, n_fft, route):
    """Extraction on the card at a 25-ms window: 400 goes through each
    kernel's FFT route (the mixed-radix plan), 401, which the FFT route
    does not take, through the dense route; both match the CPU (the plain
    versions, held against JAX by tests/test_torch_fft_operands.py)."""
    ys = _clips(3, 16000, seed=2)
    for kind, name in (("mfcc", "mfcc_fused"), ("log_mel", "log_mel_fused")):
        cfg = dataclasses.replace(KWS, n_fft=n_fft)
        before = dict(tk.route_counts)
        got = tf.extract_features(ys, cfg, kind=kind, device="cuda")
        assert {k: v - before[k] for k, v in tk.route_counts.items()
                if v != before[k]} == {f"{name}/{route}": 1}
        want = tf.extract_features(ys, cfg, kind=kind, device="cpu")
        assert got.shape == want.shape == (3, cfg.n_frames(16000),
                                           13 if kind == "mfcc" else 40)
        np.testing.assert_allclose(got, want, atol=3e-2, rtol=1e-3)


def test_mfcc_fused_rejects_float64_on_cuda(cuda):
    with pytest.raises(ValueError):
        tk.mfcc_fused(torch.zeros(2, 16000, dtype=torch.float64, device=cuda), KWS)
    with pytest.raises(ValueError):
        tk.log_mel_fused(torch.zeros(2, 16000, dtype=torch.float64, device=cuda))


def test_cuda_evaluation_repeats_bit_for_bit(cuda):
    from cmoop_audio_processing_torch.core.config import DataConfig, TrainConfig
    from cmoop_audio_processing_torch.data.pipeline import prepare_dataset
    from cmoop_audio_processing_torch.engine.evaluator import PopulationEvaluator

    data = prepare_dataset(DataConfig(synthetic_train=256, synthetic_eval=128,
                                      time_steps=45, features=13))
    cfg = TrainConfig(epochs=2, compute_dtype="bfloat16")
    genomes = [
        dict(filters=32, kernel_size=5, use_bn=True, residual_blocks=2,
             fc_layers=3, use_dropout=True),
        dict(filters=32, kernel_size=5, use_bn=False, residual_blocks=1,
             fc_layers=1, use_dropout=False),
    ]
    runs = [PopulationEvaluator(data, cfg, device="cuda").evaluate(genomes, seed=2)
            for _ in range(2)]
    assert runs[0] == runs[1]
    assert all(np.isfinite(v) for fit in runs[0] for v in fit)


def test_sa_nsga2_gp_fits_repeat_bit_for_bit_on_the_card(cuda):
    """The batched Cholesky NLL fits and their autograd under deterministic
    mode: two fits from the same seeds give the same hyperparameters, and a
    surrogate-assisted search repeats its records exactly."""
    from cmoop_audio_processing_torch.algorithms.sa_nsga2 import run_sa_nsga2
    from cmoop_audio_processing_torch.core.config import Constraints, SearchConfig
    from cmoop_audio_processing_torch.engine.evaluator import FakeEvaluator
    from cmoop_audio_processing_torch.surrogate.gp import GPConfig, fit_gp_multi

    rng = np.random.default_rng(3)
    x = rng.random((40, 8))
    ys = [np.sin(3 * x[:, 0]), x[:, 1] ** 2, x[:, 2] - x[:, 3], x[:, 4]]
    fits = [fit_gp_multi(x, ys, GPConfig(), seeds=[1, 2, 3, 4], device="cuda")
            for _ in range(2)]
    for a, b in zip(*fits):
        assert (a.log_c, a.log_l, a.log_n) == (b.log_c, b.log_l, b.log_n)
    cfg = SearchConfig(pop_size=8, max_gen=3, infill_percent=0.334, seed=5,
                       constraints=Constraints(0.85, 2.5, 0.09))
    runs = [run_sa_nsga2(cfg, FakeEvaluator(), device="cuda")[0] for _ in range(2)]
    assert [(p["hparams"], p["objs"]) for p in runs[0]] == \
        [(p["hparams"], p["objs"]) for p in runs[1]]


# -- the per-lane fused Adam (engine/lane_adam.py, csrc/lane_adam.cu) --------

# the cells' bucket: 64 filters, 5x5 kernels, 3 blocks; KWS template A (10
# classes) and BirdCLEF template B (11 classes)
ADAM_BUCKETS = {"A": 10, "B": 11}
_ADAM_TREES = {}


def _adam_tree(template, lanes):
    """The bucket's stacked parameter tree from ``init_population`` at 16
    lanes (the 16 genomes of the cells), or the first ``lanes`` odd-indexed
    of them as the evaluator's compaction leaves them (``gather_lanes``),
    on the card; built once a template."""
    from cmoop_audio_processing_torch.engine.trainer import gather_lanes
    from cmoop_audio_processing_torch.models import supernet as ts

    if template not in _ADAM_TREES:
        genomes = [dict(filters=64, kernel_size=5, use_bn=bn,
                        residual_blocks=3, fc_layers=fc, use_dropout=dr)
                   for bn in (True, False) for fc in (1, 2, 3, 4)
                   for dr in (True, False)]
        spec = ts.BucketSpec(template, 64, 5, ADAM_BUCKETS[template])
        params, _, _ = ts.init_population(7, spec, genomes, "cuda")
        _ADAM_TREES[template] = params
    params = _ADAM_TREES[template]
    if lanes == 16:
        return params
    return gather_lanes(params, list(range(1, 2 * lanes, 2))[:lanes])


def _adam_inputs(template, lanes, n_active, seed=0):
    """(params, grads, mu, nu, active, bc1, bc2): moments as after some
    steps, per-lane step counts 1..lanes, ``n_active`` lanes active (every
    third first), and a NaN in each leaf's gradient of the first inactive
    lane."""
    from cmoop_audio_processing_torch.engine import lane_adam as la
    from cmoop_audio_processing_torch.models.supernet import tree_map

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def draw(t, scale, positive=False):
        x = torch.randn(t.shape, generator=gen, device=t.device) * scale
        return x * x if positive else x

    params = _adam_tree(template, lanes)
    order = list(range(0, lanes, 3)) + [i for i in range(lanes) if i % 3]
    active = torch.zeros(lanes, dtype=torch.bool, device="cuda")
    active[order[:n_active]] = True
    off = [i for i in range(lanes) if not bool(active[i])]

    def grad(t):
        g = draw(t, 1e-2)
        if off:
            g[off[0]] = float("nan")
        return g

    grads = tree_map(grad, params)
    mu = tree_map(lambda t: draw(t, 1e-3), params)
    nu = tree_map(lambda t: draw(t, 1e-3, positive=True), params)
    cnt = torch.arange(1, lanes + 1, device="cuda").float()
    return (params, grads, mu, nu, active, 1.0 - torch.pow(la.ADAM_B1, cnt),
            1.0 - torch.pow(la.ADAM_B2, cnt))


@pytest.mark.parametrize("n_active", [0, 1, 7])
@pytest.mark.parametrize("lanes", [16, 5])
@pytest.mark.parametrize("template", ["A", "B"])
def test_lane_adam_kernel_equals_its_plain_version(cuda, template, lanes,
                                                   n_active):
    """The kernel against ``lane_adam_reference`` on the card, bit for bit,
    on a template's whole tree: no lane active, one or seven; a stopped
    lane keeps p, m and v bit for bit although its gradient is NaN; the
    inputs are unchanged; a second launch gives the same bits; one launch a
    call (at most 64 leaves)."""
    from cmoop_audio_processing_torch.engine import lane_adam as la
    from cmoop_audio_processing_torch.models.supernet import tree_leaves

    inputs = _adam_inputs(template, lanes, min(n_active, lanes))
    params, grads, mu, nu, active = inputs[:5]
    before = [[t.clone() for t in tree_leaves(tree)]
              for tree in (params, grads, mu, nu)]
    launches = la.launch_counts["lane_adam"]
    got = la.lane_adam(*inputs, 1e-3, 1e-7)
    again = la.lane_adam(*inputs, 1e-3, 1e-7)
    torch.cuda.synchronize()
    assert la.launch_counts["lane_adam"] == launches + 2
    want = la.lane_adam_reference(*inputs, 1e-3, 1e-7)
    for old, tree in zip(before, (params, grads, mu, nu)):  # NaN included
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(old, tree_leaves(tree)))
    on = active.view(-1, 1)
    for name, got_t, again_t, want_t, old_t in zip(
            ("p", "m", "v"), got, again, want, (params, mu, nu)):
        for g, a, w, o in zip(tree_leaves(got_t), tree_leaves(again_t),
                              tree_leaves(want_t), tree_leaves(old_t)):
            assert torch.equal(g, w), (name, tuple(g.shape))
            assert torch.equal(g, a), (name, tuple(g.shape))
            # stopped lanes: the input itself
            flat_o = o.flatten(1)
            assert torch.equal(torch.where(on, flat_o, g.flatten(1)), flat_o)
            assert bool(torch.isfinite(g).all()), (name, tuple(g.shape))


def test_lane_adam_is_one_kernel_a_call(cuda):
    """Under the port's deterministic algorithms (the ``cuda`` fixture) a
    call runs one kernel on the card, the fused Adam: its output buffers
    take no NaN fill."""
    from cmoop_audio_processing_torch.engine import lane_adam as la

    assert torch.are_deterministic_algorithms_enabled()
    inputs = _adam_inputs("A", 16, 7)
    la.lane_adam(*inputs, 1e-3, 1e-7)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        la.lane_adam(*inputs, 1e-3, 1e-7)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "lane_adam_kernel" in kernels[0], kernels


def test_lane_adam_refuses_what_the_kernel_does_not_take(cuda):
    """float64, a non-contiguous leaf, a leaf on another device and a
    leaf of another shape (another lane count) raise before anything
    launches."""
    from cmoop_audio_processing_torch.engine import lane_adam as la
    from cmoop_audio_processing_torch.models.supernet import tree_map

    params, grads, mu, nu, active, bc1, bc2 = _adam_inputs("B", 5, 1)
    w = grads["block0"]["conv1"]["w"]  # (5, 128, 64, 5, 5)
    bad = {
        "float32": w.double(),
        "contiguous": w.transpose(-1, -2).contiguous().transpose(-1, -2),
        "one device": w.cpu(),
        "shape": torch.cat([w, w[:1]]),
    }
    launches = la.launch_counts["lane_adam"]
    for match, leaf in bad.items():
        broken = tree_map(lambda t: t, grads)
        broken["block0"]["conv1"]["w"] = leaf
        with pytest.raises(ValueError, match=match):
            la.lane_adam(params, broken, mu, nu, active, bc1, bc2, 1e-3, 1e-7)
    assert la.launch_counts["lane_adam"] == launches


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the launch on a card that is "
                    "not the current one")
    return cuda


def test_lane_adam_launches_on_its_leaves_card_while_another_is_current(
        two_cards):
    """Leaves on cuda:1 while cuda:0 is current (the mesh's pop shards):
    the kernel launches there, equal to the plain version bit for bit, and
    cuda:0 is current again afterwards."""
    from cmoop_audio_processing_torch.engine import lane_adam as la
    from cmoop_audio_processing_torch.models.supernet import (tree_leaves,
                                                              tree_map)

    inputs = [tree_map(lambda t: t.to("cuda:1"), x)
              for x in _adam_inputs("B", 5, 3)]
    launches = la.launch_counts["lane_adam"]
    with torch.cuda.device(0):
        got = la.lane_adam(*inputs, 1e-3, 1e-7)
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize("cuda:1")
    assert la.launch_counts["lane_adam"] == launches + 1
    want = la.lane_adam_reference(*inputs, 1e-3, 1e-7)
    for g, w in zip(*(tree_leaves(dict(enumerate(t))) for t in (got, want))):
        assert g.device == torch.device("cuda:1")
        assert torch.equal(g, w), tuple(g.shape)


def test_mesh_over_the_cards_equals_the_mesh_on_one_card(two_cards):
    """The default mesh, one pop shard a visible card, in one process,
    trains each shard on its own card (the fused Adam included) and gives
    the fitness of the same mesh laid on cuda:0 alone, bit for bit."""
    from cmoop_audio_processing_torch.core.config import DataConfig, TrainConfig
    from cmoop_audio_processing_torch.data.pipeline import prepare_dataset
    from cmoop_audio_processing_torch.engine.evaluator import PopulationEvaluator
    from cmoop_audio_processing_torch.parallel.mesh import population_mesh

    cards = torch.cuda.device_count()
    data = prepare_dataset(DataConfig(synthetic_train=256, synthetic_eval=128,
                                      time_steps=45, features=13))
    cfg = TrainConfig(epochs=2, compute_dtype="bfloat16")
    genomes = [dict(filters=32, kernel_size=5, use_bn=i % 2 == 0,
                    residual_blocks=1 + i % 3, fc_layers=1 + i % 4,
                    use_dropout=i % 3 == 0) for i in range(2 * cards)]
    runs = [PopulationEvaluator(data, cfg, mesh=mesh).evaluate(genomes, seed=2)
            for mesh in (population_mesh(),
                         population_mesh(devices=["cuda:0"] * cards))]
    assert runs[0] == runs[1]
    assert all(np.isfinite(v) for fit in runs[0] for v in fit)
