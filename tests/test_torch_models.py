"""The PyTorch port's supernet and grouped population forward against the
JAX package, given the same parameters (carried over with
``params_from_jax``): logits and new BN state, templates A and B, train
and eval mode, dropout off, odd 45x13 input. f32 on the CPU; the
tolerance 1e-4 covers f32 reassociation only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmoop_audio_processing_torch.models import grouped as tg
from cmoop_audio_processing_torch.models import supernet as ts
from cmoop_audio_processing_tpu.models import grouped as jg
from cmoop_audio_processing_tpu.models import supernet as js

# the test workers share the CPU's cores: one intra-op thread per worker
# keeps PyTorch's thread pool from oversubscribing them
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def mk_genome(f=16, k=3, bn=True, nb=2, nfc=2, do=False):
    return dict(filters=f, kernel_size=k, use_bn=bn, residual_blocks=nb,
                fc_layers=nfc, use_dropout=do)


GENOMES = [mk_genome(nb=1, nfc=1), mk_genome(nb=2, nfc=3, bn=False),
           mk_genome(nb=3, nfc=4), mk_genome(nb=2, nfc=2)]


def _x(b=6, h=45, w=13, seed=1):
    return np.random.default_rng(seed).standard_normal((b, h, w, 1)).astype(np.float32)


def _jax_population(template):
    spec = js.BucketSpec(template, 16, 3, 10, compute_dtype="float32")
    params, state, flags = js.init_population(jax.random.key(0), spec, GENOMES)
    return spec, params, state, flags


def _port_population(template, params, state):
    spec = ts.BucketSpec(template, 16, 3, 10, compute_dtype="float32")
    tp, tst = ts.params_from_jax(jax.tree.map(np.asarray, params),
                                 jax.tree.map(np.asarray, state))
    return spec, tp, tst, ts.stack_flags(GENOMES)


def _assert_state_close(jax_state, port_state):
    assert set(jax_state) == set(port_state)
    for name in jax_state:
        for stat in ("mean", "var"):
            np.testing.assert_allclose(
                port_state[name][stat].detach().numpy(),
                np.asarray(jax_state[name][stat]), **TOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("template", ["A", "B"])
def test_apply_population_matches_jax(template, train):
    jspec, p, s, fl = _jax_population(template)
    tspec, tp, tst, tfl = _port_population(template, p, s)
    x = _x()
    jl, jst = jg.apply_population(jspec, p, s, fl, jnp.asarray(x), train=train)
    tl, tstt = tg.apply_population(tspec, tp, tst, tfl, torch.as_tensor(x),
                                   train=train)
    assert tl.shape == (4, 6, 10)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    _assert_state_close(jst, tstt)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("template", ["A", "B"])
def test_apply_model_matches_jax(template, train):
    jspec, p, s, fl = _jax_population(template)
    tspec, tp, tst, tfl = _port_population(template, p, s)
    x = _x(b=5)
    for i in range(len(GENOMES)):
        jl, jst = js.apply_model(
            jspec, jax.tree.map(lambda a: a[i], p),
            jax.tree.map(lambda a: a[i], s), {k: v[i] for k, v in fl.items()},
            jnp.asarray(x), train=train)
        tl, tstt = ts.apply_model(
            tspec, ts.tree_map(lambda a: a[i], tp),
            ts.tree_map(lambda a: a[i], tst), {k: v[i] for k, v in tfl.items()},
            torch.as_tensor(x), train=train)
        np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
        _assert_state_close(jst, tstt)


@pytest.mark.parametrize("template", ["A", "B"])
def test_grouped_equals_loop_over_single_models_with_dropout(template):
    """Grouped conv == per-model forward, train mode with dropout active:
    both draw each lane's masks from the step key folded with its uid."""
    spec = ts.BucketSpec(template, 16, 3, 10)
    genomes = [dict(g, use_dropout=True) for g in GENOMES]
    params, state, flags = ts.init_population(3, spec, genomes)
    x = torch.as_tensor(_x())
    logits, new_state = tg.apply_population(spec, params, state, flags, x,
                                            train=True, dropout_key=12345)
    for i in range(len(genomes)):
        li, si = ts.apply_model(
            spec, ts.tree_map(lambda a: a[i], params),
            ts.tree_map(lambda a: a[i], state),
            {k: v[i] for k, v in flags.items()}, x, train=True,
            dropout_key=12345)
        torch.testing.assert_close(li, logits[i], **TOL)
        for name in si:
            torch.testing.assert_close(si[name]["var"], new_state[name]["var"][i],
                                       **TOL)


def test_dropout_masks_follow_the_genome_not_the_lane():
    uids = torch.tensor([11, 22, 33])
    m = ts.dropout_mask(99, uids, 2, (8, 64), keep=0.7)
    m_rev = ts.dropout_mask(99, uids.flip(0), 2, (8, 64), keep=0.7)
    torch.testing.assert_close(m, m_rev.flip(0), rtol=0, atol=0)
    assert not torch.equal(m[0], m[1])
    assert set(torch.unique(m).tolist()) == {0.0, np.float32(1.0 / 0.7)}
    assert abs(float((m > 0).float().mean()) - 0.7) < 0.05


@pytest.mark.parametrize("template", ["A", "B"])
def test_max_blocks_specialization_is_invisible(template):
    """Init is prefix-stable across max_blocks (block slots always taken;
    FC gap weights drawn at canonical width and sliced) and skipped blocks
    are exact zeros, so logits match bitwise in f32."""
    genomes = [mk_genome(nb=2, nfc=2), mk_genome(nb=1, nfc=4, bn=False)]
    s3 = ts.BucketSpec(template, 16, 3, 7)
    s2 = ts.BucketSpec(template, 16, 3, 7, max_blocks=2)
    p3, st3, fl = ts.init_population(5, s3, genomes)
    p2, st2, _ = ts.init_population(5, s2, genomes)
    assert "block2" not in p2 and "block2" in p3
    for name in [k for k in p2 if k != "fc"]:
        for a, b in zip(ts.tree_leaves(p2[name]), ts.tree_leaves(p3[name])):
            assert torch.equal(a, b)
    for li in range(1, 5):
        assert torch.equal(p2["fc"][f"fc{li}"]["wg"],
                           p3["fc"][f"fc{li}"]["wg"][:, : s2.gap_width])
    x = torch.as_tensor(_x(b=4))
    l3, _ = tg.apply_population(s3, p3, st3, fl, x, train=False)
    l2, _ = tg.apply_population(s2, p2, st2, fl, x, train=False)
    torch.testing.assert_close(l2, l3, rtol=0, atol=0)


def test_init_layout_and_keras_distributions():
    spec = ts.BucketSpec("A", 16, 3, 10)
    genomes = [mk_genome(nb=nb, nfc=nfc) for nb, nfc in ((1, 4), (2, 2), (3, 1))]
    params, state, flags = ts.init_population(0, spec, genomes)
    assert params["stem1"]["w"].shape == (3, 16, 1, 3, 3)  # (pop, O, I, k, k)
    assert params["block2"]["conv2"]["w"].shape == (3, 128, 128, 3, 3)
    for i, g in enumerate(genomes):
        entry = 5 - g["fc_layers"]
        active = 16 * 2 ** g["residual_blocks"]
        for li, units in enumerate(ts.FC_WIDTHS, start=1):
            wg = params["fc"][f"fc{li}"]["wg"][i]
            if li == entry:
                assert wg[:active].abs().max() > 0
                assert torch.all(wg[active:] == 0)
                assert wg.abs().max() <= np.sqrt(6.0 / (active + units)) + 1e-6
            else:
                assert torch.all(wg == 0)
            if li > 1:
                wp = params["fc"][f"fc{li}"]["wp"][i]
                assert (wp.abs().max() > 0) == (li > entry)
    # genome-keyed: the same genome gets the same parameters in any population
    p_alone, _, _ = ts.init_population(0, spec, genomes[1:2])
    for a, b in zip(ts.tree_leaves(p_alone), ts.tree_leaves(params)):
        assert torch.equal(a[0], b[1])


def test_params_round_trip_through_the_jax_layout():
    _, p, s, _ = _jax_population("A")
    pn, sn = jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s)
    tp, tst = ts.params_from_jax(pn, sn)
    bp, bs = ts.params_to_jax(tp, tst)
    jax.tree.map(np.testing.assert_array_equal, pn, bp)
    jax.tree.map(np.testing.assert_array_equal, sn, bs)


def test_odd_input_pools_to_ceil_size():
    x = torch.zeros(1, 1, 45, 13)
    assert ts.maxpool2(x).shape == (1, 1, 23, 7)
