"""Template D, DS-CNN's depthwise-separable block, on the port's grouped
population path, against the plain float32 reference of the benchmark
(``benchmark/reference/ds_cnn.py``) on seeded random weights at a small
size: the grouped forward, ``supernet.apply_model`` and the reference
agree; one training step's loss, gradients and Adam update agree; the
stride-2 stem pads as Keras's SAME does; the analytic counts equal the
materialised tree; a small ``PopulationEvaluator.evaluate`` gives each
genome the same fitness whatever shares its bucket, and again on a re-run;
the depthwise spans of all three passes are recorded when backward runs
on another thread, and under their own forward's parent when two
threads run backward at once; a saved D model predicts through ``engine.export``,
and the Keras export refuses D.

Tolerances: float32 against float32, where only the order of sums differs
(BN statistics, conv algorithms): relative gaps of about 1e-6, held at
1e-4; bfloat16 operands leave about 1e-2 and fail them
(``test_bfloat16_fails_the_forward_tolerance``)."""

import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import ds_cnn, training
from cmoop_audio_processing_torch.core.config import DataConfig, TrainConfig
from cmoop_audio_processing_torch.core.genome import all_genomes
from cmoop_audio_processing_torch.data.pipeline import prepare_dataset
from cmoop_audio_processing_torch.engine import evaluator as tev
from cmoop_audio_processing_torch.engine import export
from cmoop_audio_processing_torch.engine.lane_adam import ADAM_B1
from cmoop_audio_processing_torch.engine.trainer import (
    PopulationTrainer,
    TrainSettings,
)
from cmoop_audio_processing_torch.models import (
    genome_arch,
    grouped,
    keras_export,
    supernet,
)
from cmoop_audio_processing_torch.utils import profiling

# the test workers share the CPU's cores: one intra-op thread per worker
torch.set_num_threads(1)

CLASSES = 5
SEED = 2 ** 31 + 23
# relative gap of float32 against float32 (orders of sums alone)
F32_GAP = 1e-4
# one (16, 5) bucket at 2 blocks: BN and no BN, every FC entry, dropout
GENOMES = [
    dict(filters=16, kernel_size=5, use_bn=bn, residual_blocks=2,
         fc_layers=fc, use_dropout=do)
    for bn, fc, do in ((True, 1, True), (False, 2, False), (True, 3, False),
                       (False, 4, True))
]


def _spec(genomes, dtype="float32", filters=16, kernel=5):
    return supernet.BucketSpec(
        template="D", filters=filters, kernel=kernel, num_classes=CLASSES,
        compute_dtype=dtype,
        max_blocks=max(g["residual_blocks"] for g in genomes))


def _lane(tree, p):
    return supernet.tree_map(lambda a: a[p], tree)


def _rel(a, b):
    """||a - b|| / ||b||, or ||a - b|| where b is 0 (a BN state at its
    init)."""
    den = float(torch.linalg.vector_norm(b.double()))
    return float(torch.linalg.vector_norm((a - b).double())) / (den or 1.0)


def _x(rows=6, h=21, w=10, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(rows, h, w, 1, generator=g)


def _reference(genome, params, state):
    return ds_cnn.reference_params(*(supernet.tree_map(
        lambda a: a.detach().clone(), t) for t in (params, state)), genome,
        "D")


@pytest.mark.parametrize("train", [True, False])
def test_grouped_forward_equals_apply_model_and_the_reference(train):
    spec = _spec(GENOMES)
    params, state, flags = supernet.init_population(SEED, spec, GENOMES)
    x = _x()
    logits, new_state = grouped.apply_population(
        spec, params, state, flags, x, train=train, dropout_key=77)
    for p, g in enumerate(GENOMES):
        lp, ls = _lane(params, p), _lane(state, p)
        lf = {k: v[p] for k, v in flags.items()}
        one, one_state = supernet.apply_model(spec, lp, ls, lf, x,
                                              train=train, dropout_key=77)
        # a lane's sums do not depend on the lanes beside it
        assert torch.equal(one, logits[p])
        for k in one_state:
            for s in ("mean", "var"):
                assert torch.equal(one_state[k][s], new_state[k][s][p])
        rp, rs = _reference(g, lp, ls)
        ref, ref_state = ds_cnn.forward(rp, rs, g, "D", x, train=train,
                                        dropout_key=77)
        assert _rel(logits[p], ref) < F32_GAP
        for k in ref_state:
            for s in ("mean", "var"):
                assert _rel(new_state[k][s][p], ref_state[k][s]) < F32_GAP


def test_bfloat16_fails_the_forward_tolerance():
    """The configuration's bf16 convs, against the float32 reference, miss
    the float32 tolerance: the tolerances above would catch a path that
    computed in a lower precision than it states."""
    spec = _spec(GENOMES, dtype="bfloat16")
    params, state, flags = supernet.init_population(SEED, spec, GENOMES)
    x = _x()
    logits, _ = grouped.apply_population(spec, params, state, flags, x,
                                         train=True, dropout_key=77)
    gaps = []
    for p, g in enumerate(GENOMES):
        rp, rs = _reference(g, _lane(params, p), _lane(state, p))
        ref, _ = ds_cnn.forward(rp, rs, g, "D", x, train=True,
                                dropout_key=77)
        gaps.append(_rel(logits[p].float(), ref))
    assert max(gaps) > F32_GAP, gaps


def _paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_one_training_step_equals_the_reference():
    spec = _spec(GENOMES)
    params, state, flags = supernet.init_population(SEED, spec, GENOMES)
    tr = PopulationTrainer(spec, TrainSettings(), CLASSES)
    g = torch.Generator().manual_seed(3)
    x = _x(rows=8, seed=1)
    y = torch.randint(0, CLASSES, (8,), generator=g)
    w = torch.tensor([1.0] * 7 + [0.0])  # a padding row weighs 0
    key = 12345
    leaves = supernet.tree_map(lambda t: t.detach().requires_grad_(True),
                               params)
    loss, _ = tr.pop_loss(leaves, state, flags, x, y, w, key)
    grads = supernet.tree_unflatten(params, torch.autograd.grad(
        loss, supernet.tree_leaves(leaves)))
    opt = tr.init_carry(params, state, flags)["opt"]
    active = torch.ones(len(GENOMES), dtype=torch.bool)
    new_params, _, new_opt = tr.batch_step(params, state, opt, flags, x, y,
                                           w, key, active)
    ref_loss = 0.0
    for p, genome in enumerate(GENOMES):
        rp, rs = _reference(genome, _lane(params, p), _lane(state, p))
        rec = training.train_steps(ds_cnn.forward, rp, rs, genome, "D",
                                   [(x, y, w, key)], lr=1e-3, eps=1e-7,
                                   dropout_rate=0.3)[0]
        ref_loss += rec["loss"]
        ref_g = dict(_paths(rec["grads"]))
        med = float(np.median([float(t.norm()) for t in ref_g.values()]))
        for path, rg in ref_g.items():
            node_g, node_p, node_m = grads, new_params, new_opt["mu"]
            for part in path.split("/"):
                node_g, node_p, node_m = (node_g[part], node_p[part],
                                          node_m[part])
            pg = node_g[p][tuple(slice(0, n) for n in rg.shape)]
            # against the leaf's norm or the median leaf's: a conv bias
            # ahead of BN has a gradient that cancels to round-off
            den = max(float(rg.norm()), med)
            assert float((pg - rg).norm()) / den < F32_GAP, path
            # Adam's first moment is the gradient the update used
            pm = node_m[p][tuple(slice(0, n) for n in rg.shape)]
            assert float((pm / (1 - ADAM_B1) - rg).norm()) / den < F32_GAP
            # the first update is lr * sign(g) where |g| is far above
            # Adam's eps and the round-off of a cancelling gradient (a
            # leaf under a thousandth of the median leaf's, as the
            # benchmark's check leaves it out)
            if float(rg.norm()) < 1e-3 * med:
                continue
            moved = rg.abs() > 1e-3 * float(rg.abs().max())
            rp_new = dict(_paths(rec["params"]))[path]
            pp_new = node_p[p][tuple(slice(0, n) for n in rg.shape)]
            assert torch.allclose(pp_new[moved], rp_new[moved], rtol=0,
                                  atol=1e-3 * 1e-3), path
    assert abs(float(loss.detach()) - ref_loss) / abs(ref_loss) < F32_GAP


# bfloat16 gradients against float32: relative rounding of 2^-9 an
# operand through the network's layers leaves 1-4e-2 on a leaf that moves
# (the leaf's reference norm at least a thousandth of the median leaf's);
# a missing or doubled term would leave O(1)
BF16_MOVING_GAP = 0.1


def test_bfloat16_gradient_gap_is_the_biases_ahead_of_bn():
    """In bfloat16 the worst leaf's gradient gap is a conv bias ahead of a
    training-mode BN: the normalisation removes a per-channel constant, so
    its exact gradient is 0 (the reference's is f32 round-off, about 1e-6
    of the median leaf's), and the program's is the sum, over rows and
    pixels, of the bf16 rounding of terms that cancel. Every leaf that
    moves stays close; without BN no leaf cancels."""
    genomes = [dict(GENOMES[0], residual_blocks=3, use_dropout=False),
               dict(GENOMES[1], residual_blocks=3)]
    spec = _spec(genomes, dtype="bfloat16")
    params, state, flags = supernet.init_population(SEED, spec, genomes)
    tr = PopulationTrainer(spec, TrainSettings(), CLASSES)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(16, 64, 40, 1, generator=g)
    y = torch.randint(0, CLASSES, (16,), generator=g)
    w = torch.ones(16)
    leaves = supernet.tree_map(lambda t: t.detach().requires_grad_(True),
                               params)
    loss, _ = tr.pop_loss(leaves, state, flags, x, y, w, 7)
    grads = dict(_paths(supernet.tree_unflatten(params, torch.autograd.grad(
        loss, supernet.tree_leaves(leaves)))))
    ahead_of_bn = {"stem1/b"} | {f"block{i}/{c}/b" for i in range(3)
                                 for c in ("dw", "pw")}
    for p, genome in enumerate(genomes):
        rp, rs = _reference(genome, _lane(params, p), _lane(state, p))
        rec = training.train_steps(ds_cnn.forward, rp, rs, genome, "D",
                                   [(x, y, w, 7)], lr=1e-3, eps=1e-7,
                                   dropout_rate=0.3)[0]
        ref_g = dict(_paths(rec["grads"]))
        med = float(np.median([float(t.norm()) for t in ref_g.values()]))
        gaps, still = {}, set()
        for path, rg in ref_g.items():
            pg = grads[path][p][tuple(slice(0, n) for n in rg.shape)]
            r = float(rg.norm())
            gaps[path] = abs(float(pg.float().norm()) - r) / max(r, med)
            if r < 1e-3 * med:
                still.add(path)
        worst = max(gaps, key=gaps.get)
        if genome["use_bn"]:
            assert still == ahead_of_bn
            assert worst in ahead_of_bn and gaps[worst] > BF16_MOVING_GAP / 4
        else:
            assert not still
        assert max(gaps[k] for k in gaps if k not in still) < \
            BF16_MOVING_GAP, genome


@pytest.mark.parametrize("k", [3, 5])
def test_stride2_stem_pads_as_keras_same(k):
    """At an even width the stride-2 stem pads one column less before than
    after (k 5 at 40: (1, 2)); PyTorch's symmetric padding gives the same
    size with shifted windows."""
    assert supernet.same_pads(40, 5, 2) == (1, 2)
    assert supernet.same_pads(501, 5, 2) == (2, 2)
    assert supernet.same_pads(40, 3, 2) == (0, 1)
    assert supernet.same_pads(501, 3, 2) == (1, 1)
    g = torch.Generator().manual_seed(k)
    x = torch.randn(2, 1, 9, 40, generator=g, dtype=torch.float64)
    wt = torch.randn(3, 1, k, k, generator=g, dtype=torch.float64)
    b = torch.randn(3, generator=g, dtype=torch.float64)
    got = supernet.conv2d(x, wt, b, 2, torch.float64)
    # the explicit reference: the input placed in a zero map whose
    # (before) rows and columns come from Keras's total padding
    out_h, out_w = -(-9 // 2), -(-40 // 2)
    th = max((out_h - 1) * 2 + k - 9, 0)
    tw = max((out_w - 1) * 2 + k - 40, 0)
    big = torch.zeros(2, 1, 9 + th, 40 + tw, dtype=torch.float64)
    big[:, :, th // 2:th // 2 + 9, tw // 2:tw // 2 + 40] = x
    want = torch.empty(2, 3, out_h, out_w, dtype=torch.float64)
    for i in range(out_h):
        for j in range(out_w):
            win = big[:, :, 2 * i:2 * i + k, 2 * j:2 * j + k]
            want[:, :, i, j] = torch.einsum("nchw,ochw->no", win, wt) + b
    assert got.shape == want.shape
    assert torch.allclose(got, want, rtol=0, atol=1e-12)
    sym = F.conv2d(x, wt, b, stride=2, padding=k // 2)
    assert sym.shape == want.shape and not torch.allclose(sym, want)


def _own_count(genome):
    """Keras's count of the genome's own layers in the program's
    materialised tree: its blocks, its BN layers (with the moving
    statistics) if it uses BN, its FC stack from the entry layer, the
    entry's rows cut to its GAP width."""
    f = genome["filters"]
    spec = supernet.BucketSpec(template="D", filters=f,
                               kernel=genome["kernel_size"],
                               num_classes=CLASSES,
                               max_blocks=genome["residual_blocks"])
    params, state = supernet.init_params(0, spec, genome)
    entry = 5 - genome["fc_layers"]
    total = 0
    for path, t in _paths(params):
        top, *rest = path.split("/")
        if path.endswith("_bn/gamma") or path.endswith("_bn/beta"):
            total += t.numel() if genome["use_bn"] else 0
        elif top == "fc":
            li = int(rest[0][2:])
            if li < entry or (li == entry and rest[1] == "wp") or (
                    li > entry and rest[1] == "wg"):
                continue
            total += (f * 2 ** genome["residual_blocks"] * t.shape[1]
                      if rest[1] == "wg" else t.numel())
        else:
            total += t.numel()
    if genome["use_bn"]:
        total += sum(t.numel() for _, t in _paths(state))
    return total


def test_counts_equal_the_materialised_tree():
    genomes = all_genomes()
    assert len(genomes) == 288
    for g in genomes:
        n = genome_arch.count_params(g, CLASSES, "D")
        assert n == _own_count(g), g
        assert n == ds_cnn.count_params(g, CLASSES, "D")
        assert genome_arch.count_fwd_flops(g, (45, 13), CLASSES, "D") == \
            ds_cnn.count_fwd_flops(g, (45, 13), CLASSES, "D")
    deepest = dict(genomes[0], filters=64, residual_blocks=3)
    leaves = supernet.tree_leaves(supernet.init_params(
        0, _spec([deepest], filters=64), deepest)[0])
    assert len(leaves) == 47  # under lane_adam's 64 rows at 3 blocks
    with pytest.raises(ValueError, match="unknown template"):
        genome_arch.count_params(genomes[0], CLASSES, "C")


@pytest.fixture(scope="module")
def data():
    return prepare_dataset(DataConfig(
        synthetic_train=64, synthetic_eval=24, time_steps=16, features=8,
        num_classes=CLASSES))


def _evaluator(data, impl="grouped"):
    cfg = TrainConfig(epochs=2, batch_size=32, patience=1,
                      num_classes=CLASSES, template="D",
                      compute_dtype="float32", compaction_chunk=0,
                      bucket_genes=("filters", "kernel_size"),
                      parallel_impl=impl)
    return tev.PopulationEvaluator(data, cfg, device="cpu")


def test_evaluate_is_keyed_by_genome_and_repeats(data):
    """Mixed depths share a bucket; each genome's fitness is the same in
    the whole population, in another population and alone, again on a
    re-run, and under the ``vmap`` setting (which runs the grouped
    forward)."""
    genomes = GENOMES[:2] + [dict(GENOMES[2], residual_blocks=1),
                             dict(GENOMES[3], kernel_size=3)]
    ev = _evaluator(data)
    whole = ev.evaluate(genomes, seed=5)
    assert ev.evaluate(genomes, seed=5) == whole
    assert _evaluator(data).evaluate(genomes[1:3], seed=5) == whole[1:3]
    assert _evaluator(data).evaluate([genomes[0]], seed=5) == whole[:1]
    assert _evaluator(data, "vmap").evaluate(genomes, seed=5) == whole
    for g, fit in zip(genomes, whole):
        assert fit[1] == genome_arch.model_size_mb(g, CLASSES, "D")
        assert all(np.isfinite(fit))


def test_depthwise_spans_of_a_backward_on_another_thread():
    """Backward on a thread that never turned recording on (on the card,
    autograd's device thread) still records the input and weight gradient
    spans, under the recorder the forward saw; off, no recorder is
    active."""
    spec = _spec(GENOMES)
    params, state, flags = supernet.init_population(SEED, spec, GENOMES)
    leaves = supernet.tree_map(lambda t: t.detach().requires_grad_(True),
                               params)
    assert profiling.active() is None
    with profiling.recording() as records:
        logits, _ = grouped.apply_population(spec, leaves, state, flags,
                                             _x(), train=True)
        errors = []

        def backward():
            try:
                assert profiling.active() is None
                torch.autograd.grad(logits.sum(),
                                    supernet.tree_leaves(leaves))
            except Exception as e:  # reported by the test's thread
                errors.append(e)

        t = threading.Thread(target=backward)
        t.start()
        t.join(timeout=120)
    assert not t.is_alive() and not errors, errors
    dw = [r for r in records if r.name == "grouped.depthwise"]
    passes = [r.attrs["pass"] for r in dw]
    assert sorted(passes) == ["dgrad"] * 2 + ["fwd"] * 2 + ["wgrad"] * 2
    assert all(r.end_ns >= r.start_ns > 0 for r in dw)
    fwd = [r.attrs for r in dw if r.attrs["pass"] == "fwd"]
    assert fwd == [{"pass": "fwd", "lanes": 4, "channels": 16,
                    "hw": [11, 5], "k": 5},
                   {"pass": "fwd", "lanes": 4, "channels": 32,
                    "hw": [6, 3], "k": 5}]


def test_depthwise_spans_of_two_backwards_at_once():
    """Two backward passes at once on one recorder, each on a thread of
    its own (on the mesh path, autograd's device threads of two cards):
    each pass's spans open beside its own forward's, under the span that
    enclosed that forward, and close in their own thread."""
    spec = _spec(GENOMES)
    params, state, flags = supernet.init_population(SEED, spec, GENOMES)
    graphs = []
    with profiling.recording() as records:
        for name, h in (("a", 21), ("b", 33)):
            leaves = supernet.tree_map(
                lambda t: t.detach().requires_grad_(True), params)
            with profiling.span(name):
                logits, _ = grouped.apply_population(
                    spec, leaves, state, flags, _x(h=h), train=True)
            graphs.append((logits, leaves))
        start = threading.Barrier(2)
        errors = []

        def backward(logits, leaves):
            try:
                start.wait(60)
                torch.autograd.grad(logits.sum(),
                                    supernet.tree_leaves(leaves))
            except Exception as e:  # reported by the test's thread
                errors.append(e)

        threads = [threading.Thread(target=backward, args=g)
                   for g in graphs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert [r.id for r in records] == list(range(len(records)))
    tops = {r.name: r for r in records if r.name in ("a", "b")}
    for name, hw in (("a", [[11, 5], [6, 3]]), ("b", [[17, 5], [9, 3]])):
        mine = [r for r in records if r.name == "grouped.depthwise"
                and r.parent == tops[name].id]
        assert sorted(r.attrs["pass"] for r in mine) == (
            ["dgrad"] * 2 + ["fwd"] * 2 + ["wgrad"] * 2)
        assert sorted(r.attrs["hw"] for r in mine) == sorted(hw * 3)
        assert all(r.call == tops[name].call for r in mine)
    assert all(r.end_ns >= r.start_ns > 0 for r in records)


def test_a_saved_d_model_predicts_and_keras_export_refuses_it(tmp_path):
    g = GENOMES[0]
    spec = _spec([g])
    params, state = supernet.init_params(SEED, spec, g)
    cfg = TrainConfig(num_classes=CLASSES, template="D",
                      compute_dtype="float32")
    export.save_model(str(tmp_path), g, cfg, params, state, {}, SEED,
                      input_hw=(21, 10))
    genome, spec2, p2, s2, meta = export.load_model(str(tmp_path), "cpu")
    assert spec2.template == "D" and meta["template"] == "D"
    saved = dict(_paths(p2))
    assert sorted(saved) == sorted(dict(_paths(params)))
    for path, t in _paths(params):
        assert torch.equal(t, saved[path]), path
    x = _x()
    got = export.predict(spec2, genome, p2, s2, x.numpy(), device="cpu")
    flags = {k: v[0] for k, v in supernet.stack_flags([g]).items()}
    want, _ = supernet.apply_model(spec, params, state, flags, x,
                                   train=False)
    np.testing.assert_array_equal(got, want.numpy())
    with pytest.raises(ValueError, match="'D'"):
        keras_export.build_keras_model(g, CLASSES, (21, 10), "D")
