"""The per-lane fused Adam's host side (engine/lane_adam.py), on the CPU:
the trainer's ``adam_step`` takes the plain route here, one
``trainer.adam`` span a ``batch_step``, out of place; the kernel's leaf
table (per-lane sizes, output offsets, one launch under the parameter
limit, the 16-byte or scalar choice per leaf); the kernel route's wrapper
(``fused``) driving a numpy stand-in of csrc/lane_adam.cu's launch on
host memory, equal to the plain version bit for bit; and the wrapper's
refusals. The kernel itself is held against the plain route on the card
(tests/test_torch_cuda.py)."""

import ctypes

import numpy as np
import pytest
import torch

from cmoop_audio_processing_torch.engine import lane_adam as la
from cmoop_audio_processing_torch.engine import trainer as tt
from cmoop_audio_processing_torch.models import supernet as ts
from cmoop_audio_processing_torch.utils.profiling import recording

# the test workers share the CPU's cores: one intra-op thread per worker
# keeps PyTorch's thread pool from oversubscribing them
torch.set_num_threads(1)

GENOMES = [
    dict(filters=16, kernel_size=3, use_bn=bn, residual_blocks=nb,
         fc_layers=nfc, use_dropout=False)
    for bn, nb, nfc in ((True, 1, 1), (False, 2, 3), (True, 3, 4))
]
# csrc/lane_adam.cu ``Args``: six pointers, the lane count, six floats, two
# ints, then the rows
ARGS_HEAD_BYTES = 6 * 8 + 8 + 6 * 4 + 2 * 4


def _leaves(*trees):
    return [t for tree in trees for t in ts.tree_leaves(tree)]


def _same_bits(a, b):
    """Equal bit for bit, NaN included."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _fake_ptrs(n, base=1 << 20, step=1 << 16):
    """Distinct 16-byte-aligned (p, g, m, v) addresses for ``n`` leaves."""
    return [tuple(base + (4 * i + j) * step for j in range(4))
            for i in range(n)]


@pytest.mark.parametrize("template,n_classes", [("A", 10), ("B", 11)])
def test_adam_step_on_the_cpu_takes_the_plain_route(template, n_classes):
    """Each ``batch_step`` opens one ``trainer.adam`` span, route "plain",
    launches no kernel, leaves its inputs as they were and returns fresh
    tensors; its update is ``lane_adam_reference``'s, bit for bit."""
    spec = ts.BucketSpec(template, 16, 3, n_classes, compute_dtype="float32")
    trainer = tt.PopulationTrainer(spec, tt.TrainSettings(), n_classes)
    params, state, flags = ts.init_population(1, spec, GENOMES)
    carry = trainer.init_carry(params, state, flags)
    rng = np.random.default_rng(0)
    h, w = (45, 13) if template == "A" else (40, 20)
    xb = torch.as_tensor(rng.standard_normal((8, h, w, 1)).astype(np.float32))
    yb = torch.as_tensor(rng.integers(0, n_classes, 8)).long()
    wb = torch.ones(8)
    active = torch.tensor([True, False, True])
    p, st, opt = carry["params"], carry["state"], carry["opt"]
    launches = la.launch_counts["lane_adam"]
    with recording() as recs:
        for _ in range(2):
            before = [t.clone() for t in _leaves(p, opt)]
            new_p, st, new_opt = trainer.batch_step(p, st, opt, flags, xb, yb,
                                                    wb, 0, active)
            for old, kept in zip(before, _leaves(p, opt)):
                assert torch.equal(old, kept)  # inputs untouched
            for old, new in zip(ts.tree_leaves(p), ts.tree_leaves(new_p)):
                assert new.data_ptr() != old.data_ptr()
            p, opt = new_p, new_opt
    assert [(r.name, r.attrs) for r in recs] == [
        ("trainer.adam", {"route": "plain"})] * 2
    assert la.launch_counts["lane_adam"] == launches
    assert opt["count"].tolist() == [2, 0, 2]

    # the update alone against the plain version, on a gradient tree
    grads = ts.tree_map(lambda t: torch.randn_like(t), p)
    got_p, got_opt = trainer.adam_step(p, grads, opt, active)
    cnt = torch.clamp(got_opt["count"], min=1).float()
    want = la.lane_adam_reference(p, grads, opt["mu"], opt["nu"], active,
                                  1.0 - torch.pow(la.ADAM_B1, cnt),
                                  1.0 - torch.pow(la.ADAM_B2, cnt), 1e-3,
                                  1e-7)
    for got, ref in zip(_leaves(got_p, got_opt["mu"], got_opt["nu"]),
                        _leaves(*want)):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("template,n_classes,n_leaves", [("A", 10, 51),
                                                          ("B", 11, 35)])
@pytest.mark.parametrize("lanes", [16, 5])
def test_leaf_table_of_a_population_tree(template, n_classes, n_leaves,
                                         lanes):
    """A template's whole tree is one table: every leaf's per-lane size and
    addresses, its output at a 256-byte boundary past the one before, and
    16-byte accesses for every leaf but the output bias (10 or 11 elements
    a lane)."""
    spec = ts.BucketSpec(template, 16, 3, n_classes)
    params, _ = ts.init_params(0, spec, GENOMES[2])
    shapes = [(lanes,) + tuple(t.shape) for t in ts.tree_leaves(params)]
    per_lane = [t.numel() for t in ts.tree_leaves(params)]
    sizes = [n * lanes for n in per_lane]
    ptrs = _fake_ptrs(len(sizes))
    rows = la.leaf_table(ptrs, shapes, lanes)
    assert len(rows) == n_leaves <= la.MAX_LEAVES
    assert rows["per_lane"].tolist() == per_lane
    assert [tuple(int(r[k]) for k in "pgmv") for r in rows] == ptrs
    offsets, total = la.out_layout(sizes)
    assert rows["out"].tolist() == offsets
    assert all(o % la.ALIGN == 0 for o in offsets)
    assert all(a + n <= b for a, n, b in zip(offsets, sizes, offsets[1:]))
    assert offsets[-1] + sizes[-1] <= total < offsets[-1] + sizes[-1] + la.ALIGN
    scalar = [i for i, n in enumerate(per_lane) if n % 4]
    assert [per_lane[i] for i in scalar] == [n_classes]
    assert rows["vec"].tolist() == [int(i not in scalar)
                                    for i in range(len(sizes))]


def test_leaf_table_runs_under_the_parameter_limit():
    """A table of ``MAX_LEAVES`` rows fits 4 KB of kernel parameters and is
    one launch; a tree of more leaves is refused before anything
    launches."""
    assert la.LEAF_DTYPE.itemsize == 56
    assert ARGS_HEAD_BYTES + la.MAX_LEAVES * la.LEAF_DTYPE.itemsize <= 4096
    active, bc = torch.ones(3, dtype=torch.bool), torch.ones(3)
    lib = _EmulatedLaunch()
    for n_leaves in (la.MAX_LEAVES, la.MAX_LEAVES + 1):
        trees = [{f"leaf{i}": torch.zeros(3, 1 + 7 * (i % 13))
                  for i in range(n_leaves)} for _ in range(4)]
        if n_leaves > la.MAX_LEAVES:
            with pytest.raises(ValueError, match="at most 64 leaves"):
                la.fused(_NoLaunch(), 0, *trees, active, bc, bc, 1e-3, 1e-7)
        else:
            la.fused(lib, 0, *trees, active, bc, bc, 1e-3, 1e-7)
    assert lib.leaves_a_launch == [la.MAX_LEAVES]


@pytest.mark.parametrize("per_lane,shift,vec", [
    (64, None, 1), (4, None, 1), (10, None, 0), (11, None, 0), (2, None, 0),
    (64, 0, 0), (64, 1, 0), (64, 2, 0), (64, 3, 0), (64, 8, 1)],
    ids=["bias_64", "per_lane_4", "classes_10", "classes_11", "per_lane_2",
         "p_4_bytes_off", "g_4_bytes_off", "m_4_bytes_off",
         "v_4_bytes_off", "all_32_bytes_on"])
def test_leaf_table_vector_or_scalar(per_lane, shift, vec):
    """16-byte accesses need a per-lane size that is a multiple of 4 and
    all four inputs on 16-byte boundaries; one input 4 bytes off takes the
    scalar path. (``shift`` 8: every input 32 bytes on, still aligned.)"""
    ptrs = list(_fake_ptrs(1)[0])
    if shift == 8:
        ptrs = [a + 32 for a in ptrs]
    elif shift is not None:
        ptrs[shift] += 4
    rows = la.leaf_table(ptrs, [(5, per_lane)], 5)
    assert rows["vec"].tolist() == [vec]


def test_route_by_device():
    assert la.route(torch.device("cuda", 0)) == "kernel"
    assert la.route(torch.device("cpu")) == "plain"
    with pytest.raises(ValueError, match="unsupported device"):
        la.route(torch.device("meta"))


class _NoLaunch:
    def lane_adam_launch(self, *args):
        raise AssertionError("launched")


@pytest.mark.parametrize("tree,bad,match", [
    (1, lambda t: t.double(), "float32"),
    (2, lambda t: t.t().contiguous().t(), "contiguous"),
    (3, lambda t: torch.empty(t.shape, device="meta"), "one device"),
    (0, lambda t: t[:3], "shape"),
    (1, lambda t: t[:, :4], "shape"),
    (0, lambda t: t[0, 0], "shape"),
], ids=["float64", "non_contiguous", "mixed_devices", "lane_count",
        "grad_of_another_shape", "no_lane_axis"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(tree, bad, match):
    """The kernel route raises before any launch on a leaf of another
    dtype, layout, device or shape than its parameter's, on any of the
    four trees."""
    trees = [{"a": torch.zeros(4, 8), "b": {"c": torch.zeros(4, 6)}}
             for _ in range(4)]
    active, bc = torch.ones(4, dtype=torch.bool), torch.ones(4)
    la.fused(_EmulatedLaunch(), 0, *trees, active, bc, bc, 1e-3, 1e-7)
    trees[tree]["b"]["c"] = bad(trees[tree]["b"]["c"])
    with pytest.raises(ValueError, match=match):
        la.fused(_NoLaunch(), 0, *trees, active, bc, bc, 1e-3, 1e-7)


class _EmulatedLaunch:
    """csrc/lane_adam.cu's ``lane_adam_launch`` in numpy on host memory:
    the table read from its address, each leaf's inputs from theirs, the
    kernel's float32 operations in its order, the outputs written at their
    offsets; the 16-byte choice checked against the rows.
    The square root is torch's CPU op, as the plain route's: on the CPU it
    is not correctly rounded (~0.6% of float32 inputs a unit in the last
    place off numpy's), the kernel's ``__fsqrt_rn`` and torch's CUDA sqrt
    are (tests/test_torch_cuda.py holds them bit for bit)."""

    def __init__(self):
        self.leaves_a_launch = []

    def lane_adam_launch(self, rows_at, n_leaves, p_out, m_out, v_out,
                         active, bc1, bc2, lanes, b1, c1, b2, c2, lr, eps,
                         stream):
        def at(addr, n, ctype=ctypes.c_float):
            return np.ctypeslib.as_array((ctype * n).from_address(addr))

        rows = np.frombuffer(at(rows_at, n_leaves * la.LEAF_DTYPE.itemsize,
                                ctypes.c_char), la.LEAF_DTYPE)
        b1, c1, b2, c2, lr, eps = map(np.float32, (b1, c1, b2, c2, lr, eps))
        on = at(active, lanes, ctypes.c_uint8) != 0
        bc1, bc2 = at(bc1, lanes), at(bc2, lanes)
        assert 1 <= n_leaves <= la.MAX_LEAVES
        for r in rows:
            per_lane = int(r["per_lane"])
            n = lanes * per_lane
            p, g, m, v = (at(int(r[k]), n) for k in "pgmv")
            assert r["vec"] == (per_lane % 4 == 0 and all(
                int(r[k]) % 16 == 0 for k in "pgmv"))
            lane = np.arange(n) // per_lane
            with np.errstate(invalid="ignore"):
                m2 = b1 * m + c1 * g
                v2 = b2 * v + (c2 * g) * g
                root = torch.sqrt(torch.from_numpy(v2 / bc2[lane])).numpy()
                step = (m2 / bc1[lane]) / (root + eps)
                p2 = p - lr * step
            keep = on[lane]
            for base, new, old in ((p_out, p2, p), (m_out, m2, m),
                                   (v_out, v2, v)):
                assert (base + 4 * int(r["out"])) % 16 == 0
                at(base + 4 * int(r["out"]), n)[:] = np.where(keep, new, old)
        assert stream == 0
        self.leaves_a_launch.append(n_leaves)
        return 0


def _misaligned(t):
    """``t``'s values in a view that starts 4 bytes past an aligned
    buffer's start."""
    buf = torch.empty(t.numel() + 1)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("n_leaves,lanes,misalign", [
    (51, 16, False), (35, 5, False), (64, 3, False), (12, 4, True)],
    ids=["kws_leaf_count", "bird_leaf_count_5_lanes", "max_leaves",
         "misaligned_inputs"])
def test_kernel_route_on_an_emulated_launch(n_leaves, lanes, misalign):
    """``fused`` through the stand-in launch equals the plain version bit
    for bit: leaves with per-lane sizes of 4k (16-byte path) and 10 or 11
    (scalar path), inputs on 4-byte boundaries, three lanes' worth of
    patterns (active, stopped with a NaN gradient, active) repeated; the
    inputs unchanged, one launch, ``launch_counts`` moved."""
    gen = torch.Generator().manual_seed(n_leaves)

    def tree(scale, square=False):
        out = {}
        for i in range(n_leaves):
            per_lane = (10, 11, 4, 64, 4100)[i % 5]
            x = torch.randn((lanes, per_lane), generator=gen) * scale
            x = x * x if square else x
            out[f"leaf{i}"] = _misaligned(x) if misalign else x
        return out

    params, grads, mu, nu = tree(0.1), tree(1e-2), tree(1e-3), tree(1e-3, True)
    active = torch.arange(lanes) % 3 != 1
    for g in grads.values():
        g[1] = float("nan")  # lane 1 is stopped
    cnt = torch.arange(1, lanes + 1).float()
    bc1 = 1.0 - torch.pow(la.ADAM_B1, cnt)
    bc2 = 1.0 - torch.pow(la.ADAM_B2, cnt)
    inputs = (params, grads, mu, nu, active, bc1, bc2, 1e-3, 1e-7)
    before = [t.clone() for t in _leaves(params, grads, mu, nu)]
    lib = _EmulatedLaunch()
    launches = la.launch_counts["lane_adam"]
    got = la.fused(lib, 0, *inputs)
    assert lib.leaves_a_launch == [n_leaves]
    assert la.launch_counts["lane_adam"] == launches + 1
    assert all(_same_bits(a, b) for a, b in
               zip(before, _leaves(params, grads, mu, nu)))
    want = la.lane_adam_reference(*inputs)
    for g, w in zip(_leaves(*got), _leaves(*want)):
        assert g.shape == w.shape and g.is_contiguous()
        assert torch.equal(g, w)
    assert torch.equal(got[0]["leaf0"][1], params["leaf0"][1])


def test_outputs_skip_the_deterministic_nan_fill():
    """Under deterministic algorithms ``torch.empty`` fills with NaN; the
    kernel route's output buffers are left unfilled (the kernel writes
    every element their views show), the setting is as it was afterwards,
    and the result is still the plain version's."""
    det = torch.utils.deterministic
    trees = [{"a": torch.rand(4, 8), "b": {"c": torch.rand(4, 6)}}
             for _ in range(4)]
    active = torch.tensor([True, False, True, True])
    bc = torch.full((4,), 0.5)
    fills = []
    real_empty = torch.empty

    def empty(*args, **kwargs):
        fills.append(det.fill_uninitialized_memory)
        return real_empty(*args, **kwargs)

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        torch.empty = empty
        got = la.fused(_EmulatedLaunch(), 0, *trees, active, bc, bc, 1e-3,
                       1e-7)
    finally:
        torch.empty = real_empty
        torch.use_deterministic_algorithms(was)
    assert fills == [False] * 3 and det.fill_uninitialized_memory
    want = la.lane_adam_reference(*trees, active, bc, bc, 1e-3, 1e-7)
    for g, w in zip(_leaves(*got), _leaves(*want)):
        assert torch.equal(g, w)
