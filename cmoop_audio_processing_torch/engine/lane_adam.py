"""The population trainer's per-lane masked Adam update, and its plain
version.

``lane_adam(params, grads, mu, nu, active, bc1, bc2, lr, eps)`` takes
stacked trees (nested dicts whose leaves carry a leading lane axis) and
the per-lane step flags and bias corrections, and returns fresh trees of
the new parameters and moments; the inputs are left as they are. A lane
that is not ``active`` keeps its parameters and moments bit for bit.

* On a CUDA tensor it launches csrc/lane_adam.cu: one pass over every
  leaf, reading p, g, m and v and writing p, m and v once, from a leaf
  table passed in the kernel's parameters (``leaf_table``), one launch for
  a tree of up to ``MAX_LEAVES`` leaves (the templates' trees have at most
  51). Each output tree is one flat buffer with a view per leaf, each leaf
  at a 256-byte boundary, allocated without the NaN fill that
  deterministic algorithms give ``torch.empty`` (the kernel writes every
  element a view shows; the fill wrote 2.7 GB more a KWS step). Built
  with nvcc at first use into build/kernels/ and bound through ctypes
  (frontend/cuda_kernels); it launches on the
  leaves' device, whichever device is current, on that device's current
  stream, and never synchronises. It raises on anything it does not take:
  another dtype than float32, a non-contiguous leaf, leaves on more than
  one device or with another lane count, more than ``MAX_LEAVES`` leaves.
* On a CPU tensor it computes ``lane_adam_reference``, the plain PyTorch
  ops the kernel repeats operation for operation.

``launch_counts["lane_adam"]`` counts kernel launches.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..frontend import cuda_kernels
from ..models.supernet import tree_leaves, tree_map, tree_unflatten

ADAM_B1 = 0.9
ADAM_B2 = 0.999
MAX_LEAVES = 64  # table rows csrc/lane_adam.cu takes: 3.7 KB of parameters
ALIGN = 64  # elements: each output leaf starts at a 256-byte boundary

# one table row, csrc/lane_adam.cu ``Leaf`` (its launch fills first_block)
LEAF_DTYPE = np.dtype([
    ("p", np.uint64), ("g", np.uint64), ("m", np.uint64), ("v", np.uint64),
    ("out", np.int64), ("per_lane", np.int64), ("first_block", np.int32),
    ("vec", np.int32)])

launch_counts: Dict[str, int] = {"lane_adam": 0}


def route(device: torch.device) -> str:
    """"kernel" for a CUDA device, "plain" for the CPU."""
    if device.type == "cuda":
        return "kernel"
    if device.type == "cpu":
        return "plain"
    raise ValueError(f"lane_adam: unsupported device {device}")


def lane_adam_reference(params, grads, mu, nu, active, bc1, bc2, lr, eps):
    """The plain version: 17 PyTorch ops a leaf. Returns (params, mu, nu)."""
    def lanes(v, x):
        return v.view((-1,) + (1,) * (x.dim() - 1))

    def upd(p, g, m, v):
        m2 = ADAM_B1 * m + (1.0 - ADAM_B1) * g
        v2 = ADAM_B2 * v + (1.0 - ADAM_B2) * g * g
        step = (m2 / lanes(bc1, m2)) / (torch.sqrt(v2 / lanes(bc2, v2)) + eps)
        keep = lanes(active, p)
        return (torch.where(keep, p - lr * step, p),
                torch.where(keep, m2, m), torch.where(keep, v2, v))

    new = tree_map(upd, params, grads, mu, nu)  # 3-tuples

    def pick(i):
        return tree_map(lambda t: t[i], new)

    return pick(0), pick(1), pick(2)


def out_layout(sizes: Sequence[int]) -> Tuple[List[int], int]:
    """Each leaf's offset in a flat output buffer (``ALIGN``-element
    boundaries) and the buffer's length, for leaves of ``sizes`` elements."""
    offsets, end = [], 0
    for n in sizes:
        offsets.append(end)
        end += -(-n // ALIGN) * ALIGN
    return offsets, end


@functools.lru_cache(maxsize=64)
def _plan(shapes: Tuple[torch.Size, ...], lanes: int):
    """What the launch takes from the leaves' shapes alone: the output
    buffers' length, each output leaf's (shape, strides, offset) in its
    buffer, the table rows with each leaf's offset and per-lane size
    filled, and whether each per-lane size allows 16-byte accesses."""
    sizes = tuple(math.prod(shape) for shape in shapes)
    offsets, total = out_layout(sizes)
    views = [(shape, _contiguous_strides(shape), off)
             for shape, off in zip(shapes, offsets)]
    rows = np.zeros(len(sizes), LEAF_DTYPE)
    rows["out"] = offsets
    rows["per_lane"] = np.array(sizes, np.int64) // lanes
    return total, views, rows, rows["per_lane"] % 4 == 0


def _contiguous_strides(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    strides, step = [], 1
    for n in reversed(shape):
        strides.append(step)
        step *= n
    return tuple(reversed(strides))


def leaf_table(ptrs: Sequence[int], shapes: Sequence[Tuple[int, ...]],
               lanes: int) -> np.ndarray:
    """The launch's table rows (``LEAF_DTYPE``), given each leaf's p, g, m
    and v addresses (four a leaf, in order) and shape. A leaf takes 16-byte
    accesses where its per-lane size is a multiple of 4 and its four inputs
    lie on 16-byte boundaries (its output does, by ``out_layout``)."""
    addr = np.array(ptrs, np.uint64).reshape(-1, 4)
    _, _, rows, vec = _plan(tuple(shapes), lanes)
    rows = rows.copy()
    for k, name in enumerate("pgmv"):
        rows[name] = addr[:, k]
    rows["vec"] = vec & (addr % 16 == 0).all(axis=1)
    return rows


def _unfilled(k: int, n: int, device: torch.device) -> List[torch.Tensor]:
    """``k`` float32 buffers of ``n`` elements on ``device``, left
    uninitialised even where deterministic algorithms would fill
    ``torch.empty`` with NaN: every element the kernel's outputs show is
    written by it."""
    det = torch.utils.deterministic
    fill, det.fill_uninitialized_memory = det.fill_uninitialized_memory, False
    try:
        return [torch.empty(n, dtype=torch.float32, device=device)
                for _ in range(k)]
    finally:
        det.fill_uninitialized_memory = fill


def _refuse(t: torch.Tensor, shape, device: torch.device) -> None:
    """Raise, naming what the kernel does not take in leaf ``t``, which
    should be a contiguous float32 tensor of ``shape`` on ``device``."""
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(
            f"lane_adam takes contiguous float32 leaves; got {t.dtype} of "
            f"shape {tuple(t.shape)} and strides {t.stride()}")
    if t.device != device:
        raise ValueError(f"lane_adam takes leaves on one device; got "
                         f"{t.device} beside {device}")
    raise ValueError(f"lane_adam takes leaves of shape {tuple(shape)} (a "
                     f"leading lane axis of the mask's length, the same "
                     f"in the four trees); got {tuple(t.shape)}")


def lane_adam(params, grads, mu, nu, active, bc1, bc2, lr: float,
              eps: float):
    """One Adam step per lane over stacked trees; returns fresh (params,
    mu, nu). ``active`` (P,) bool, ``bc1`` and ``bc2`` (P,) float32 bias
    corrections. CUDA: the kernel, on ``active``'s device; CPU:
    ``lane_adam_reference``."""
    device = active.device
    if route(device) == "plain":
        return lane_adam_reference(params, grads, mu, nu, active, bc1, bc2,
                                   lr, eps)
    # the launch goes to the current device: make it the leaves' (the
    # mesh trains a pop shard on cuda:1 while cuda:0 stays current)
    with torch.cuda.device(device):
        return fused(cuda_kernels._library("lane_adam"),
                     torch.cuda.current_stream(device).cuda_stream, params,
                     grads, mu, nu, active, bc1, bc2, lr, eps)


def fused(lib, stream: int, params, grads, mu, nu, active, bc1, bc2,
          lr: float, eps: float):
    """``lane_adam``'s kernel route through ``lib`` (the built library, or
    a stand-in with its ``lane_adam_launch``): the checks, the three flat
    output buffers and their leaf views, the table and its launch."""
    trees = [tree_leaves(t) for t in (params, grads, mu, nu)]
    if len({len(t) for t in trees}) != 1:
        raise ValueError("lane_adam takes trees of one structure")
    if len(trees[0]) > MAX_LEAVES:
        raise ValueError(f"lane_adam takes trees of at most {MAX_LEAVES} "
                         f"leaves (one launch); got {len(trees[0])}")
    lanes, device = active.shape[0], active.device
    if active.dtype != torch.bool or not active.is_contiguous():
        raise ValueError("lane_adam takes a contiguous bool lane mask")
    for bc in (bc1, bc2):
        if (bc.dtype != torch.float32 or not bc.is_contiguous()
                or bc.device != device or bc.shape != active.shape):
            _refuse(bc, active.shape, device)
    ptrs = []
    for leaf in zip(*trees):
        shape = leaf[0].shape
        if not shape or shape[0] != lanes:
            _refuse(leaf[0], (lanes,) + tuple(shape[1:]), device)
        for t in leaf:
            if (t.dtype != torch.float32 or not t.is_contiguous()
                    or t.device != device or t.shape != shape):
                _refuse(t, shape, device)
            ptrs.append(t.data_ptr())

    shapes = tuple(t.shape for t in trees[0])
    total, views, _, _ = _plan(shapes, lanes)
    flats, outs = [], []
    for flat in _unfilled(3, total, device):
        flats.append(flat.data_ptr())
        outs.append(tree_unflatten(params, [flat.as_strided(*view)
                                            for view in views]))
    rows = leaf_table(ptrs, shapes, lanes)
    err = lib.lane_adam_launch(
        rows.ctypes.data, len(rows), *flats, active.data_ptr(),
        bc1.data_ptr(), bc2.data_ptr(), lanes, ADAM_B1, 1.0 - ADAM_B1,
        ADAM_B2, 1.0 - ADAM_B2, lr, eps, stream)
    if err != 0:
        raise RuntimeError(f"lane_adam kernel launch failed: cudaError {err}")
    launch_counts["lane_adam"] += 1
    return tuple(outs)
