"""Exact hypervolume computation (pygmo-parity).

The reference computes HV with pygmo's C++ `pg.hypervolume(front).compute(r)`
(reference: compare.ipynb cell 1, "Compute Hypervolumes" section), in
minimization space (-acc, size, fpr) with reference point r = per-axis max of
the union of fronts + 1e-3. BASELINE.md requires parity to <1%; we provide an
exact algorithm (so parity is exact up to float error):

* 2-D: staircase sweep, O(n log n).
* 3-D: z-sweep accumulating 2-D slab areas, O(n^2 log n) — exact, and fast
  for the tens-of-points fronts this workload produces.
* d>=4: WFG-style recursive exclusive-hypervolume, exponential worst case but
  fine for small fronts; provided for completeness.

A C++ implementation of the same 2-D/3-D algorithms (native/hv.cpp, built
into build/native/libhv.so by ``python -m
cmoop_audio_processing_torch.native.build``) is used when its shared library
has been built, as in cmoop_audio_processing_tpu/metrics/hypervolume.py; it
agrees with the numpy code within 1e-14 relative
(tests/test_torch_host_modules.py), which stays as the plain version and the
fallback. ``core()`` names the one that runs.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

from ..native.build import HV_LIB

_NATIVE: Optional[ctypes.CDLL] = None
_NATIVE_TRIED = False
_WFG_WARN_SIZE = 24  # WFG recursion is exponential in the front size


def open_native(path: str) -> Optional[ctypes.CDLL]:
    """The HV library at ``path`` with ``hv_compute``'s signature set, or
    None if it cannot be loaded."""
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.hv_compute.restype = ctypes.c_double
    lib.hv_compute.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
    ]
    return lib


def _load_native() -> Optional[ctypes.CDLL]:
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE
    _NATIVE_TRIED = True
    if os.path.exists(HV_LIB):
        _NATIVE = open_native(HV_LIB)
    return _NATIVE


def core() -> str:
    """"native" when the C++ core serves 2-D/3-D fronts, else "numpy"."""
    return "native" if _load_native() is not None else "numpy"


def _clip_to_ref(points: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Drop points outside the reference box. A point's dominated region is
    the box [p, ref], which is empty whenever any p_i >= r_i, so such points
    contribute zero volume and can be removed up front. (Clipping p to
    min(p, ref) would be wrong — it would invent volume for points beyond the
    box.) This matches pygmo: hypervolume is the measure of the union of
    [p, ref] boxes over the front."""
    keep = np.all(points < ref, axis=1)
    return points[keep]


def _hv2d(points: np.ndarray, ref: np.ndarray) -> float:
    pts = _clip_to_ref(points, ref)
    if len(pts) == 0:
        return 0.0
    # sort ascending by x; sweep keeping the best (lowest) y seen so far
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]
    hv = 0.0
    best_y = ref[1]
    for x, y in pts:
        if y < best_y:
            hv += (ref[0] - x) * (best_y - y)
            best_y = y
    return float(hv)


def _hv3d(points: np.ndarray, ref: np.ndarray) -> float:
    pts = _clip_to_ref(points, ref)
    if len(pts) == 0:
        return 0.0
    # sweep planes at each distinct z (ascending); between consecutive
    # z-levels the dominated 2-D area is constant = area of the staircase of
    # all points with pz <= z_level.
    order = np.argsort(pts[:, 2], kind="stable")
    pts = pts[order]
    zs = pts[:, 2]
    hv = 0.0
    n = len(pts)
    i = 0
    while i < n:
        z = zs[i]
        j = i
        while j < n and zs[j] == z:
            j += 1
        z_next = zs[j] if j < n else ref[2]
        active = pts[:j, :2]
        area = _hv2d(active, ref[:2])
        hv += area * (z_next - z)
        i = j
    return float(hv)


def _hv_wfg(points: np.ndarray, ref: np.ndarray) -> float:
    """Inclusion-exclusion style exact HV for d>=2 via the WFG recursion:
    HV(S) = sum over i of exclusive contribution of p_i against S[i+1:].

    Exponential worst case — only used for d>=4, where this workload's
    fronts are tiny. Fronts beyond ``_WFG_WARN_SIZE`` points get a runtime
    warning rather than a silent hang."""
    pts = _clip_to_ref(points, ref)
    if len(pts) == 0:
        return 0.0
    if len(pts) > _WFG_WARN_SIZE:
        import warnings

        warnings.warn(
            f"WFG exact hypervolume on {len(pts)} points (d="
            f"{pts.shape[1]}) is exponential-time; expect a long runtime",
            RuntimeWarning,
            stacklevel=2,
        )
    # sort by first objective descending improves pruning
    order = np.argsort(-pts[:, 0], kind="stable")
    pts = pts[order]

    def limit_set(s: np.ndarray, p: np.ndarray) -> np.ndarray:
        q = np.maximum(s, p)
        # remove dominated rows within q
        keep = np.ones(len(q), dtype=bool)
        for a in range(len(q)):
            if not keep[a]:
                continue
            for b in range(len(q)):
                if a == b or not keep[b]:
                    continue
                if np.all(q[b] <= q[a]) and np.any(q[b] < q[a]):
                    keep[a] = False
                    break
        return q[keep]

    def inclusive(p: np.ndarray) -> float:
        return float(np.prod(ref - p))

    def exclusive(p: np.ndarray, s: np.ndarray) -> float:
        return inclusive(p) - wfg(limit_set(s, p))

    def wfg(s: np.ndarray) -> float:
        total = 0.0
        for i in range(len(s)):
            total += exclusive(s[i], s[i + 1:])
        return total

    return wfg(pts)


def hypervolume(points: Sequence[Sequence[float]], ref: Sequence[float]) -> float:
    """Exact hypervolume of a minimization front w.r.t. reference point
    ``ref``. Accepts dominated/duplicate points (they contribute nothing
    extra), matching pygmo semantics."""
    pts = np.asarray(points, dtype=np.float64)
    r = np.asarray(ref, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[1] != r.shape[0]:
        raise ValueError(f"points {pts.shape} incompatible with ref {r.shape}")
    d = pts.shape[1]
    lib = _load_native()
    if lib is not None and d in (2, 3):
        flat = np.ascontiguousarray(pts).ravel()
        return float(
            lib.hv_compute(
                flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                pts.shape[0],
                d,
                np.ascontiguousarray(r).ctypes.data_as(
                    ctypes.POINTER(ctypes.c_double)
                ),
            )
        )
    if d == 2:
        return _hv2d(pts, r)
    if d == 3:
        return _hv3d(pts, r)
    return _hv_wfg(pts, r)


def reference_point(fronts: Sequence[np.ndarray], eps: float = 1e-3) -> np.ndarray:
    """The compare.ipynb reference-point rule: per-axis max over the union of
    all fronts + eps (compare.ipynb cell 1 lines 64-75)."""
    union = np.vstack([np.asarray(f, dtype=np.float64) for f in fronts])
    return union.max(axis=0) + eps
