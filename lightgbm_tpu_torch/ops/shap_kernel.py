"""TreeSHAP on the card: the wrapper of ``csrc/tree_shap.cu``'s
``tree_shap``, its launch count and the forest layout it reads.

:func:`pack_shap_forest` lays a forest's trees out once a call, in f64
where the host walk is f64 (not the serving forest's 16-byte records,
which carry bins): each tree's internal nodes (split feature, threshold,
decision type, children, data count), leaves (value, data count) and
categorical bitsets concatenated, a metadata row a tree (its offsets,
leaves and class) and its expected value, computed on the host
(``models.shap.expected_value``).  :func:`tree_shap` launches the kernel
over chunks of :func:`chunk_rows` rows, whose path scratch (sized from
the forest's deepest tree) stays within :data:`SCRATCH_BYTES`.  CPU
tensors take the plain version (``models.shap.tree_shap_ref``); CUDA
tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List

import numpy as np
import torch

from ..models.shap import expected_value, tree_depth, tree_shap_ref
from ..utils.device import resolve_device
from ..utils.log import LightGBMError
from . import _build

# threads a block (the library's tree_shap_threads)
THREADS = 128
# the path scratch of one launch stays within this
SCRATCH_BYTES = 512 << 20


def path_elements(max_depth: int) -> int:
    """Path elements a row: a segment of ``d + 1`` for each depth ``d``
    of the deepest tree (LightGBM's ``(D + 1)(D + 2) / 2``)."""
    return (max_depth + 1) * (max_depth + 2) // 2


def row_bytes(max_depth: int, nf: int) -> int:
    """Scratch bytes a row (the library's ``tree_shap_row_bytes``): 28 a
    path element (three f64 and an i32), 32 a stack frame (``D + 2``
    frames: two f64 and four i32) and the tree's phi (``nf + 1`` f64)."""
    return (path_elements(max_depth) * 28 + (max_depth + 2) * 32
            + (nf + 1) * 8)


def chunk_rows(max_depth: int, nf: int, n: int) -> int:
    """Rows a launch: all ``n`` where their scratch fits
    :data:`SCRATCH_BYTES`, else the most that fit, in whole blocks."""
    fit = SCRATCH_BYTES // row_bytes(max_depth, nf)
    if fit >= n:
        return max(n, 1)
    return max(THREADS, fit // THREADS * THREADS)


@dataclasses.dataclass
class ShapForest:
    """A forest as the kernel reads it, on ``device``; ``trees`` keeps
    the host trees (the plain version's input)."""
    trees: List
    k: int
    nf: int
    iters: int
    average: bool
    ev: np.ndarray
    max_depth: int
    max_feature: int
    device: torch.device
    split_feature: torch.Tensor = None
    threshold: torch.Tensor = None
    decision_type: torch.Tensor = None
    left: torch.Tensor = None
    right: torch.Tensor = None
    internal_count: torch.Tensor = None
    leaf_value: torch.Tensor = None
    leaf_count: torch.Tensor = None
    cat_boundaries: torch.Tensor = None
    cat_threshold: torch.Tensor = None
    meta: torch.Tensor = None
    ev_t: torch.Tensor = None


def pack_shap_forest(trees, k: int, nf: int, iters: int, average: bool,
                     device) -> ShapForest:
    """The trees (iteration-major, ``k`` a iteration) laid out for the
    kernel on ``device`` (uploaded once; nothing on a CPU device)."""
    device = resolve_device(device)
    ev = np.array([expected_value(t) for t in trees], np.float64)
    max_depth = max([tree_depth(t) for t in trees], default=0)
    split = [t for t in trees if t.num_leaves > 1]
    max_feature = max([int(t.split_feature.max()) for t in split],
                      default=-1)
    sf = ShapForest(trees=list(trees), k=k, nf=nf, iters=iters,
                    average=average, ev=ev, max_depth=max_depth,
                    max_feature=max_feature, device=device)
    if device.type != "cuda":
        return sf
    meta = np.zeros((len(trees), 6), np.int32)
    offs = np.zeros(4, np.int64)
    cols = {name: [] for name in ("split_feature", "threshold",
                                  "decision_type", "left", "right",
                                  "internal_count", "leaf_value",
                                  "leaf_count", "cat_boundaries",
                                  "cat_threshold")}
    for j, t in enumerate(trees):
        ni = max(t.num_leaves - 1, 0)
        meta[j] = (*offs, t.num_leaves, j % k)
        cols["split_feature"].append(np.asarray(t.split_feature[:ni],
                                                np.int32))
        cols["threshold"].append(np.asarray(t.threshold[:ni], np.float64))
        cols["decision_type"].append(np.asarray(t.decision_type[:ni],
                                                np.int32))
        cols["left"].append(np.asarray(t.left_child[:ni], np.int32))
        cols["right"].append(np.asarray(t.right_child[:ni], np.int32))
        cols["internal_count"].append(np.asarray(t.internal_count[:ni],
                                                 np.float64))
        cols["leaf_value"].append(np.asarray(t.leaf_value, np.float64))
        cols["leaf_count"].append(np.asarray(t.leaf_count, np.float64))
        cb = np.asarray(t.cat_boundaries, np.int32)
        ct = np.asarray(t.cat_threshold, np.uint32).view(np.int32)
        cols["cat_boundaries"].append(cb)
        cols["cat_threshold"].append(ct)
        offs += (ni, t.num_leaves, len(cb), len(ct))
    for name, parts in cols.items():
        arr = np.concatenate(parts) if parts else np.zeros(0)
        dtype = (np.float64 if name in ("threshold", "internal_count",
                                        "leaf_value", "leaf_count")
                 else np.int32)
        # a zero-length array still gets one element: the kernel's
        # pointers are never null
        arr = np.asarray(arr, dtype)
        if arr.size == 0:
            arr = np.zeros(1, dtype)
        setattr(sf, name, torch.as_tensor(arr, device=device))
    sf.meta = torch.as_tensor(meta if len(trees) else np.zeros((1, 6),
                                                               np.int32),
                              device=device)
    sf.ev_t = torch.as_tensor(ev if len(ev) else np.zeros(1), device=device)
    return sf


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("tree_shap")
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.tree_shap.argtypes = ([p, i, i] + [p] * 12 + [i, i, i, p, i, i, p,
                                                       d, i, p])
    lib.tree_shap.restype = i
    lib.tree_shap_row_bytes.argtypes = [i, i]
    lib.tree_shap_row_bytes.restype = ctypes.c_longlong
    lib.tree_shap_threads.argtypes = []
    lib.tree_shap_threads.restype = i
    return lib


def tree_shap(sf: ShapForest, x: torch.Tensor) -> torch.Tensor:
    """``[n, k (nf + 1)]`` f64: the contributions of the rows ``x`` (f64
    ``[n, F]``, ``F`` above every split feature) on ``sf``'s device.  CPU
    tensors take :func:`models.shap.tree_shap_ref` (a forest packed on
    the card refuses them); CUDA tensors launch ``tree_shap`` on the
    current stream, once for each chunk of :func:`chunk_rows` rows,
    allocating the scratch and the output."""
    dev = x.device
    if dev.type == "cpu":
        if sf.device.type != "cpu":
            raise LightGBMError(f"tree_shap: rows on the CPU, the forest "
                                f"on {sf.device}")
        return tree_shap_ref(sf.trees, sf.k, sf.nf, sf.ev, x, sf.iters,
                             sf.average)
    if dev.type != "cuda":
        raise LightGBMError(f"tree_shap runs on cuda or cpu, not {dev}")
    if (x.dtype != torch.float64 or x.dim() != 2 or not x.is_contiguous()
            or sf.device != dev or sf.meta is None):
        raise LightGBMError("tree_shap wants contiguous f64 rows [n, F] on "
                            "the device its forest was packed on")
    n, f = x.shape
    if f <= sf.max_feature:
        raise LightGBMError(f"tree_shap: the rows have {f} features, the "
                            f"trees split on feature {sf.max_feature}")
    width = sf.k * (sf.nf + 1)
    out = torch.empty((n, width), dtype=torch.float64, device=dev)
    if n == 0:
        return out
    rows = chunk_rows(sf.max_depth, sf.nf, n)
    scratch = torch.empty(rows * row_bytes(sf.max_depth, sf.nf),
                          dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    with torch.cuda.device(dev):
        for r0 in range(0, n, rows):
            m = min(rows, n - r0)
            rc = lib.tree_shap(
                x[r0].data_ptr(), m, f, sf.split_feature.data_ptr(),
                sf.threshold.data_ptr(), sf.decision_type.data_ptr(),
                sf.left.data_ptr(), sf.right.data_ptr(),
                sf.internal_count.data_ptr(), sf.leaf_value.data_ptr(),
                sf.leaf_count.data_ptr(), sf.cat_boundaries.data_ptr(),
                sf.cat_threshold.data_ptr(), sf.meta.data_ptr(),
                sf.ev_t.data_ptr(), len(sf.trees), sf.k, sf.nf,
                scratch.data_ptr(), rows, sf.max_depth, out[r0].data_ptr(),
                float(max(sf.iters, 1)), int(sf.average), stream)
            if rc != 0:
                raise LightGBMError(f"tree_shap kernel launch failed with "
                                    f"CUDA error {rc}")
            tree_shap.launches += 1
    return out


tree_shap.launches = 0
