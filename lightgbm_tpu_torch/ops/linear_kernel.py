"""The linear-leaf fit's moments: the wrapper of ``csrc/linear_fit.cu``'s
``linear_moments``, its launch count and its plain version.

For every leaf ``l`` of a grown tree, over its rows with weight ``wf``
(the in-bag weight, 0 where a path feature of the leaf is NaN) and
design vector ``xa = (x_1 .. x_kmax, 1)`` (the raw values of the leaf's
path features ``feat_idx[l]``, 0 where padded or NaN): the upper
triangle of ``XᵀHX`` (``((wf * h) * xa_i) * xa_j``), ``XᵀG`` (``(wf *
g) * xa_i``) and the weighted count (``wf``), all in f64, as ``[L, E]``
(:func:`moment_layout`).  The JAX package accumulates the same moments
in f32 with an XLA einsum (``lightgbm_tpu/models/linear.py:101-114``);
the port's order is fixed, so the card's moments equal the CPU's bit for
bit: each leaf's rows (ascending) are cut into chunks of :data:`CHUNK`
from the leaf's first row, every chunk summed in row order from +0 and
the chunks added in chunk order from +0.

The wrapper sorts the rows by leaf (a stable sort of ``leaf_id``) and
finds each leaf's segment on the device, with no host read.  CPU tensors
take :func:`linear_moments_ref`; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..utils.log import LightGBMError
from . import _build

# rows a chunk: the kernel's unit of staging and of the fixed order
CHUNK = 64
# most path features a leaf's model may take: the kernel's shared stage at
# CHUNK rows stays within one block's 227 KB
MAX_FEATURES = 800
THREADS = 256


def moment_layout(kmax: int) -> Tuple[int, int]:
    """``(P, E)``: the upper-triangle entries of ``XᵀHX`` over ``k1 =
    kmax + 1`` dimensions and the row width ``E = P + k1 + 1`` of the
    moments (``XᵀHX`` row by row with ``i <= j``, then ``XᵀG``, then the
    count)."""
    k1 = int(kmax) + 1
    p = k1 * (k1 + 1) // 2
    return p, p + k1 + 1


def smem_bytes(kmax: int, chunk: int = CHUNK) -> int:
    """Shared memory of one block (the library's
    ``linear_moments_smem_bytes``): the leaf's path features, the chunk's
    staged values (f32 ``[chunk, k1]``) and its f64 row factors."""
    k1 = int(kmax) + 1
    return (-(-kmax * 4 // 8) * 8 + -(-chunk * k1 * 4 // 8) * 8
            + chunk * 3 * 8)


def leaf_segments(leaf_id: torch.Tensor, num_leaves: int):
    """``(order, seg)``: the rows sorted by leaf, stably (i32 ``[n]``),
    and each leaf's ``(start, count)`` in that order (i32 ``[L, 2]``),
    on ``leaf_id``'s device."""
    order = torch.argsort(leaf_id, stable=True).to(torch.int32)
    cnt = torch.bincount(leaf_id.long(), minlength=num_leaves)[:num_leaves]
    start = torch.cumsum(cnt, 0) - cnt
    seg = torch.stack([start, cnt], dim=1).to(torch.int32).contiguous()
    return order, seg


def design_rows(raw: torch.Tensor, rows: torch.Tensor,
                fi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x, nan_row)`` of ``rows`` whose path features are ``fi`` ([m,
    kmax], -1 padded): the raw values, 0 where padded or NaN (f32 [m,
    kmax]), and whether a path feature is NaN ([m] bool)."""
    valid = fi >= 0
    x = raw[rows.long()[:, None], fi.clamp(min=0).long()]
    nan = torch.isnan(x) & valid
    x = torch.where(valid & ~nan, x, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))
    return x, nan.any(dim=1)


def linear_moments_ref(raw: torch.Tensor, leaf_id: torch.Tensor,
                       g: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                       feat_idx: torch.Tensor,
                       chunk: int = CHUNK) -> torch.Tensor:
    """Plain version, in the kernel's order of f64 operations: each
    chunk's entries summed over its rows one position at a time (every
    chunk at once), then each leaf's chunks added one chunk at a time.
    On the CPU it gives the kernel's bits."""
    dev = raw.device
    L, kmax = feat_idx.shape
    p, e = moment_layout(kmax)
    k1 = kmax + 1
    order, seg = leaf_segments(leaf_id, L)
    start, cnt = seg[:, 0].long(), seg[:, 1].long()
    nchunk = (cnt + chunk - 1) // chunk                        # [L]
    first = torch.cumsum(nchunk, 0) - nchunk                   # [L]
    total = int(nchunk.sum())
    f64 = torch.float64
    sums = torch.zeros((max(total, 1), e), dtype=f64, device=dev)
    iu, ju = torch.triu_indices(k1, k1, device=dev)
    if total:
        # chunk c of leaf l: its rows' positions and its length
        leaf_of = torch.repeat_interleave(torch.arange(L, device=dev),
                                          nchunk, output_size=total)
        c_in = torch.arange(total, device=dev) - first[leaf_of]
        c_lo = start[leaf_of] + c_in * chunk
        c_len = torch.minimum(cnt[leaf_of] - c_in * chunk,
                              torch.full_like(c_in, chunk))
        for r in range(chunk):
            live = torch.nonzero(c_len > r).flatten()
            if live.numel() == 0:
                break
            rows = order[c_lo[live] + r].long()
            x, nan = design_rows(raw, rows, feat_idx[leaf_of[live]])
            xa = torch.cat([x.to(f64), torch.ones((len(rows), 1), dtype=f64,
                                                  device=dev)], dim=1)
            wf = torch.where(nan, torch.zeros((), dtype=f64, device=dev),
                             w[rows].to(f64))
            a = wf * h[rows].to(f64)
            b = wf * g[rows].to(f64)
            val = torch.cat([(a[:, None] * xa[:, iu]) * xa[:, ju],
                             b[:, None] * xa, wf[:, None]], dim=1)
            sums[live] = sums[live] + val
    out = torch.zeros((L, e), dtype=f64, device=dev)
    for j in range(int(nchunk.max()) if L else 0):
        has = torch.nonzero(nchunk > j).flatten()
        out[has] = out[has] + sums[first[has] + j]
    return out


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("linear_fit")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.linear_moments.argtypes = [p, i] + [p] * 6 + [i] * 3 + [p, p]
    lib.linear_moments.restype = i
    lib.linear_moments_smem_bytes.argtypes = [i, i]
    lib.linear_moments_smem_bytes.restype = i
    return lib


def linear_moments(raw: torch.Tensor, leaf_id: torch.Tensor,
                   g: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                   feat_idx: torch.Tensor) -> torch.Tensor:
    """The moments ``[L, E]`` f64 of each leaf's linear model
    (:func:`moment_layout`).  ``raw`` f32 ``[n, F]``, ``leaf_id`` ``[n]``
    (every entry in ``[0, L)``), ``g``, ``h``, ``w`` f32 ``[n]``,
    ``feat_idx`` i32 ``[L, kmax]`` (-1 padded), all on one device.  CPU
    tensors take :func:`linear_moments_ref`; CUDA tensors launch
    ``linear_moments`` on the current stream, allocating the row order,
    the segments and the output."""
    dev = raw.device
    if dev.type == "cpu":
        return linear_moments_ref(raw, leaf_id, g, h, w, feat_idx)
    if dev.type != "cuda":
        raise LightGBMError(f"linear_moments runs on cuda or cpu, not {dev}")
    n, f = raw.shape
    L, kmax = feat_idx.shape
    if (raw.dtype != torch.float32 or not raw.is_contiguous()
            or any(t.device != dev or t.dtype != torch.float32
                   or tuple(t.shape) != (n,) or not t.is_contiguous()
                   for t in (g, h, w))
            or leaf_id.device != dev or tuple(leaf_id.shape) != (n,)
            or feat_idx.device != dev or feat_idx.dtype != torch.int32
            or not feat_idx.is_contiguous()):
        raise LightGBMError("linear_moments wants contiguous f32 raw [n, F] "
                            "and g, h, w [n], leaf_id [n] and i32 feat_idx "
                            "[L, kmax] on one device")
    if not 0 < kmax <= MAX_FEATURES:
        raise LightGBMError(f"linear_moments takes 1 to {MAX_FEATURES} path "
                            f"features a leaf, not {kmax}")
    order, seg = leaf_segments(leaf_id, L)
    _, e = moment_layout(kmax)
    out = torch.empty((L, e), dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().linear_moments(
            raw.data_ptr(), f, order.data_ptr(), seg.data_ptr(),
            g.data_ptr(), h.data_ptr(), w.data_ptr(), feat_idx.data_ptr(), L,
            kmax, CHUNK, out.data_ptr(), stream)
    if rc != 0:
        raise LightGBMError(f"linear_moments kernel launch failed with CUDA "
                            f"error {rc}")
    linear_moments.launches += 1
    return out


linear_moments.launches = 0
