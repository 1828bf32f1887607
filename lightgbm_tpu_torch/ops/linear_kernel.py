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

The wrapper sorts the rows by leaf (a stable sort of ``leaf_id``), finds
each leaf's segment and first chunk on the device and sizes the scratch
from the shapes alone, with no host read (so a call can be captured in a
CUDA graph).  The kernel zeroes the output and takes, for each pass of
entries and each batch of chunks, the chunk sums into scratch
(``chunk_sums_warp``, a warp a chunk, where the entries number at most
512; else ``chunk_sums``, a block a chunk staged once for its warps'
tiles) and ``chunk_chain`` (each leaf's chunk sums added onto the
output in chunk order); :func:`linear_moments_model` replays them on the
CPU.  CPU tensors take :func:`linear_moments_ref`;
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..utils.log import LightGBMError
from . import _build

# rows a chunk: the kernel's unit of work and of the fixed order
CHUNK = 64
# most path features a leaf's model may take: chunk_sums' stage of one row
# stays within its budget
MAX_FEATURES = 800
# chunk_sums (E > 512): warps (tiles) a block and its stage budget, a
# pass at most WARPS tiles of 32 MAX_SLOTS entries; chunk_sums_warp (E <=
# 512): warps a block, rows a stage; chunk_chain: threads a block, chunks
# a round
WARPS = 8
BLOCK_BUDGET = 100 * 1024
MAX_SLOTS = 16
WARPS_W = 4
WARP_ROWS = 16
CHAIN_THREADS = 256
ROUND = 256
# the scratch of chunk sums [batch, pass] f64 (with the rows' g, h, w kept
# by position where the entries take more than one pass) stays within this
SCRATCH_BYTES = 64_000_000


def moment_layout(kmax: int) -> Tuple[int, int]:
    """``(P, E)``: the upper-triangle entries of ``XᵀHX`` over ``k1 =
    kmax + 1`` dimensions and the row width ``E = P + k1 + 1`` of the
    moments (``XᵀHX`` row by row with ``i <= j``, then ``XᵀG``, then the
    count)."""
    k1 = int(kmax) + 1
    p = k1 * (k1 + 1) // 2
    return p, p + k1 + 1


def _align8(x: int) -> int:
    return -(-x // 8) * 8


def stage_bytes(kw: int, rows: int, groups: int) -> int:
    """Shared memory of a ``chunk_sums`` block staging ``rows`` rows
    (``groups`` chunks) of ``kw`` columns: two buffers of f32 values, g,
    h, w, row ids, NaN flags and the chunks' places, then the f64 values
    and the f64 row factors."""
    return (_align8(8 * rows * kw + 40 * rows + 24 * groups)
            + 8 * rows * kw + 24 * rows)


def lane_slots(e: int) -> int:
    """Entries a lane (NS) of ``chunk_sums_warp``: the least of 3, 4, 8,
    16 whose 32 NS cover ``e``; :data:`MAX_SLOTS` above."""
    return next((k for k in (3, 4, 8) if 32 * k >= e), MAX_SLOTS)


def pass_entries(kmax: int) -> int:
    """Entries a pass (the library's ``linear_moments_pass_entries``):
    every entry up to :data:`WARPS` tiles of ``32 MAX_SLOTS``, else that
    many."""
    return min(moment_layout(kmax)[1], WARPS * 32 * MAX_SLOTS)


def warp_bytes(k1: int, rows: int) -> int:
    """Shared memory of one ``chunk_sums_warp`` warp at ``rows`` rows of
    ``k1`` columns: two f32 value stages, two g, h, w stages, two stages'
    row ids and NaN flags, the f64 values and the f64 row factors."""
    return _align8(8 * rows * k1 + 40 * rows) + 8 * rows * k1 + 24 * rows


def step_units(tiles: int) -> Tuple[int, int]:
    """``(G, TW)``: chunks and tiles a ``chunk_sums`` step (a unit, one a
    warp, is a chunk and a tile): ``WARPS // tiles`` chunks of every tile
    where a chunk has fewer tiles than warps, else one chunk and
    :data:`WARPS` tiles."""
    if tiles < WARPS:
        return WARPS // tiles, tiles
    return 1, WARPS


def stage_rows(kw: int, groups: int, chunk: int = CHUNK) -> int:
    """Rows of a chunk a ``chunk_sums`` stage of ``kw`` columns and
    ``groups`` chunks: the most, a power of two up to 64 and ``chunk``,
    whose stage fits :data:`BLOCK_BUDGET`."""
    rows = 64
    while rows > chunk:
        rows //= 2
    while rows > 1 and stage_bytes(kw, groups * rows, groups) > BLOCK_BUDGET:
        rows //= 2
    return rows


def smem_bytes(kmax: int, chunk: int = CHUNK) -> int:
    """Shared memory of a block of the kernel that sums the chunks (the
    library's ``linear_moments_smem_bytes``): ``chunk_sums_warp``'s warps
    where ``E <= 32 MAX_SLOTS``, else ``chunk_sums`` in its first pass,
    which stages every column (the most any pass takes)."""
    k1 = int(kmax) + 1
    e = moment_layout(kmax)[1]
    if e <= 32 * MAX_SLOTS:
        return WARPS_W * warp_bytes(k1, min(WARP_ROWS, chunk))
    groups, _ = step_units(-(-pass_entries(kmax) // (32 * MAX_SLOTS)))
    return stage_bytes(k1, groups * stage_rows(k1, groups, chunk), groups)


def chain_smem_bytes() -> int:
    """Shared memory of one ``chunk_chain`` block (the library's
    ``linear_moments_chain_smem_bytes``): a round of 32 entries' sums."""
    return ROUND * 32 * 8


def scratch_chunks(n: int, num_leaves: int, chunk: int = CHUNK) -> int:
    """Rows of the scratch: a bound on the chunks of ``n`` rows in
    ``num_leaves`` leaves (each leaf's last chunk may be short), from the
    shapes alone."""
    return -(-n // chunk) + num_leaves


def chunk_batch(kmax: int, cmax: int, n: int) -> int:
    """Chunks a batch: every chunk where the scratch ``[cmax, pass]`` f64
    stays within :data:`SCRATCH_BYTES`, else the most whose scratch
    stays within it beside the rows' g, h and w kept by position (f32
    ``[3, n]``) for the passes after the first."""
    e = moment_layout(kmax)[1]
    ep = pass_entries(kmax)
    if ep == e and cmax * ep * 8 <= SCRATCH_BYTES:
        return cmax
    room = SCRATCH_BYTES - (12 * n if ep < e else 0)
    return max(1, min(cmax, room // (ep * 8)))


def first_column(e0: int, e1: int, kmax: int) -> int:
    """The first design column an entry of ``[e0, e1)`` reads (the
    library's tile geometry: a tile stages columns ``[first, k1)``): the
    triangle row of ``e0`` (rows rise with the entry), the first ``XᵀG``
    entry's column, or the intercept's."""
    k1 = int(kmax) + 1
    p = k1 * (k1 + 1) // 2
    lo = kmax
    if e0 < p:
        rem, i = e0, 0
        while rem >= k1 - i:
            rem -= k1 - i
            i += 1
        lo = i
    if e1 > p:
        lo = min(lo, max(e0, p) - p)
    return lo


def leaf_segments(leaf_id: torch.Tensor, num_leaves: int):
    """``(order, seg)``: the rows sorted by leaf, stably (i32 ``[n]``),
    and each leaf's ``(start, count)`` in that order (i32 ``[L, 2]``),
    on ``leaf_id``'s device, with no host read."""
    key, order = torch.sort(leaf_id, stable=True)
    bounds = torch.searchsorted(
        key, torch.arange(num_leaves + 1, dtype=key.dtype,
                          device=key.device))
    seg = torch.stack([bounds[:-1], bounds[1:] - bounds[:-1]], dim=1)
    return order.to(torch.int32), seg.to(torch.int32).contiguous()


def chunk_starts(seg: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """i32 ``[L + 1]``: each leaf's first chunk, the chunks of all leaves
    numbered in leaf order, and the number of chunks last."""
    nchunk = (seg[:, 1].long() + chunk - 1) // chunk
    return torch.cat([torch.zeros(1, dtype=torch.long, device=seg.device),
                      torch.cumsum(nchunk, 0)]).to(torch.int32)


def entry_columns(kmax: int) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """``(factor, i, j)`` i64 ``[E]`` of each entry as the kernel forms it,
    ``(fac * xa_i) * xa_j``: a pair of ``XᵀHX`` takes ``wf * h`` (0) and
    its two columns, an ``XᵀG`` entry ``wf * g`` (1), its column and the
    intercept's (a product by 1), the count ``wf`` (2) and the
    intercept's twice."""
    k1 = int(kmax) + 1
    iu, ju = torch.triu_indices(k1, k1)
    ar = torch.arange(k1)
    one = torch.full((1,), kmax, dtype=torch.long)
    fac = torch.cat([torch.zeros(len(iu), dtype=torch.long),
                     torch.ones(k1, dtype=torch.long),
                     torch.full((1,), 2, dtype=torch.long)])
    return (fac, torch.cat([iu, ar, one]),
            torch.cat([ju, torch.full((k1,), kmax, dtype=torch.long), one]))


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


def linear_moments_model(raw: torch.Tensor, leaf_id: torch.Tensor,
                         g: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                         feat_idx: torch.Tensor,
                         chunk: int = CHUNK) -> torch.Tensor:
    """The kernel's two passes replayed on the CPU, in its order of f64
    operations: ``out`` zeroed; for each pass of :func:`pass_entries`
    entries (staging the columns from :func:`first_column` on: a column
    below it would fail the index) and each batch of :func:`chunk_batch`
    chunks, ``chunk_sums`` sums every entry of each chunk of the batch
    row by row from +0 as ``(fac * xa_i) * xa_j`` (:func:`entry_columns`;
    a step's chunks and tiles, dealt to the warps, each staged
    :func:`stage_rows` rows at a time, keep each chunk's rows in order)
    into the scratch, and ``chunk_chain`` adds each leaf's chunk sums of
    the batch onto ``out`` in chunk order.  Its bits are
    :func:`linear_moments_ref`'s."""
    dev = raw.device
    f64 = torch.float64
    L, kmax = feat_idx.shape
    _, e = moment_layout(kmax)
    n = raw.shape[0]
    order, seg = leaf_segments(leaf_id, L)
    cfirst = chunk_starts(seg, chunk).long()
    total = int(cfirst[-1])
    cmax = scratch_chunks(n, L, chunk)
    ep = pass_entries(kmax)
    cb = chunk_batch(kmax, cmax, n)
    fac, col_i, col_j = (t.to(dev) for t in entry_columns(kmax))
    c_all = torch.arange(total, device=dev)
    leaf_of = torch.searchsorted(cfirst, c_all, right=True) - 1
    c_in = c_all - cfirst[leaf_of]
    c_lo = seg[leaf_of, 0].long() + c_in * chunk
    c_len = torch.clamp(seg[leaf_of, 1].long() - c_in * chunk, max=chunk)
    out = torch.zeros((L, e), dtype=f64, device=dev)
    for e0 in range(0, e, ep):
        tile = slice(e0, min(e0 + ep, e))
        klo = first_column(e0, tile.stop, kmax)
        ci, cj = col_i[tile] - klo, col_j[tile] - klo
        for c0 in range(0, total, cb):                 # a batch
            batch = torch.arange(c0, min(c0 + cb, total), device=dev)
            scratch = torch.zeros((len(batch), tile.stop - e0), dtype=f64,
                                  device=dev)
            for r in range(chunk):                     # rows in order
                live = torch.nonzero(c_len[batch] > r).flatten()
                if live.numel() == 0:
                    break
                rid = order[c_lo[batch[live]] + r].long()
                x, nan = design_rows(raw, rid,
                                     feat_idx[leaf_of[batch[live]]])
                xa = torch.cat([x.to(f64), torch.ones((len(rid), 1),
                                                      dtype=f64, device=dev)],
                               dim=1)
                wf = torch.where(nan, torch.zeros((), dtype=f64, device=dev),
                                 w[rid].to(f64))
                fr = torch.stack([wf * h[rid].to(f64), wf * g[rid].to(f64),
                                  wf], dim=1)
                cols = xa[:, klo:]
                val = ((fr[:, fac[tile]] * cols.index_select(1, ci))
                       * cols.index_select(1, cj))
                scratch[live] = scratch[live] + val
            # chunk_chain: each leaf's chunks of the batch onto out, in order
            lb = leaf_of[batch]
            for k in range(len(batch)):
                out[lb[k], tile] = out[lb[k], tile] + scratch[k]
    return out


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("linear_fit")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.linear_moments.argtypes = ([p, i] + [p] * 7 + [i] * 5
                                   + [p, i, p, p, p])
    lib.linear_moments.restype = i
    lib.linear_moments_smem_bytes.argtypes = [i, i]
    lib.linear_moments_smem_bytes.restype = i
    lib.linear_moments_pass_entries.argtypes = [i]
    lib.linear_moments_pass_entries.restype = i
    lib.linear_moments_chain_smem_bytes.argtypes = []
    lib.linear_moments_chain_smem_bytes.restype = i
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
    the segments, the chunk starts, the scratch (at most
    :data:`SCRATCH_BYTES` with the rows' g, h, w kept for the later
    passes) and the output."""
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
    cfirst = chunk_starts(seg)
    _, e = moment_layout(kmax)
    cmax = scratch_chunks(n, L)
    ep = pass_entries(kmax)
    cb = chunk_batch(kmax, cmax, n)
    scratch = torch.empty((cb, ep), dtype=torch.float64, device=dev)
    # the rows' g, h and w by position, for the passes after the first
    ghw = (torch.empty((3, n), dtype=torch.float32, device=dev) if ep < e
           else None)
    out = torch.empty((L, e), dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().linear_moments(
            raw.data_ptr(), f, order.data_ptr(), seg.data_ptr(),
            cfirst.data_ptr(), g.data_ptr(), h.data_ptr(), w.data_ptr(),
            feat_idx.data_ptr(), L, kmax, CHUNK, n, cmax, scratch.data_ptr(),
            cb, None if ghw is None else ghw.data_ptr(), out.data_ptr(),
            stream)
    if rc != 0:
        raise LightGBMError(f"linear_moments kernel launch failed with CUDA "
                            f"error {rc}")
    linear_moments.launches += 1
    return out


linear_moments.launches = 0
