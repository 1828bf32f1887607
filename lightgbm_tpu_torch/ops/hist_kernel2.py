"""The histogram kernels' wrappers, launch counts and plain versions:
the comb-direct histogram (``csrc/hist_comb.cu``) of the physical path
and the row-indexed histogram (``csrc/hist_rows.cu``) of the row-order
path.

**Comb-direct.** Counterpart of ``build_histogram_comb`` /
``build_histogram_comb_dyn`` in
``lightgbm_tpu/ops/pallas/hist_kernel2.py``: the (sum g*w, sum h*w)
histogram ``[F, B, 2]`` f32 of row-matrix rows
``[start + off, start + off + count)``.  ``rng`` is an i32 ``[3]``
tensor ``(start, off, count)`` on the rows' device, so a range the
device computed (the smaller child of a split) needs no host read; the
caller passes ``max_rows``, an upper bound on ``count`` that sets the
slices the bits are summed in (:func:`hist_blocks`).  Rows outside the
range, or outside the matrix, contribute nothing.  Accumulation is f32
throughout, in a fixed order: the kernel's output is bitwise identical
across launches on the same input, and the plain version adds in the
same order.  :func:`comb_geometry` picks one of two kernels: up to
``COMB_RANGE_SLICES`` slices one launch in which a warp owns a 32-bin
range of one feature and walks every slice (range mode: the smaller
children, most launches), above it per-slice partials over feature
chunks of :func:`comb_chunk` features (one feature a warp, unless the
slices are many enough to fill the card with larger chunks) and a
reduction (feature mode: the larger children and the roots); the bits
are the same either way.

:func:`build_histogram_comb_p2` is the same histogram at pack=2
(``_hist2_comb2_kernel``) over the records of
:class:`~.device_data.PackedRows`: its plain version is
:func:`build_histogram_comb_ref` over :meth:`PackedRows.fields`, and
the kernel's bits are the pack=1 kernel's.

**Row-indexed.** Counterpart of ``build_histogram_pallas2`` in the same
file and of ``build_histogram_pallas`` in
``lightgbm_tpu/ops/pallas/hist_kernel.py`` (one function, one kernel):
the histogram ``[F, B, 2]`` f32 of separate bins ``[n, F]`` (u8, or u16
at ``max_bin > 255``) and values ``[n, 2]``, over the positions
``[start, start + count)`` of an optional row index (without one the
positions are the rows).  The TPU kernels round the values to bf16
inside their one-hot matmul (v2) as an MXU operand choice; the port adds
the exact f32 values, in the comb-direct histogram's fixed order, so
trees grown on the card and on the CPU stay bit-identical.  Where
``max_rows`` gives one or two slices (up to 32,768 rows at B = 1024)
one launch writes the histogram, a warp owning a 32-bin range of one
feature (:func:`rows_geometry`); larger ranges take per-slice partials
and a reduction in slice order, with the same bits either way.

**The gpu_use_dp mode** (:func:`build_histogram_rows_dp`; the JAX
package's histogram under ``gpu_use_dp`` and x64 is the XLA scatter-add
of ``lightgbm_tpu/ops/histogram.py:178-190``, no Pallas kernel) is the
same kernel with an f64 accumulator: each slice's cells summed in f64 in
position order, the slices' sums added in slice order in f64, rounded to
f32 once.  Its output is the same ``[F, B, 2]`` f32, and its geometry
takes the accumulator's bytes (``acc_bytes`` 8).

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from ..utils.log import LightGBMError
from . import _build
from .device_data import PackedRows, Rows, bins_i32, check_packed
from .histogram import build_histogram

# shared memory a block may use on the H100 (232,448 bytes)
MAX_SMEM = 232448
# rows per first-pass block aimed at, and the most blocks one launch uses
ROWS_PER_BLOCK = 4096
MAX_BLOCKS = 2 * 132
# rows a histogram block stages per step (csrc/hist_block.cuh kChunk)
HIST_CHUNK = 256
# shared memory of one SM on the H100 (233,472 bytes), of which the
# system reserves 1 KB for each resident block
SM_SMEM = 233472
BLOCK_RESERVED_SMEM = 1024
# comb-direct blocks sized to share an SM: fewer, larger feature chunks
# left its warps idle (chip_smoke.py's hist_comb chunk sweep, PERF.md)
COMB_BLOCKS_PER_SM = 5


def comb_smem_bytes(f: int, padded_bins: int, bin_bytes: int = 1) -> int:
    """Shared memory of one block of ``histblock::smem_bytes``'s layout
    (the stream refresh's histogram, and the figure
    :func:`comb_feature_chunk` sizes chunks by): the ``[F, B, 2]`` f32
    histogram, then per staged row (g*w, h*w) and the bins."""
    return f * padded_bins * 8 + HIST_CHUNK * (8 + f * bin_bytes)


@functools.lru_cache(maxsize=None)
def comb_feature_chunk(f: int, padded_bins: int) -> int:
    """Features one comb-direct block histograms: the most whose
    blocks fit ``COMB_BLOCKS_PER_SM`` to an SM (18 at B = 256), balanced
    over the chunks, ``ceil(F / ceil(F / most))`` (F = 28: two chunks of
    14; F = 136: eight of 17).  ``F`` itself at or below the most: one
    chunk.  Raises where not one feature fits a block.  The rule was set
    on the first feature-chunked kernel; the feature-mode block of
    ``csrc/hist_comb.cu`` takes :func:`comb_feature_smem` (40,960
    bytes at 14 features, five an SM), and :func:`comb_chunk` keeps the
    rule where it fills the card below ``COMB_WIDE_FEATURES``."""
    budget = SM_SMEM // COMB_BLOCKS_PER_SM - BLOCK_RESERVED_SMEM
    most = max(1, (budget - HIST_CHUNK * 8)
               // (int(padded_bins) * 8 + HIST_CHUNK))
    if comb_smem_bytes(most, padded_bins) > MAX_SMEM:
        raise LightGBMError(f"a histogram of {padded_bins} bins per feature "
                            "does not fit one block's shared memory")
    chunks = -(-int(f) // most)
    return -(-int(f) // chunks)


def hist_blocks(max_rows: int) -> int:
    """First-pass grid size for a range of at most ``max_rows`` rows."""
    return max(1, min(MAX_BLOCKS, -(-int(max_rows) // ROWS_PER_BLOCK)))


def _window(rng, n: int):
    start, off, count = (int(v) for v in rng)
    lo = max(start + off, 0)
    hi = min(start + off + max(count, 0), n)
    return lo, max(hi, lo)


def block_ranges(lo: int, hi: int, nblocks: int):
    """The rows each first-pass block of the kernel sums (its
    ``block_range``): equal slices rounded up to 32 rows."""
    per = -(-(hi - lo) // nblocks)
    per = -(-per // 32) * 32
    return [(min(lo + per * b, hi), min(lo + per * (b + 1), hi))
            for b in range(nblocks)]


def build_histogram_comb_ref(rows: Rows, rng: torch.Tensor, *,
                             padded_bins: int, max_rows: int) -> torch.Tensor:
    """Plain version, in the kernel's order of f32 additions: each
    block's slice of the range is summed row by row into its own
    histogram (``index_add_``, sequential on the CPU), and the block
    histograms are added in block order.  On the CPU it therefore gives
    the kernel's bits."""
    lo, hi = _window(rng.tolist(), rows.bins.shape[0])
    f = rows.bins.shape[1]
    out = torch.zeros((f, padded_bins, 2), dtype=torch.float32,
                      device=rows.bins.device)
    for b_lo, b_hi in block_ranges(lo, hi, hist_blocks(max_rows)):
        if b_hi > b_lo:
            out = out + build_histogram(rows.bins[b_lo:b_hi],
                                        rows.vals[b_lo:b_hi, :2],
                                        padded_bins=padded_bins)
    return out


# comb-direct kernels (csrc/hist_comb.cu): the most features a block
# stages in feature mode (4 * kFeatureWords) and in range mode (4 *
# kRangeWords); rows a step stages in each (kThreads * kFeatureRows,
# kThreads * kRangeRows); bins a range-mode warp owns (histwalk::kRange)
COMB_MAX_CHUNK = 32
COMB_RANGE_FEATS = 8
COMB_STAGE_FEATURE = 256
COMB_STAGE_RANGE = 1024
COMB_RANGE_BINS = 32
COMB_WARPS = 8
# slices up to which a warp owns a 32-bin range of one feature and walks
# every slice in one launch (range mode); above, feature mode: range mode
# was the faster from 1 to 3 slices at 28 features, feature mode (one
# feature a warp) from 4; at 136 from 3 (tools/profile_hist_comb.py
# --variants on the H100, PERF.md)
COMB_RANGE_SLICES = 3
# feature mode holds one feature a warp (a block of 7 at 28 features, 8
# at 136) unless the chunks of comb_feature_chunk (14 at 28) already give
# COMB_FILL_BLOCKS blocks: the root (245 slices x 2) was the faster in
# 14-feature blocks, the largest child (97 x 2) and every count of 8
# slices or fewer in blocks of 7; from COMB_WIDE_FEATURES features one
# feature a warp was the faster at every size measured (136)
COMB_FILL_BLOCKS = 2 * 132
COMB_WIDE_FEATURES = 64


def _staged_bytes(nf: int) -> int:
    """Bytes of one staged row of ``nf`` u8 bins (whole 32-bit words)."""
    return 4 * -(-int(nf) // 4)


def comb_feature_smem(fc: int, padded_bins: int) -> int:
    """Shared memory of one feature-mode block of ``fc`` features (the
    library's ``hist_comb_smem_bytes(fc, B, 0)``): the ``[fc, B, 2]`` f32
    histogram, then two stages of ``COMB_STAGE_FEATURE`` rows' (g*w,
    h*w) and bins."""
    return (int(fc) * int(padded_bins) * 8
            + 2 * COMB_STAGE_FEATURE * (8 + _staged_bytes(fc)))


def comb_range_smem(nf: int) -> int:
    """Shared memory of one range-mode block staging ``nf`` features
    (``hist_comb_smem_bytes(nf, B, 1)``): two stages of
    ``COMB_STAGE_RANGE`` rows, and for each warp its 32 cells (f32
    pairs) and its list of a step's rows (u32)."""
    return (2 * COMB_STAGE_RANGE * (8 + _staged_bytes(nf))
            + COMB_WARPS * COMB_RANGE_BINS * 8
            + COMB_WARPS * COMB_STAGE_RANGE * 4)


class CombGeometry(NamedTuple):
    """One ``hist_comb`` call's launch geometry.

    ``slices`` = :func:`hist_blocks` of the caller's bound (the bits'
    cut).  Range mode (``ranged``, ``bin_parts`` = ``ceil(B / 32)`` > 1,
    up to ``COMB_RANGE_SLICES`` slices): one launch of ``grid[0]``
    blocks of ``COMB_WARPS`` warps, warp ``w`` of block ``x`` owning
    unit ``u = x * 8 + w`` below ``f * bin_parts``: feature ``u //
    bin_parts``, bins ``[(u % bin_parts) * 32, ... + 32)``, one cell a
    lane, for every slice; ``feats`` the most features a block stages.
    Feature mode: ``grid`` = (slices, feature chunks) blocks of
    ``feats`` features each into per-slice partials, then the reduction
    in a second launch.  The wrapper passes the geometry to the library
    as it is (``smem`` is the library's own figure, which the analyzer
    holds against it); the library only refuses one that misses a cell
    or that its kernels cannot stage."""
    slices: int
    ranged: bool
    grid: Tuple[int, int]
    feats: int
    bin_parts: int
    smem: int


def _balanced(f: int, most: int) -> int:
    """The chunk of at most ``most`` features that cuts ``f`` features
    into the fewest, most even chunks."""
    return -(-int(f) // -(-int(f) // int(most)))


def comb_chunk(f: int, padded_bins: int, slices: int) -> int:
    """Features a feature-mode block histograms at ``slices`` slices: one
    a warp (at most ``COMB_WARPS``, balanced over the chunks) where the
    chunks of :func:`comb_feature_chunk` (read at each call) give fewer
    than ``COMB_FILL_BLOCKS`` blocks or from ``COMB_WIDE_FEATURES``
    features on, else those chunks, rebalanced over more chunks where
    they pass the ``COMB_MAX_CHUNK`` features a block stages (only below
    B = 128)."""
    fc = comb_feature_chunk(f, padded_bins)
    if (f >= COMB_WIDE_FEATURES
            or slices * -(-int(f) // fc) < COMB_FILL_BLOCKS):
        return _balanced(f, min(fc, COMB_WARPS))
    return fc if fc <= COMB_MAX_CHUNK else _balanced(f, COMB_MAX_CHUNK)


def comb_geometry(f: int, padded_bins: int, max_rows: int) -> CombGeometry:
    """The geometry of a ``hist_comb`` call over ``f`` features of
    ``padded_bins`` bins and a range of at most ``max_rows`` rows: range
    mode up to ``COMB_RANGE_SLICES`` slices where a feature has more than
    one 32-bin range, else feature mode in chunks of :func:`comb_chunk`
    features (both read at each call).  No host read: a CUDA graph can
    capture the call."""
    slices = hist_blocks(max_rows)
    return mode_geometry(f, padded_bins, slices,
                         comb_chunk(f, padded_bins, slices),
                         COMB_RANGE_SLICES)


@functools.lru_cache(maxsize=None)
def mode_geometry(f: int, b: int, slices: int, fc: int,
                  range_slices: int) -> CombGeometry:
    """:func:`comb_geometry` of ``slices`` slices with chunks of ``fc``
    features and range mode up to ``range_slices`` slices."""
    f, b = int(f), int(b)
    parts = -(-b // COMB_RANGE_BINS)
    if parts > 1 and slices <= range_slices:
        nf = rows_direct_feats(f, b)
        return CombGeometry(slices, True, (-(-f * parts // COMB_WARPS), 1),
                            nf, parts, comb_range_smem(nf))
    smem = comb_feature_smem(fc, b)
    if smem > MAX_SMEM:
        raise LightGBMError(f"a histogram of {b} bins per feature does not "
                            "fit one block's shared memory")
    return CombGeometry(slices, False, (slices, -(-f // fc)), fc, 1, smem)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("hist_comb")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hist_comb.argtypes = [p] * 5 + [i] * 9 + [p]
    lib.hist_comb.restype = i
    lib.hist_comb_p2.argtypes = [p, i, i] + [p] * 3 + [i] * 9 + [p]
    lib.hist_comb_p2.restype = i
    lib.hist_comb_smem_bytes.argtypes = [i, i, i]
    lib.hist_comb_smem_bytes.restype = i
    return lib


def _check_rng(rng: torch.Tensor, dev) -> None:
    if (rng.device != dev or rng.dtype != torch.int32 or rng.numel() != 3
            or not rng.is_contiguous()):
        raise LightGBMError("rng must be a contiguous i32 [3] tensor "
                            "(start, off, count) on the rows' device")


def _comb_buffers(geo: CombGeometry, f: int, padded_bins: int, dev):
    """(partials, out) of one comb-direct call: the partials only in
    feature mode."""
    partials = None if geo.ranged else torch.empty(
        (geo.slices, f, padded_bins, 2), dtype=torch.float32, device=dev)
    out = torch.empty((f, padded_bins, 2), dtype=torch.float32, device=dev)
    return partials, out


def comb_args(geo: CombGeometry, partials, out, n: int, f: int,
              padded_bins: int) -> tuple:
    """The library's arguments after the rows and the range."""
    return (None if partials is None else partials.data_ptr(),
            out.data_ptr(), n, f, int(padded_bins), geo.slices,
            int(geo.ranged), geo.grid[0], geo.grid[1], geo.feats,
            geo.bin_parts)


def build_histogram_comb(rows: Rows, rng: torch.Tensor, *, padded_bins: int,
                         max_rows: int) -> torch.Tensor:
    """Histogram ``[F, padded_bins, 2]`` f32 of the rows ``rng`` selects
    (``count`` at most ``max_rows``).  CPU tensors take
    :func:`build_histogram_comb_ref`; CUDA tensors launch the kernel on
    the current stream in the geometry :func:`comb_geometry` picks (one
    launch in range mode), with no host read, allocating only the output
    (and the partials in feature mode), so a CUDA graph can capture
    it.  ``max_rows == 0`` (a segment empty on this rank) returns zeros
    and launches nothing."""
    dev = rows.bins.device
    if dev.type == "cpu":
        return build_histogram_comb_ref(rows, rng, padded_bins=padded_bins,
                                        max_rows=max_rows)
    if dev.type != "cuda":
        raise LightGBMError(f"histogram runs on cuda or cpu, not {dev}")
    n, f = rows.bins.shape
    if (rows.bins.dtype != torch.uint8 or rows.vals.dtype != torch.float32
            or tuple(rows.vals.shape) != (n, 3)
            or not rows.bins.is_contiguous()
            or not rows.vals.is_contiguous()):
        raise LightGBMError("histogram wants contiguous u8 bins [n, F] and "
                            "f32 vals [n, 3]")
    _check_rng(rng, dev)
    if max_rows <= 0:
        return torch.zeros((f, padded_bins, 2), dtype=torch.float32,
                           device=dev)
    geo = comb_geometry(f, padded_bins, max_rows)
    partials, out = _comb_buffers(geo, f, padded_bins, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().hist_comb(rows.bins.data_ptr(), rows.vals.data_ptr(),
                              rng.data_ptr(),
                              *comb_args(geo, partials, out, n, f,
                                         padded_bins), stream)
    if rc != 0:
        raise LightGBMError(f"hist_comb kernel launch failed with CUDA "
                            f"error {rc}")
    build_histogram_comb.launches += 1
    return out


build_histogram_comb.launches = 0


def build_histogram_comb_p2_ref(rows: PackedRows, rng: torch.Tensor, *,
                                padded_bins: int,
                                max_rows: int) -> torch.Tensor:
    """Plain version of the pack=2 histogram:
    :func:`build_histogram_comb_ref` over the records' fields."""
    return build_histogram_comb_ref(rows.fields(), rng,
                                    padded_bins=padded_bins,
                                    max_rows=max_rows)


def build_histogram_comb_p2(rows: PackedRows, rng: torch.Tensor, *,
                            padded_bins: int,
                            max_rows: int) -> torch.Tensor:
    """:func:`build_histogram_comb` over records, in the same geometry
    and with the same bits.  CPU tensors take
    :func:`build_histogram_comb_p2_ref`; CUDA tensors launch the
    kernel on the current stream."""
    dev = rows.buf.device
    if dev.type == "cpu":
        return build_histogram_comb_p2_ref(rows, rng,
                                           padded_bins=padded_bins,
                                           max_rows=max_rows)
    if dev.type != "cuda":
        raise LightGBMError(f"histogram runs on cuda or cpu, not {dev}")
    check_packed(rows)
    _check_rng(rng, dev)
    n, lay = rows.buf.shape[0], rows.layout
    f = lay.num_features
    geo = comb_geometry(f, padded_bins, max_rows)
    partials, out = _comb_buffers(geo, f, padded_bins, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().hist_comb_p2(rows.buf.data_ptr(), lay.stride, lay.fb,
                                 rng.data_ptr(),
                                 *comb_args(geo, partials, out, n, f,
                                            padded_bins), stream)
    if rc != 0:
        raise LightGBMError(f"hist_comb_p2 kernel launch failed with CUDA "
                            f"error {rc}")
    build_histogram_comb_p2.launches += 1
    return out


build_histogram_comb_p2.launches = 0


# -- row-indexed histogram (csrc/hist_rows.cu) ------------------------------
# features one multi-slice block histograms: one per warp
ROWS_FEATURES = 8
# warps a block; positions a block stages a step (kThreads times
# kPartialRows, kDirectRows); bins a one-launch warp owns (kRange)
ROWS_WARPS = 8
ROWS_STAGE_PARTIAL = 512
ROWS_STAGE_DIRECT = 1024
ROWS_RANGE = 32
# slices one hist_rows_direct launch sums (kDirectSlices)
ROWS_DIRECT_SLICES = 2


def rows_stage_bytes(nf: int, bin_bytes: int, stage: int) -> int:
    """Shared memory of a double-buffered stage of ``nf`` features
    (``stage_bytes``): (g*w, h*w) and the bins of ``stage`` positions,
    twice."""
    return 2 * stage * (8 + nf * bin_bytes)


def rows_smem_bytes(fc: int, padded_bins: int, bin_bytes: int,
                    acc_bytes: int = 4) -> int:
    """Shared memory of one multi-slice block of ``fc`` features (the
    library's ``hist_rows_smem_bytes``): the ``[fc, B, 2]`` histogram of
    ``acc_bytes`` cells (4: f32, 8: the gpu_use_dp mode) and the
    stage."""
    return (fc * padded_bins * 2 * acc_bytes
            + rows_stage_bytes(fc, bin_bytes, ROWS_STAGE_PARTIAL))


def rows_direct_smem_bytes(nf: int, bin_bytes: int,
                           acc_bytes: int = 4) -> int:
    """Shared memory of one one-launch block staging ``nf`` features (the
    library's ``hist_rows_direct_smem_bytes``): the stage, and for each
    warp its 32 cells (pairs of ``acc_bytes``) and its list of a step's
    rows (u32)."""
    return (rows_stage_bytes(nf, bin_bytes, ROWS_STAGE_DIRECT)
            + ROWS_WARPS * ROWS_RANGE * 2 * acc_bytes
            + ROWS_WARPS * ROWS_STAGE_DIRECT * 4)


@functools.lru_cache(maxsize=None)
def rows_feature_chunk(padded_bins: int, bin_bytes: int,
                       acc_bytes: int = 4) -> int:
    """Features a multi-slice block histograms: ``ROWS_FEATURES``, halved
    until one block's shared memory fits."""
    fc = ROWS_FEATURES
    while fc >= 1:
        if rows_smem_bytes(fc, padded_bins, bin_bytes, acc_bytes) <= MAX_SMEM:
            return fc
        fc //= 2
    raise LightGBMError(f"a histogram of {padded_bins} bins per feature "
                        "does not fit one block's shared memory")


def rows_direct_feats(f: int, padded_bins: int) -> int:
    """The most features one one-launch block stages: those its
    ``ROWS_WARPS`` consecutive (feature, 32-bin range) units span."""
    r = -(-int(padded_bins) // ROWS_RANGE)
    units = int(f) * r
    return max((min(u0 + ROWS_WARPS, units) - 1) // r - u0 // r + 1
               for u0 in range(0, units, ROWS_WARPS))


def rows_blocks(max_rows: int, padded_bins: int) -> int:
    """Position slices of a row-indexed launch over at most ``max_rows``
    positions: ``hist_blocks`` at B <= 256; wider bins take B / 256 times
    the rows per slice and at most 256 / B of the slices, so the partials
    (slices x F x B x 8 bytes) stay near a fifth of the rows' bytes at
    the 1M-row root."""
    scale = max(1, int(padded_bins) // 256)
    per = ROWS_PER_BLOCK * scale
    return max(1, min(MAX_BLOCKS // scale, -(-int(max_rows) // per)))


class RowsGeometry(NamedTuple):
    """One ``hist_rows`` call's launch geometry.

    ``slices`` position slices (:func:`rows_blocks`).  At up to
    ``ROWS_DIRECT_SLICES`` (``direct``) one launch of
    ``hist_rows_direct``: ``grid[0]`` blocks of ``ROWS_WARPS`` warps,
    warp ``w`` of block ``x`` owning unit ``u = x * ROWS_WARPS + w``
    below ``f * bin_parts``: feature ``u // bin_parts``, bins ``[(u %
    bin_parts) * 32, ... + 32)``, one cell a lane, for every slice;
    ``feats`` the most features a block stages.  At more slices
    ``hist_rows_partial`` on ``grid`` (slices, feature chunks) with
    ``feats`` features a block (``bin_parts`` 1: a warp owns its feature's
    every bin), then the reduction in a second launch.  The wrapper
    passes the geometry to the library as it is (``smem`` is the
    library's own figure at ``feats``, which the analyzer holds against
    it); the library only refuses one that misses a cell."""
    slices: int
    direct: bool
    grid: Tuple[int, int]
    feats: int
    bin_parts: int
    smem: int


@functools.lru_cache(maxsize=None)
def rows_geometry(f: int, padded_bins: int, bin_bytes: int,
                  slices: int, acc_bytes: int = 4) -> RowsGeometry:
    """The geometry of a ``hist_rows`` call over ``f`` features of
    ``padded_bins`` bins of ``bin_bytes`` bytes cut into ``slices``, with
    cells of ``acc_bytes`` (8: the gpu_use_dp mode)."""
    f, b = int(f), int(padded_bins)
    if slices <= ROWS_DIRECT_SLICES:
        parts = -(-b // ROWS_RANGE)
        nf = rows_direct_feats(f, b)
        return RowsGeometry(int(slices), True,
                            (-(-f * parts // ROWS_WARPS), 1), nf, parts,
                            rows_direct_smem_bytes(nf, bin_bytes, acc_bytes))
    fc = rows_feature_chunk(b, bin_bytes, acc_bytes)
    return RowsGeometry(int(slices), False, (int(slices), -(-f // fc)), fc,
                        1, rows_smem_bytes(fc, b, bin_bytes, acc_bytes))


def build_histogram_rows_ref(bins: torch.Tensor, vals: torch.Tensor,
                             rng: torch.Tensor, *, index=None,
                             padded_bins: int, max_rows: int,
                             dp: bool = False) -> torch.Tensor:
    """Plain version, in the kernel's order of additions: each slice's
    rows (gathered through ``index``) summed into their own histogram by
    one ``index_add_`` (sequential on the CPU), the slice histograms
    added in slice order; in f32, or with ``dp`` (the gpu_use_dp mode) in
    f64 and rounded to f32 at the end.  On the CPU it gives the kernel's
    bits."""
    n_pos = bins.shape[0] if index is None else index.shape[0]
    start, count = (int(v) for v in rng.tolist())
    lo, hi = _window((start, 0, count), n_pos)
    f = bins.shape[1]
    acc = torch.float64 if dp else torch.float32
    out = torch.zeros((f, padded_bins, 2), dtype=acc, device=bins.device)
    for b_lo, b_hi in block_ranges(lo, hi,
                                   rows_blocks(max_rows, padded_bins)):
        if b_hi <= b_lo:
            continue
        if index is None:
            b, v = bins_i32(bins[b_lo:b_hi]), vals[b_lo:b_hi]
        else:
            rows = index[b_lo:b_hi].long()
            b, v = bins_i32(bins, rows), vals.index_select(0, rows)
        out = out + build_histogram(b, v, padded_bins=padded_bins,
                                    dtype=acc)
    return out.to(torch.float32)


@functools.lru_cache(maxsize=1)
def _rows_lib():
    lib = _build.load("hist_rows")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.hist_rows, lib.hist_rows_f64):
        fn.argtypes = [p, i] + [p] * 5 + [i] * 9 + [p]
        fn.restype = i
    return lib


def build_histogram_rows(bins: torch.Tensor, vals: torch.Tensor,
                         rng: torch.Tensor, *, index=None, padded_bins: int,
                         max_rows: int) -> torch.Tensor:
    """Histogram ``[F, padded_bins, 2]`` f32 of the positions ``rng``
    selects (``count`` at most ``max_rows``) of ``index`` (i32, entries
    in ``[0, n)``), or of the rows themselves without one.  CPU tensors
    take :func:`build_histogram_rows_ref`; CUDA tensors launch the
    kernel on the current stream in the geometry :func:`rows_geometry`
    picks (one launch where ``max_rows`` gives one or two slices), with
    no host read, allocating only the output (and the partials at more
    slices), so a CUDA graph can capture it.  ``max_rows == 0`` (a
    segment empty on this rank) returns zeros and launches nothing."""
    if bins.device.type == "cpu":
        return build_histogram_rows_ref(bins, vals, rng, index=index,
                                        padded_bins=padded_bins,
                                        max_rows=max_rows)
    if max_rows <= 0:
        return torch.zeros((bins.shape[1], padded_bins, 2),
                           dtype=torch.float32, device=bins.device)
    out = _rows_call(bins, vals, rng, index, padded_bins, max_rows, False)
    build_histogram_rows.launches += 1
    return out


build_histogram_rows.launches = 0


def build_histogram_rows_dp(bins: torch.Tensor, vals: torch.Tensor,
                            rng: torch.Tensor, *, index=None,
                            padded_bins: int, max_rows: int) -> torch.Tensor:
    """The gpu_use_dp mode of :func:`build_histogram_rows`: the same
    histogram accumulated in f64 and rounded to f32 once (the library's
    ``hist_rows_f64``).  CPU tensors take
    ``build_histogram_rows_ref(..., dp=True)``."""
    if bins.device.type == "cpu":
        return build_histogram_rows_ref(bins, vals, rng, index=index,
                                        padded_bins=padded_bins,
                                        max_rows=max_rows, dp=True)
    out = _rows_call(bins, vals, rng, index, padded_bins, max_rows, True)
    build_histogram_rows_dp.launches += 1
    return out


build_histogram_rows_dp.launches = 0


def _rows_call(bins, vals, rng, index, padded_bins: int, max_rows: int,
               dp: bool) -> torch.Tensor:
    """Check the inputs and launch ``hist_rows`` (``dp``: its f64 entry)
    on the current stream."""
    dev = bins.device
    if dev.type != "cuda":
        raise LightGBMError(f"histogram runs on cuda or cpu, not {dev}")
    n, f = bins.shape
    if (bins.dtype not in (torch.uint8, torch.uint16)
            or vals.dtype != torch.float32 or tuple(vals.shape) != (n, 2)
            or vals.device != dev or not bins.is_contiguous()
            or not vals.is_contiguous() or vals.data_ptr() % 8):
        raise LightGBMError("hist_rows wants contiguous u8 or u16 bins "
                            "[n, F] and 8-byte aligned f32 vals [n, 2] on "
                            "one device")
    if index is not None and (index.device != dev
                              or index.dtype != torch.int32
                              or index.dim() != 1
                              or not index.is_contiguous()):
        raise LightGBMError("the row index must be a contiguous i32 "
                            "vector on the bins' device")
    if (rng.device != dev or rng.dtype != torch.int32 or rng.numel() != 2
            or not rng.is_contiguous()):
        raise LightGBMError("rng must be a contiguous i32 [2] tensor "
                            "(start, count) on the bins' device")
    bin_bytes = bins.element_size()
    geo = rows_geometry(f, padded_bins, bin_bytes,
                        rows_blocks(max_rows, padded_bins), 8 if dp else 4)
    out = torch.empty((f, padded_bins, 2), dtype=torch.float32, device=dev)
    partials = None if geo.direct else torch.empty(
        (geo.slices, f, padded_bins, 2),
        dtype=torch.float64 if dp else torch.float32, device=dev)
    n_pos = n if index is None else index.shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _rows_lib()
    with torch.cuda.device(dev):
        rc = (lib.hist_rows_f64 if dp else lib.hist_rows)(
            bins.data_ptr(), bin_bytes, vals.data_ptr(),
            None if index is None else index.data_ptr(), rng.data_ptr(),
            None if partials is None else partials.data_ptr(),
            out.data_ptr(), n_pos, f, int(padded_bins), geo.slices,
            int(geo.direct), geo.grid[0], geo.grid[1], geo.feats,
            geo.bin_parts, stream)
    if rc != 0:
        raise LightGBMError(f"hist_rows kernel launch failed with CUDA "
                            f"error {rc}")
    return out
