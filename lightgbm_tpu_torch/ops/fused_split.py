"""Fused split: the wrapper of ``csrc/fused_split.cu``, its launch count
and its plain PyTorch version.

Counterpart of ``lightgbm_tpu/ops/pallas/fused_split.py``
(``make_fused_split``, pack=1): one pass over a leaf segment partitions
its rows into the scratch matrix in ``partition_scan``'s layout (left
rows in order, then right rows reversed), writes ``nleft`` to a device
scalar and returns BOTH children's histograms ``[2, F, B, 2]``.  Each
child's histogram equals ``build_histogram_comb`` of its final range
with ``max_rows = cnt // 2 + 1``, bit for bit: the grid and summation
order slice 2's grower uses for the smaller child.  The caller copies
the segment back (``partition_kernel.copyback``) and selects the
smaller child by ``nleft * 2 <= cnt``.

:func:`fused_split_p2` is the same split at pack=2
(``_make_fused_p2``) over the records of
:class:`~.device_data.PackedRows`: its plain version is
:func:`fused_split_ref` over :meth:`PackedRows.fields`, and the kernel
writes the pack=1 kernel's rows, ``nleft`` and histograms.

A descriptor may carry up to eight membership words after its eight
slots (``descriptor.SEL_MEMBER``; the sorted-subset routes pass
them with every split): a categorical row then goes left where its
bin's bit is set, as in ``partition_kernel.go_left``.  Both entries
pass them to the kernels (``count_tiles`` and ``fused_scatter`` test
one predicate, ``part::pred_left``).

:func:`fused_split` and :func:`fused_split_p2` take the plain version
only for tensors on the CPU; for CUDA tensors they launch the kernels or
raise.  On the card a split runs in two passes (``csrc/fused_split.cu``):
the partition into scratch, which also writes a feature-major copy of
the partitioned segment, then both children's histograms over that
copy, on the geometry :func:`fused_geometry` picks (the library refuses
one that misses a row or a cell).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from ..utils.log import LightGBMError
from . import _build
from .device_data import PackedRows, Rows, check_packed
from .hist_kernel2 import MAX_SMEM, build_histogram_comb_ref, hist_blocks
from .partition_kernel import (SCAN_TILE, SEL_CNT, SEL_FEAT, SEL_S0,
                               check_nleft, check_rows, check_segment,
                               check_words, partition_scan_ref, row_pointers,
                               split_args, word_args)


def child_ranges(s0: int, cnt: int, nleft: int):
    """(start, off, count) of the left and right child of a split."""
    return (s0, 0, nleft), (s0 + nleft, 0, cnt - nleft)


def fused_split_ref(rows: Rows, scratch: Rows, sel: Sequence[int],
                    nleft: torch.Tensor, *, padded_bins: int) -> torch.Tensor:
    """Plain version: ``partition_scan_ref`` into scratch, then
    ``build_histogram_comb_ref`` of each child's range of the scratch
    rows with ``max_rows = cnt // 2 + 1``."""
    s0, cnt = int(sel[SEL_S0]), int(sel[SEL_CNT])
    partition_scan_ref(rows, scratch, sel, nleft)
    dev = rows.bins.device
    hists = [build_histogram_comb_ref(
        scratch, torch.tensor(rng, dtype=torch.int32, device=dev),
        padded_bins=padded_bins, max_rows=cnt // 2 + 1)
        for rng in child_ranges(s0, cnt, int(nleft))]
    return torch.stack(hists)


def fused_supported(num_features: int, padded_bins: int) -> bool:
    """Whether the fused split serves these shapes (the counterpart of
    the reference's ``fused_supported``: a route decision, taken up
    front): :func:`smem_bytes` within one block's shared memory.  The
    test, one for both packs, is the first kernel's, which staged whole
    tiles beside the histogram; the kernel now needs less
    (:func:`hist_smem_bytes`), and the gate stays so that the routes do
    not move."""
    return smem_bytes(num_features, padded_bins) <= MAX_SMEM


def smem_bytes(num_features: int, padded_bins: int) -> int:
    """The route gate's figure: ``F * B * 8`` bytes of histogram and, per
    slot of a 1,024-row tile, (g*w, h*w), the source index and the
    bins."""
    return num_features * padded_bins * 8 + SCAN_TILE * (num_features + 12)


# the histogram pass (csrc/fused_split.cu): rows a ring stage holds, the
# ring's stages, a range-mode warp's bins and a block's warps
# (kStageRows, kStages, kRange, kWarps)
STAGE_ROWS = 512
STAGES = 4
RANGE_BINS = 32
HIST_WARPS = 8
# slices up to which a warp owns a 32-bin range of one feature (range
# mode); above, a warp owns whole features (feature mode): range mode
# was the faster from 2 to 7 slices at F = 28, B = 256 and feature mode
# at 8 (tools/profile_fused.py --variants on the H100)
RANGE_SLICES = 7
# feature-mode histogram blocks a launch aims at: two an SM of the H100
FILL_BLOCKS = 2 * 132


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def staged_features(feats: int, parts: int) -> int:
    """Features whose columns a histogram block stages: its ``feats`` in
    feature mode, in range mode the most its ``HIST_WARPS`` units can
    span (a bound)."""
    return feats if parts == 1 else (HIST_WARPS - 1) // parts + 2


def hist_smem_bytes(feats: int, parts: int, padded_bins: int) -> int:
    """Shared memory of one histogram block (the library's
    ``fused_hist_smem_bytes``): in feature mode (``parts`` 1) the
    ``[feats, B, 2]`` f32 histogram, in range mode each warp's list of a
    stage's rows (16 bytes a row); then ``STAGES`` ring stages of
    ``STAGE_ROWS`` rows: each staged feature's column bytes and the
    rows' (g*w, h*w), each with 16 bytes of alignment slack."""
    if parts == 1:
        own = _round16(feats * padded_bins * 8)
    else:
        own = HIST_WARPS * STAGE_ROWS * 16
    stage = (staged_features(feats, parts) * _round16(STAGE_ROWS + 16)
             + _round16(STAGE_ROWS * 8 + 16))
    return own + STAGES * stage


class FusedGeometry(NamedTuple):
    """One fused split's launch geometry.

    ``tiles`` 1,024-row count tiles (the partition pass's blocks);
    ``slices`` = ``hist_blocks(cnt // 2 + 1)`` slices a side (the bits'
    grid); the histogram pass on ``grid`` = (slices, 2 sides, groups)
    blocks of ``HIST_WARPS`` warps.  Range mode (``parts`` =
    ``ceil(B / 32)`` > 1, up to ``RANGE_SLICES`` slices): warp ``w`` of
    block ``z`` owns unit ``u = z * 8 + w`` below ``F * parts``: feature
    ``u // parts``, bins ``[(u % parts) * 32, ... + 32)``.  Feature mode
    (``parts`` 1): block ``z`` sums features ``[z * feats, z * feats +
    feats)``, a warp owning whole features.  Above one slice the
    reduction adds the slices' partials in a fourth launch.  ``smem``:
    the library's own figure for a histogram block (held against it by
    the analyzer).  The wrapper passes it to the library
    as it is; the library refuses one that misses a row or a cell."""
    tiles: int
    slices: int
    groups: int
    feats: int
    parts: int
    smem: int

    @property
    def grid(self) -> Tuple[int, int, int]:
        return (self.slices, 2, self.groups)


@functools.lru_cache(maxsize=None)
def _hist_geometry(f: int, b: int, slices: int):
    parts = -(-b // RANGE_BINS)
    if slices <= RANGE_SLICES and parts > 1:
        return (-(-f * parts // HIST_WARPS), 0, parts,
                hist_smem_bytes(0, parts, b))
    groups = max(1, min(f, -(-FILL_BLOCKS // (2 * slices))))
    feats = -(-f // groups)
    while hist_smem_bytes(feats, 1, b) > MAX_SMEM:
        feats -= 1
        if feats == 0:
            raise LightGBMError(f"a histogram of {b} bins per feature does "
                                "not fit one block's shared memory")
    return (-(-f // feats), feats, 1, hist_smem_bytes(feats, 1, b))


def fused_geometry(f: int, padded_bins: int, cnt: int) -> FusedGeometry:
    """The geometry of a fused split of ``cnt`` rows of ``f`` features of
    ``padded_bins`` bins, either pack (the histogram pass reads the
    partition pass's feature-major copy, the same at both): range
    mode up to ``RANGE_SLICES`` slices (112 blocks a slice and side at
    F = 28, B = 256), else feature mode with as many feature groups as
    bring the launch to ``FILL_BLOCKS`` blocks (two at the 1M-row
    root), each as large as fits a block."""
    f, cnt = int(f), int(cnt)
    slices = hist_blocks(cnt // 2 + 1)
    return FusedGeometry(-(-cnt // SCAN_TILE), slices,
                         *_hist_geometry(f, int(padded_bins), slices))


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("fused_split")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_split.argtypes = [p] * 16 + [i] * 9 + [i, p] + [i] * 5 + [p]
    lib.fused_split.restype = i
    lib.fused_split_p2.argtypes = ([p] * 2 + [i] * 2 + [p] * 6 + [i] * 9
                                   + [i, p] + [i] * 5 + [p])
    lib.fused_split_p2.restype = i
    lib.fused_hist_smem_bytes.argtypes = [i] * 3
    lib.fused_hist_smem_bytes.restype = i
    return lib


def _check_split(sel, f: int, padded_bins: int) -> None:
    if not 0 <= int(sel[SEL_FEAT]) < f:
        raise LightGBMError(f"split feature {sel[SEL_FEAT]} outside [0, {f})")
    if not fused_supported(f, padded_bins):
        raise LightGBMError(f"fused split of {f} features x {padded_bins} "
                            "bins does not fit one block's shared memory")


def _split_buffers(geo: FusedGeometry, f: int, padded_bins: int, cnt: int,
                   dev) -> tuple:
    """(workspace, out, [tile_left, cols, gv, partials]) of one launch:
    ``out`` f32 [2, F, B, 2], and the device addresses (0 for none) of
    the launch's buffers, 256-byte aligned in one workspace: tile_left
    i32 [tiles], the feature-major copy of the segment (cols u8 [F,
    cnt], gv f32 [cnt, 2]), partials f32 [2, slices, F, B, 2] only where
    there is more than one slice.  Two allocations a
    launch; the caller keeps the workspace alive until the launch is
    enqueued (the caching allocator orders its reuse on the stream)."""
    sizes = [4 * geo.tiles, f * cnt, 8 * cnt,
             4 * 2 * geo.slices * f * padded_bins * 2 if geo.slices > 1
             else 0]
    ws = torch.empty(sum(-(-n // 256) * 256 for n in sizes),
                     dtype=torch.uint8, device=dev)
    ptrs, at = [], ws.data_ptr()
    for n in sizes:
        ptrs.append(at if n else 0)
        at += -(-n // 256) * 256
    out = torch.empty((2, f, padded_bins, 2), dtype=torch.float32,
                      device=dev)
    return ws, out, ptrs


def _geometry_args(geo: FusedGeometry) -> list:
    return [geo.tiles, geo.slices, geo.groups, geo.feats, geo.parts]


def fused_split(rows: Rows, scratch: Rows, sel: Sequence[int],
                nleft: torch.Tensor, *, padded_bins: int) -> torch.Tensor:
    """Partition the segment ``sel`` describes into ``scratch``, write
    its left count into ``nleft`` and return both children's histograms
    ``[2, F, padded_bins, 2]`` (left, right).  CPU tensors take
    :func:`fused_split_ref`; CUDA tensors launch the kernels on
    :func:`fused_geometry`.  ``cnt == 0`` writes ``nleft = 0``, returns
    zeros and launches nothing."""
    dev = rows.bins.device
    if dev.type == "cpu":
        return fused_split_ref(rows, scratch, sel, nleft,
                               padded_bins=padded_bins)
    if dev.type != "cuda":
        raise LightGBMError(f"fused_split runs on cuda or cpu, not {dev}")
    check_rows(rows, scratch, nleft)
    s0, cnt = int(sel[SEL_S0]), int(sel[SEL_CNT])
    check_segment(rows.bins.shape[0], s0, cnt)
    check_words(sel)
    f = rows.bins.shape[1]
    shape = (2, f, padded_bins, 2)
    if cnt == 0:
        nleft.zero_()
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    _check_split(sel, f, padded_bins)
    geo = fused_geometry(f, padded_bins, cnt)
    ws, out, ptrs = _split_buffers(geo, f, padded_bins, cnt, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().fused_split(
            *row_pointers(rows), *row_pointers(scratch), ptrs[0],
            nleft.data_ptr(), *ptrs[1:], out.data_ptr(), f,
            int(padded_bins), s0, cnt, *split_args(sel), *word_args(sel),
            *_geometry_args(geo), stream)
    if rc != 0:
        raise LightGBMError(f"fused_split kernel launch failed with CUDA "
                            f"error {rc}")
    fused_split.launches += 1
    del ws
    return out


fused_split.launches = 0


def fused_split_p2_ref(rows: PackedRows, scratch: PackedRows,
                       sel: Sequence[int], nleft: torch.Tensor, *,
                       padded_bins: int) -> torch.Tensor:
    """Plain version of the pack=2 split: :func:`fused_split_ref` over
    the records' fields."""
    return fused_split_ref(rows.fields(), scratch.fields(), sel, nleft,
                           padded_bins=padded_bins)


def fused_split_p2(rows: PackedRows, scratch: PackedRows, sel: Sequence[int],
                   nleft: torch.Tensor, *, padded_bins: int) -> torch.Tensor:
    """:func:`fused_split` over records (the caller copies back with
    ``partition_kernel.copyback_p2``).  CPU tensors take
    :func:`fused_split_p2_ref`; CUDA tensors launch the kernel.  ``cnt
    == 0`` writes ``nleft = 0``, returns zeros and launches nothing."""
    dev = rows.buf.device
    if dev.type == "cpu":
        return fused_split_p2_ref(rows, scratch, sel, nleft,
                                  padded_bins=padded_bins)
    if dev.type != "cuda":
        raise LightGBMError(f"fused_split_p2 runs on cuda or cpu, not {dev}")
    check_packed(rows, scratch)
    check_nleft(nleft, dev)
    s0, cnt = int(sel[SEL_S0]), int(sel[SEL_CNT])
    check_segment(rows.buf.shape[0], s0, cnt)
    check_words(sel)
    lay = rows.layout
    f = lay.num_features
    if cnt == 0:
        nleft.zero_()
        return torch.zeros((2, f, padded_bins, 2), dtype=torch.float32,
                           device=dev)
    _check_split(sel, f, padded_bins)
    geo = fused_geometry(f, padded_bins, cnt)
    ws, out, ptrs = _split_buffers(geo, f, padded_bins, cnt, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().fused_split_p2(
            rows.buf.data_ptr(), scratch.buf.data_ptr(), lay.stride, lay.fb,
            ptrs[0], nleft.data_ptr(), *ptrs[1:], out.data_ptr(), f,
            int(padded_bins), s0, cnt, *split_args(sel), *word_args(sel),
            *_geometry_args(geo), stream)
    if rc != 0:
        raise LightGBMError(f"fused_split_p2 kernel launch failed with CUDA "
                            f"error {rc}")
    fused_split_p2.launches += 1
    del ws
    return out


fused_split_p2.launches = 0
