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

:func:`fused_split` and :func:`fused_split_p2` take the plain version
only for tensors on the CPU; for CUDA tensors they launch the kernel or
raise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from ..utils.log import LightGBMError
from . import _build
from .device_data import PackedRows, Rows, check_packed
from .hist_kernel2 import MAX_SMEM, build_histogram_comb_ref, hist_blocks
from .partition_kernel import (SCAN_TILE, SEL_CNT, SEL_FEAT, SEL_S0,
                               check_nleft, check_rows, check_segment,
                               partition_scan_ref, row_pointers, split_args)


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
    """Whether one block's shared histogram and staging fit (the
    counterpart of the reference's ``fused_supported``: a route
    decision, taken up front): ``F * B * 8`` bytes of histogram and,
    per slot of a 1,024-row tile, (g*w, h*w), the source index and the
    bins.  The pack=2 kernel needs the same: it moves each record's
    16-byte words from source to scratch through registers and stages
    only what the pack=1 kernel stages, so one test serves both packs."""
    return smem_bytes(num_features, padded_bins) <= MAX_SMEM


def smem_bytes(num_features: int, padded_bins: int) -> int:
    """Shared memory of one scatter block, either pack (the library's
    ``fused_split_smem_bytes``)."""
    return num_features * padded_bins * 8 + SCAN_TILE * (num_features + 12)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("fused_split")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_split.argtypes = [p] * 15 + [i] * 10 + [p]
    lib.fused_split.restype = i
    lib.fused_split_p2.argtypes = [p] * 2 + [i] * 2 + [p] * 5 + [i] * 10 + [p]
    lib.fused_split_p2.restype = i
    return lib


def _check_split(sel, f: int, padded_bins: int) -> None:
    if not 0 <= int(sel[SEL_FEAT]) < f:
        raise LightGBMError(f"split feature {sel[SEL_FEAT]} outside [0, {f})")
    if not fused_supported(f, padded_bins):
        raise LightGBMError(f"fused split of {f} features x {padded_bins} "
                            "bins does not fit one block's shared memory")


def _split_buffers(f: int, padded_bins: int, cnt: int, dev):
    """(tile_left, lprefix, nblocks, partials, out) of one launch."""
    tiles = -(-cnt // SCAN_TILE)
    nblocks = hist_blocks(cnt // 2 + 1)
    return (torch.empty(tiles, dtype=torch.int32, device=dev),
            torch.empty(tiles + 1, dtype=torch.int32, device=dev), nblocks,
            torch.empty((2, nblocks, f, padded_bins, 2), dtype=torch.float32,
                        device=dev),
            torch.empty((2, f, padded_bins, 2), dtype=torch.float32,
                        device=dev))


def fused_split(rows: Rows, scratch: Rows, sel: Sequence[int],
                nleft: torch.Tensor, *, padded_bins: int) -> torch.Tensor:
    """Partition the segment ``sel`` describes into ``scratch``, write
    its left count into ``nleft`` and return both children's histograms
    ``[2, F, padded_bins, 2]`` (left, right).  CPU tensors take
    :func:`fused_split_ref`; CUDA tensors launch the kernel.  ``cnt ==
    0`` writes ``nleft = 0``, returns zeros and launches nothing."""
    dev = rows.bins.device
    if dev.type == "cpu":
        return fused_split_ref(rows, scratch, sel, nleft,
                               padded_bins=padded_bins)
    if dev.type != "cuda":
        raise LightGBMError(f"fused_split runs on cuda or cpu, not {dev}")
    check_rows(rows, scratch, nleft)
    s0, cnt = int(sel[SEL_S0]), int(sel[SEL_CNT])
    check_segment(rows.bins.shape[0], s0, cnt)
    f = rows.bins.shape[1]
    shape = (2, f, padded_bins, 2)
    if cnt == 0:
        nleft.zero_()
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    _check_split(sel, f, padded_bins)
    tile_left, lprefix, nblocks, partials, out = _split_buffers(
        f, padded_bins, cnt, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().fused_split(
            *row_pointers(rows), *row_pointers(scratch),
            tile_left.data_ptr(), lprefix.data_ptr(), nleft.data_ptr(),
            partials.data_ptr(), out.data_ptr(), f, int(padded_bins), s0, cnt,
            *split_args(sel), nblocks, stream)
    if rc != 0:
        raise LightGBMError(f"fused_split kernel launch failed with CUDA "
                            f"error {rc}")
    fused_split.launches += 1
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
    lay = rows.layout
    f = lay.num_features
    if cnt == 0:
        nleft.zero_()
        return torch.zeros((2, f, padded_bins, 2), dtype=torch.float32,
                           device=dev)
    _check_split(sel, f, padded_bins)
    tile_left, lprefix, nblocks, partials, out = _split_buffers(
        f, padded_bins, cnt, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().fused_split_p2(
            rows.buf.data_ptr(), scratch.buf.data_ptr(), lay.stride, lay.fb,
            tile_left.data_ptr(), lprefix.data_ptr(), nleft.data_ptr(),
            partials.data_ptr(), out.data_ptr(), f, int(padded_bins), s0,
            cnt, *split_args(sel), nblocks, stream)
    if rc != 0:
        raise LightGBMError(f"fused_split_p2 kernel launch failed with CUDA "
                            f"error {rc}")
    fused_split_p2.launches += 1
    return out


fused_split_p2.launches = 0
