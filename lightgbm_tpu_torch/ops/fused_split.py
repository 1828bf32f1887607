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

:func:`fused_split` takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from ..utils.log import LightGBMError
from . import _build
from .device_data import Rows
from .hist_kernel2 import MAX_SMEM, build_histogram_comb_ref, hist_blocks
from .partition_kernel import (SCAN_TILE, SEL_CNT, SEL_FEAT, SEL_S0,
                               check_rows, check_segment, partition_scan_ref,
                               row_pointers, split_args)


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
    decision, taken up front)."""
    return (num_features * padded_bins * 8 + SCAN_TILE * (num_features + 12)
            <= MAX_SMEM)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("fused_split")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_split.argtypes = [p] * 15 + [i] * 10 + [p]
    lib.fused_split.restype = i
    return lib


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
    check_segment(rows, s0, cnt)
    f = rows.bins.shape[1]
    shape = (2, f, padded_bins, 2)
    if cnt == 0:
        nleft.zero_()
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    if not 0 <= int(sel[SEL_FEAT]) < f:
        raise LightGBMError(f"split feature {sel[SEL_FEAT]} outside [0, {f})")
    if not fused_supported(f, padded_bins):
        raise LightGBMError(f"fused split of {f} features x {padded_bins} "
                            "bins does not fit one block's shared memory")
    tiles = -(-cnt // SCAN_TILE)
    tile_left = torch.empty(tiles, dtype=torch.int32, device=dev)
    lprefix = torch.empty(tiles + 1, dtype=torch.int32, device=dev)
    nblocks = hist_blocks(cnt // 2 + 1)
    partials = torch.empty((2, nblocks, f, padded_bins, 2),
                           dtype=torch.float32, device=dev)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
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
