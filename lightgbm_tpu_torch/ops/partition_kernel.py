"""Partition of one leaf segment of the row matrix: the wrappers of
``csrc/partition.cu`` (scan and copyback) and ``csrc/partition_3ph.cu``
(the 3-phase partition), their launch counts and their plain PyTorch
versions.

Counterpart of ``lightgbm_tpu/ops/pallas/partition_kernel2.py``
(``make_partition_ss`` with ``partition_kernel3.make_partition_perm``'s
packing, and ``copyback_call``) and of
``lightgbm_tpu/ops/pallas/partition_kernel.py`` (``make_partition``,
behind ``LGBM_TPU_PART=3ph``).  The split descriptor keeps the layout
of ``partition_kernel.py`` (``SEL_S0 .. SEL_NANB``, and optionally
membership words from ``SEL_MEMBER`` on) and the predicate is
``_go_left``'s.  After :func:`partition` the segment holds its left
rows in their original order, then its right rows in reversed original
order, exactly as the compiled single-scan TPU kernel leaves it; after
:func:`partition_3ph` the right rows come in ascending original order,
as the 3-phase kernel writes them.  Rows outside the segment are
untouched.

:func:`partition_scan_p2` and :func:`copyback_p2` are the scan and the
copyback at pack=2 (``make_partition_p2``'s ``_scan_kernel_p2`` and
``copyback_call_p2`` in ``partition_kernel3.py``) over the records of
:class:`~.device_data.PackedRows`; their plain versions are
:func:`partition_scan_ref` and :func:`copyback_ref` over
:meth:`PackedRows.fields`, and :func:`partition_p2` is the two
launches ``make_partition_p2`` makes per split.

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from ..utils.log import LightGBMError
from . import _build
from .device_data import PackedRows, Rows, check_packed

# split descriptor layout (lightgbm_tpu/ops/pallas/partition_kernel.py):
# seven slots (an eighth is spare), then optionally membership words
SEL_S0, SEL_CNT, SEL_FEAT, SEL_SBIN, SEL_DL, SEL_CAT, SEL_NANB = range(7)
SEL_MEMBER = 8
# membership words a descriptor may carry (layout.CAT_BITSET_WORDS)
MAX_MEMBER_WORDS = 8
# rows per block of the scan kernels (csrc/partition.cu kTile)
SCAN_TILE = 1024


def member_words(sel: Sequence[int]) -> list:
    """The descriptor's membership words as u32 values (empty without
    them); i32 words with bit 31 set are read as their u32 bits."""
    return [int(w) & 0xFFFFFFFF for w in sel[SEL_MEMBER:]]


def go_left(col: torch.Tensor, sel: Sequence[int]) -> torch.Tensor:
    """The go-left predicate of ``partition_kernel._go_left`` on the
    split column's integer bins.  A descriptor longer than
    ``SEL_MEMBER`` carries membership words: a categorical row then
    goes left when bit ``bin % 32`` of word ``bin // 32`` is set (a bin
    past the last word goes right); numerical splits ignore them."""
    words = member_words(sel)
    if sel[SEL_CAT]:
        if not words:
            return col == sel[SEL_SBIN]
        w = torch.tensor(words + [0], dtype=torch.int64, device=col.device)
        c = col.to(torch.int64)
        word = w[torch.clamp(c >> 5, max=len(words))]
        return ((word >> (c & 31)) & 1) > 0
    nanb = sel[SEL_NANB]
    at_nan = (col == nanb) if nanb >= 0 else torch.zeros_like(col,
                                                             dtype=torch.bool)
    return torch.where(at_nan, bool(sel[SEL_DL]), col <= sel[SEL_SBIN])


def partition_scan_ref(rows: Rows, scratch: Rows, sel: Sequence[int],
                       nleft: torch.Tensor) -> torch.Tensor:
    """Plain version of the scan: writes the partitioned segment into
    ``scratch`` (left rows in order, then right rows reversed) and its
    left count into ``nleft`` (i32 [1])."""
    s0, cnt = int(sel[SEL_S0]), int(sel[SEL_CNT])
    if cnt <= 0:
        nleft.zero_()
        return nleft
    col = rows.bins[s0:s0 + cnt, int(sel[SEL_FEAT])].to(torch.int32)
    gl = go_left(col, sel)
    order = torch.cat([torch.nonzero(gl).flatten(),
                       torch.nonzero(~gl).flatten().flip(0)]) + s0
    for src, dst in zip(rows, scratch):
        dst[s0:s0 + cnt] = src[order]
    nleft.fill_(int(gl.sum()))
    return nleft


def partition_3ph_ref(rows: Rows, scratch: Rows, sel: Sequence[int],
                      nleft: torch.Tensor) -> torch.Tensor:
    """Plain version of the 3-phase partition: the segment goes through
    ``scratch`` (left rows in order, then right rows in order) back into
    ``rows``; its left count goes to ``nleft`` (i32 [1])."""
    s0, cnt = int(sel[SEL_S0]), int(sel[SEL_CNT])
    if cnt <= 0:
        nleft.zero_()
        return nleft
    col = rows.bins[s0:s0 + cnt, int(sel[SEL_FEAT])].to(torch.int32)
    gl = go_left(col, sel)
    order = torch.cat([torch.nonzero(gl).flatten(),
                       torch.nonzero(~gl).flatten()]) + s0
    for src, dst in zip(rows, scratch):
        dst[s0:s0 + cnt] = src[order]
    copyback_ref(rows, scratch, s0, cnt)
    nleft.fill_(int(gl.sum()))
    return nleft


def copyback_ref(rows: Rows, scratch: Rows, s0: int, cnt: int) -> None:
    """Plain version of the copyback: rows[s0:s0+cnt] = scratch's, for
    every column."""
    for dst, src in zip(rows, scratch):
        dst[s0:s0 + cnt] = src[s0:s0 + cnt]


def partition_ref(rows: Rows, scratch: Rows, sel: Sequence[int],
                  nleft: torch.Tensor) -> torch.Tensor:
    """Plain version of the whole partition (scan, then copyback)."""
    partition_scan_ref(rows, scratch, sel, nleft)
    copyback_ref(rows, scratch, int(sel[SEL_S0]), int(sel[SEL_CNT]))
    return nleft


def check_rows(rows: Rows, scratch: Rows, nleft=None) -> None:
    """Raise unless ``rows`` and ``scratch`` are row matrices of one
    shape (u8 bins [n, F], f32 vals [n, 3], i32 rid [n], f32 score [n],
    f32 consts [n, 2]), contiguous on one device, and ``nleft`` (when
    given) an i32 scalar there."""
    n, f = rows.bins.shape
    dev = rows.bins.device
    want = ((torch.uint8, (n, f)), (torch.float32, (n, 3)),
            (torch.int32, (n,)), (torch.float32, (n,)),
            (torch.float32, (n, 2)))
    for r in (rows, scratch):
        for a, (dt, shape) in zip(r, want):
            if a.dtype != dt or tuple(a.shape) != shape:
                raise LightGBMError(
                    f"row matrix arrays must be u8 [{n}, {f}], f32 [{n}, 3], "
                    f"i32 [{n}], f32 [{n}] and f32 [{n}, 2]")
            if a.device != dev or not a.is_contiguous():
                raise LightGBMError("row matrix arrays must be contiguous "
                                    "and on one device")
    if nleft is not None:
        check_nleft(nleft, dev)


def check_nleft(nleft: torch.Tensor, dev) -> None:
    """Raise unless ``nleft`` is an i32 scalar on ``dev``."""
    if nleft.device != dev or nleft.dtype != torch.int32 \
            or nleft.numel() != 1:
        raise LightGBMError("nleft must be an i32 scalar on the rows' "
                            "device")


def row_pointers(rows: Rows) -> list:
    """The five arrays' device addresses, in the kernels' order."""
    return [a.data_ptr() for a in rows]


def split_args(sel: Sequence[int]) -> list:
    """(feat, sbin, default_left, is_cat, nan_bin) of a descriptor: the
    kernels' trailing split arguments."""
    return [int(sel[k]) for k in (SEL_FEAT, SEL_SBIN, SEL_DL, SEL_CAT,
                                  SEL_NANB)]


def check_segment(n: int, s0: int, cnt: int) -> None:
    """Raise unless [s0, s0 + cnt) lies inside an ``n``-row matrix."""
    if s0 < 0 or cnt < 0 or s0 + cnt > n:
        raise LightGBMError(f"segment [{s0}, {s0 + cnt}) is outside the "
                            f"{n}-row matrix")


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("partition")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.partition_scan.argtypes = [p] * 12 + [i] * 8 + [p]
    lib.partition_scan.restype = i
    lib.partition_copyback.argtypes = [p] * 10 + [i] * 3 + [p]
    lib.partition_copyback.restype = i
    lib.partition_copyback_p2.argtypes = [p, p, i, i, i, p]
    lib.partition_copyback_p2.restype = i
    lib.partition_scan_p2.argtypes = [p, p, i, i, p, p] + [i] * 7 + [p]
    lib.partition_scan_p2.restype = i
    return lib


@functools.lru_cache(maxsize=1)
def _lib_3ph():
    lib = _build.load("partition_3ph")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.partition_3ph.argtypes = [p] * 12 + [i] * 9 + [p, p]
    lib.partition_3ph.restype = i
    return lib


def partition_scan(rows: Rows, scratch: Rows, sel: Sequence[int],
                   nleft: torch.Tensor) -> torch.Tensor:
    """Scan the segment ``sel`` describes into ``scratch`` and write its
    left count into ``nleft``.  CPU tensors take
    :func:`partition_scan_ref`; CUDA tensors launch the kernel on the
    current stream.  ``cnt == 0`` (a dead split) writes ``nleft = 0``
    and launches nothing."""
    dev = rows.bins.device
    if dev.type == "cpu":
        return partition_scan_ref(rows, scratch, sel, nleft)
    if dev.type != "cuda":
        raise LightGBMError(f"partition runs on cuda or cpu, not {dev}")
    check_rows(rows, scratch, nleft)
    s0, cnt = int(sel[SEL_S0]), int(sel[SEL_CNT])
    check_segment(rows.bins.shape[0], s0, cnt)
    if cnt == 0:
        nleft.zero_()
        return nleft
    f = rows.bins.shape[1]
    if not 0 <= int(sel[SEL_FEAT]) < f:
        raise LightGBMError(f"split feature {sel[SEL_FEAT]} outside [0, {f})")
    tiles = -(-cnt // SCAN_TILE)
    tile_left = torch.empty(tiles, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().partition_scan(
            *row_pointers(rows), *row_pointers(scratch),
            tile_left.data_ptr(), nleft.data_ptr(), f, s0, cnt,
            *split_args(sel), stream)
    if rc != 0:
        raise LightGBMError(f"partition_scan kernel launch failed with "
                            f"CUDA error {rc}")
    partition_scan.launches += 1
    return nleft


def copyback(rows: Rows, scratch: Rows, s0: int, cnt: int) -> None:
    """Move rows [s0, s0 + cnt) of every column from ``scratch`` back
    into ``rows``.  CPU tensors take :func:`copyback_ref`; CUDA tensors
    launch the kernel."""
    dev = rows.bins.device
    if dev.type == "cpu":
        return copyback_ref(rows, scratch, s0, cnt)
    if dev.type != "cuda":
        raise LightGBMError(f"copyback runs on cuda or cpu, not {dev}")
    check_rows(rows, scratch)
    check_segment(rows.bins.shape[0], s0, cnt)
    if cnt == 0:
        return None
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().partition_copyback(
            *row_pointers(rows), *row_pointers(scratch), rows.bins.shape[1],
            int(s0), int(cnt), stream)
    if rc != 0:
        raise LightGBMError(f"copyback kernel launch failed with CUDA "
                            f"error {rc}")
    copyback.launches += 1
    return None


def partition_scan_p2_ref(rows: PackedRows, scratch: PackedRows,
                          sel: Sequence[int],
                          nleft: torch.Tensor) -> torch.Tensor:
    """Plain version of the pack=2 scan: :func:`partition_scan_ref` over
    the records' fields."""
    return partition_scan_ref(rows.fields(), scratch.fields(), sel, nleft)


def partition_scan_p2(rows: PackedRows, scratch: PackedRows,
                      sel: Sequence[int],
                      nleft: torch.Tensor) -> torch.Tensor:
    """:func:`partition_scan` over records.  CPU tensors take
    :func:`partition_scan_p2_ref`; CUDA tensors launch the kernel on the
    current stream.  ``cnt == 0`` (a dead split) writes ``nleft = 0``
    and launches nothing."""
    dev = rows.buf.device
    if dev.type == "cpu":
        return partition_scan_p2_ref(rows, scratch, sel, nleft)
    if dev.type != "cuda":
        raise LightGBMError(f"partition_scan_p2 runs on cuda or cpu, not "
                            f"{dev}")
    check_packed(rows, scratch)
    check_nleft(nleft, dev)
    s0, cnt = int(sel[SEL_S0]), int(sel[SEL_CNT])
    check_segment(rows.buf.shape[0], s0, cnt)
    if cnt == 0:
        nleft.zero_()
        return nleft
    lay = rows.layout
    f = lay.num_features
    if not 0 <= int(sel[SEL_FEAT]) < f:
        raise LightGBMError(f"split feature {sel[SEL_FEAT]} outside [0, {f})")
    tile_left = torch.empty(-(-cnt // SCAN_TILE), dtype=torch.int32,
                            device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().partition_scan_p2(
            rows.buf.data_ptr(), scratch.buf.data_ptr(), lay.stride, lay.fb,
            tile_left.data_ptr(), nleft.data_ptr(), s0, cnt,
            *split_args(sel), stream)
    if rc != 0:
        raise LightGBMError(f"partition_scan_p2 kernel launch failed with "
                            f"CUDA error {rc}")
    partition_scan_p2.launches += 1
    return nleft


def copyback_p2_ref(rows: PackedRows, scratch: PackedRows, s0: int,
                    cnt: int) -> None:
    """Plain version of the pack=2 copyback: :func:`copyback_ref` over
    the records' fields."""
    copyback_ref(rows.fields(), scratch.fields(), s0, cnt)


def copyback_p2(rows: PackedRows, scratch: PackedRows, s0: int,
                cnt: int) -> None:
    """Move records [s0, s0 + cnt) from ``scratch`` back into ``rows``.
    CPU tensors take :func:`copyback_p2_ref`; CUDA tensors launch the
    kernel."""
    dev = rows.buf.device
    if dev.type == "cpu":
        return copyback_p2_ref(rows, scratch, s0, cnt)
    if dev.type != "cuda":
        raise LightGBMError(f"copyback_p2 runs on cuda or cpu, not {dev}")
    check_packed(rows, scratch)
    check_segment(rows.buf.shape[0], s0, cnt)
    if cnt == 0:
        return None
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().partition_copyback_p2(
            rows.buf.data_ptr(), scratch.buf.data_ptr(), rows.layout.stride,
            int(s0), int(cnt), stream)
    if rc != 0:
        raise LightGBMError(f"copyback_p2 kernel launch failed with CUDA "
                            f"error {rc}")
    copyback_p2.launches += 1
    return None


def partition_3ph(rows: Rows, scratch: Rows, sel: Sequence[int],
                  nleft: torch.Tensor) -> torch.Tensor:
    """The 3-phase partition of the segment ``sel`` describes, in place
    (through ``scratch``), its left count into ``nleft``.  CPU tensors
    take :func:`partition_3ph_ref`; CUDA tensors launch the kernel's
    three passes on the current stream (one launch in the count).
    ``cnt == 0`` (a dead split) writes ``nleft = 0`` and launches
    nothing."""
    dev = rows.bins.device
    if dev.type == "cpu":
        return partition_3ph_ref(rows, scratch, sel, nleft)
    if dev.type != "cuda":
        raise LightGBMError(f"partition_3ph runs on cuda or cpu, not {dev}")
    check_rows(rows, scratch, nleft)
    s0, cnt = int(sel[SEL_S0]), int(sel[SEL_CNT])
    check_segment(rows.bins.shape[0], s0, cnt)
    words = member_words(sel)
    if len(words) > MAX_MEMBER_WORDS:
        raise LightGBMError(f"a split descriptor carries at most "
                            f"{MAX_MEMBER_WORDS} membership words, not "
                            f"{len(words)}")
    if cnt == 0:
        nleft.zero_()
        return nleft
    f = rows.bins.shape[1]
    if not 0 <= int(sel[SEL_FEAT]) < f:
        raise LightGBMError(f"split feature {sel[SEL_FEAT]} outside [0, {f})")
    tiles = -(-cnt // SCAN_TILE)
    tile_left = torch.empty(tiles, dtype=torch.int32, device=dev)
    words_c = (ctypes.c_uint32 * max(len(words), 1))(*words)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib_3ph().partition_3ph(
            *row_pointers(rows), *row_pointers(scratch),
            tile_left.data_ptr(), nleft.data_ptr(), f, s0, cnt,
            *split_args(sel), len(words), words_c, stream)
    if rc != 0:
        raise LightGBMError(f"partition_3ph kernel launch failed with CUDA "
                            f"error {rc}")
    partition_3ph.launches += 1
    return nleft


def partition(rows: Rows, scratch: Rows, sel: Sequence[int],
              nleft: torch.Tensor) -> torch.Tensor:
    """The split's partition: scan into scratch, then copy back (the
    two kernels the TPU path runs per split)."""
    partition_scan(rows, scratch, sel, nleft)
    copyback(rows, scratch, int(sel[SEL_S0]), int(sel[SEL_CNT]))
    return nleft


def partition_p2(rows: PackedRows, scratch: PackedRows, sel: Sequence[int],
                 nleft: torch.Tensor) -> torch.Tensor:
    """:func:`partition` over records: :func:`partition_scan_p2`, then
    :func:`copyback_p2`."""
    partition_scan_p2(rows, scratch, sel, nleft)
    copyback_p2(rows, scratch, int(sel[SEL_S0]), int(sel[SEL_CNT]))
    return nleft


partition_scan.launches = 0
partition_scan_p2.launches = 0
copyback.launches = 0
copyback_p2.launches = 0
partition_3ph.launches = 0
