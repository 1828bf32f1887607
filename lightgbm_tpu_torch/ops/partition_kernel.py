"""Partition of one leaf segment of the row matrix: the wrappers of
``csrc/partition.cu`` (scan and copyback) and ``csrc/partition_3ph.cu``
(the 3-phase partition), their launch counts and their plain PyTorch
versions.

Counterpart of ``lightgbm_tpu/ops/pallas/partition_kernel2.py``
(``make_partition_ss`` with ``partition_kernel3.make_partition_perm``'s
packing, and ``copyback_call``) and of
``lightgbm_tpu/ops/pallas/partition_kernel.py`` (``make_partition``,
behind ``LGBM_TPU_PART=3ph``).  The split descriptor is
:mod:`.descriptor`'s (the layout of ``partition_kernel.py``) and the
predicate is ``_go_left``'s.  After :func:`partition` the segment holds its left
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

The scans (:func:`partition_scan`, :func:`partition_scan_p2` and the
first launch of :func:`partition_3ph`) run one kernel,
``csrc/partition_scan.cuh`` ``scan_tiles``: a block a tile of rows
staged in shared memory (the bins or records left in global memory
where the rows are too wide to stage), the tiles chained by a decoupled
look-back through a state each call allocates on the caller's stream
and the library zeroes there; :func:`scan_geometry` gives the tile, the
staging and the shared memory.  The wrappers make no host read, so a
CUDA graph can capture them.

A descriptor of the sorted-subset routes carries up to
``descriptor.MAX_MEMBER_WORDS`` membership words after its eight slots;
every entry passes them to its kernel (``part::pred_left``); more words
raise.

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch

from ..utils.log import LightGBMError
from . import _build
from .descriptor import (MAX_MEMBER_WORDS, SEL_CAT, SEL_CNT, SEL_DL,
                         SEL_FEAT, SEL_MEMBER, SEL_NANB, SEL_S0, SEL_SBIN,
                         member_words)
from .device_data import PackedRows, Rows, check_packed

# rows per count tile of the fused split's partition pass
# (csrc/partition_common.cuh kTile)
SCAN_TILE = 1024
# the scan kernel (csrc/partition_scan.cuh): threads a block, the tile
# sizes it takes (a multiple of 32 up to 1,024 rows), the shared memory
# a block may use on the H100 and the kernel's static part of it (perm,
# the group masks and prefixes, three ints, 2,316 B, which the compiler
# rounds to 16; analysis/resources_sm90a.txt),
# and the most a tile stages unless a tile is asked for (PERF.md: 256
# rows at 28 features and at pack=2, 128 at 136 features were the
# fastest or within 5 % of it at every segment size timed)
SCAN_THREADS = 256
SCAN_TILES = (1024, 512, 256, 128, 64, 32)
MAX_SMEM = 232_448
SCAN_STATIC_SMEM = 2_320
SCAN_SMEM_BUDGET = 24 * 1024


class ScanGeometry(NamedTuple):
    """One scan launch: ``tile`` rows a block, ``tiles`` blocks of
    ``SCAN_THREADS`` threads, ``smem`` dynamic shared bytes a block,
    ``staged`` whether the bins (records at pack=2) pass through it."""
    tile: int
    tiles: int
    smem: int
    staged: bool


def stage_bytes(n: int) -> int:
    """Shared bytes staging ``n`` bytes from a 4-byte-aligned address
    (``partition_scan.cuh`` ``stage_bytes``)."""
    return (n + 16 + 15) // 16 * 16


def scan_smem(tile: int, num_features: int = 0,
              record_stride: Optional[int] = None,
              staged: bool = True) -> int:
    """A scan block's dynamic shared memory: ``tile`` rows of the five
    arrays at ``num_features`` bins (the four value arrays alone
    unstaged), or ``tile`` records of ``record_stride`` bytes (none
    unstaged) (``scan_smem`` / ``scan_smem_rec``)."""
    if record_stride is not None:
        return stage_bytes(tile * record_stride) if staged else 0
    return ((stage_bytes(tile * num_features) if staged else 0)
            + stage_bytes(12 * tile) + 2 * stage_bytes(4 * tile)
            + stage_bytes(8 * tile))


@functools.lru_cache(maxsize=None)
def _scan_launch(num_features: int, record_stride: Optional[int],
                 tile: Optional[int], staged: Optional[bool]) -> tuple:
    """(tile, smem, staged) of :func:`scan_geometry`, which depends on
    the row's width and the overrides only (kept: a split's wrapper call
    asks for it)."""
    def fits(t, st, limit):
        return scan_smem(t, num_features, record_stride, st) <= limit
    if tile is None:
        modes = (True, False) if staged is None else (staged,)
        fitting = [(t, st) for st in modes for t in SCAN_TILES
                   if fits(t, st, SCAN_SMEM_BUDGET)]
        tile, staged = fitting[0] if fitting else (SCAN_TILES[-1], staged)
    if tile not in SCAN_TILES:
        raise LightGBMError(f"a scan tile is one of {SCAN_TILES} rows, "
                            f"not {tile}")
    room = MAX_SMEM - SCAN_STATIC_SMEM
    if staged is None:
        staged = fits(tile, True, room)
    smem = scan_smem(tile, num_features, record_stride, staged)
    if smem > room:
        raise LightGBMError(
            f"a staged {tile}-row scan tile of "
            f"{record_stride or num_features + 28}-byte rows needs {smem} "
            f"bytes of shared memory beside the kernel's "
            f"{SCAN_STATIC_SMEM}, over the {MAX_SMEM} a block may use")
    return tile, smem, bool(staged)


def scan_geometry(cnt: int, num_features: int = 0,
                  record_stride: Optional[int] = None,
                  tile: Optional[int] = None,
                  staged: Optional[bool] = None) -> ScanGeometry:
    """The scan's launch over a ``cnt``-row segment: the largest tile of
    :data:`SCAN_TILES` whose staging fits :data:`SCAN_SMEM_BUDGET` with
    the bins (records) staged, else the largest that fits with them
    unstaged, read from global memory (rows of about 740 features or
    more, records of more than 736 bytes); ``ceil(cnt / tile)``
    blocks.  ``tile`` and ``staged`` override the choice (a given tile
    is staged when a block holds it).  Raises when the tile is not one
    the kernel takes or a staged one does not fit a block."""
    t, smem, st = _scan_launch(int(num_features), record_stride, tile,
                               staged)
    return ScanGeometry(t, -(-int(cnt) // t), smem, st)


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


def word_args(sel: Sequence[int]) -> list:
    """(nwords, words) of a descriptor: the kernels' membership-word
    arguments, the words as a C array of u32 (one zero word where there
    are none, so the pointer is never null)."""
    words = member_words(sel)
    return [len(words), (ctypes.c_uint32 * max(len(words), 1))(*words)]


def check_words(sel: Sequence[int]) -> int:
    """The descriptor's word count; raises above
    ``MAX_MEMBER_WORDS`` (no kernel reads more: a wider bitset is the
    ``cat_overwide`` route's, which partitions in PyTorch)."""
    n = len(sel) - SEL_MEMBER if len(sel) > SEL_MEMBER else 0
    if n > MAX_MEMBER_WORDS:
        raise LightGBMError(f"a split descriptor carries at most "
                            f"{MAX_MEMBER_WORDS} membership words, not {n}")
    return n


def check_segment(n: int, s0: int, cnt: int) -> None:
    """Raise unless [s0, s0 + cnt) lies inside an ``n``-row matrix."""
    if s0 < 0 or cnt < 0 or s0 + cnt > n:
        raise LightGBMError(f"segment [{s0}, {s0 + cnt}) is outside the "
                            f"{n}-row matrix")


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("partition")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.partition_scan.argtypes = ([p] * 12 + [i] * 8 + [i, p] + [i] * 2
                                   + [p])
    lib.partition_scan.restype = i
    lib.partition_copyback.argtypes = [p] * 10 + [i] * 3 + [p]
    lib.partition_copyback.restype = i
    lib.partition_copyback_p2.argtypes = [p, p, i, i, i, p]
    lib.partition_copyback_p2.restype = i
    lib.partition_scan_p2.argtypes = ([p, p, i, i, p, p] + [i] * 7 + [i, p]
                                      + [i] * 2 + [p])
    lib.partition_scan_p2.restype = i
    return lib


@functools.lru_cache(maxsize=1)
def _lib_3ph():
    lib = _build.load("partition_3ph")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.partition_3ph.argtypes = [p] * 12 + [i] * 9 + [p, i, i, p]
    lib.partition_3ph.restype = i
    return lib


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise LightGBMError(f"{name} kernel launch failed with CUDA error "
                            f"{rc}")


def launch_scan(rows, scratch, sel: Sequence[int], nleft: torch.Tensor,
                geo: ScanGeometry, scheme: str = "ss") -> None:
    """Launch the scan of a checked, live segment on ``geo``: ``scheme``
    ``ss`` (:func:`partition_scan`, or :func:`partition_scan_p2` for
    records) or ``3ph`` (:func:`partition_3ph`'s two launches).  The
    look-back state, i64 ``[1 + geo.tiles]``, is allocated here on the
    current stream, so calls on other streams never share it and a
    graph keeps the one it captured; the library zeroes it on the
    stream before the kernel."""
    packed = isinstance(rows, PackedRows)
    dev = rows.buf.device if packed else rows.bins.device
    s0, cnt = int(sel[SEL_S0]), int(sel[SEL_CNT])
    with torch.cuda.device(dev):
        state = torch.empty(1 + geo.tiles, dtype=torch.int64, device=dev)
        tail = [*word_args(sel), geo.tile, int(geo.staged),
                torch.cuda.current_stream(dev).cuda_stream]
        if packed:
            lay = rows.layout
            rc = _lib().partition_scan_p2(
                rows.buf.data_ptr(), scratch.buf.data_ptr(), lay.stride,
                lay.fb, state.data_ptr(), nleft.data_ptr(), s0, cnt,
                *split_args(sel), *tail)
            return _raise_on(rc, "partition_scan_p2")
        head = [*row_pointers(rows), *row_pointers(scratch),
                state.data_ptr(), nleft.data_ptr(), rows.bins.shape[1], s0,
                cnt, *split_args(sel)]
        if scheme == "3ph":
            rc = _lib_3ph().partition_3ph(*head, *tail)
            return _raise_on(rc, "partition_3ph")
        return _raise_on(_lib().partition_scan(*head, *tail),
                         "partition_scan")


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
    check_words(sel)
    if cnt == 0:
        nleft.zero_()
        return nleft
    f = rows.bins.shape[1]
    if not 0 <= int(sel[SEL_FEAT]) < f:
        raise LightGBMError(f"split feature {sel[SEL_FEAT]} outside [0, {f})")
    launch_scan(rows, scratch, sel, nleft, scan_geometry(cnt, f))
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
    check_words(sel)
    if cnt == 0:
        nleft.zero_()
        return nleft
    lay = rows.layout
    f = lay.num_features
    if not 0 <= int(sel[SEL_FEAT]) < f:
        raise LightGBMError(f"split feature {sel[SEL_FEAT]} outside [0, {f})")
    launch_scan(rows, scratch, sel, nleft,
                scan_geometry(cnt, record_stride=lay.stride))
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
    take :func:`partition_3ph_ref`; CUDA tensors launch the scan and the
    reversing copyback on the current stream (one launch in the
    count).
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
    check_words(sel)
    if cnt == 0:
        nleft.zero_()
        return nleft
    f = rows.bins.shape[1]
    if not 0 <= int(sel[SEL_FEAT]) < f:
        raise LightGBMError(f"split feature {sel[SEL_FEAT]} outside [0, {f})")
    launch_scan(rows, scratch, sel, nleft, scan_geometry(cnt, f),
                scheme="3ph")
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
