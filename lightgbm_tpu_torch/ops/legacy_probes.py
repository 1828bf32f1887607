"""The partition-bisection probes' wrappers, launch counts and plain
versions (``csrc/legacy_probes.cu``): the port's counterparts of the
eight Pallas kernels of ``tools/profile_legacy.py`` (TPU rows T1-T8),
driven by :mod:`lightgbm_tpu_torch.tools.profile_legacy`.

Rows are f32 ``[n_alloc, 128]`` holding integers (the script's
``_rows``); ``R`` = 512 rows is the TPU's block, and a grid of ``nb``
blocks covers ``nb * 512`` rows.  The split descriptor ``sel`` is i32
[8] = ``[s0, cnt, feat, sbin, dl, cat, nanb, 0]``.

- :func:`block_copy` (T1, ``part3`` copy / copy3): ``scratch[:nb * 512]
  = rows[:nb * 512]``.
- :func:`partition_dense` (T2, ``part3`` scan / scan2; with 3 phases
  ``make_partition``'s, for ``part2``, ``part3 full`` and ``part8
  real``): the segment ``[s0, s0 + cnt)`` split by ``_go_left`` on the
  f32 column, as :func:`partition_dense_ref` states.
- :func:`compact` (T3-T7, ``part4``-``part8``): the carry-window
  compaction in one of :data:`MECHS`, as :func:`compact_ref` states.
- :func:`hbm_alias_step` (T8): ``comb[dst:dst + 1024] = comb[src:src +
  1024] + 1`` in place, every read before any write.

Each plain version (``*_ref``) computes its function in closed form
(``nonzero`` of the keep mask, whole groups, the zero-filled flush), not
by the TPU's carry loop.  The wrappers make no host read and allocate
only with ``torch.empty``, on the current stream, so a CUDA graph can
capture them (their counts rise at capture, not at replay).  Each takes
its plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from ..utils.log import LightGBMError
from . import _build

R, C = 512, 128
SEL_S0, SEL_CNT, SEL_FEAT, SEL_SBIN, SEL_DL, SEL_CAT, SEL_NANB = range(7)
TILE = 128                     # rows a block of the passes
ALIAS_ROWS, ALIAS_N = 1024, 1 << 16
# csrc/legacy_probes.cu Mech, in order
MECHS = ("nosmem", "grid2", "smem_full", "alias2", "nsplit", "selread",
         "when", "dynoff", "pred", "smemuse", "prefetch", "deadsel",
         "scratchthr", "smem_thr", "noalias", "hbmsel")
S0_FROM_SEL = {"smem_full", "alias2", "nsplit", "dynoff", "pred"}
FULL_PRED = {"smem_full", "alias2", "nsplit", "pred"}
BOUND_LIVE = FULL_PRED | {"when", "dynoff"}
THR_FROM_SEL = {"smem_thr", "noalias", "hbmsel"}
TO_SCRATCH = {"alias2", "nsplit"}
# mechanisms whose kernel takes no sel, and the one that takes it by value
NO_SEL = {"nosmem", "grid2", "scratchthr"}
BY_VALUE = {"prefetch"}


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("legacy_probes")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.legacy_block_copy.argtypes = [i, p, p, i, p]
    lib.legacy_partition_dense.argtypes = [i, p, p, p, p] + [i] * 8 + [p]
    lib.legacy_compact.argtypes = [i, p, p, p, p, p, p, i, i, p]
    lib.legacy_hbm_alias_step.argtypes = [p, i, i, p]
    for fn in (lib.legacy_block_copy, lib.legacy_partition_dense,
               lib.legacy_compact, lib.legacy_hbm_alias_step):
        fn.restype = i
    return lib


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise LightGBMError(f"{name} kernel launch failed with CUDA error "
                            f"{rc}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_rows(*mats: torch.Tensor) -> None:
    shape, dev = mats[0].shape, mats[0].device
    for m in mats:
        if (m.dtype != torch.float32 or m.dim() != 2 or m.shape[1] != C
                or m.shape != shape or m.device != dev
                or not m.is_contiguous() or m.data_ptr() % 16):
            raise LightGBMError(f"the legacy probes want contiguous, 16-byte "
                                f"aligned f32 [n, {C}] matrices of one shape "
                                f"on one device")


def _device(t: torch.Tensor, name: str) -> torch.device:
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise LightGBMError(f"{name} runs on cuda or cpu, not {dev}")
    return dev


# -- T1: block_copy -------------------------------------------------------------
def block_copy_ref(rows: torch.Tensor, scratch: torch.Tensor, nb: int,
                   copy3: bool = False) -> torch.Tensor:
    """Plain version: ``scratch[:nb * 512] = rows[:nb * 512]``."""
    scratch[:nb * R].copy_(rows[:nb * R])
    return scratch


def block_copy(rows: torch.Tensor, scratch: torch.Tensor, nb: int,
               copy3: bool = False) -> torch.Tensor:
    """Copy the first ``nb`` 512-row tiles of ``rows`` into ``scratch``
    through shared memory; ``copy3`` launches a grid three times as
    large whose extra blocks exit at once.  Returns ``scratch``."""
    dev = _device(rows, "block_copy")
    if dev.type == "cpu":
        return block_copy_ref(rows, scratch, nb, copy3)
    _check_rows(rows, scratch)
    if not 0 < nb * R <= rows.shape[0]:
        raise LightGBMError(f"block_copy of {nb} tiles over {rows.shape[0]} "
                            f"rows")
    with torch.cuda.device(dev):
        rc = _lib().legacy_block_copy(3 if copy3 else 1, rows.data_ptr(),
                                      scratch.data_ptr(), int(nb),
                                      _stream(dev))
    _raise_on(rc, "block_copy")
    block_copy.launches += 1
    return scratch


block_copy.launches = 0


# -- T2: partition_dense --------------------------------------------------------
def go_left(col: torch.Tensor, sel: Sequence[int]) -> torch.Tensor:
    """``partition_kernel._go_left`` on the f32 column."""
    sbin = float(sel[SEL_SBIN])
    nanb = int(sel[SEL_NANB])
    at_nan = (col == float(nanb)) if nanb >= 0 else torch.zeros_like(
        col, dtype=torch.bool)
    num = (col <= sbin) & ~at_nan | at_nan & (int(sel[SEL_DL]) > 0)
    return (col == sbin) if int(sel[SEL_CAT]) > 0 else num


def column(rows: torch.Tensor, lo: int, hi: int, feat: int) -> torch.Tensor:
    """The split column of rows [lo, hi): 0 for a feature outside [0,
    128), as the TPU's one-hot matvec gives."""
    if 0 <= feat < C:
        return rows[lo:hi, feat]
    return torch.zeros(max(hi - lo, 0), dtype=rows.dtype, device=rows.device)


def _flush_end(lo: int, k: int) -> int:
    """End of the 512-row flush that carries the last of ``k`` rows
    written from ``lo`` (``lo`` when ``k`` is whole groups)."""
    return lo + -(-k // R) * R if k % R else lo


def partition_dense_ref(phases: int, rows: torch.Tensor,
                        scratch: torch.Tensor,
                        sel: Sequence[int]) -> torch.Tensor:
    """Plain version of :func:`partition_dense`; returns nsplit i32 [1].

    The segment ``[s0, s0 + cnt)`` splits into its left rows (``go_left``)
    and right rows, each in order.  Phase 1 writes the left rows to
    ``scratch[s0:s0 + nleft]`` and zeros the rest of their last 512-row
    flush; nsplit 0.  Phase 2 also writes the right rows to
    ``scratch[s0 + nleft:s0 + cnt]`` and zeros past ``s0 + cnt`` to the
    end of the later of the two flushes; nsplit = nleft.  Phase 3 then
    copies ``scratch[s0:s0 + cnt]`` back into ``rows``.  No other row
    changes (the zeros stop at the matrix's end)."""
    s0, cnt = int(sel[SEL_S0]), int(sel[SEL_CNT])
    nsplit = torch.zeros(1, dtype=torch.int32, device=rows.device)
    if cnt <= 0:
        return nsplit
    n = rows.shape[0]
    gl = go_left(column(rows, s0, s0 + cnt, int(sel[SEL_FEAT])), sel)
    left = torch.nonzero(gl).flatten() + s0
    right = torch.nonzero(~gl).flatten() + s0
    nl = left.numel()
    scratch[s0:s0 + nl] = rows[left]
    if phases == 1:
        scratch[s0 + nl:min(_flush_end(s0, nl), n)] = 0.0
        return nsplit
    scratch[s0 + nl:s0 + cnt] = rows[right]
    end = max(_flush_end(s0, nl), _flush_end(s0 + nl, cnt - nl))
    scratch[s0 + cnt:min(end, n)] = 0.0
    if phases == 3:
        rows[s0:s0 + cnt] = scratch[s0:s0 + cnt]
    nsplit.fill_(nl)
    return nsplit


def partition_dense(phases: int, rows: torch.Tensor, scratch: torch.Tensor,
                    sel: Sequence[int]) -> torch.Tensor:
    """The dense-row partition of ``sel``'s segment with ``phases`` 1-3
    (host ints ``sel``); returns nsplit i32 [1].  CPU tensors take
    :func:`partition_dense_ref`; CUDA tensors launch the kernel's passes
    on the current stream (one launch in the count).  ``cnt == 0`` (a
    dead call) writes nsplit 0 and launches nothing."""
    dev = _device(rows, "partition_dense")
    if dev.type == "cpu":
        return partition_dense_ref(phases, rows, scratch, sel)
    _check_rows(rows, scratch)
    if phases not in (1, 2, 3):
        raise LightGBMError(f"partition_dense runs 1, 2 or 3 phases, not "
                            f"{phases}")
    s0, cnt = int(sel[SEL_S0]), int(sel[SEL_CNT])
    if s0 < 0 or cnt < 0 or s0 + cnt > rows.shape[0]:
        raise LightGBMError(f"segment [{s0}, {s0 + cnt}) is outside the "
                            f"{rows.shape[0]}-row matrix")
    if cnt == 0:
        return torch.zeros(1, dtype=torch.int32, device=dev)
    tiles = -(-cnt // TILE)
    work = torch.empty(2 * tiles + 1, dtype=torch.int32, device=dev)
    nsplit = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().legacy_partition_dense(
            int(phases), rows.data_ptr(), scratch.data_ptr(),
            work.data_ptr(), nsplit.data_ptr(), rows.shape[0], s0, cnt,
            *[int(sel[k]) for k in (SEL_FEAT, SEL_SBIN, SEL_DL, SEL_CAT,
                                    SEL_NANB)], _stream(dev))
    _raise_on(rc, f"partition_dense<{phases}>")
    partition_dense.launches += 1
    return nsplit


partition_dense.launches = 0


# -- T3-T7: compact -------------------------------------------------------------
def _sel_values(mech: str, sel) -> list:
    if mech in NO_SEL:
        return []
    if isinstance(sel, torch.Tensor):
        return [int(v) for v in sel.tolist()]
    return [int(v) for v in sel]


def compact_ref(mech: str, rows: torch.Tensor, nb: int, sel=None,
                scratch: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor], int]:
    """Plain version of :func:`compact`: (out, nsplit or None, written).

    The region is rows ``[s0, s0 + blocks * 512)`` (cut at the matrix's
    end): s0 is ``sel[0]`` for :data:`S0_FROM_SEL`, else 0; ``blocks``
    is ``ceil(sel[1] / 512)`` for :data:`BOUND_LIVE`, else ``nb``.  A row
    is kept when ``go_left`` holds and its offset in the region is below
    ``sel[1]`` (:data:`FULL_PRED`), else when its column 3 is at most the
    threshold (``sel[3]`` for :data:`THR_FROM_SEL`, else 127).  With T
    kept rows, the first ``written = T // 512 * 512`` are written in
    order from ``out[s0]``; ``nsplit`` writes all T, zeros the rest of
    their last 512-row group and returns T.  ``out`` is ``rows`` (in
    place), ``scratch`` (:data:`TO_SCRATCH`) or, for ``noalias``, a new
    tensor whose rows past ``written`` are NaN here (undefined in the
    kernel's)."""
    v = _sel_values(mech, sel)
    n = rows.shape[0]
    s0 = v[SEL_S0] if mech in S0_FROM_SEL else 0
    blocks = -(-v[SEL_CNT] // R) if mech in BOUND_LIVE else nb
    lo, hi = s0, min(s0 + max(blocks, 0) * R, n)
    if mech in FULL_PRED:
        keep = go_left(column(rows, lo, hi, v[SEL_FEAT]), v) & (
            torch.arange(max(hi - lo, 0), device=rows.device) < v[SEL_CNT])
    else:
        thr = float(v[SEL_SBIN]) if mech in THR_FROM_SEL else 127.0
        keep = column(rows, lo, hi, 3) <= thr
    kept = torch.nonzero(keep).flatten() + lo
    total = kept.numel()
    written = total if mech == "nsplit" else total // R * R
    moved = rows[kept[:written]]
    if mech == "noalias":
        out = torch.full_like(rows, float("nan"))
    else:
        out = scratch if mech in TO_SCRATCH else rows
    out[s0:s0 + written] = moved
    nsplit = None
    if mech == "nsplit":
        out[s0 + total:min(_flush_end(s0, total), n)] = 0.0
        nsplit = torch.full((1,), total, dtype=torch.int32,
                            device=rows.device)
    return out, nsplit, written


def _check_sel(sel, dev) -> None:
    if (not isinstance(sel, torch.Tensor) or sel.device != dev
            or sel.dtype != torch.int32 or sel.numel() != 8
            or not sel.is_contiguous() or sel.data_ptr() % 16):
        raise LightGBMError("sel must be a contiguous, 16-byte aligned i32 "
                            "[8] tensor on the rows' device")


def compact(mech: str, rows: torch.Tensor, nb: int, sel=None,
            scratch: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The carry-window compaction of ``mech`` over a grid of ``nb``
    512-row blocks; returns (out, nsplit i32 [1] for ``nsplit``, else
    None).  ``sel`` is the device i32 [8] the kernel reads (host ints for
    ``prefetch``, unused for :data:`NO_SEL`); ``scratch`` receives the
    rows for :data:`TO_SCRATCH`.  CPU tensors take :func:`compact_ref`;
    CUDA tensors launch the kernel's passes on the current stream (one
    launch in the count)."""
    if mech not in MECHS:
        raise LightGBMError(f"compact mechanism must be one of {MECHS}")
    dev = _device(rows, "compact")
    if dev.type == "cpu":
        out, nsplit, _ = compact_ref(mech, rows, nb, sel, scratch)
        return out, nsplit
    if mech in TO_SCRATCH and scratch is None:
        raise LightGBMError(f"compact<{mech}> writes into scratch")
    _check_rows(*((rows, scratch) if mech in TO_SCRATCH else (rows,)))
    if not 0 < nb * R <= rows.shape[0]:
        raise LightGBMError(f"compact over {nb} blocks of {rows.shape[0]} "
                            f"rows")
    sel_ptr, selv = None, None
    if mech in BY_VALUE:
        selv = (ctypes.c_int * 8)(*[int(x) for x in sel])
    elif mech not in NO_SEL:
        _check_sel(sel, dev)
        sel_ptr = sel.data_ptr()
    if mech == "noalias":
        out = torch.empty_like(rows)
    else:
        out = scratch if mech in TO_SCRATCH else rows
    tiles = nb * (R // TILE)
    work = torch.empty(3 * tiles + 2, dtype=torch.int32, device=dev)
    nsplit = (torch.empty(1, dtype=torch.int32, device=dev)
              if mech == "nsplit" else None)
    with torch.cuda.device(dev):
        rc = _lib().legacy_compact(
            MECHS.index(mech), sel_ptr, selv, rows.data_ptr(),
            out.data_ptr(), work.data_ptr(),
            None if nsplit is None else nsplit.data_ptr(), rows.shape[0],
            int(nb), _stream(dev))
    _raise_on(rc, f"compact<{mech}>")
    compact.launches += 1
    return out, nsplit


compact.launches = 0


# -- T8: hbm_alias_step -----------------------------------------------------------
def _check_window(comb: torch.Tensor, src: int, dst: int) -> None:
    n = comb.shape[0]
    if not (0 <= src <= n - ALIAS_ROWS and 0 <= dst <= n - ALIAS_ROWS):
        raise LightGBMError(f"hbm_alias_step windows [{src}, +{ALIAS_ROWS}) "
                            f"and [{dst}, +{ALIAS_ROWS}) must lie in the "
                            f"{n}-row matrix")


def hbm_alias_step_ref(comb: torch.Tensor, src: int,
                       dst: int) -> torch.Tensor:
    """Plain version: ``comb[dst:dst + 1024] = comb[src:src + 1024] + 1``
    with the source read before the write."""
    _check_window(comb, src, dst)
    comb[dst:dst + ALIAS_ROWS] = comb[src:src + ALIAS_ROWS] + 1.0
    return comb


def hbm_alias_step(comb: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """Rows ``[dst, dst + 1024)`` of ``comb`` f32 [65536, 128] become rows
    ``[src, src + 1024)`` + 1, in place, every read before any write
    (the windows may overlap).  CPU tensors take
    :func:`hbm_alias_step_ref`; CUDA tensors launch the kernel."""
    dev = _device(comb, "hbm_alias_step")
    if dev.type == "cpu":
        return hbm_alias_step_ref(comb, src, dst)
    _check_rows(comb)
    if comb.shape[0] != ALIAS_N:
        raise LightGBMError(f"hbm_alias_step wants comb f32 [{ALIAS_N}, {C}]")
    _check_window(comb, src, dst)
    with torch.cuda.device(dev):
        rc = _lib().legacy_hbm_alias_step(comb.data_ptr(), int(src),
                                          int(dst), _stream(dev))
    _raise_on(rc, "hbm_alias_step")
    hbm_alias_step.launches += 1
    return comb


hbm_alias_step.launches = 0

COUNTED = (block_copy, partition_dense, compact, hbm_alias_step)


def smem_bytes(kind: str) -> int:
    """Dynamic shared memory of a launch (the library's
    ``legacy_smem_bytes``): 64 KiB for ``block_copy`` and for the move
    pass of an in-place ``compact``, none otherwise."""
    return {"block_copy": 64 * 1024, "compact_move": TILE * C * 4}.get(
        kind, 0)
