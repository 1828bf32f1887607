"""The launch-cost probes' wrappers, launch counts and plain versions
(``csrc/probes.cu``): the port's counterparts of the TPU
microbenchmark kernels under ``tools/``, driven by
:mod:`lightgbm_tpu_torch.tools.profile_pallas_ov` and
:mod:`lightgbm_tpu_torch.tools.profile_step_cost`.

- :func:`select_update` (``tools/profile_pallas_ov.py`` ``_select_kernel``):
  one block updates a leaf state f32 ``[255, 20]`` in place (argmax of
  column 0, the chosen row plus ``(row + 1) - row``) and returns sel f32
  ``[8]``; :func:`select_update_loop` launches it ``k`` times from C.
- :func:`step_cost` (``tools/profile_step_cost.py`` ``kern``): one block
  per 512-row step of rows f32 ``[n, 128]``, in four variants
  (:data:`VARIANTS`), an i32 ``[1]`` result.
- :func:`stream_tiles` (the same file's ``dma_bs``): each block streams
  its 512-row tile through shared memory; the sum of
  ``int32(rows[512 b, 0])``.

Each result is an exact function of its inputs, and each plain version
(``*_ref``) computes it in closed form, reading only the elements the
function needs (the integer ones in int64 and wrapped to int32 as the
kernels' integer sums wrap).  The wrappers make no host read and
allocate only their outputs with ``torch.empty``, on the current stream
read at every call, so a CUDA graph can capture them: their launch
counts rise at capture, not at replay.  Each wrapper takes its plain
version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.log import LightGBMError
from . import _build

# the leaf state of tools/profile_pallas_ov.py: L leaves x 20 columns
LEAVES, COLS, SEL = 255, 20, 8
# one TPU grid step's block of rows (tools/profile_step_cost.py R, C)
TILE_ROWS, TILE_COLS = 512, 128
VARIANTS = ("empty", "smemrw", "dma_nw", "waits")


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor wrapped to int32 (two's complement)."""
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("probes")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.select_update.argtypes = [p, p, p]
    lib.select_update_loop.argtypes = [p, p, i, p]
    lib.step_cost.argtypes = [i, p, p, p, i, p]
    lib.stream_tiles.argtypes = [p, p, i, p]
    for fn in (lib.select_update, lib.select_update_loop, lib.step_cost,
               lib.stream_tiles):
        fn.restype = i
    return lib


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise LightGBMError(f"{name} kernel launch failed with CUDA error "
                            f"{rc}")


# -- T11: select_update -------------------------------------------------------
def argmax_first(col: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax`` of a float vector as a 0-d i64 tensor: the first
    NaN if there is one, else the first index of the maximum; no host
    read."""
    nan = torch.isnan(col)
    top = torch.where(nan, torch.full_like(col, -float("inf")), col).max()
    cand = torch.where(nan.any(), nan, col == top)
    return torch.argmax(cand.to(torch.int32))


def select_update_ref(leafs: torch.Tensor) -> torch.Tensor:
    """Plain version: the TPU kernel's formula on ``leafs`` f32
    ``[255, 20]`` in place, in its f32 order; returns sel f32 ``[8]``.
    ``row`` is the one-hot masked column sum (``leafs[leaf]`` where every
    other row of a column is finite; its other terms are signed zeros, so
    its value does not depend on the order of the additions; ``0.0 +``
    takes the sum's +0 start)."""
    leaf = argmax_first(leafs[:, 0])
    oh = (torch.arange(LEAVES, device=leafs.device) == leaf).to(
        torch.float32)[:, None]
    row = 0.0 + (leafs * oh).sum(dim=0)
    d = (row + 1.0) - row
    leafs.copy_(leafs + (oh * d[None, :]) * oh)
    sel = torch.zeros(SEL, dtype=torch.float32, device=leafs.device)
    sel[0] = leaf.to(torch.float32)
    sel[1] = row[0]
    return sel


def _check_leafs(leafs: torch.Tensor) -> None:
    if (leafs.dtype != torch.float32 or tuple(leafs.shape) != (LEAVES, COLS)
            or not leafs.is_contiguous()):
        raise LightGBMError(f"select_update wants a contiguous f32 "
                            f"[{LEAVES}, {COLS}] leaf state")


def select_update(leafs: torch.Tensor) -> torch.Tensor:
    """One select-and-update of ``leafs`` in place; returns sel f32 [8].
    CPU tensors take :func:`select_update_ref`; CUDA tensors launch the
    kernel on the current stream."""
    dev = leafs.device
    if dev.type == "cpu":
        return select_update_ref(leafs)
    if dev.type != "cuda":
        raise LightGBMError(f"select_update runs on cuda or cpu, not {dev}")
    _check_leafs(leafs)
    sel = torch.empty(SEL, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().select_update(leafs.data_ptr(), sel.data_ptr(), stream)
    _raise_on(rc, "select_update")
    select_update.launches += 1
    return sel


select_update.launches = 0


def select_update_loop(leafs: torch.Tensor, k: int) -> torch.Tensor:
    """``k`` select-and-updates of ``leafs`` in place, launched from C in
    one call (no Python between launches); returns the last sel.  CPU
    tensors take ``k`` :func:`select_update_ref` calls."""
    dev = leafs.device
    if dev.type == "cpu":
        sel = torch.zeros(SEL, dtype=torch.float32)
        for _ in range(k):
            sel = select_update_ref(leafs)
        return sel
    if dev.type != "cuda":
        raise LightGBMError(f"select_update runs on cuda or cpu, not {dev}")
    _check_leafs(leafs)
    sel = torch.zeros(SEL, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().select_update_loop(leafs.data_ptr(), sel.data_ptr(),
                                       int(k), stream)
    _raise_on(rc, "select_update")
    select_update.launches += int(k)
    return sel


# -- T10 and T9: step_cost, stream_tiles -------------------------------------
def _steps(rows: torch.Tensor) -> int:
    n = rows.shape[0]
    if (rows.dim() != 2 or rows.shape[1] != TILE_COLS or n <= 0
            or n % TILE_ROWS):
        raise LightGBMError(f"the probes want rows f32 [n, {TILE_COLS}] "
                            f"with n a positive multiple of {TILE_ROWS}")
    return n // TILE_ROWS


def _default_sel(rows: torch.Tensor) -> torch.Tensor:
    """sel i32 [2] = (0, n) on the rows' device, made there."""
    return torch.arange(2, dtype=torch.int32, device=rows.device) \
        * rows.shape[0]


def _check_rows(rows: torch.Tensor) -> None:
    if (rows.dtype != torch.float32 or not rows.is_contiguous()
            or rows.data_ptr() % 16):
        raise LightGBMError("the probes want contiguous, 16-byte aligned "
                            "f32 rows")


def step_cost_ref(variant: str, rows: torch.Tensor,
                  sel: torch.Tensor = None) -> torch.Tensor:
    """Plain version of :func:`step_cost`, closed form, i32 [1]: reads
    ``sel`` and the row count, not the rows."""
    nb = _steps(rows)
    if variant not in VARIANTS:
        raise LightGBMError(f"step_cost variant must be one of {VARIANTS}")
    s = (_default_sel(rows) if sel is None else sel).to(torch.int64)
    if variant == "empty":
        total = s[:1]
    elif variant == "smemrw":
        blk = torch.arange(nb, dtype=torch.int64, device=rows.device)
        total = s[:1] + (blk + torch.div(s[1], blk + 1,
                                         rounding_mode="floor")).sum()
    else:
        total = s[:1] + nb
    return _wrap32(total)


def step_cost(variant: str, rows: torch.Tensor,
              sel: torch.Tensor = None) -> torch.Tensor:
    """One grid-step-cost launch of ``variant`` over ``rows`` f32 [n, 128]
    (``sel`` i32 [2], default (0, n)); returns i32 [1].  CPU tensors take
    :func:`step_cost_ref`; CUDA tensors launch the kernel on the current
    stream."""
    dev = rows.device
    if dev.type == "cpu":
        return step_cost_ref(variant, rows, sel)
    if dev.type != "cuda":
        raise LightGBMError(f"step_cost runs on cuda or cpu, not {dev}")
    if variant not in VARIANTS:
        raise LightGBMError(f"step_cost variant must be one of {VARIANTS}")
    nb = _steps(rows)
    _check_rows(rows)
    if sel is None:
        sel = _default_sel(rows)
    elif (sel.device != dev or sel.dtype != torch.int32
          or sel.numel() != 2 or not sel.is_contiguous()):
        raise LightGBMError("sel must be a contiguous i32 [2] tensor on the "
                            "rows' device")
    out = torch.empty(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().step_cost(VARIANTS.index(variant), sel.data_ptr(),
                              rows.data_ptr(), out.data_ptr(), nb, stream)
    _raise_on(rc, f"step_cost<{variant}>")
    step_cost.launches += 1
    return out


step_cost.launches = 0


def stream_tiles_ref(rows: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`stream_tiles`, i32 [1]: reads the first
    element of each 512-row tile."""
    _steps(rows)
    firsts = rows[::TILE_ROWS, 0].to(torch.int32).to(torch.int64)
    return _wrap32(firsts.sum().reshape(1))


def stream_tiles(rows: torch.Tensor) -> torch.Tensor:
    """Stream every 512-row tile of ``rows`` f32 [n, 128] through shared
    memory; returns i32 [1], the sum of ``int32(rows[512 b, 0])``.  CPU
    tensors take :func:`stream_tiles_ref`; CUDA tensors launch the
    kernel on the current stream."""
    dev = rows.device
    if dev.type == "cpu":
        return stream_tiles_ref(rows)
    if dev.type != "cuda":
        raise LightGBMError(f"stream_tiles runs on cuda or cpu, not {dev}")
    nb = _steps(rows)
    _check_rows(rows)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().stream_tiles(rows.data_ptr(), out.data_ptr(), nb, stream)
    _raise_on(rc, "stream_tiles")
    stream_tiles.launches += 1
    return out


stream_tiles.launches = 0


def smem_bytes(variant: str) -> int:
    """Dynamic shared memory of a launch (the library's
    ``probes_smem_bytes``): one 64 KiB piece for ``dma_nw``, two for
    ``stream_tiles``, none otherwise."""
    piece = 64 * 1024
    return {"dma_nw": piece, "stream_tiles": 2 * piece}.get(variant, 0)
