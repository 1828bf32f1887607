"""The static analyzer's fixture kernels (``csrc/analysis_fixtures.cu``):
wrappers, launch counts and plain versions.

Counterparts of the red-team Pallas kernels of
``lightgbm_tpu/analysis/fixtures``, each of which breaks one rule of the
TPU and is flagged by one pass of the JAX package's analyzer.  Here each
kernel is right at its legal geometry, and
``lightgbm_tpu_torch/analysis/fixtures`` registers it a second time at a
seeded geometry that breaks the port's own rule; the wrappers refuse a
seeded geometry before any launch.

- :func:`stage_copy` (``_bad_lane``, ``_bad_cat``, ``_bad_serve_kernel``,
  ``_bad_mc_batch``): rows ``[0, rows)`` of ``x`` ``[R, C]`` or of each
  class slice of ``x`` ``[K, R, C]`` (f32 or i32) copied through shared
  memory in 16-byte words; the other rows of the result are zero.  The
  rule: every row is whole 16-byte words (:func:`stage_rule_broken`).
- :func:`smem_acc` (``_bad_vmem``): ``x`` ``[nblk * block_rows, C]``
  f32 copied block by block beside a zeroed accumulator of ``acc_bytes``
  of dynamic shared memory.  The rule: ``acc_bytes <= MAX_SMEM``.
- :func:`scale_bias` (``bad_host_ast.py``'s ``build``): ``x * scale +
  bias`` with ``scale`` and ``bias`` f32 tensors of one element on the
  rows' device, read in the kernel (the product rounded before the sum).

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.log import LightGBMError
from . import _build

# 16-byte words: the unit fixture_stage_copy moves
STAGE_WORD = 16
MAX_SMEM = 232448


def stage_rule_broken(row_bytes: int, base_offset: int = 0) -> bool:
    """Whether a tensor of ``row_bytes`` a row at ``base_offset`` bytes
    breaks the 16-byte word rule of :func:`stage_copy`."""
    return row_bytes % STAGE_WORD != 0 or base_offset % STAGE_WORD != 0


def stage_copy_ref(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Plain version: rows ``[0, rows)`` of ``x`` (of each class slice
    when ``x`` is 3-D), the other rows zero."""
    out = torch.zeros_like(x)
    out[..., :rows, :] = x[..., :rows, :]
    return out


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("analysis_fixtures")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.analysis_stage_copy.argtypes = [p, p, i, i, i, i, ll, p]
    lib.analysis_stage_copy.restype = i
    lib.analysis_stage_copy_smem_bytes.argtypes = [i, i]
    lib.analysis_stage_copy_smem_bytes.restype = i
    lib.analysis_smem_acc.argtypes = [p, p, i, i, i, p]
    lib.analysis_smem_acc.restype = i
    lib.analysis_scale_bias.argtypes = [p, p, p, p, ll, p]
    lib.analysis_scale_bias.restype = i
    return lib


def _cuda_or_ref(x: torch.Tensor, name: str) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise LightGBMError(f"{name} runs on cuda or cpu, not {x.device}")
    return True


def _launched(rc: int, name: str) -> None:
    if rc != 0:
        raise LightGBMError(f"{name} kernel launch failed with CUDA error "
                            f"{rc}")


def stage_copy(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Rows ``[0, rows)`` of ``x`` (``[R, C]`` or ``[K, R, C]``, f32 or
    i32, contiguous), one block per class slice.  CPU tensors take
    :func:`stage_copy_ref`; CUDA tensors launch ``fixture_stage_copy``
    on the current stream.  A geometry that breaks the 16-byte word
    rule raises before any launch."""
    if not _cuda_or_ref(x, "stage_copy"):
        return stage_copy_ref(x, rows)
    if (x.dtype not in (torch.float32, torch.int32) or x.dim() not in (2, 3)
            or not x.is_contiguous()):
        raise LightGBMError("stage_copy wants a contiguous f32 or i32 "
                            "[R, C] or [K, R, C] tensor")
    r, c = x.shape[-2:]
    row_bytes = c * x.element_size()
    if stage_rule_broken(row_bytes, x.data_ptr()):
        raise LightGBMError(f"stage_copy moves 16-byte words: rows of "
                            f"{row_bytes} bytes at address "
                            f"{x.data_ptr():#x} break that rule")
    if not 0 < rows <= r:
        raise LightGBMError(f"rows {rows} outside (0, {r}]")
    lib = _lib()
    if lib.analysis_stage_copy_smem_bytes(rows, row_bytes) > MAX_SMEM:
        raise LightGBMError(f"{rows} rows of {row_bytes} bytes do not fit "
                            "one block's shared memory")
    out = torch.zeros_like(x)
    classes = x.shape[0] if x.dim() == 3 else 1
    words = row_bytes // STAGE_WORD
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.analysis_stage_copy(
            x.data_ptr(), out.data_ptr(), int(x.dtype == torch.int32),
            classes, int(rows), words, r * words, stream)
    _launched(rc, "fixture_stage_copy")
    stage_copy.launches += 1
    return out


stage_copy.launches = 0


def smem_acc_ref(x: torch.Tensor, *, block_rows: int = 8,
                 acc_bytes: int = 8192) -> torch.Tensor:
    """Plain version: the copy (the accumulator is zeroed and read by
    nothing, as in the TPU kernel)."""
    return x.clone()


def smem_acc(x: torch.Tensor, *, block_rows: int = 8,
             acc_bytes: int = 8192) -> torch.Tensor:
    """``x`` ``[nblk * block_rows, C]`` f32 copied by ``nblk`` blocks,
    each beside ``acc_bytes`` of zeroed dynamic shared memory.  CPU
    tensors take :func:`smem_acc_ref`; CUDA tensors launch
    ``fixture_smem_acc`` on the current stream.  An accumulator over
    ``MAX_SMEM`` raises before any launch."""
    if not _cuda_or_ref(x, "smem_acc"):
        return smem_acc_ref(x, block_rows=block_rows, acc_bytes=acc_bytes)
    if (x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous()
            or x.shape[0] % block_rows):
        raise LightGBMError("smem_acc wants a contiguous f32 [nblk * "
                            "block_rows, C] tensor")
    if not 0 < acc_bytes <= MAX_SMEM or acc_bytes % 4:
        raise LightGBMError(f"an accumulator of {acc_bytes} bytes does not "
                            "fit one block's shared memory")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _lib().analysis_smem_acc(
            x.data_ptr(), out.data_ptr(), x.shape[0] // block_rows,
            block_rows * x.shape[1], int(acc_bytes), stream)
    _launched(rc, "fixture_smem_acc")
    smem_acc.launches += 1
    return out


smem_acc.launches = 0


def scale_bias_ref(x: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x * scale + bias`` in f32, the product rounded
    before the sum."""
    return x * scale.reshape(()) + bias.reshape(())


def scale_bias(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """``x * scale + bias`` over f32 ``x`` with ``scale`` and ``bias``
    f32 one-element tensors on its device, read by the kernel (no host
    read).  CPU tensors take :func:`scale_bias_ref`; CUDA tensors launch
    ``fixture_scale_bias`` on the current stream."""
    if not _cuda_or_ref(x, "scale_bias"):
        return scale_bias_ref(x, scale, bias)
    for t in (x, scale, bias):
        if (t.dtype != torch.float32 or t.device != x.device
                or not t.is_contiguous()):
            raise LightGBMError("scale_bias wants contiguous f32 tensors "
                                "on one device")
    if scale.numel() != 1 or bias.numel() != 1:
        raise LightGBMError("scale and bias must hold one value each")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _lib().analysis_scale_bias(x.data_ptr(), scale.data_ptr(),
                                        bias.data_ptr(), out.data_ptr(),
                                        x.numel(), stream)
    _launched(rc, "fixture_scale_bias")
    scale_bias.launches += 1
    return out


scale_bias.launches = 0
