"""Forest traversal kernel for serving: the wrapper of
``csrc/serve_traverse.cu``, its launch count, and its plain PyTorch
version.

Counterpart of ``lightgbm_tpu/ops/pallas/serve_kernel.py``
(``make_serve_traverse``), with the same operand contract:
``forest_kernel_args`` gives the forest operands in the same order, the
input is the single ``[n, F]`` i32 matrix from
``ops.predict.quantize_rows_kernel``, and the scores form writes the
per-class sums into the caller's ``[n, K]`` f32 buffer in place (the
engine's pooled buffer, the JAX package's donated one).

:func:`serve_traverse` takes the plain version only for tensors on the
CPU.  For CUDA tensors it launches the kernel or raises; nothing falls
back.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..utils.log import LightGBMError
from . import _build
from .predict import ServingForest, _leaf_sums


def forest_kernel_args(forest: ServingForest, *, leaves: bool = False
                       ) -> Tuple[torch.Tensor, ...]:
    """The forest operands of the traversal, in ``make_serve_traverse``
    order: ``sf, tb, lc, rc, nm[, cw, nb][, lv]`` (``cw, nb`` only when
    the forest has categorical bitsets, ``lv`` only for scores)."""
    t, ni = forest.split_feature.shape
    w = forest.cat_words.shape[1] // max(int(ni), 1)
    args = [forest.split_feature, forest.threshold_bin,
            forest.left_child, forest.right_child, forest.node_meta]
    if w > 0:
        args += [forest.cat_words, forest.cat_nbits]
    if not leaves:
        args += [forest.leaf_value]
    return tuple(args)


def _unpack(args, leaves: bool):
    sf, tb, lc, rc, nm = args[:5]
    rest = list(args[5:])
    lv = None if leaves else rest.pop()
    cw, nb = rest if rest else (None, None)
    return sf, tb, lc, rc, nm, cw, nb, lv


def serve_traverse_ref(args, bins: torch.Tensor, n_real: int,
                       out: torch.Tensor, *, n_steps: int,
                       leaves: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same inputs and outputs:
    a lock-step walk of every (row, tree) from node 0 for ``n_steps``
    levels, then leaf indices into ``out`` ([n, T] i32) or per-class
    leaf sums into ``out`` ([n, K] f32), in place."""
    sf, tb, lc, rc, nm, cw, nb, lv = _unpack(args, leaves)
    n = bins.shape[0]
    t_cnt, ni = sf.shape
    w = cw.shape[1] // ni if cw is not None else 0
    tri = torch.arange(t_cnt, device=bins.device)[None, :]
    sf_f, tb_f, lc_f, rc_f, nm_f = (a.reshape(-1) for a in (sf, tb, lc, rc,
                                                           nm))
    node = torch.zeros((n, t_cnt), dtype=torch.int32, device=bins.device)
    for _ in range(n_steps):
        active = node >= 0
        gidx = tri * ni + node.clamp(min=0).long()           # [n, T]
        b = torch.gather(bins, 1, sf_f[gidx].long())
        meta = nm_f[gidx]
        at_nan = ((meta & 2) > 0) & (b == (meta >> 3))
        go_left = ((b <= tb_f[gidx]) & ~at_nan) | (at_nan & ((meta & 1) > 0))
        if w > 0:
            ok = (b >= 0) & (b < nb.reshape(-1)[gidx])
            ivc = b.clamp(0, w * 32 - 1)
            word = cw.reshape(-1)[gidx * w + (ivc // 32).long()]
            go_cat = ok & (((word >> (ivc % 32)) & 1) > 0)
            go_left = torch.where((meta & 4) > 0, go_cat, go_left)
        nxt = torch.where(go_left, lc_f[gidx], rc_f[gidx])
        node = torch.where(active, nxt, node)
    leaf = ~node.clamp(max=-1)
    if leaves:
        live = torch.arange(n, device=bins.device)[:, None] < n_real
        out.copy_(torch.where(live, leaf, torch.zeros_like(leaf)))
    else:
        out.copy_(_leaf_sums(lv, leaf, out.shape[1], n, n_real))
    return out


def _check(args, bins, out, leaves: bool) -> None:
    dev = bins.device
    for a in (*args, bins, out):
        if a.device != dev:
            raise LightGBMError("serve_traverse operands must share one "
                                f"device (got {a.device} and {dev})")
        if not a.is_contiguous():
            raise LightGBMError("serve_traverse operands must be "
                                "contiguous")
    sf, tb, lc, rc, nm, cw, nb, lv = _unpack(args, leaves)
    for a in (sf, tb, lc, rc, nm, cw, nb, bins):
        if a is not None and a.dtype != torch.int32:
            raise LightGBMError(f"serve_traverse wants i32 node arrays "
                                f"and bins, got {a.dtype}")
    t_cnt, ni = sf.shape
    for a in (tb, lc, rc, nm) + ((nb,) if nb is not None else ()):
        if tuple(a.shape) != (t_cnt, ni):
            raise LightGBMError("serve_traverse node arrays must all be "
                                f"[T, ni_pad] = {(t_cnt, ni)}")
    if cw is not None and (cw.shape[0] != t_cnt or cw.shape[1] % ni):
        raise LightGBMError("cat_words must be [T, ni_pad * W]")
    if bins.dim() != 2:
        raise LightGBMError("bins must be [n, F]")
    if leaves:
        if out.dtype != torch.int32 or tuple(out.shape) != (bins.shape[0],
                                                            t_cnt):
            raise LightGBMError("leaves output must be [n, T] i32")
    else:
        if lv.dtype not in (torch.float32, torch.bfloat16) \
                or lv.shape[0] != t_cnt:
            raise LightGBMError("leaf table must be [T, nl_pad] f32 or "
                                "bf16")
        k = out.shape[1] if out.dim() == 2 else 0
        if out.dtype != torch.float32 or out.dim() != 2 \
                or out.shape[0] != bins.shape[0] or k < 1 or t_cnt % k:
            raise LightGBMError("scores output must be [n, K] f32 with K "
                                "dividing the tree count")


@functools.lru_cache(maxsize=1)
def _lib():
    """The built library with its argument types declared."""
    lib = _build.load("serve_traverse")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.serve_traverse_scores.argtypes = [p] * 8 + [i, p, p] + [i] * 9 + [p]
    lib.serve_traverse_scores.restype = i
    lib.serve_traverse_leaves.argtypes = [p] * 9 + [i] * 7 + [p]
    lib.serve_traverse_leaves.restype = i
    return lib


def serve_traverse(args, bins: torch.Tensor, n_real: int,
                   out: torch.Tensor, *, n_steps: int,
                   leaves: bool = False) -> torch.Tensor:
    """Walk the stacked forest for ``bins`` and write the result into
    ``out`` in place: ``[n, T]`` i32 leaf indices (``leaves=True``) or
    ``[n, K]`` f32 per-class leaf sums.  ``args`` is
    :func:`forest_kernel_args` of the same form.  Rows >= ``n_real``
    come back 0.  CPU tensors take :func:`serve_traverse_ref`; CUDA
    tensors launch the kernel on the current stream."""
    if bins.device.type == "cpu":
        return serve_traverse_ref(args, bins, n_real, out, n_steps=n_steps,
                                  leaves=leaves)
    if bins.device.type != "cuda":
        raise LightGBMError(f"serve_traverse runs on cuda or cpu, not "
                            f"{bins.device}")
    _check(args, bins, out, leaves)
    n, n_feat = bins.shape
    if n == 0:
        return out
    sf, tb, lc, rc, nm, cw, nb, lv = _unpack(args, leaves)
    t_cnt, ni = sf.shape
    w = cw.shape[1] // ni if cw is not None else 0
    ptr = (lambda a: a.data_ptr() if a is not None else None)
    lib = _lib()
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    node_ptrs = [ptr(a) for a in (sf, tb, lc, rc, nm, cw, nb)]
    with torch.cuda.device(bins.device):
        if leaves:
            rc_ = lib.serve_traverse_leaves(
                *node_ptrs, ptr(bins), ptr(out), n, int(n_real), n_feat,
                t_cnt, ni, w, int(n_steps), stream)
        else:
            rc_ = lib.serve_traverse_scores(
                *node_ptrs, ptr(lv), int(lv.dtype == torch.bfloat16),
                ptr(bins), ptr(out), n, int(n_real), n_feat, t_cnt, ni,
                lv.shape[1], w, out.shape[1], int(n_steps), stream)
    if rc_ != 0:
        raise LightGBMError(f"serve_traverse kernel launch failed with "
                            f"CUDA error {rc_}")
    serve_traverse.launches += 1
    return out


serve_traverse.launches = 0
