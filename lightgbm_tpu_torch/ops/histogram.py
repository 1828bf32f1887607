"""Histograms over separate bins and values, and the subtraction trick.

Counterparts of ``build_histogram`` (in its scatter-add form, the one
the JAX package runs off the TPU), ``default_histogram_impl`` and
``subtract_histogram`` in ``lightgbm_tpu/ops/histogram.py``.
:func:`build_histogram` is also the arithmetic of the histogram
kernels' plain versions (``hist_kernel2.build_histogram_comb_ref`` and
``build_histogram_rows_ref``).
"""
from __future__ import annotations

import torch

from ..config import env_knob
from ..utils.log import LightGBMError

# LGBM_TPU_HIST_IMPL values that select the row-order histogram kernel
# (hist_kernel2.build_histogram_rows): the JAX package's two Pallas
# kernels compute one function, which the port computes with one kernel
ROWS_IMPLS = ("auto", "pallas2", "pallas")


def histogram_impl(environ=None) -> str:
    """The row-order histogram the ``LGBM_TPU_HIST_IMPL`` knob selects
    (``default_histogram_impl``'s counterpart): ``"rows"``, the
    ``hist_rows`` kernel, for ``auto``, ``pallas2`` and ``pallas``.  The
    JAX package's ``matmul`` and ``scatter`` are XLA formulations with
    no kernel here, so they raise, as does any other value."""
    impl = env_knob("LGBM_TPU_HIST_IMPL", environ)
    if impl not in ROWS_IMPLS:
        raise LightGBMError(
            f"LGBM_TPU_HIST_IMPL={impl} is not a histogram of "
            f"lightgbm_tpu_torch (use one of {', '.join(ROWS_IMPLS)}: the "
            "hist_rows kernel)")
    return "rows"


def build_histogram(bins: torch.Tensor, values: torch.Tensor, *,
                    padded_bins: int,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``bins`` [n, F] u8 or int32 bins < padded_bins, ``values`` [n, C] f32
    -> hist [F, padded_bins, C] of ``dtype`` (f32, or f64 for the
    gpu_use_dp mode's plain version): one ``index_add_`` of every (row,
    feature) into the flat histogram (the reference CPU loop,
    dense_bin.hpp:98-140)."""
    n, f = bins.shape
    c = values.shape[1]
    idx = (bins.to(torch.int64)
           + torch.arange(f, device=bins.device) * padded_bins).reshape(-1)
    upd = values[:, None, :].expand(n, f, c).reshape(-1, c)
    hist = torch.zeros((f * padded_bins, c), dtype=dtype,
                       device=bins.device)
    hist.index_add_(0, idx, upd.to(dtype))
    return hist.reshape(f, padded_bins, c)


def subtract_histogram(parent: torch.Tensor,
                       child: torch.Tensor) -> torch.Tensor:
    """The sibling's histogram as parent - child (the reference's
    subtraction trick, serial_tree_learner.cpp:428)."""
    return parent - child
