"""Histograms over separate bins and values, and the subtraction trick.

Counterparts of ``build_histogram`` (in its scatter-add form, the one
the JAX package runs off the TPU) and ``subtract_histogram`` in
``lightgbm_tpu/ops/histogram.py``.  :func:`build_histogram` is also the
arithmetic of the comb-direct histogram's plain version
(``hist_kernel2.build_histogram_comb_ref``).
"""
from __future__ import annotations

import torch


def build_histogram(bins: torch.Tensor, values: torch.Tensor, *,
                    padded_bins: int) -> torch.Tensor:
    """``bins`` [n, F] integer bins < padded_bins, ``values`` [n, C] f32
    -> hist [F, padded_bins, C] f32: one ``index_add_`` of every
    (row, feature) into the flat histogram (the reference CPU loop,
    dense_bin.hpp:98-140)."""
    n, f = bins.shape
    c = values.shape[1]
    idx = (bins.to(torch.int64)
           + torch.arange(f, device=bins.device) * padded_bins).reshape(-1)
    upd = values[:, None, :].expand(n, f, c).reshape(-1, c)
    hist = torch.zeros((f * padded_bins, c), dtype=torch.float32,
                       device=bins.device)
    hist.index_add_(0, idx, upd.to(torch.float32))
    return hist.reshape(f, padded_bins, c)


def subtract_histogram(parent: torch.Tensor,
                       child: torch.Tensor) -> torch.Tensor:
    """The sibling's histogram as parent - child (the reference's
    subtraction trick, serial_tree_learner.cpp:428)."""
    return parent - child
