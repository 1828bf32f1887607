"""Device-resident dataset and the physically partitioned row matrix.

Counterpart of ``lightgbm_tpu/ops/device_data.py`` (``DeviceDataset``,
``to_device``) and of the row-matrix init ``phys_init_comb``
(``lightgbm_tpu/ops/grow.py``).  The TPU packs each row into a 128-lane
f32 line with the row id stored as three f32 bytes and, on the stream
route, the score and the objective's constants as bf16x3 terms
(``stream_grad.py:13-27``); the port keeps the same per-row content in
five arrays (:class:`Rows`): the ``F`` u8 bins, the f32 values
``(g*w, h*w, w)``, an i32 row id, the f32 score and the two f32
objective constants (binary: sign, label weight; l2: target, weight).
The kernels move whole rows, so each leaf's rows stay contiguous and
every histogram reads one contiguous range.  Slice 2's route leaves
the score and constants at zero and moves them all the same.  Features
are not padded to matmul groups (there is no MXU tile to fill); bins are
padded to the JAX package's per-feature width so histograms have the
same ``[F, B, 2]`` shape.

The device bins are u8, or u16 where a feature has more than 256 bins
(``max_bin > 255``; the row-order path, ``ops/routing.py``).  PyTorch
implements few operations on ``torch.uint16`` (copies and casts), so
:func:`bins_i32` is the one place stored bins become numbers for
PyTorch ops; the kernels read the u16 bins themselves.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..io.binning import BinType
from ..io.dataset_core import BinnedDataset
from ..utils.log import LightGBMError


def bins_per_feature_padded(max_num_bins: int) -> int:
    """Per-feature bin count padded to a multiple of 16 (the JAX
    package's ``histogram.bins_per_feature_padded``)."""
    b = max(int(max_num_bins), 16)
    return int(np.ceil(b / 16) * 16)


def bins_i32(bins: torch.Tensor, rows=None, col=None) -> torch.Tensor:
    """The int32 bins of ``rows`` (an i32 or i64 index tensor, every row
    when None) in column ``col`` (every column when None).  u16 bins are read
    through an int16 view of the same bits, so no op runs on a uint16
    tensor."""
    wide = bins.dtype == torch.uint16
    src = bins.view(torch.int16) if wide else bins
    if col is not None:
        src = src[:, col]
    if rows is not None:
        src = src.index_select(0, rows)
    out = src.to(torch.int32)
    return out & 0xFFFF if wide else out


class Rows(NamedTuple):
    """The row matrix: row r is (bins[r], vals[r], rid[r], score[r],
    consts[r])."""
    bins: torch.Tensor    # u8 [n, F]
    vals: torch.Tensor    # f32 [n, 3]: g*w, h*w, w
    rid: torch.Tensor     # i32 [n]: original row id
    score: torch.Tensor   # f32 [n]: raw score (stream route)
    consts: torch.Tensor  # f32 [n, 2]: objective constants (stream route)


def init_rows(bins: torch.Tensor) -> Rows:
    """A fresh row matrix in original row order (``phys_init_comb``):
    the bins copied, values, score and constants zero (slice 2's route
    refreshes the values per tree), row ids 0..n-1."""
    n = bins.shape[0]
    dev = bins.device
    return Rows(bins.clone(),
                torch.zeros((n, 3), dtype=torch.float32, device=dev),
                torch.arange(n, dtype=torch.int32, device=dev),
                torch.zeros(n, dtype=torch.float32, device=dev),
                torch.zeros((n, 2), dtype=torch.float32, device=dev))


def empty_rows_like(rows: Rows) -> Rows:
    """Partition scratch of the same shapes (contents undefined)."""
    return Rows(*(torch.empty_like(a) for a in rows))


@dataclasses.dataclass
class DeviceDataset:
    bins: torch.Tensor       # [n, F] u8 or u16 on the device
    num_bins: torch.Tensor   # [F] i32
    has_nan: torch.Tensor    # [F] bool
    is_cat: torch.Tensor     # [F] bool
    padded_bins: int         # B: histogram bins per feature
    num_features: int
    num_data: int

    @property
    def device(self) -> torch.device:
        return self.bins.device


def to_device(ds: BinnedDataset, device: torch.device) -> DeviceDataset:
    mat = ds.bin_matrix
    if mat.dtype not in (np.uint8, np.uint16):
        raise LightGBMError(
            f"the bin matrix must be uint8 or uint16 (at most 65,536 bins "
            f"per feature), not {mat.dtype}")
    nbins = ds.num_bins_per_feature
    f = mat.shape[1]
    has_nan = np.array([m.has_nan_bin for m in ds.mappers], bool)
    is_cat = np.array([m.bin_type == BinType.CATEGORICAL
                       for m in ds.mappers], bool)
    return DeviceDataset(
        bins=torch.as_tensor(np.ascontiguousarray(mat), device=device),
        num_bins=torch.as_tensor(nbins, dtype=torch.int32, device=device),
        has_nan=torch.as_tensor(has_nan, device=device),
        is_cat=torch.as_tensor(is_cat, device=device),
        padded_bins=bins_per_feature_padded(int(nbins.max()) if f else 16),
        num_features=f,
        num_data=mat.shape[0])
