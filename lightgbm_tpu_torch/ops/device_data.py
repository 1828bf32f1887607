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

Under ``LGBM_TPU_COMB_PACK=2`` the same per-row content is laid out as
one **record** per row (:class:`RecordLayout`, :class:`PackedRows`):
the bins, then the twenty-eight bytes of four-byte fields, in one
stride of a multiple of 16 bytes, so a kernel moves a row with whole
16-byte loads (64 bytes at 28 features: two records per 128-byte line,
the card's counterpart of the TPU's two rows per 128-lane line).
:meth:`PackedRows.fields` views the record buffer as :class:`Rows`, so
every reader of the five arrays reads either layout.
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

    def fields(self) -> "Rows":
        """The five arrays (:meth:`PackedRows.fields`'s counterpart)."""
        return self


# bytes of the four-byte fields after a record's bins: vals f32 x 3,
# rid i32, score f32, consts f32 x 2
RECORD_FIELD_BYTES = 28


@dataclasses.dataclass(frozen=True)
class RecordLayout:
    """The pack=2 row record of ``num_features`` u8 bins: bytes
    ``[0, F)`` the bins, ``[F, Fb)`` zero with ``Fb = 4 * ceil(F / 4)``,
    then vals at ``Fb``, rid at ``Fb + 12``, score at ``Fb + 16``,
    consts at ``Fb + 20``, and zero up to the stride ``S = 16 *
    ceil((Fb + 28) / 16)``.  ``Fb`` keeps every field four-byte aligned
    and ``S`` every record a whole number of 16-byte words."""
    num_features: int

    @property
    def fb(self) -> int:
        return 4 * -(-self.num_features // 4)

    @property
    def stride(self) -> int:
        return 16 * -(-(self.fb + RECORD_FIELD_BYTES) // 16)


class PackedRows(NamedTuple):
    """The row matrix as records: one contiguous u8 buffer ``[n, S]``
    and its layout."""
    buf: torch.Tensor     # u8 [n, S]
    layout: RecordLayout

    def fields(self) -> Rows:
        """The five arrays as strided views into the buffer (writes go
        to the records)."""
        f, fb = self.layout.num_features, self.layout.fb
        b = self.buf

        def f32(lo: int, hi: int) -> torch.Tensor:
            return b[:, lo:hi].view(torch.float32)
        return Rows(b[:, :f], f32(fb, fb + 12),
                    b[:, fb + 12:fb + 16].view(torch.int32)[:, 0],
                    f32(fb + 16, fb + 20)[:, 0], f32(fb + 20, fb + 28))


def empty_packed(n: int, num_features: int, device) -> PackedRows:
    """Records of every row, all bytes zero (pads included)."""
    layout = RecordLayout(int(num_features))
    return PackedRows(torch.zeros((n, layout.stride), dtype=torch.uint8,
                                  device=device), layout)


def pack_rows(rows: Rows) -> PackedRows:
    """The records of a row matrix (pad bytes zero)."""
    n, f = rows.bins.shape
    out = empty_packed(n, f, rows.bins.device)
    for dst, src in zip(out.fields(), rows):
        dst.copy_(src)
    return out


def init_packed_rows(bins: torch.Tensor) -> PackedRows:
    """:func:`init_rows` as records: the bins copied, row ids 0..n-1,
    every other field zero."""
    n, f = bins.shape
    out = empty_packed(n, f, bins.device)
    view = out.fields()
    view.bins.copy_(bins)
    view.rid.copy_(torch.arange(n, dtype=torch.int32, device=bins.device))
    return out


def check_packed(rows: PackedRows, scratch=None) -> None:
    """Raise unless ``rows`` (and ``scratch``, when given) hold a
    contiguous u8 ``[n, S]`` record buffer of their layout's stride,
    16-byte aligned, on one CUDA device: the kernels read it as 16-byte
    words from its base."""
    dev = rows.buf.device
    for r in (rows,) if scratch is None else (rows, scratch):
        b = r.buf
        if (b.dtype != torch.uint8 or b.dim() != 2
                or b.shape[1] != r.layout.stride or r.layout != rows.layout
                or b.shape[0] != rows.buf.shape[0]):
            raise LightGBMError(
                f"record buffers must be u8 [n, {rows.layout.stride}] of "
                "one layout and row count")
        if (b.device != dev or not b.is_contiguous()
                or b.data_ptr() % 16):
            raise LightGBMError("record buffers must be contiguous, "
                                "16-byte aligned and on one device")


def empty_packed_like(rows: PackedRows) -> PackedRows:
    """Partition scratch of the same layout (contents undefined)."""
    return PackedRows(torch.empty_like(rows.buf), rows.layout)


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
