"""Score-resident gradients: the wrappers of ``csrc/stream_grad.cu``
(stream init, the refresh with the next root histogram and the plain
refresh), their launch counts and their plain PyTorch versions.

Counterpart of ``lightgbm_tpu/ops/pallas/stream_grad.py`` (``make_init``
and ``make_refresh`` with ``root_hist=True`` and ``root_hist=False``,
pack=1).  On the stream route the row matrix carries each row's raw
score and its objective's two constants (:class:`~.device_data.Rows`),
so the per-tree gradient refresh is one in-place pass over the rows by
position, with no gather by row id: ``s = score + lv`` (``lv`` the
per-position score delta, shrinkage times the output of the leaf owning
the position), then ``g*w, h*w`` from ``s`` and the constants
(:func:`stream_refresh_plain`, the unfused routes').  On the fused route
the refresh also returns the next tree's root histogram
(:func:`stream_refresh`): the plain refresh's kernel and then
``hist_comb``'s root over ``[0, n)`` with ``max_rows = n``, the
histogram the unfused routes build at the next tree's start, bit for
bit.  On the H100 these two launches take less time than one kernel
that sums the histogram as it refreshes the rows (``PERF.md``).

The gradient arithmetic is the objectives' own (``binary_gradients``,
``l2_gradients``): the CPU route and slice 2's route compute the same
f32 values.  The TPU kernels' bf16 rounding of g/h is not applied (the
JAX package's interpret reference skips it too).

:func:`stream_init_p2`, :func:`stream_refresh_p2` and
:func:`stream_refresh_plain_p2` are the init and the two refreshes at
pack=2 (``_init_kernel_p2``, ``_refresh_hist_kernel_p2``,
``_refresh_kernel_p2``) over the records of
:class:`~.device_data.PackedRows`: their plain versions are the pack=1
plain versions over :meth:`PackedRows.fields`, and the kernels write the
pack=1 kernels' bits.

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..objective.binary import binary_gradients
from ..objective.regression import l2_gradients
from ..utils.log import LightGBMError
from . import _build
from .device_data import (PackedRows, RecordLayout, Rows, check_packed,
                          pack_rows)
from .hist_kernel2 import (HIST_CHUNK, _comb_buffers,
                           build_histogram_comb_ref, comb_args,
                           comb_geometry)
from .hist_kernel2 import _lib as _comb_lib
from .partition_kernel import check_rows

# the kernels' objective codes
KINDS = {"binary": 0, "l2": 1}


def init_p2_smem_bytes(stride: int) -> int:
    """Shared memory of one ``stream_init_p2`` block: ``HIST_CHUNK``
    records staged as ``stride / 4 + 1`` 32-bit words each
    (``staged_words``)."""
    return HIST_CHUNK * (stride // 4 + 1) * 4


def stream_gradients(kind: str, sigmoid: float, score: torch.Tensor,
                     consts: torch.Tensor, w: torch.Tensor):
    """(g*w, h*w) of every row from its score, constants [n, 2] and
    validity ``w``."""
    if kind == "binary":
        g, h = binary_gradients(score, consts[:, 0], consts[:, 1], sigmoid)
    elif kind == "l2":
        g, h = l2_gradients(score, consts[:, 0], consts[:, 1])
    else:
        raise LightGBMError(f"the stream route has no gradients for {kind}")
    return g * w, h * w


def stream_init_ref(bins: torch.Tensor, score: torch.Tensor,
                    valid: torch.Tensor, consts: torch.Tensor, *, kind: str,
                    sigmoid: float) -> Rows:
    """Plain version of the init: the row matrix in original row order
    from the bins [n, F], scores [n] (boost-from-average included),
    validity [n] and objective constants [n, 2]."""
    n = bins.shape[0]
    g, h = stream_gradients(kind, sigmoid, score, consts, valid)
    return Rows(bins.clone(), torch.stack([g, h, valid], dim=1),
                torch.arange(n, dtype=torch.int32, device=bins.device),
                score.clone(), consts.clone())


def stream_refresh_plain_ref(rows: Rows, lv: torch.Tensor, *, kind: str,
                             sigmoid: float) -> None:
    """Plain version of the plain refresh (``_xla_refresh``'s contract):
    every position's score gains ``lv`` and g*w, h*w are recomputed in
    place from it."""
    s = rows.score + lv
    g, h = stream_gradients(kind, sigmoid, s, rows.consts, rows.vals[:, 2])
    rows.score.copy_(s)
    rows.vals[:, 0] = g
    rows.vals[:, 1] = h


def stream_refresh_ref(rows: Rows, lv: torch.Tensor, *, kind: str,
                       sigmoid: float, padded_bins: int) -> torch.Tensor:
    """Plain version of the refresh: the plain refresh, then the next
    tree's root histogram [F, B, 2] is returned (``hist_comb`` over
    [0, n))."""
    stream_refresh_plain_ref(rows, lv, kind=kind, sigmoid=sigmoid)
    n = rows.bins.shape[0]
    rng = torch.tensor([0, 0, n], dtype=torch.int32, device=rows.bins.device)
    return build_histogram_comb_ref(rows, rng, padded_bins=padded_bins,
                                    max_rows=n)


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("stream_grad")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.stream_init.argtypes = [p] * 4 + [i] * 3 + [f] + [p] * 6
    lib.stream_init.restype = i
    lib.stream_init_p2.argtypes = [p] * 4 + [i] * 5 + [f, p, p]
    lib.stream_init_p2.restype = i
    lib.stream_refresh_plain.argtypes = [p] * 4 + [i] * 2 + [f, p]
    lib.stream_refresh_plain.restype = i
    lib.stream_refresh_plain_p2.argtypes = [p, i, i, p, i, i, f, p]
    lib.stream_refresh_plain_p2.restype = i
    return lib


def _check_vec(t: torch.Tensor, shape, dev, name: str) -> None:
    if (t.dtype != torch.float32 or tuple(t.shape) != tuple(shape)
            or t.device != dev or not t.is_contiguous()):
        raise LightGBMError(f"{name} must be a contiguous f32 "
                            f"{list(shape)} tensor on {dev}")


_ROOT_RANGES: dict = {}


def _root_range(n: int, dev) -> torch.Tensor:
    """The i32 (start, off, count) = (0, 0, n) of hist_comb's root on
    ``dev``, made once a (device, n)."""
    key = (str(dev), int(n))
    rng = _ROOT_RANGES.get(key)
    if rng is None:
        rng = _ROOT_RANGES[key] = torch.tensor([0, 0, n], dtype=torch.int32,
                                               device=dev)
    return rng


def _root_hist(lib_call, first_args, n: int, f: int, padded_bins: int, dev,
               stream):
    """The refresh's second kernel: hist_comb's root over [0, n) in its
    own geometry (``comb_geometry(f, B, n)``), through the hist_comb
    library entry ``lib_call`` with the rows' arguments ``first_args``;
    returns (rc, out)."""
    geo = comb_geometry(f, padded_bins, n)
    partials, out = _comb_buffers(geo, f, padded_bins, dev)
    rc = lib_call(*first_args, _root_range(n, dev).data_ptr(),
                  *comb_args(geo, partials, out, n, f, padded_bins), stream)
    return rc, out


def _check_init(bins, score, valid, consts) -> None:
    dev = bins.device
    n = bins.shape[0]
    if bins.dtype != torch.uint8 or bins.dim() != 2 \
            or not bins.is_contiguous():
        raise LightGBMError("bins must be contiguous u8 [n, F]")
    _check_vec(score, (n,), dev, "score")
    _check_vec(valid, (n,), dev, "valid")
    _check_vec(consts, (n, 2), dev, "consts")


def stream_init(bins: torch.Tensor, score: torch.Tensor, valid: torch.Tensor,
                consts: torch.Tensor, *, kind: str, sigmoid: float) -> Rows:
    """The stream route's row matrix.  CPU tensors take
    :func:`stream_init_ref`; CUDA tensors launch the kernel."""
    dev = bins.device
    if dev.type == "cpu":
        return stream_init_ref(bins, score, valid, consts, kind=kind,
                               sigmoid=sigmoid)
    if dev.type != "cuda":
        raise LightGBMError(f"stream_init runs on cuda or cpu, not {dev}")
    n, f = bins.shape
    _check_init(bins, score, valid, consts)
    rows = Rows(torch.empty_like(bins),
                torch.empty((n, 3), dtype=torch.float32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty(n, dtype=torch.float32, device=dev),
                torch.empty((n, 2), dtype=torch.float32, device=dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().stream_init(
            bins.data_ptr(), score.data_ptr(), valid.data_ptr(),
            consts.data_ptr(), n, f, KINDS[kind], float(sigmoid),
            *(a.data_ptr() for a in rows), stream)
    if rc != 0:
        raise LightGBMError(f"stream_init kernel launch failed with CUDA "
                            f"error {rc}")
    stream_init.launches += 1
    return rows


def stream_refresh(rows: Rows, lv: torch.Tensor, *, kind: str,
                   sigmoid: float, padded_bins: int) -> torch.Tensor:
    """Refresh the rows in place with the per-position score delta
    ``lv`` [n] and return the next tree's root histogram.  CPU tensors
    take :func:`stream_refresh_ref`; CUDA tensors launch the plain
    refresh's kernel and then ``hist_comb``'s root over [0, n) (one call
    counted here, none in the two kernels' own wrappers)."""
    dev = rows.bins.device
    if dev.type == "cpu":
        return stream_refresh_ref(rows, lv, kind=kind, sigmoid=sigmoid,
                                  padded_bins=padded_bins)
    if dev.type != "cuda":
        raise LightGBMError(f"stream_refresh runs on cuda or cpu, not {dev}")
    check_rows(rows, rows)
    n, f = rows.bins.shape
    _check_vec(lv, (n,), dev, "lv")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().stream_refresh_plain(
            rows.vals.data_ptr(), rows.score.data_ptr(),
            rows.consts.data_ptr(), lv.data_ptr(), n, KINDS[kind],
            float(sigmoid), stream)
        if rc == 0:
            rc, out = _root_hist(
                _comb_lib().hist_comb,
                (rows.bins.data_ptr(), rows.vals.data_ptr()), n, f,
                padded_bins, dev, stream)
    if rc != 0:
        raise LightGBMError(f"stream_refresh kernel launch failed with CUDA "
                            f"error {rc}")
    stream_refresh.launches += 1
    return out


def stream_refresh_plain(rows: Rows, lv: torch.Tensor, *, kind: str,
                         sigmoid: float) -> None:
    """Refresh the rows in place with the per-position score delta
    ``lv`` [n], with no histogram.  CPU tensors take
    :func:`stream_refresh_plain_ref`; CUDA tensors launch the kernel."""
    dev = rows.bins.device
    if dev.type == "cpu":
        return stream_refresh_plain_ref(rows, lv, kind=kind, sigmoid=sigmoid)
    if dev.type != "cuda":
        raise LightGBMError(f"stream_refresh_plain runs on cuda or cpu, not "
                            f"{dev}")
    check_rows(rows, rows)
    n = rows.bins.shape[0]
    _check_vec(lv, (n,), dev, "lv")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().stream_refresh_plain(
            rows.vals.data_ptr(), rows.score.data_ptr(),
            rows.consts.data_ptr(), lv.data_ptr(), n, KINDS[kind],
            float(sigmoid), stream)
    if rc != 0:
        raise LightGBMError(f"stream_refresh_plain kernel launch failed with "
                            f"CUDA error {rc}")
    stream_refresh_plain.launches += 1
    return None


def stream_init_p2_ref(bins: torch.Tensor, score: torch.Tensor,
                       valid: torch.Tensor, consts: torch.Tensor, *,
                       kind: str, sigmoid: float) -> PackedRows:
    """Plain version of the pack=2 init: :func:`stream_init_ref`'s rows
    as records (pad bytes zero)."""
    return pack_rows(stream_init_ref(bins, score, valid, consts, kind=kind,
                                     sigmoid=sigmoid))


def stream_refresh_p2_ref(rows: PackedRows, lv: torch.Tensor, *, kind: str,
                          sigmoid: float, padded_bins: int) -> torch.Tensor:
    """Plain version of the pack=2 refresh: :func:`stream_refresh_ref`
    over the records' fields."""
    return stream_refresh_ref(rows.fields(), lv, kind=kind, sigmoid=sigmoid,
                              padded_bins=padded_bins)


def stream_refresh_plain_p2_ref(rows: PackedRows, lv: torch.Tensor, *,
                                kind: str, sigmoid: float) -> None:
    """Plain version of the pack=2 plain refresh:
    :func:`stream_refresh_plain_ref` over the records' fields."""
    stream_refresh_plain_ref(rows.fields(), lv, kind=kind, sigmoid=sigmoid)


def stream_init_p2(bins: torch.Tensor, score: torch.Tensor,
                   valid: torch.Tensor, consts: torch.Tensor, *, kind: str,
                   sigmoid: float) -> PackedRows:
    """The stream route's records.  CPU tensors take
    :func:`stream_init_p2_ref`; CUDA tensors launch the kernel."""
    dev = bins.device
    if dev.type == "cpu":
        return stream_init_p2_ref(bins, score, valid, consts, kind=kind,
                                  sigmoid=sigmoid)
    if dev.type != "cuda":
        raise LightGBMError(f"stream_init_p2 runs on cuda or cpu, not {dev}")
    n, f = bins.shape
    _check_init(bins, score, valid, consts)
    lay = RecordLayout(f)
    rows = PackedRows(torch.empty((n, lay.stride), dtype=torch.uint8,
                                  device=dev), lay)
    check_packed(rows)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().stream_init_p2(
            bins.data_ptr(), score.data_ptr(), valid.data_ptr(),
            consts.data_ptr(), n, f, lay.stride, lay.fb, KINDS[kind],
            float(sigmoid), rows.buf.data_ptr(), stream)
    if rc != 0:
        raise LightGBMError(f"stream_init_p2 kernel launch failed with CUDA "
                            f"error {rc}")
    stream_init_p2.launches += 1
    return rows


def stream_refresh_p2(rows: PackedRows, lv: torch.Tensor, *, kind: str,
                      sigmoid: float, padded_bins: int) -> torch.Tensor:
    """:func:`stream_refresh` over records: the pack=2 plain refresh's
    kernel, then ``hist_comb_p2``'s root.  CPU tensors take
    :func:`stream_refresh_p2_ref`; CUDA tensors launch the kernels."""
    dev = rows.buf.device
    if dev.type == "cpu":
        return stream_refresh_p2_ref(rows, lv, kind=kind, sigmoid=sigmoid,
                                     padded_bins=padded_bins)
    if dev.type != "cuda":
        raise LightGBMError(f"stream_refresh_p2 runs on cuda or cpu, not "
                            f"{dev}")
    check_packed(rows)
    n, lay = rows.buf.shape[0], rows.layout
    f = lay.num_features
    _check_vec(lv, (n,), dev, "lv")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().stream_refresh_plain_p2(
            rows.buf.data_ptr(), lay.stride, lay.fb, lv.data_ptr(), n,
            KINDS[kind], float(sigmoid), stream)
        if rc == 0:
            rc, out = _root_hist(
                _comb_lib().hist_comb_p2,
                (rows.buf.data_ptr(), lay.stride, lay.fb), n, f,
                padded_bins, dev, stream)
    if rc != 0:
        raise LightGBMError(f"stream_refresh_p2 kernel launch failed with "
                            f"CUDA error {rc}")
    stream_refresh_p2.launches += 1
    return out


def stream_refresh_plain_p2(rows: PackedRows, lv: torch.Tensor, *,
                            kind: str, sigmoid: float) -> None:
    """:func:`stream_refresh_plain` over records.  CPU tensors take
    :func:`stream_refresh_plain_p2_ref`; CUDA tensors launch the
    kernel."""
    dev = rows.buf.device
    if dev.type == "cpu":
        return stream_refresh_plain_p2_ref(rows, lv, kind=kind,
                                           sigmoid=sigmoid)
    if dev.type != "cuda":
        raise LightGBMError(f"stream_refresh_plain_p2 runs on cuda or cpu, "
                            f"not {dev}")
    check_packed(rows)
    n, lay = rows.buf.shape[0], rows.layout
    _check_vec(lv, (n,), dev, "lv")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().stream_refresh_plain_p2(
            rows.buf.data_ptr(), lay.stride, lay.fb, lv.data_ptr(), n,
            KINDS[kind], float(sigmoid), stream)
    if rc != 0:
        raise LightGBMError(f"stream_refresh_plain_p2 kernel launch failed "
                            f"with CUDA error {rc}")
    stream_refresh_plain_p2.launches += 1
    return None


stream_init.launches = 0
stream_refresh.launches = 0
stream_refresh_plain.launches = 0
stream_init_p2.launches = 0
stream_refresh_p2.launches = 0
stream_refresh_plain_p2.launches = 0
