"""Stacked-forest serving arrays, the row quantizer, and a plain
gather walk over the whole forest.

:class:`ServingForest` holds the same fields, shapes and dtypes as
``lightgbm_tpu.ops.predict.ServingForest``, as torch tensors on one
device.  :func:`quantize_rows_kernel` builds the traversal kernel's
single ``[n, F]`` i32 input; it is plain PyTorch on either device (the
JAX package leaves it to XLA too).  :func:`forest_leaves` and
:func:`forest_scores` are the plain gather walk over raw rows, an
independent reference for the kernel's input contract: no serving
path runs them.
"""
from __future__ import annotations

import dataclasses

import torch

_BIG_BIN = 1 << 24
_KZERO = 1e-35
# the largest f32 below 2**31: finite raw values are clamped here before
# the int cast, and values >= 2**31 saturate to INT32_MAX as XLA's
# f32 -> s32 conversion does (the cast itself is undefined out of range)
_F32_BELOW_2_31 = 2147483520.0
_INT32_MAX = 2147483647


@dataclasses.dataclass
class ServingForest:
    """Every tree of a booster slice stacked into padded arrays, plus
    the per-(inner)-feature quantizer tables.

    Node arrays are ``[T, ni_pad]`` and the leaf table ``[T, nl_pad]``,
    padded to 128-multiples exactly as the JAX build pads them, so the
    two packages' arrays compare equal field by field.  A single-leaf
    tree has ``init_node = -1`` and both node-0 children ``~0``, so the
    kernel (which starts every tree at node 0) parks on leaf 0 after
    one step.  Categorical membership uses the raw-value bitsets
    (tree.h:271-279).  The quantizer's ``ub`` rows are f64 bin upper
    bounds rounded down to f32, so ``x <= ub_f32`` equals
    ``x <= ub_f64`` for every f32 input."""
    # node arrays [T, ni_pad]
    split_feature: torch.Tensor   # i32 inner feature idx
    threshold_bin: torch.Tensor   # i32
    default_left: torch.Tensor    # bool; the walk reads node_meta bit 0
    is_categorical: torch.Tensor  # bool; the kernel reads node_meta bit 2
    left_child: torch.Tensor      # i32, ~leaf encoding
    right_child: torch.Tensor     # i32
    leaf_value: torch.Tensor      # [T, nl_pad] f32, or bf16 under
                                  # LGBM_TPU_SERVE_LEAF_BF16
    init_node: torch.Tensor       # [T] i32: 0, or -1 for single-leaf
    cat_words: torch.Tensor       # [T, ni_pad * W] i32 raw-value bitsets
                                  # (node-major; W = shape[1] // ni_pad)
    cat_nbits: torch.Tensor       # [T, ni_pad] i32 valid bits per node
    # quantizer tables [F] / [F, B] (F = inner features)
    used_cols: torch.Tensor       # i32 original column per inner feature
    ub: torch.Tensor              # f32 upper bounds (floor-rounded), +inf pad
    default_bin: torch.Tensor     # i32 bin of value 0.0
    num_bins: torch.Tensor        # i32
    has_nan: torch.Tensor         # bool (missing_type == NAN)
    missing_zero: torch.Tensor    # bool (missing_type == ZERO)
    # (nan_bin << 3) | (is_categorical << 2) | (has_nan << 1) | default_left
    node_meta: torch.Tensor       # [T, ni_pad] i32
    cat_col: torch.Tensor         # [F] bool: column holds int-truncated
                                  # raw values (categorical) in the
                                  # kernel's input matrix

    @property
    def device(self) -> torch.device:
        return self.split_feature.device

    def to(self, device) -> "ServingForest":
        return ServingForest(**{f.name: getattr(self, f.name).to(device)
                                for f in dataclasses.fields(self)})

    def numpy(self) -> dict:
        """Field name -> numpy array (bf16 leaves come back as f32)."""
        out = {}
        for f in dataclasses.fields(self):
            t = getattr(self, f.name).detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.float()
            out[f.name] = t.numpy()
        return out


def quantize_rows(forest: ServingForest, raw_used: torch.Tensor
                  ) -> torch.Tensor:
    """[n, F] raw f32 (inner-feature order) -> [n, F] i32 logical bins,
    with the host walk's missing semantics: NaN -> the NaN bin (missing
    NAN) else the bin of 0.0; |v| <= 1e-35 -> the zero bin under
    missing ZERO; +inf -> a sentinel past every threshold bin."""
    b = torch.searchsorted(forest.ub, raw_used.t().contiguous(),
                           right=False).t().to(torch.int32)
    isnan = torch.isnan(raw_used)
    db = forest.default_bin[None, :]
    b = torch.where(forest.missing_zero[None, :]
                    & (torch.abs(raw_used) <= _KZERO), db, b)
    b = torch.where(isnan,
                    torch.where(forest.has_nan[None, :],
                                forest.num_bins[None, :] - 1, db), b)
    return torch.where(raw_used == float("inf"),
                       torch.full_like(b, _BIG_BIN), b)


def _int_truncate(raw: torch.Tensor) -> torch.Tensor:
    """Raw f32 -> i32 as the JAX package truncates categorical values:
    NaN and +-inf -> -1, finite values toward zero, saturating at the
    int32 range."""
    v = torch.where(torch.isfinite(raw), raw, torch.full_like(raw, -1.0))
    iv = v.clamp(-2147483648.0, _F32_BELOW_2_31).to(torch.int32)
    return torch.where(v >= 2147483648.0, torch.full_like(iv, _INT32_MAX),
                       iv)


def quantize_rows_kernel(forest: ServingForest,
                         raw_used: torch.Tensor) -> torch.Tensor:
    """[n, F] raw f32 -> the traversal kernel's single [n, F] i32 input:
    quantized bins on numerical columns, int-truncated raw values on
    categorical columns (NaN/inf -> -1, which the kernel's bitset test
    rejects like the host walk)."""
    b = quantize_rows(forest, raw_used)
    return torch.where(forest.cat_col[None, :], _int_truncate(raw_used), b)


def _forest_walk(forest: ServingForest, raw_used, bins, n_steps: int):
    """[n, F] bins/raw -> [n, T] leaf indices: lock-step node-pointer
    chase over all trees at once, one flat gather per node field per
    level, categorical bits read from the raw values."""
    n = raw_used.shape[0]
    t_cnt, ni = forest.split_feature.shape
    dev = raw_used.device
    tri = torch.arange(t_cnt, dtype=torch.int64, device=dev)[None, :]
    sf = forest.split_feature.reshape(-1).long()
    tb_f = forest.threshold_bin.reshape(-1)
    cat_f = forest.is_categorical.reshape(-1)
    lc_f = forest.left_child.reshape(-1)
    rc_f = forest.right_child.reshape(-1)
    nm_f = forest.node_meta.reshape(-1)
    nbits_f = forest.cat_nbits.reshape(-1)
    cw_f = forest.cat_words.reshape(-1)
    w = forest.cat_words.shape[-1] // max(ni, 1)

    node = forest.init_node[None, :].expand(n, t_cnt).clone()
    for _ in range(n_steps):
        active = node >= 0
        gidx = tri * ni + node.clamp(min=0).long()           # [n, T]
        feat = sf[gidx]
        b = torch.gather(bins, 1, feat)
        meta = nm_f[gidx]
        at_nan = ((meta & 2) > 0) & (b == (meta >> 3))
        go_num = ((b <= tb_f[gidx]) & ~at_nan) | (at_nan & ((meta & 1) > 0))
        if w > 0:
            iv = _int_truncate(torch.gather(raw_used, 1, feat))
            ok = (iv >= 0) & (iv < nbits_f[gidx])
            ivc = iv.clamp(0, w * 32 - 1)
            word = cw_f[gidx * w + (ivc // 32).long()]
            go_cat = ok & (((word >> (ivc % 32)) & 1) > 0)
            go_left = torch.where(cat_f[gidx], go_cat, go_num)
        else:
            go_left = go_num
        nxt = torch.where(go_left, lc_f[gidx], rc_f[gidx])
        node = torch.where(active, nxt, node)
    return ~node.clamp(max=-1)


def forest_leaves(forest: ServingForest, raw, n_real: int, *,
                  n_steps: int) -> torch.Tensor:
    """[n, Forig] raw f32 rows -> [n, T] i32 leaf indices (rows >=
    ``n_real`` are bucket padding and come back 0)."""
    raw_used = raw[:, forest.used_cols.long()]
    bins = quantize_rows(forest, raw_used)
    leaf = _forest_walk(forest, raw_used, bins, n_steps)
    live = torch.arange(raw.shape[0], device=raw.device)[:, None] < n_real
    return torch.where(live, leaf, torch.zeros_like(leaf))


def forest_scores(forest: ServingForest, raw, n_real: int, num_class: int,
                  *, n_steps: int) -> torch.Tensor:
    """[n, Forig] raw f32 rows -> [n, K] f32 per-class sums of leaf
    values over trees ``t = it * K + kk``; rows >= ``n_real`` are 0."""
    leaf = forest_leaves(forest, raw, n_real, n_steps=n_steps)
    return _leaf_sums(forest.leaf_value, leaf, num_class,
                      raw.shape[0], n_real)


def _leaf_sums(leaf_value, leaf, num_class: int, n: int, n_real: int):
    """[n, T] leaf indices -> [n, K] f32 per-class sums, upcasting the
    leaf table right after the gather (it may be bf16)."""
    t_cnt, nl = leaf_value.shape
    tri = torch.arange(t_cnt, device=leaf.device)[None, :]
    vals = leaf_value.reshape(-1)[tri * nl + leaf.long()].float()
    k = max(int(num_class), 1)
    per_class = vals.reshape(n, t_cnt // k, k).sum(dim=1)
    live = torch.arange(n, device=leaf.device)[:, None] < n_real
    return torch.where(live, per_class, torch.zeros_like(per_class))
