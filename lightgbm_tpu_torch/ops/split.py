"""Best-split search over histograms (plain PyTorch on the device).

Counterpart of ``lightgbm_tpu/ops/split.py`` (reference
feature_histogram.hpp:85,858 FindBestThreshold; its CUDA form
cuda_best_split_finder.cu:209-263): cumulative sums over the bin axis
give every threshold's left sums at once, the gains of all (direction,
feature, bin) candidates form one masked tensor, and the winner is
chosen on :func:`selection_key`, feature-major.  Numerical splits in
both missing directions and one-hot categorical splits are ported, with
L1/L2, ``max_delta_step``, ``min_gain_to_split``, the min-data /
min-hessian gates and path smoothing.  Monotone constraints, sorted-
subset categorical splits, CEGB and extra_trees are not
(``ROADMAP.md`` A9).

Every function takes a leading batch dimension K (the two children of
a split are searched in one pass) and keeps the JAX package's
operation order.  The bin prefix sums are taken in f64 and rounded, so
the CPU and the card compute the same f32 gains.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SplitHyperParams(NamedTuple):
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    max_delta_step: float = 0.0
    path_smooth: float = 0.0
    use_smoothing: bool = False


class SplitInfo(NamedTuple):
    """Best split of each of K leaves (reference split_info.hpp:22);
    every field is a [K] tensor."""
    gain: torch.Tensor            # f32; <= 0 means "no valid split"
    feature: torch.Tensor         # i64 inner feature index
    threshold_bin: torch.Tensor   # i64
    default_left: torch.Tensor    # bool
    is_categorical: torch.Tensor  # bool
    left_sum_g: torch.Tensor
    left_sum_h: torch.Tensor
    left_count: torch.Tensor
    left_output: torch.Tensor
    right_output: torch.Tensor


# Winner selection compares gains with the low SEL_DROP_BITS mantissa
# bits truncated, so sums taken in another order (the card's kernels,
# the JAX package's XLA code), about 1 ulp apart, cannot reorder two
# equal candidates; survivors tie-break on the smallest feature.
SEL_DROP_BITS = 10


def selection_key(g: torch.Tensor) -> torch.Tensor:
    """Quantized, weakly monotonic gain key used only to pick winners."""
    gi = g.to(torch.float32).contiguous().view(torch.int32)
    gi = gi & ~((1 << SEL_DROP_BITS) - 1)
    return gi.view(torch.float32)


def threshold_l1(s: torch.Tensor, l1: float) -> torch.Tensor:
    if l1 <= 0.0:
        return s
    return torch.sign(s) * torch.clamp(torch.abs(s) - l1, min=0.0)


def calculate_leaf_output(sum_g, sum_h, hp: SplitHyperParams, count=None,
                          parent_output=None) -> torch.Tensor:
    """CalculateSplittedLeafOutput (feature_histogram.hpp:743-781)."""
    out = -threshold_l1(sum_g, hp.lambda_l1) / (sum_h + hp.lambda_l2 + 1e-38)
    if hp.max_delta_step > 0.0:
        out = torch.clamp(out, -hp.max_delta_step, hp.max_delta_step)
    if hp.use_smoothing and count is not None and parent_output is not None:
        w = count / hp.path_smooth
        out = out * w / (w + 1.0) + parent_output / (w + 1.0)
    return out


def leaf_gain_given_output(sum_g, sum_h, out, hp: SplitHyperParams):
    """GetLeafGainGivenOutput (feature_histogram.hpp:848)."""
    sg = threshold_l1(sum_g, hp.lambda_l1)
    return -(2.0 * sg * out + (sum_h + hp.lambda_l2) * out * out)


def leaf_split_gain(sum_g, sum_h, hp: SplitHyperParams) -> torch.Tensor:
    """GetLeafGain: 2x the loss reduction of fitting the leaf."""
    sg = threshold_l1(sum_g, hp.lambda_l1)
    if hp.max_delta_step > 0.0:
        out = calculate_leaf_output(sum_g, sum_h, hp)
        return -(2.0 * sg * out + (sum_h + hp.lambda_l2) * out * out)
    return (sg * sg) / (sum_h + hp.lambda_l2 + 1e-38)


def derived_counts(h, count, sum_h):
    """Row counts estimated from hessians (feature_histogram.hpp:316):
    ``RoundInt(hess * num_data / sum_hessian)`` on the cumulative
    hessian, as the JAX package does."""
    factor = count / torch.clamp(sum_h, min=1e-38)
    return torch.floor(h * factor + 0.5)


def _candidate_tensors(hist, sum_g, sum_h, count, num_bins, has_nan, is_cat,
                       feature_mask, allow_split, hp: SplitHyperParams,
                       parent_output=None):
    """All (direction, feature, bin) candidates of K leaves: gains
    ``[K, 2, F, B]`` (-inf where invalid) and the left sums."""
    k, f, b, _ = hist.shape
    hg, hh = hist[..., 0], hist[..., 1]                        # [K, F, B]
    # prefix sums in f64, rounded once: the CPU's sequential and the
    # card's parallel scan then give the same f32
    cg = torch.cumsum(hg.double(), dim=2).to(hist.dtype)
    ch = torch.cumsum(hh.double(), dim=2).to(hist.dtype)
    nan_idx = torch.clamp(num_bins.long() - 1, min=0)          # [F]
    take = lambda a: torch.gather(                            # noqa: E731
        a, 2, nan_idx[None, :, None].expand(k, f, 1))[..., 0]
    zero = torch.zeros((), dtype=hist.dtype, device=hist.device)
    nan_g = torch.where(has_nan, take(hg), zero)               # [K, F]
    nan_h = torch.where(has_nan, take(hh), zero)

    bins_r = torch.arange(b, dtype=torch.int32, device=hist.device)[None, :]
    max_t = num_bins[:, None] - 2 - has_nan[:, None].to(torch.int32)
    num_valid = (bins_r <= max_t) & ~is_cat[:, None]           # [F, B]
    cat_valid = (bins_r < num_bins[:, None]) & is_cat[:, None]

    cat3 = is_cat[None, :, None]
    left_g0 = torch.where(cat3, hg, cg)
    left_h0 = torch.where(cat3, hh, ch)
    left_g1 = cg + nan_g[..., None]
    left_h1 = ch + nan_h[..., None]
    lg = torch.stack([left_g0, left_g1], dim=1)                # [K, 2, F, B]
    lh = torch.stack([left_h0, left_h1], dim=1)
    sg4 = sum_g[:, None, None, None]
    sh4 = sum_h[:, None, None, None]
    c4 = count[:, None, None, None]
    lc = derived_counts(lh, c4, sh4)
    valid = torch.stack([num_valid | cat_valid,
                         num_valid & has_nan[:, None]])        # [2, F, B]
    rg, rh, rc = sg4 - lg, sh4 - lh, c4 - lc

    min_data = float(hp.min_data_in_leaf)
    ok = (valid[None]
          & (lc >= min_data) & (rc >= min_data)
          & (lh >= hp.min_sum_hessian_in_leaf)
          & (rh >= hp.min_sum_hessian_in_leaf)
          & (feature_mask[None, None, :, None] > 0)
          & allow_split[:, None, None, None])
    if hp.use_smoothing:
        po4 = parent_output[:, None, None, None]
        l_out = calculate_leaf_output(lg, lh, hp, lc, po4)
        r_out = calculate_leaf_output(rg, rh, hp, rc, po4)
        parent_gain = leaf_gain_given_output(sg4, sh4, po4, hp)
        gains = (leaf_gain_given_output(lg, lh, l_out, hp)
                 + leaf_gain_given_output(rg, rh, r_out, hp)
                 - parent_gain - hp.min_gain_to_split)
    else:
        l_out = r_out = None
        parent_gain = leaf_split_gain(sg4, sh4, hp)
        gains = (leaf_split_gain(lg, lh, hp) + leaf_split_gain(rg, rh, hp)
                 - parent_gain - hp.min_gain_to_split)
    gains = torch.where(ok, gains, torch.full_like(gains, float("-inf")))
    return gains, lg, lh, lc, l_out, r_out


def find_best_split(hist, sum_g, sum_h, count, num_bins, has_nan, is_cat,
                    feature_mask, allow_split, hp: SplitHyperParams, *,
                    parent_output=None) -> SplitInfo:
    """Best split of each of K leaves.

    ``hist`` [K, F, B, 2] (grad, hess); ``sum_g``, ``sum_h``, ``count``,
    ``allow_split`` (bool) and ``parent_output`` are [K]; ``num_bins``
    [F] i32 (NaN bin included), ``has_nan`` / ``is_cat`` [F] bool,
    ``feature_mask`` [F] f32."""
    k, f, b, _ = hist.shape
    gains, lg, lh, lc, l_out, r_out = _candidate_tensors(
        hist, sum_g, sum_h, count, num_bins, has_nan, is_cat, feature_mask,
        allow_split, hp, parent_output=parent_output)
    # feature-major winner over the quantized key: equal keys tie-break
    # on the smallest feature, then direction, then bin
    flat = gains.reshape(k, -1)
    qflat = selection_key(flat)
    gmax = qflat.max(dim=1, keepdim=True).values
    io = torch.arange(flat.shape[1], device=hist.device)
    fm_rank = ((io % (f * b)) // b * (2 * b) + io // (f * b) * b + io % b)
    big = torch.full_like(fm_rank, 1 << 30)
    bi_fm = torch.where(qflat >= gmax, fm_rank[None, :],
                        big[None, :]).min(dim=1).values        # [K]
    feat = bi_fm // (2 * b)
    d = (bi_fm % (2 * b)) // b
    tbin = bi_fm % b
    best = d * (f * b) + feat * b + tbin
    pick = lambda a: torch.gather(                            # noqa: E731
        a.reshape(k, -1), 1, best[:, None])[:, 0]
    blg, blh, blc = pick(lg), pick(lh), pick(lc)
    if hp.use_smoothing:
        b_lo, b_ro = pick(l_out), pick(r_out)
    else:
        b_lo = calculate_leaf_output(blg, blh, hp)
        b_ro = calculate_leaf_output(sum_g - blg, sum_h - blh, hp)
    return SplitInfo(gain=pick(gains), feature=feat, threshold_bin=tbin,
                     default_left=d == 1, is_categorical=is_cat[feat],
                     left_sum_g=blg, left_sum_h=blh, left_count=blc,
                     left_output=b_lo, right_output=b_ro)


def pack_split_info(si: SplitInfo) -> torch.Tensor:
    """SplitInfo -> [K, 10] f32 rows (gain, feat, bin, default_left,
    is_cat, left sum_g, sum_h, count, left_out, right_out): the best-row
    layout of the grower's state."""
    f32 = torch.float32
    return torch.stack([
        si.gain, si.feature.to(f32), si.threshold_bin.to(f32),
        si.default_left.to(f32), si.is_categorical.to(f32),
        si.left_sum_g, si.left_sum_h, si.left_count,
        si.left_output, si.right_output], dim=-1)
