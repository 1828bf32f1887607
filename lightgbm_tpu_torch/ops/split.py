"""Best-split search over histograms (plain PyTorch on the device).

Counterpart of ``lightgbm_tpu/ops/split.py`` (reference
feature_histogram.hpp:85,858 FindBestThreshold; its CUDA form
cuda_best_split_finder.cu:209-263): cumulative sums over the bin axis
give every threshold's left sums at once, the gains of all (direction,
feature, bin) candidates form one masked tensor, and the winner is
chosen on :func:`selection_key`, feature-major.  Numerical splits in
both missing directions, one-hot categorical splits and the sorted-
subset search over categorical features with more than
``max_cat_to_onehot`` bins (:func:`cat_subset_rank`,
:func:`cat_subset_member`, ``_cat_subset_tensors``) are ported, with
L1/L2, ``cat_l2`` / ``cat_smooth`` / ``max_cat_threshold`` /
``min_data_per_group``, ``max_delta_step``, ``min_gain_to_split``, the
min-data / min-hessian gates, path smoothing and monotone constraints
(each leaf's output bounds ``mn`` / ``mx``, the violation mask and the
depth penalty, read from :func:`monotone_penalty_table`), CEGB (a
per-count and a per-feature penalty off every gain) and extremely
randomized trees (one random threshold a feature, one random subset
size a feature, from the uniforms the grower draws for the node).

A subset winner is encoded in ``threshold_bin`` as ``B * (1 + dir) +
(k - 1)``: the first ``k`` candidate bins of the ratio order
(``dir`` 0 ascending, 1 descending) go left.  Its membership is
recomputed from the leaf's pooled histogram row by
:func:`cat_subset_member`, the finder's own ranking.  One deviation
from the JAX package: bin 0 of a categorical feature (other, NaN,
negative and unseen categories, ``io/binning.py``) is never a
categorical candidate, subset or one-hot, as the reference leaves its
other bin out (feature_histogram.hpp
FindBestThresholdCategoricalInner), because the model's bitset over raw
category values cannot send it left: a split sending it left would
route those rows one way in training and the other way in serving (the
JAX package does so, ROADMAP C).  Where bin 0 is empty the search is
the JAX package's.

Every function takes a leading batch dimension K (the two children of
a split are searched in one pass) and keeps the JAX package's
operation order; the per-leaf inputs (feature mask, CEGB penalty, the
extra trees' uniforms) are ``[K, F]`` or one ``[F]`` row for all.  The
bin prefix sums are taken in f64 and rounded, so the CPU and the card
compute the same f32 gains.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
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
    # the sorted-subset categorical search (feature_histogram.hpp:278),
    # on for categorical features with more than max_cat_to_onehot bins
    # when use_cat_subset is set
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    use_cat_subset: bool = False
    max_cat_to_onehot: int = 4
    max_cat_threshold: int = 32
    min_data_per_group: int = 100
    # monotone constraints (monotone_constraints.hpp): per-leaf output
    # bounds, the sibling-order violation mask and, with a penalty, the
    # depth factor on monotone features' gains; the intermediate method
    # (monotone_constraints.hpp:514) also tightens face-adjacent leaves'
    # bounds after each split (ops/grow.py)
    use_monotone: bool = False
    monotone_penalty: float = 0.0
    mono_intermediate: bool = False
    # extremely randomized trees (feature_histogram.hpp USE_RAND): one
    # random candidate threshold (or subset size) a feature and leaf
    use_extra_trees: bool = False
    # CEGB (cost_effective_gradient_boosting.hpp:80 DeltaGain):
    # cegb_tradeoff * cegb_penalty_split * count, plus the caller's
    # per-feature penalty, off every gain
    use_cegb: bool = False
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0


class SplitInfo(NamedTuple):
    """Best split of each of K leaves (reference split_info.hpp:22);
    every field is a [K] tensor."""
    gain: torch.Tensor            # f32; <= 0 means "no valid split"
    feature: torch.Tensor         # i64 inner feature index
    threshold_bin: torch.Tensor   # i64; a subset winner B * (1 + dir) + k - 1
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
                          parent_output=None, mn=None,
                          mx=None) -> torch.Tensor:
    """CalculateSplittedLeafOutput (feature_histogram.hpp:743-781), with
    the monotone clip to ``[mn, mx]`` last (``jnp.clip``'s order: the
    larger of the output and ``mn``, then the smaller of that and
    ``mx``)."""
    out = -threshold_l1(sum_g, hp.lambda_l1) / (sum_h + hp.lambda_l2 + 1e-38)
    if hp.max_delta_step > 0.0:
        out = torch.clamp(out, -hp.max_delta_step, hp.max_delta_step)
    if hp.use_smoothing and count is not None and parent_output is not None:
        w = count / hp.path_smooth
        out = out * w / (w + 1.0) + parent_output / (w + 1.0)
    if hp.use_monotone and mn is not None:
        out = torch.minimum(torch.maximum(out, mn), mx)
    return out


def leaf_gain_given_output(sum_g, sum_h, out, hp: SplitHyperParams):
    """GetLeafGainGivenOutput (feature_histogram.hpp:848)."""
    sg = threshold_l1(sum_g, hp.lambda_l1)
    return -(2.0 * sg * out + (sum_h + hp.lambda_l2) * out * out)


def monotone_penalty_table(penalty: float, depths: int) -> np.ndarray:
    """ComputeMonotoneSplitGainPenalty (monotone_constraints.hpp:355;
    the JAX package's ``monotone_penalty_factor``) at depths ``0 ..
    depths - 1``, f32 as the JAX package computes it.  Built once a
    training on the host: the plain versions and the kernel tail index
    it by the leaf's depth, so the CPU and the card multiply by the same
    factor (``exp2`` of a non-integer may differ by an ulp between
    them).  Without a penalty (``penalty <= 0``, where the JAX package
    applies no factor) every entry is 1.0, and the gains pass unchanged."""
    if penalty <= 0.0:
        return np.ones(depths, np.float32)
    d = np.arange(depths, dtype=np.float32)
    one, eps = np.float32(1.0), np.float32(1e-15)
    pen = np.float32(penalty)
    with np.errstate(over="ignore"):      # 2^d is inf from d = 128
        small = one - pen / np.exp2(d) + eps
    large = one - np.exp2(pen - one - d) + eps
    fac = small if penalty <= 1.0 else large
    return np.where(pen >= d + one, eps, fac).astype(np.float32)


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


def _rows(x: torch.Tensor) -> torch.Tensor:
    """A per-leaf input as ``[K or 1, F]``."""
    return x if x.dim() == 2 else x[None]


def _cegb_delta(gains, count, cegb_penalty, hp: SplitHyperParams):
    """``gains`` less CEGB's DeltaGain: ``cegb_tradeoff *
    cegb_penalty_split`` times the leaf's count, plus the leaf's
    per-feature penalty (``[K, F]`` or ``[F]``; None for none)."""
    if not hp.use_cegb:
        return gains
    delta = (hp.cegb_tradeoff * hp.cegb_penalty_split) * count[
        :, None, None, None]
    if cegb_penalty is not None:
        delta = delta + _rows(cegb_penalty)[:, None, :, None]
    return gains - delta


def random_pick(u: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The extra trees' candidate index of each feature:
    ``floor(u * (hi + 1))`` in f32 with ``hi`` clamped at 0, clipped to
    ``[0, hi]`` (the JAX package's ``rand.NextInt`` over the scan
    bounds), i32 of ``u``'s shape."""
    hm = torch.clamp(hi, min=0)
    pick = torch.floor(u * (hm + 1)).to(torch.int32)
    return torch.minimum(torch.clamp(pick, min=0), hm.to(torch.int32))


def _bounds4(mn, mx, hp: SplitHyperParams):
    """The [K] output bounds broadcast over the candidates, or None."""
    if not hp.use_monotone:
        return None, None
    return mn[:, None, None, None], mx[:, None, None, None]


def _candidate_tensors(hist, sum_g, sum_h, count, num_bins, has_nan, is_cat,
                       feature_mask, allow_split, hp: SplitHyperParams,
                       parent_output=None, monotone=None, mn=None, mx=None,
                       depth=None, penalty=None, cegb_penalty=None,
                       rand=None):
    """All (direction, feature, bin) candidates of K leaves: gains
    ``[K, 2, F, B]`` (-inf where invalid), the left sums and, where the
    search is constrained (path smoothing or monotone constraints), the
    children's outputs.  Under ``hp.use_monotone`` the outputs are
    clipped to the leaf's ``[mn, mx]``, a candidate whose outputs are out
    of its feature's ``monotone`` order is invalid, and the gains of
    monotone features are scaled by ``penalty[depth]`` (the table of
    :func:`monotone_penalty_table`, all 1.0 without a penalty).  With
    ``hp.use_extra_trees`` and the leaves' uniforms ``rand`` each
    feature keeps the one threshold :func:`random_pick` draws; with
    ``hp.use_cegb`` the gains pay :func:`_cegb_delta`."""
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
    # bin 0 (other, NaN, unseen) is no one-hot candidate: it holds no
    # raw value, so the served model sends it right
    cat_valid = ((bins_r >= 1) & (bins_r < num_bins[:, None])
                 & is_cat[:, None])
    if hp.use_cat_subset:
        # wider categorical features take the sorted-subset search only
        cat_valid = cat_valid & (num_bins[:, None] <= hp.max_cat_to_onehot)

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
          & (_rows(feature_mask)[:, None, :, None] > 0)
          & allow_split[:, None, None, None])
    if hp.use_extra_trees and rand is not None:
        # USE_RAND: one random candidate threshold a feature, within its
        # valid range (categorical: its bins); both missing directions
        # are still searched at that bin
        hi = torch.where(is_cat, num_bins - 1, max_t[:, 0])
        pick = random_pick(_rows(rand), hi)                    # [K, F]
        ok = ok & (bins_r[None, None] == pick[:, None, :, None])
    if hp.use_smoothing or hp.use_monotone:
        # GetSplitGains USE_MC / USE_SMOOTHING
        # (feature_histogram.hpp:786-824): each candidate's outputs and
        # the gains at them
        po4 = parent_output[:, None, None, None]
        mn4, mx4 = _bounds4(mn, mx, hp)
        l_out = calculate_leaf_output(lg, lh, hp, lc, po4, mn4, mx4)
        r_out = calculate_leaf_output(rg, rh, hp, rc, po4, mn4, mx4)
        if hp.use_monotone:
            mono = monotone[None, None, :, None]
            ok = ok & ~(((mono > 0) & (l_out > r_out))
                        | ((mono < 0) & (l_out < r_out)))
        parent_gain = leaf_gain_given_output(sg4, sh4, po4, hp)
        gains = (leaf_gain_given_output(lg, lh, l_out, hp)
                 + leaf_gain_given_output(rg, rh, r_out, hp)
                 - parent_gain - hp.min_gain_to_split)
        if hp.use_monotone:
            # the table is 1.0 at every depth without a penalty; depths
            # past its end read its last entry, as the kernel tail does
            d = torch.clamp(depth.long(), 0, penalty.numel() - 1)
            fac = penalty[d][:, None, None, None]
            gains = torch.where(mono != 0, gains * fac, gains)
    else:
        l_out = r_out = None
        parent_gain = leaf_split_gain(sg4, sh4, hp)
        gains = (leaf_split_gain(lg, lh, hp) + leaf_split_gain(rg, rh, hp)
                 - parent_gain - hp.min_gain_to_split)
    gains = _cegb_delta(gains, count, cegb_penalty, hp)
    gains = torch.where(ok, gains, torch.full_like(gains, float("-inf")))
    return gains, lg, lh, lc, l_out, r_out


def cat_subset_rank(hg, hh, hc, valid, hp: SplitHyperParams):
    """The candidate bins of the sorted-subset search and their rank in
    the ratio order (feature_histogram.hpp:379-400; the JAX package's
    ``cat_subset_rank``), over the last axis of ``[..., B]`` tensors.

    A candidate has a hessian-estimated count ``hc`` of at least
    ``cat_smooth`` and above 0, lies below the feature's bin count
    (``valid``) and is not bin 0; candidates are ranked ascending by
    the f32 ratio ``hg / (hh + cat_smooth)``, ties by bin.  Returns
    ``(cand bool, rank i64, used i64)``; ``rank`` means something only
    where ``cand``.  The rank is the position in a stable sort, the
    count of candidates strictly before the bin in (ratio, bin) order,
    as the JAX package counts it pairwise; ``-0.0`` is made ``+0.0``
    first, so that the card's bit-ordered sort ties it as the
    comparison does."""
    b = hg.shape[-1]
    bins = torch.arange(b, device=hg.device)
    cand = (hc >= hp.cat_smooth) & (hc > 0) & valid & (bins >= 1)
    ratio = hg / (hh + hp.cat_smooth) + 0.0
    r = torch.where(cand, ratio, torch.full_like(ratio, float("inf")))
    order = torch.sort(r, dim=-1, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        -1, order, bins.expand(order.shape).contiguous())
    used = cand.sum(dim=-1)
    return cand, rank, used


def cat_subset_member(hg, hh, hc, nb, k, direction, hp: SplitHyperParams):
    """``[..., B]`` bool membership of a subset winner: the first ``k``
    bins of the ratio-sorted candidates (``direction`` 0 ascending, 1
    descending); its bins go left (the JAX package's
    ``cat_subset_member``).  ``nb`` is the feature's bin count; ``nb``,
    ``k`` and ``direction`` broadcast against the leading dims."""
    b = hg.shape[-1]
    valid = (torch.arange(b, device=hg.device)
             < torch.as_tensor(nb, device=hg.device)[..., None])
    cand, rank, used = cat_subset_rank(hg, hh, hc, valid, hp)
    d = torch.as_tensor(direction, device=hg.device)[..., None]
    kk = torch.as_tensor(k, device=hg.device)[..., None]
    rank_d = torch.where(d > 0, used[..., None] - 1 - rank, rank)
    return cand & (rank_d < kk)


def _cat_subset_tensors(hist, sum_g, sum_h, count, num_bins, is_cat,
                        feature_mask, allow_split, hp: SplitHyperParams,
                        parent_output=None, mn=None, mx=None,
                        cegb_penalty=None, rand=None):
    """Sorted-subset candidates of K leaves (the JAX package's
    ``_cat_subset_tensors``): prefix index ``i`` of direction ``d`` means
    "the first ``i + 1`` candidates of the ratio order (``d`` 0
    ascending, 1 descending) go left".  Returns gains ``[K, 2, F, B]``
    (-inf where invalid), the left sums and, with path smoothing or
    monotone constraints, the children's outputs (clipped to the leaf's
    ``[mn, mx]``; a subset split has no order, so no violation mask and
    no penalty, as in the JAX package).  The rank-order prefix sums are taken in f64
    and rounded once, as the bin prefix sums are; the right child's
    ``min_data_per_group`` gate is applied, the group accumulator's
    ``continue`` is not (as in the JAX package).  With
    ``hp.use_extra_trees`` each feature keeps one random prefix size,
    drawn from ``rand`` (the JAX package's ``fold_in(key, 1)`` stream);
    with ``hp.use_cegb`` the gains pay :func:`_cegb_delta`."""
    k, f, b, _ = hist.shape
    hg, hh = hist[..., 0], hist[..., 1]                        # [K, F, B]
    c3, sh3 = count[:, None, None], sum_h[:, None, None]
    hc = derived_counts(hh, c3, sh3)
    valid = (torch.arange(b, device=hist.device)[None, :]
             < num_bins[:, None])                              # [F, B]
    cand, rank, used = cat_subset_rank(hg, hh, hc, valid[None], hp)
    iot = torch.arange(b, device=hist.device)
    # the bins in rank order (rank is a permutation of the bins, the
    # candidates first)
    order = torch.empty_like(rank).scatter_(
        -1, rank, iot.expand(rank.shape).contiguous())

    def _rank_cumsum(x):
        # the channel in rank order (non-candidates, last, add zero),
        # summed along it
        srt = torch.gather(x * cand, -1, order)
        return torch.cumsum(srt.double(), dim=-1).to(hist.dtype)
    # backward prefix of i + 1 = total - forward prefix of used - i - 1
    j = used[..., None] - 2 - iot                              # [K, F, B]
    jc = torch.clamp(j, 0, b - 1)

    def _dirs(cum):
        tot = cum[..., -1:]
        take_j = torch.gather(cum, -1, jc)
        bwd = tot - torch.where(j >= 0, take_j, torch.zeros_like(take_j))
        return torch.stack([cum, bwd], dim=1)                  # [K, 2, F, B]

    lg = _dirs(_rank_cumsum(hg))
    lh = _dirs(_rank_cumsum(hh)) + 1e-15
    lc = _dirs(_rank_cumsum(hc))
    sg4, sh4 = sum_g[:, None, None, None], sum_h[:, None, None, None]
    c4 = count[:, None, None, None]
    rg, rh, rc = sg4 - lg, sh4 - lh, c4 - lc

    eligible = is_cat & (num_bins > hp.max_cat_to_onehot)     # [F]
    kk = (iot + 1)[None, None, None, :]                       # prefix size
    used4 = used[:, None, :, None]
    max_num_cat = torch.clamp((used4 + 1) // 2, max=hp.max_cat_threshold)
    min_data = float(hp.min_data_in_leaf)
    ok = (eligible[None, None, :, None]
          & (kk <= max_num_cat) & (kk <= used4)
          & (lc >= min_data) & (rc >= min_data)
          & (rc >= float(hp.min_data_per_group))
          & (lh >= hp.min_sum_hessian_in_leaf)
          & (rh >= hp.min_sum_hessian_in_leaf)
          & (_rows(feature_mask)[:, None, :, None] > 0)
          & allow_split[:, None, None, None])
    if hp.use_extra_trees and rand is not None:
        # USE_RAND: one random prefix size a feature
        # (feature_histogram.hpp:401-406)
        max_thr = torch.minimum(max_num_cat, used4)[:, 0, :, 0] - 1
        pick = random_pick(_rows(rand), max_thr)               # [K, F]
        ok = ok & (iot[None, None, None, :] == pick[:, None, :, None])
    # the children's gains with l2 + cat_l2, the parent's with l2
    # (feature_histogram.hpp:297-302)
    hp2 = hp._replace(lambda_l2=hp.lambda_l2 + hp.cat_l2)
    if hp.use_smoothing or hp.use_monotone:
        po4 = parent_output[:, None, None, None]
        mn4, mx4 = _bounds4(mn, mx, hp)
        l_out = calculate_leaf_output(lg, lh, hp2, lc, po4, mn4, mx4)
        r_out = calculate_leaf_output(rg, rh, hp2, rc, po4, mn4, mx4)
        gains = (leaf_gain_given_output(lg, lh, l_out, hp2)
                 + leaf_gain_given_output(rg, rh, r_out, hp2)
                 - leaf_gain_given_output(sg4, sh4, po4, hp)
                 - hp.min_gain_to_split)
    else:
        l_out = r_out = None
        gains = (leaf_split_gain(lg, lh, hp2) + leaf_split_gain(rg, rh, hp2)
                 - leaf_split_gain(sg4, sh4, hp) - hp.min_gain_to_split)
    gains = _cegb_delta(gains, count, cegb_penalty, hp)
    gains = torch.where(ok, gains, torch.full_like(gains, float("-inf")))
    return gains, lg, lh, lc, l_out, r_out


def per_feature_best_gain(hist, sum_g, sum_h, count, num_bins, has_nan,
                          is_cat, feature_mask, hp: SplitHyperParams, *,
                          parent_output=None) -> torch.Tensor:
    """The best gain of each feature of K leaves, ``[K, F]`` (the JAX
    package's ``per_feature_best_gain``, the voting learner's ballot),
    the subset candidates included."""
    allow = torch.ones(hist.shape[0], dtype=torch.bool, device=hist.device)
    gains, *_ = _candidate_tensors(
        hist, sum_g, sum_h, count, num_bins, has_nan, is_cat, feature_mask,
        allow, hp, parent_output=parent_output)
    best = gains.amax(dim=(1, 3))
    if hp.use_cat_subset:
        gains_s, *_ = _cat_subset_tensors(
            hist, sum_g, sum_h, count, num_bins, is_cat, feature_mask,
            allow, hp, parent_output=parent_output)
        best = torch.maximum(best, gains_s.amax(dim=(1, 3)))
    return best


def find_best_split(hist, sum_g, sum_h, count, num_bins, has_nan, is_cat,
                    feature_mask, allow_split, hp: SplitHyperParams, *,
                    parent_output=None, monotone=None, mn=None, mx=None,
                    depth=None, penalty=None, cegb_penalty=None, rand=None,
                    rand_subset=None) -> SplitInfo:
    """Best split of each of K leaves.

    ``hist`` [K, F, B, 2] (grad, hess); ``sum_g``, ``sum_h``, ``count``,
    ``allow_split`` (bool) and ``parent_output`` are [K]; ``num_bins``
    [F] i32 (NaN bin included), ``has_nan`` / ``is_cat`` [F] bool,
    ``feature_mask`` [F] f32.  With ``hp.use_cat_subset`` the subset
    candidates are two more directions, and a subset winner's
    ``threshold_bin`` is ``B * (1 + dir) + (k - 1)``.  Under
    ``hp.use_monotone``: ``monotone`` i32 [F] the features' signs, ``mn``
    / ``mx`` / ``depth`` [K] each leaf's output bounds and depth,
    ``penalty`` the f32 table of :func:`monotone_penalty_table`; the
    winner's outputs are its clipped ones."""
    k, f, b, _ = hist.shape
    gains, lg, lh, lc, l_out, r_out = _candidate_tensors(
        hist, sum_g, sum_h, count, num_bins, has_nan, is_cat, feature_mask,
        allow_split, hp, parent_output=parent_output, monotone=monotone,
        mn=mn, mx=mx, depth=depth, penalty=penalty, cegb_penalty=cegb_penalty,
        rand=rand)
    constrained = hp.use_smoothing or hp.use_monotone
    if hp.use_cat_subset:
        gs, lgs, lhs, lcs, los, ros = _cat_subset_tensors(
            hist, sum_g, sum_h, count, num_bins, is_cat, feature_mask,
            allow_split, hp, parent_output=parent_output, mn=mn, mx=mx,
            cegb_penalty=cegb_penalty, rand=rand_subset)
        gains = torch.cat([gains, gs], dim=1)                  # [K, 4, F, B]
        lg, lh, lc = (torch.cat([a, c], dim=1)
                      for a, c in ((lg, lgs), (lh, lhs), (lc, lcs)))
        if constrained:
            l_out = torch.cat([l_out, los], dim=1)
            r_out = torch.cat([r_out, ros], dim=1)
    d_all = gains.shape[1]
    # feature-major winner over the quantized key: equal keys tie-break
    # on the smallest feature, then direction, then bin
    flat = gains.reshape(k, -1)
    qflat = selection_key(flat)
    gmax = qflat.max(dim=1, keepdim=True).values
    io = torch.arange(flat.shape[1], device=hist.device)
    fm_rank = ((io % (f * b)) // b * (d_all * b) + io // (f * b) * b
               + io % b)
    big = torch.full_like(fm_rank, 1 << 30)
    bi_fm = torch.where(qflat >= gmax, fm_rank[None, :],
                        big[None, :]).min(dim=1).values        # [K]
    feat = bi_fm // (d_all * b)
    d = (bi_fm % (d_all * b)) // b
    tbin = bi_fm % b
    best = d * (f * b) + feat * b + tbin
    pick = lambda a: torch.gather(                            # noqa: E731
        a.reshape(k, -1), 1, best[:, None])[:, 0]
    blg, blh, blc = pick(lg), pick(lh), pick(lc)
    if constrained:
        b_lo, b_ro = pick(l_out), pick(r_out)
    else:
        b_lo = calculate_leaf_output(blg, blh, hp)
        b_ro = calculate_leaf_output(sum_g - blg, sum_h - blh, hp)
    if hp.use_cat_subset:
        is_subset = d >= 2
        tbin = torch.where(is_subset, b * (1 + (d - 2)) + tbin, tbin)
        if not constrained:
            # subset leaf outputs with l2 + cat_l2
            # (feature_histogram.hpp:477-489)
            hp_out = hp._replace(lambda_l2=hp.lambda_l2 + hp.cat_l2)
            b_lo = torch.where(is_subset,
                               calculate_leaf_output(blg, blh, hp_out), b_lo)
            b_ro = torch.where(
                is_subset,
                calculate_leaf_output(sum_g - blg, sum_h - blh, hp_out),
                b_ro)
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
