"""Regression objectives (reference regression_objective.hpp; the
port's copy of ``lightgbm_tpu/objective/regression.py``): l2, l1,
huber, fair, poisson, quantile, mape, gamma and tweedie.

The gradient expressions keep the JAX package's operation order, one
f32 rounding per operation, with ``exp`` taken in f64 and rounded once
(``base.exp32``).  Objectives whose optimal leaf value is a percentile
(l1, huber, quantile, mape) declare ``NEEDS_RENEW``: after each tree the
booster refits the leaf outputs with :func:`renew_leaf_values`, a
per-leaf (weighted) percentile of the residuals, in PyTorch ops on the
training device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import log
from .base import ObjectiveFunction, exp32


def _weighted_mean(values: np.ndarray, weight) -> float:
    if weight is None:
        return float(np.mean(values))
    return float(np.sum(values * weight) / np.sum(weight))


def _weighted_percentile_np(values: np.ndarray, weight: np.ndarray,
                            alpha: float) -> float:
    """Weighted percentile of the boost-from-average score (the JAX
    package's ``_weighted_percentile_np``)."""
    order = np.argsort(values)
    v, w = values[order], weight[order]
    cum = np.cumsum(w)
    if cum[-1] <= 0:
        return 0.0
    idx = int(np.searchsorted(cum, alpha * cum[-1]))
    return float(v[min(idx, len(v) - 1)])


def l2_gradients(score, target, weight=None):
    """(grad, hess) of l2: ``score - target`` and 1, each times the
    weight when there is one."""
    grad = score - target
    hess = torch.ones_like(score)
    if weight is not None:
        grad = grad * weight
        hess = hess * weight
    return grad, hess


class RegressionL2(ObjectiveFunction):
    NAME = "regression"
    STREAM_KIND = "l2"

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = config.reg_sqrt
        self._trans_label = None

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if self.sqrt:
            lab = np.asarray(metadata.label, dtype=np.float64)
            self._trans_label = torch.as_tensor(
                np.sign(lab) * np.sqrt(np.abs(lab)), dtype=torch.float32,
                device=device)

    @property
    def _target(self):
        return self._trans_label if self.sqrt else self.label

    def get_gradients(self, score):
        return l2_gradients(score, self._target, self.weight)

    def stream_consts(self):
        """Per-row constants of the stream route: [n, 2] (target,
        weight), the weight 1 where there is none (``l2_consts``)."""
        w = (torch.ones_like(self._target) if self.weight is None
             else self.weight)
        return torch.stack([self._target, w], dim=1)

    def boost_from_score(self):
        if not self.config.boost_from_average:
            return np.zeros(1)
        lab = self._target.double().cpu().numpy()
        if self.weight is None:
            sl, sw = float(lab.sum()), float(len(lab))
        else:
            w = self.weight.double().cpu().numpy()
            sl, sw = float((lab * w).sum()), float(w.sum())
        return np.array([sl / max(sw, 1.0)])

    def convert_output(self, raw):
        if self.sqrt:
            return torch.sign(raw) * raw * raw
        return raw

    def __str__(self):
        return "regression" + (" sqrt" if self.sqrt else "")


class RegressionL1(ObjectiveFunction):
    NAME = "regression_l1"
    NEEDS_RENEW = True

    def get_gradients(self, score):
        grad = torch.sign(score - self.label)
        return self._apply_weight(grad, torch.ones_like(score))

    def boost_from_score(self):
        if not self.config.boost_from_average:
            return np.zeros(1)
        lab = self.label_np.astype(np.float64)
        if self.weight_np is None:
            return np.array([np.median(lab)])
        return np.array([_weighted_percentile_np(
            lab, self.weight_np.astype(np.float64), 0.5)])

    def renew_leaf_percentile(self):
        return 0.5


class Huber(ObjectiveFunction):
    NAME = "huber"
    NEEDS_RENEW = True

    def get_gradients(self, score):
        a = self.config.alpha
        grad = torch.clamp(score - self.label, -a, a)
        return self._apply_weight(grad, torch.ones_like(score))

    def renew_leaf_percentile(self):
        return 0.5


class Fair(ObjectiveFunction):
    NAME = "fair"

    def get_gradients(self, score):
        c = self.config.fair_c
        diff = score - self.label
        denom = torch.abs(diff) + c
        grad = c * diff / denom
        # a tensor numerator: PyTorch's ``scalar / t`` is
        # ``t.reciprocal() * scalar``, two roundings where JAX has one
        hess = torch.full_like(denom, c * c) / (denom * denom)
        return self._apply_weight(grad, hess)


class Poisson(ObjectiveFunction):
    NAME = "poisson"

    def check_label(self, label):
        if np.any(label < 0):
            log.fatal("[poisson]: at least one target label is negative")

    def get_gradients(self, score):
        grad = exp32(score) - self.label
        hess = exp32(score + self.config.poisson_max_delta_step)
        return self._apply_weight(grad, hess)

    def boost_from_score(self):
        if not self.config.boost_from_average:
            return np.zeros(1)
        lab = self.label_np.astype(np.float64)
        return np.array([np.log(max(_weighted_mean(lab, self.weight_np),
                                    1e-20))])

    def convert_output(self, raw):
        return exp32(raw)


class Quantile(ObjectiveFunction):
    NAME = "quantile"
    NEEDS_RENEW = True

    def get_gradients(self, score):
        a = self.config.alpha
        delta = score - self.label
        grad = torch.where(delta >= 0, torch.full_like(score, 1.0 - a),
                           torch.full_like(score, -a))
        return self._apply_weight(grad, torch.ones_like(score))

    def boost_from_score(self):
        if not self.config.boost_from_average:
            return np.zeros(1)
        lab = self.label_np.astype(np.float64)
        w = (np.ones_like(lab) if self.weight_np is None
             else self.weight_np.astype(np.float64))
        return np.array([_weighted_percentile_np(lab, w, self.config.alpha)])

    def renew_leaf_percentile(self):
        return self.config.alpha


class Mape(ObjectiveFunction):
    NAME = "mape"
    NEEDS_RENEW = True

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        lw = 1.0 / torch.clamp(torch.abs(self.label), min=1.0)
        self._label_weight = lw if self.weight is None else lw * self.weight

    def get_gradients(self, score):
        grad = torch.sign(score - self.label) * self._label_weight
        return grad, self._label_weight

    def renew_leaf_percentile(self):
        return 0.5

    def renew_weight(self):
        # mape refits against its label weights, always weighted
        # (regression_objective.hpp:650)
        return self._label_weight


class Gamma(Poisson):
    NAME = "gamma"

    def check_label(self, label):
        if np.any(label <= 0):
            log.fatal("[gamma]: at least one target label is not positive")

    def get_gradients(self, score):
        e = exp32(-score)
        grad = 1.0 - self.label * e
        hess = self.label * e
        return self._apply_weight(grad, hess)


class Tweedie(Poisson):
    NAME = "tweedie"

    def check_label(self, label):
        if np.any(label < 0):
            log.fatal("[tweedie]: at least one target label is negative")

    def get_gradients(self, score):
        rho = self.config.tweedie_variance_power
        e1 = exp32((1.0 - rho) * score)
        e2 = exp32((2.0 - rho) * score)
        grad = -self.label * e1 + e2
        hess = -self.label * (1.0 - rho) * e1 + (2.0 - rho) * e2
        return self._apply_weight(grad, hess)


SCAN_BASE = 16


def blocked_cumsum(x: torch.Tensor, base: int = SCAN_BASE) -> torch.Tensor:
    """Inclusive f32 prefix sums of ``x`` [n] in XLA:CPU's order for a
    cumulative sum (the JAX package's ``jnp.cumsum`` on its CPU
    backend): rows of ``base`` elements summed left to right, each
    row's total scanned the same way, recursively, and added to the
    row's elements.  Elementwise f32 additions in a fixed order, so
    every device computes the same bits."""
    n = x.shape[0]
    rows = -(-n // base)
    xp = x.new_zeros(rows * base)
    xp[:n] = x
    inner = xp.view(rows, base).clone()
    for j in range(1, base):
        inner[:, j] = inner[:, j - 1] + inner[:, j]
    if rows == 1:
        return inner.view(-1)[:n]
    outer = blocked_cumsum(inner[:, -1].contiguous(), base)
    excl = torch.cat([outer.new_zeros(1), outer[:-1]])
    return (inner + excl[:, None]).view(-1)[:n]


def segment_sums_seq(v: torch.Tensor, start: torch.Tensor,
                     count: torch.Tensor) -> torch.Tensor:
    """f32 sum of each segment ``v[start:start + count]``, added left
    to right from 0 (XLA:CPU's order for ``segment_sum`` over sorted
    segments): one step a position, over every segment at once."""
    out = v.new_zeros(start.shape[0])
    steps = int(count.max()) if count.numel() else 0
    n = v.shape[0]
    for j in range(steps):
        take = j < count
        x = v[(start + j).clamp(max=max(n - 1, 0))]
        out = torch.where(take, out + x, out)
    return out


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of f32 tensors rounded once to f32, as the fused
    multiply-add XLA:CPU contracts such a pair into: the product is
    exact in f64 and the sum is rounded there and then to f32 (the two
    roundings differ from one only at an exact f32 tie of the f64
    sum)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def renew_leaf_values(resid: torch.Tensor, w: torch.Tensor,
                      leaf_id: torch.Tensor, valid: torch.Tensor,
                      leaf_value0: torch.Tensor, *, L: int, alpha: float,
                      weighted: bool) -> torch.Tensor:
    """Per-leaf percentile refit of the leaf outputs (the JAX package's
    ``device_renew_leaf_values``; reference PercentileFun and
    WeightedPercentileFun, regression_objective.hpp:18-88), on the
    device of its inputs: the rows sorted by (leaf, residual) with a
    stable sort by residual and then a stable sort by leaf
    (``lexsort``'s order), each leaf's segment found by its count, and
    the straddling order statistics interpolated in the JAX package's
    f32 arithmetic as XLA:CPU evaluates it: the weighted scheme's
    cumulative weights and leaf totals added in its order
    (:func:`blocked_cumsum`, :func:`segment_sums_seq`), and a product
    followed by an addition fused into one rounding (:func:`_fma`).
    Its branches (the first cumulative weight above the threshold, a
    cdf gap of at least 1) turn on single roundings, so the port
    follows those bits, on every device.

    ``resid``, ``w`` and ``valid`` [n] (``w`` read only when
    ``weighted``), ``leaf_id`` [n], ``leaf_value0`` [L] f32: the outputs
    of leaves no valid row reaches.  Returns the [L] f32 outputs."""
    dev = resid.device
    n = resid.shape[0]
    f32, i64 = torch.float32, torch.int64
    lid = torch.where(valid, leaf_id.to(i64),
                      torch.full_like(leaf_id, L, dtype=i64))
    by_resid = torch.sort(resid, stable=True).indices
    order = by_resid[torch.sort(lid[by_resid], stable=True).indices]
    v = resid[order]
    ls = lid[order]
    icnt = torch.bincount(ls, minlength=L + 1)[:L]
    istart = torch.cumsum(icnt, 0) - icnt

    def gv(idx):
        return v[idx.clamp(0, max(n - 1, 0))]

    vfirst = gv(istart)
    if not weighted:
        # PercentileFun: the position (1 - alpha) * cnt from the largest,
        # interpolated between its two neighbouring order statistics
        fpos = (1.0 - alpha) * icnt.to(f32)
        p = torch.floor(fpos).to(i64)
        bias = fpos - p.to(f32)
        vmax = gv(istart + icnt - 1)
        v1 = gv(istart + icnt - p)
        v2 = gv(istart + icnt - 1 - p)
        mid = _fma(-(v1 - v2), bias, v1)
        out = torch.where(p < 1, vmax, torch.where(p >= icnt, vfirst, mid))
    else:
        # WeightedPercentileFun: the first row whose cumulative weight in
        # its leaf passes alpha * total, the edges passed through, and
        # interpolation only where the cdf gap reaches 1
        lw = w[order] * (ls < L).to(f32)
        cumw = blocked_cumsum(lw)
        tot = segment_sums_seq(lw, istart, icnt)
        base = torch.cat([tot.new_zeros(1), blocked_cumsum(tot)])[:L]
        rel = cumw - torch.cat([base, base.new_zeros(1)])[ls]
        thr = alpha * tot
        hit = rel > torch.cat([thr, thr.new_full((1,), float("inf"))])[ls]
        pos = torch.arange(n, dtype=i64, device=dev)
        gpos = torch.full((L + 1,), n, dtype=i64, device=dev).scatter_reduce(
            0, ls, torch.where(hit, pos, torch.full_like(pos, n)), "amin")[:L]
        prel = torch.minimum((gpos - istart).clamp(min=0),
                             (icnt - 1).clamp(min=0))
        v1 = gv(istart + prel - 1)
        v2 = gv(istart + prel)

        def cdf_at(k):
            return cumw[(istart + k).clamp(0, max(n - 1, 0))] - base

        c_pos = cdf_at(prel)
        gap = cdf_at(prel + 1) - c_pos
        # thr - c_pos, with thr's product unrounded
        num = _fma(torch.full_like(tot, alpha), tot, -c_pos)
        frac = num / torch.where(gap == 0.0, torch.ones_like(gap), gap)
        interp = _fma(frac, v2 - v1, v1)
        mid = torch.where(gap >= 1.0, interp, v2)
        at_edge = (prel == 0) | (prel == icnt - 1)
        out = torch.where(at_edge, gv(istart + prel), mid)
    out = torch.where(icnt <= 1, vfirst, out)
    return torch.where(icnt > 0, out, leaf_value0[:L])
