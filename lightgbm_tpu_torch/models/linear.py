"""Linear models in the leaves (``linear_tree``).

Counterpart of ``lightgbm_tpu/models/linear.py`` (reference
linear_tree_learner.cpp): after a tree's structure is grown, each leaf
gets a ridge-regularised linear model over the numerical features on its
root-to-leaf path, from the hessian-weighted normal equations
``(XᵀHX + λI) β = -XᵀG``.  Rows with NaN in a path feature are left out
of the fit and keep the constant leaf value at prediction.

The pieces:

- :func:`leaf_path_features` (JAX ``:27-74``): the distinct numerical
  inner features on each leaf's path, from the tree's host arrays;
- :func:`fit_linear_models` (JAX ``_fit_device``, ``:77-138``): the
  moments on the device (``ops.linear_kernel.linear_moments``, f64 in a
  fixed order), one read of them, a solve per leaf on the host in f64
  (numpy), the coefficients back on the device and the training
  prediction;
- :func:`linear_leaf_output` (JAX ``:155-163``): a linear tree's output
  from leaf assignments, for validation replay, rollback and predict.

A deliberate divergence (ROADMAP C): the JAX package accumulates and
solves in f32; the port does both in f64, as LightGBM does.  A singular
system is caught per leaf (``LinAlgError``) and makes that leaf not
``ok``, as a non-finite solution or too few rows (``count < 2 * nfeat``,
the intercept counted) do; such a leaf gets no features and keeps its
constant value.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..ops.linear_kernel import design_rows, linear_moments, moment_layout


def leaf_path_features(ta, is_cat: np.ndarray, num_leaves: int) -> np.ndarray:
    """``[num_leaves, kmax]`` i32, -1 padded: each leaf's distinct
    numerical inner features along its split path, in path order.
    ``ta`` is the grown tree's host ``TreeArrays``; categorical splits
    and categorical features are left out."""
    nl = int(ta.num_leaves)
    ni = max(nl - 1, 0)
    sf = np.asarray(ta.split_feature)[:ni]
    cat = np.asarray(ta.is_categorical)[:ni]
    lc = np.asarray(ta.left_child)[:ni]
    rc = np.asarray(ta.right_child)[:ni]
    paths: List[List[int]] = [[] for _ in range(num_leaves)]
    if ni > 0:
        # iterative: a chain-shaped tree is num_leaves deep
        stack: List[Tuple[int, List[int]]] = [(0, [])]
        while stack:
            node, feats = stack.pop()
            f = int(sf[node])
            here = feats if (cat[node] or is_cat[f]) else feats + [f]
            for child in (int(lc[node]), int(rc[node])):
                if child < 0:
                    paths[~child] = list(dict.fromkeys(here))
                else:
                    stack.append((child, here))
    kmax = max((len(p) for p in paths), default=0)
    out = np.full((num_leaves, max(kmax, 1)), -1, np.int32)
    for leaf, p in enumerate(paths):
        out[leaf, :len(p)] = p
    return out


class LinearParams(NamedTuple):
    """A tree's leaf models on a device, indexed for one raw matrix:
    ``feat_idx`` i64 ``[L, kmax]`` (-1 padded; inner ids for a dataset's
    raw values, raw columns for predict input), ``coef`` f64 ``[L,
    kmax]``, ``const`` and ``leaf_value`` f64 ``[L]``."""
    feat_idx: torch.Tensor
    coef: torch.Tensor
    const: torch.Tensor
    leaf_value: torch.Tensor


class LinearFit(NamedTuple):
    """One tree's fitted leaf models: ``feat_idx`` i32 ``[L, kmax]``,
    ``coef`` f64 ``[L, kmax]``, ``const`` f64 ``[L]`` and ``ok`` bool
    ``[L]`` on the host (a leaf that is not ``ok`` has zero coefficients
    and its leaf value as the constant), ``params`` the same models on
    the device (a leaf that is not ``ok`` without features) and the
    training rows' output ``pred`` (f32 ``[n]``, device)."""
    feat_idx: np.ndarray
    coef: np.ndarray
    const: np.ndarray
    ok: np.ndarray
    params: LinearParams
    pred: torch.Tensor


def solve_leaves(moments: np.ndarray, feat_idx: np.ndarray,
                 leaf_value: np.ndarray, lam: float
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(coef, const, ok)`` from the moments ``[L, E]`` f64: one f64
    solve of ``(XᵀHX + λ I_feat) β = -XᵀG`` a leaf, the ridge on the
    feature diagonal only, masked dimensions the identity (JAX
    ``linear.py:116-133``)."""
    L, kmax = feat_idx.shape
    k1 = kmax + 1
    p, _ = moment_layout(kmax)
    iu, ju = np.triu_indices(k1)
    coef = np.zeros((L, kmax), np.float64)
    const = np.asarray(leaf_value, np.float64).copy()
    ok = np.zeros(L, bool)
    ridge = np.concatenate([np.full(kmax, float(lam)), [0.0]])
    for leaf in range(L):
        m = moments[leaf]
        a = np.zeros((k1, k1), np.float64)
        a[iu, ju] = m[:p]
        a[ju, iu] = m[:p]
        a = a + np.diag(ridge)
        vm = np.concatenate([feat_idx[leaf] >= 0, [True]])
        a = np.where(vm[:, None] & vm[None, :], a, np.eye(k1))
        b = np.where(vm, m[p:p + k1], 0.0)
        try:
            sol = -np.linalg.solve(a, b)
        except np.linalg.LinAlgError:
            continue
        if np.all(np.isfinite(sol)) and m[p + k1] >= 2.0 * vm.sum():
            ok[leaf] = True
            coef[leaf] = sol[:kmax]
            const[leaf] = sol[kmax]
    return coef, const, ok


def fit_linear_models(ta, leaf_id: torch.Tensor, raw: torch.Tensor,
                      grad: torch.Tensor, hess: torch.Tensor,
                      weight: torch.Tensor, is_cat: np.ndarray, lam: float,
                      num_leaves: int, timer) -> LinearFit:
    """Fit every leaf of the grown tree ``ta`` (host ``TreeArrays``) from
    its rows' raw values, gradients, hessians and in-bag weights
    (``leaf_id`` ``[n]``, the rest ``[n]`` f32 on the training device,
    ``raw`` ``[n, F]`` f32) and return the fit with the training rows'
    output (JAX ``fit_linear_models``).  ``timer`` (a ``StageTimer``)
    times the three parts as ``linear_moments``, ``linear_solve`` and
    ``linear_predict``."""
    dev = raw.device
    feat_idx = leaf_path_features(ta, is_cat, num_leaves)
    with timer.stage("linear_moments", dev):
        moments = linear_moments(raw, leaf_id.to(torch.int32).contiguous(),
                                 grad.contiguous(), hess.contiguous(),
                                 weight.contiguous(),
                                 torch.as_tensor(feat_idx, device=dev))
    with timer.stage("linear_solve", dev):
        lv = np.asarray(ta.leaf_value, np.float64)[:num_leaves]
        coef, const, ok = solve_leaves(moments.cpu().numpy(), feat_idx, lv,
                                       lam)
    with timer.stage("linear_predict", dev):
        params = linear_params(
            [f[f >= 0] if good else f[:0] for f, good in zip(feat_idx, ok)],
            list(coef), const, lv, dev)
        pred = linear_leaf_output(leaf_id, raw, params).to(torch.float32)
    return LinearFit(feat_idx, coef, const, ok, params, pred)


def linear_params(feats, coefs, const, leaf_value, device) -> LinearParams:
    """Device parameters of a tree's leaf models from its per-leaf
    feature ids ``feats`` and coefficients ``coefs`` (lists of arrays)."""
    nl = len(feats)
    kmax = max([len(f) for f in feats] + [1])
    fi = np.full((nl, kmax), -1, np.int64)
    co = np.zeros((nl, kmax), np.float64)
    for leaf in range(nl):
        k = len(feats[leaf])
        fi[leaf, :k] = feats[leaf]
        co[leaf, :k] = np.asarray(coefs[leaf], np.float64)[:k]
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return LinearParams(t(fi), t(co), t(np.asarray(const, np.float64)),
                        t(np.asarray(leaf_value, np.float64)))


def linear_leaf_output(leaf: torch.Tensor, raw: torch.Tensor,
                       p: LinearParams) -> torch.Tensor:
    """A tree's f64 output of the rows of ``raw`` (f32 or f64 ``[n, F]``)
    whose leaves are ``leaf`` (JAX ``linear_leaf_output``): ``const +
    Σ_k coef_k · x_k``, the terms added in k order, each product and sum
    its own elementwise op (so the CPU and the card round alike); a row
    with a NaN model feature keeps the leaf value, and a leaf without
    features outputs its constant."""
    leaf = leaf.long()
    x, nan_row = design_rows(raw, torch.arange(len(leaf), device=raw.device),
                             p.feat_idx[leaf])
    x = x.to(torch.float64)
    lin = p.const[leaf]
    cl = p.coef[leaf]
    for k in range(p.coef.shape[1]):
        lin = lin + cl[:, k] * x[:, k]
    return torch.where(nan_row, p.leaf_value[leaf], lin)
