"""SHAP feature contributions (``pred_contrib``): TreeSHAP, and its plain
version batched over rows.

Counterpart of ``lightgbm_tpu/models/shap.py`` (``_extend_path`` :33,
``_unwind_path`` :46, ``_unwound_path_sum`` :67, ``_tree_shap`` :97,
``tree_expected_value`` :148, ``predict_contrib`` :157), which runs the
recursion of LightGBM's ``Tree::TreeSHAP`` (src/io/tree.cpp) on the host,
one row at a time.  The output is ``[n, k (F + 1)]`` f64, each class's
last slot its expected value; ``average_output`` (rf) divides by the
iterations.

One deliberate difference from the JAX package: a node's cover is its
data count, as in LightGBM (``Tree::data_count``: ``internal_count_`` /
``leaf_count_``; ``ExpectedValue`` weighs each leaf by ``leaf_count_ /
internal_count_[0]``).  The JAX package weighs by the hessian sums
(``internal_weight`` / ``leaf_weight``), which for logloss are not
counts, so its contributions are not LightGBM's (ROADMAP C).

The traversal hardly depends on the row: every node is visited, the
path's features and zero fractions (a child's cover over its parent's)
are the same for all rows, and only the one fractions (the incoming one
where the child is the row's hot child, else 0) and the path weights
depend on it.  So :func:`tree_phi` runs the recursion once a tree over
``[n]`` vectors, visiting left before right, and keeps the JAX
recursion's operations and their grouping term by term (both branches of
the ``one_fraction != 0`` tests are taken and one is selected per row).
The JAX recursion visits the hot child first, so the two add the leaves'
terms into ``phi`` in other orders, the one reason they may differ (by
a few ulps).  The CUDA kernel (``csrc/tree_shap.cu``, launched by
``ops/shap_kernel.tree_shap``) does the same operations in the same
order, so on the card the two are equal bit for bit.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .tree import _K_CATEGORICAL_MASK, _K_DEFAULT_LEFT_MASK, \
    _K_ZERO_THRESHOLD, Tree

F64 = torch.float64


def _num(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as an f64 tensor on ``like``'s device: PyTorch divides a CUDA
    tensor by a Python number as a product with its reciprocal, which is
    not the quotient, so every divisor here is a tensor."""
    return torch.full((), float(v), dtype=F64, device=like.device)


def expected_value(t: Tree) -> float:
    """Tree::ExpectedValue: the leaves' outputs weighed by their data
    counts over the root's, added in leaf order (a single leaf its
    value; a tree without counts the mean leaf value, as the JAX
    package's guard)."""
    if t.num_leaves <= 1:
        return float(t.leaf_value[0])
    total = float(t.internal_count[0])
    if total <= 0:
        return float(np.mean(t.leaf_value))
    ev = 0.0
    for cnt, v in zip(t.leaf_count, t.leaf_value):
        ev += (float(cnt) / total) * float(v)
    return ev


def tree_depth(t: Tree) -> int:
    """Depth of the tree's deepest leaf (the root at 0)."""
    if t.num_leaves <= 1:
        return 0
    depth, best, stack = 0, 0, [(0, 0)]
    while stack:
        node, depth = stack.pop()
        if node < 0:
            best = max(best, depth)
            continue
        stack.append((int(t.left_child[node]), depth + 1))
        stack.append((int(t.right_child[node]), depth + 1))
    return best


def goes_left(t: Tree, node: int, fval: torch.Tensor) -> torch.Tensor:
    """``[n]`` bool: the rows ``Tree._decide`` sends to the left child
    of ``node``, from their f64 values ``fval``."""
    d = int(t.decision_type[node])
    if d & _K_CATEGORICAL_MASK:
        cat = int(t.threshold[node])
        lo, hi = int(t.cat_boundaries[cat]), int(t.cat_boundaries[cat + 1])
        words = torch.as_tensor(t.cat_threshold[lo:hi].astype(np.int64),
                                device=fval.device)
        ok = torch.isfinite(fval) & (fval > -1.0) & (fval < (hi - lo) * 32.0)
        iv = torch.where(ok, fval, torch.zeros_like(fval)).to(torch.int64)
        if hi == lo:
            return torch.zeros_like(ok)
        bit = (words[iv // 32] >> (iv % 32)) & 1
        return ok & (bit > 0)
    missing_type = (d >> 2) & 3
    default_left = bool(d & _K_DEFAULT_LEFT_MASK)
    isnan = torch.isnan(fval)
    v = (torch.where(isnan, torch.zeros_like(fval), fval)
         if missing_type != 2 else fval)
    if missing_type == 1:
        is_default = v.abs() <= _K_ZERO_THRESHOLD
    elif missing_type == 2:
        is_default = isnan
    else:
        is_default = torch.zeros_like(isnan)
    return torch.where(is_default, default_left, v <= float(t.threshold[node]))


class _Path:
    """One node's unique path: its features and zero fractions (shared
    by all rows), its one fractions and weights (``[d + 1, n]``)."""
    __slots__ = ("feature", "zero", "one", "pweight")

    def __init__(self, feature: List[int], zero: List[float],
                 one: torch.Tensor, pweight: torch.Tensor):
        self.feature, self.zero, self.one, self.pweight = (feature, zero, one,
                                                           pweight)


def _extend(parent: _Path, ud: int, zero: float, one: torch.Tensor,
            feature: int) -> _Path:
    """The parent's first ``ud`` elements extended by one (the JAX
    ``_extend_path``): position ``j`` of the new weights is ``((z *
    w_j) * (ud - j)) / (ud + 1)`` plus, from the element below, ``((o
    * w_{j-1}) * j) / (ud + 1)``; the new last element starts at 1 (the
    root) or 0."""
    n = one.shape[0]
    dev = one.device
    start = torch.full((1, n), 1.0 if ud == 0 else 0.0, dtype=F64,
                       device=dev)
    if ud == 0:
        pw = start
    else:
        old = parent.pweight[:ud]                                 # [ud, n]
        j = torch.arange(ud, dtype=F64, device=dev)[:, None]
        d1 = _num(ud + 1, old)
        g = ((zero * old) * (ud - j)) / d1
        f = ((one * old) * (j + 1)) / d1
        pw = torch.cat([g[:1], g[1:] + f[:-1], start + f[-1:]])
    return _Path(parent.feature[:ud] + [feature], parent.zero[:ud] + [zero],
                 torch.cat([parent.one[:ud], one[None]]), pw)


def _unwind(path: _Path, ud: int, pi: int) -> _Path:
    """The JAX ``_unwind_path``: element ``pi`` taken out of the weights
    (per row, by whether its one fraction is 0) and of the features and
    fractions (the weights are not shifted)."""
    one, zero = path.one[pi], path.zero[pi]
    nz = one != 0
    nop = path.pweight[ud]
    pw = list(path.pweight)
    d1 = _num(ud + 1, one)
    for i in range(ud - 1, -1, -1):
        new_a = (nop * (ud + 1)) / ((i + 1) * one)
        nop_a = pw[i] - (((new_a * zero) * (ud - i)) / d1)
        new_b = (pw[i] * (ud + 1)) / _num(zero * (ud - i), one)
        pw[i] = torch.where(nz, new_a, new_b)
        nop = torch.where(nz, nop_a, nop)
    keep = [i for i in range(ud + 1) if i != pi]
    return _Path([path.feature[i] for i in keep],
                 [path.zero[i] for i in keep], path.one[keep],
                 torch.stack(pw))


def _unwound_sums(path: _Path, ud: int) -> torch.Tensor:
    """``[ud, n]``: the JAX ``_unwound_path_sum`` of each element 1..ud
    of a leaf's path, all at once."""
    one = path.one[1:ud + 1]                                     # [ud, n]
    zero = torch.as_tensor(path.zero[1:ud + 1], dtype=F64,
                           device=one.device)[:, None]
    nz = one != 0
    nop = path.pweight[ud].expand_as(one)
    total = torch.zeros_like(one)
    for i in range(ud - 1, -1, -1):
        w = path.pweight[i]
        tmp = (nop * (ud + 1)) / ((i + 1) * one)
        frac = _num((ud - i) / (ud + 1), one)
        total_a = total + tmp
        nop = torch.where(nz, w - ((tmp * zero) * frac), nop)
        total = torch.where(nz, total_a, total + ((w / zero) / frac))
    return total


def tree_phi(t: Tree, x: torch.Tensor, nf: int) -> torch.Tensor:
    """``[n, nf + 1]`` f64: one tree's TreeSHAP terms of the rows ``x``
    (f64 ``[n, F]``), added leaf by leaf in the order of a depth-first
    walk that visits left before right, into a fresh buffer."""
    n = x.shape[0]
    dev = x.device
    phi = torch.zeros((n, nf + 1), dtype=F64, device=dev)
    cover_node = t.internal_count.astype(np.float64)
    cover_leaf = t.leaf_count.astype(np.float64)

    def cover(c: int) -> float:
        return float(cover_node[c]) if c >= 0 else float(cover_leaf[~c])

    empty = torch.zeros((0, n), dtype=F64, device=dev)
    root = _Path([], [], empty, empty)
    ones = torch.ones(n, dtype=F64, device=dev)
    zeros = torch.zeros(n, dtype=F64, device=dev)
    stack = [(0, 0, root, 1.0, ones, -1)]
    while stack:
        node, ud, parent, pz, po, pf = stack.pop()
        path = _extend(parent, ud, pz, po, pf)
        if node < 0:
            if ud:
                w = _unwound_sums(path, ud)
                zero = torch.as_tensor(path.zero[1:], dtype=F64,
                                       device=dev)[:, None]
                term = (w * (path.one[1:] - zero)) * float(
                    t.leaf_value[~node])
                cols = torch.as_tensor(path.feature[1:], device=dev)
                phi[:, cols] = phi[:, cols] + term.T
            continue
        feat = int(t.split_feature[node])
        left, right = int(t.left_child[node]), int(t.right_child[node])
        go_left = goes_left(t, node, x[:, feat])
        w = float(cover_node[node])
        zl = cover(left) / w if w > 0 else 0.0
        zr = cover(right) / w if w > 0 else 0.0
        inc_z, inc_o = 1.0, ones
        if feat in path.feature:
            pi = path.feature.index(feat)
            inc_z, inc_o = path.zero[pi], path.one[pi]
            path = _unwind(path, ud, pi)
            ud -= 1
        stack.append((right, ud + 1, path, zr * inc_z,
                      torch.where(go_left, zeros, inc_o), feat))
        stack.append((left, ud + 1, path, zl * inc_z,
                      torch.where(go_left, inc_o, zeros), feat))
    return phi


def tree_shap_ref(trees: List[Tree], k: int, nf: int, ev: np.ndarray,
                  x: torch.Tensor, iters: int,
                  average: bool) -> torch.Tensor:
    """Plain version of the ``tree_shap`` kernel: ``[n, k (nf + 1)]``
    f64 on ``x``'s device.  Tree ``j`` (of class ``j % k``) adds its
    expected value ``ev[j]`` to its class's last slot and its
    :func:`tree_phi` to the others; ``average`` divides by ``iters``."""
    n = x.shape[0]
    out = torch.zeros((n, k, nf + 1), dtype=F64, device=x.device)
    for j, t in enumerate(trees):
        c = j % k
        out[:, c, nf] = out[:, c, nf] + float(ev[j])
        if t.num_leaves > 1:
            out[:, c, :nf] = out[:, c, :nf] + tree_phi(t, x, nf)[:, :nf]
    if average:
        out = out / _num(max(iters, 1), out)
    return out.reshape(n, k * (nf + 1))


def predict_contrib(booster, arr: np.ndarray, start: int,
                    end: int) -> np.ndarray:
    """The contributions of ``booster``'s iterations ``[start, end)`` on
    the rows ``arr`` (f64 ``[n, F]``) on the booster's device: the
    ``tree_shap`` kernel on a CUDA booster, its plain version on a CPU
    one.  ``[n, F + 1]`` for one tree an iteration, else ``[n, k (F +
    1)]``."""
    from ..ops.shap_kernel import pack_shap_forest, tree_shap
    k = max(booster._k, 1)
    trees = booster._models[start * k:end * k]
    forest = pack_shap_forest(trees, k, booster.num_feature(),
                              iters=end - start,
                              average=booster._average_output,
                              device=booster.device)
    x = torch.as_tensor(np.ascontiguousarray(arr, np.float64),
                        device=booster.device)
    return tree_shap(forest, x).cpu().numpy()
