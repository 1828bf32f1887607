"""The regression and cross-entropy objectives, the leaf renewal and the
metrics of the PyTorch port against the JAX package, on the CPU.

- (a) Gradients: each objective's ``get_gradients`` on seeded scores
  equals the JAX objective's bit for bit where no transcendental is
  taken, and within 2 f32 ulps, or 16 f32 eps of the largest magnitude,
  where ``exp`` or ``log1p`` is (the port takes them in f64 and rounds
  once; the weighted lambda link's cancellations amplify that to 5e-4
  of the value); ``boost_from_score`` equal.
- (b) ``renew_leaf_values`` against the JAX ``device_renew_leaf_values``
  on adversarial leaves (ties, one row, an empty leaf, rows outside the
  bag, zero weights and so zero cdf gaps, alphas 0.1, 0.5 and 0.9, both
  interpolation schemes, integer and half weights whose f32 sums are
  exact and random ones whose sums round): equal bits.  The port adds
  the weights in XLA:CPU's order and rounds its fused multiply-adds
  once, as the JAX package's CPU backend does; the blocked scan alone
  is held against ``jnp.cumsum``.
- (c) Training, 2 trees of 15 leaves on ``test_torch_train``'s parity
  generator (2,000 x 6, seed 11), each objective on a label it accepts, the
  port on the route it picks (``path=physical fused=1 tail=kernel
  (objective_not_streamable)``) against the JAX package on its
  row-order route: trees equal in structure; leaves within 1.2e-5 of
  the tree's largest, or, where a leaf's gap passes that, its gradient
  and hessian sums (``-G / H`` is the unregularized leaf) differing by
  at most 16 f32 ulps of the root's sums of ``|g|`` and ``h`` (the
  sibling subtraction carries the root's f32 noise down to the smallest
  leaves; ROADMAP C), and within ``test_torch_train.LEAF_RTOL``; raw
  scores within 3.5e-6, or, where the row's trees' leaf gaps add up to
  more (fair's varying hessians put its leaves up to 1.1e-5 of the
  largest apart), within that sum, plus 4 f32 eps of the score;
  converted predictions within the same bound times the conversion's
  slope.  The renewed leaves of l1, huber, quantile and mape are the
  percentiles of the rows' residuals.
- (d) Each metric of ``metric/metrics.py`` against the JAX metric on
  seeded scores, with and without weights, within 1e-5; ``lambdarank``
  and ``rank_xendcg`` on a dataset without query groups raise
  ``LightGBMError`` as the JAX package does (tests/test_torch_rank.py
  holds them, and ``ndcg`` and ``map``, against it).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightgbm_tpu_torch as lgt
from chip_smoke import compare_trees
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset_core import Metadata as JMetadata
from lightgbm_tpu.metric.metrics import create_metrics as j_metrics
from lightgbm_tpu.objective import create_objective as j_objective
from lightgbm_tpu.objective.regression import device_renew_leaf_values
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset_core import Metadata as TMetadata
from lightgbm_tpu_torch.metric import create_metrics as t_metrics
from lightgbm_tpu_torch.objective import create_objective as t_objective
from lightgbm_tpu_torch.objective.regression import (blocked_cumsum,
                                                     renew_leaf_values)
from lightgbm_tpu_torch.utils.log import LightGBMError
from test_torch_train import (LEAF_RTOL, ROW_ORDER_ROUTE, SETTING_LEAF_RTOL,
                              SETTING_RAW_ATOL, _data, _first_divergence,
                              _jax_train, _port_train)

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
ROUNDS = 2
N_ROWS = 2000
ROUTE = "path=physical fused=1 tail=kernel (objective_not_streamable)"


def labels_for(objective: str, y_raw: np.ndarray, seed: int = 5):
    """A seeded label ``objective`` accepts, from the parity generator's
    continuous target: counts for poisson and tweedie, positive values
    for gamma, probabilities for the cross-entropies, the target itself
    (both signs) for the rest."""
    rng = np.random.default_rng(seed)
    if objective in ("poisson", "tweedie"):
        return rng.poisson(np.exp(0.3 * y_raw)).astype(np.float32)
    if objective == "gamma":
        return np.exp(0.3 * y_raw + 0.2 * rng.normal(size=len(y_raw))
                      ).astype(np.float32)
    if objective.startswith("cross_entropy"):
        return (1.0 / (1.0 + np.exp(-y_raw))).astype(np.float32)
    return y_raw.astype(np.float32)


def _metadata(y, w=None):
    jm, tm = JMetadata(), TMetadata()
    for m in (jm, tm):
        m.set_label(y)
        if w is not None:
            m.set_weight(w)
    return jm, tm


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


# -- (a) gradients -------------------------------------------------------
# objective -> (params, weighted, takes exp / log1p)
GRADIENTS = {
    "regression_l1": ({}, False, False),
    "huber": ({"alpha": 0.7}, True, False),
    "fair": ({"fair_c": 0.8}, True, False),
    "quantile": ({"alpha": 0.9}, True, False),
    "mape": ({}, True, False),
    "poisson": ({}, True, True),
    "gamma": ({}, False, True),
    "tweedie": ({"tweedie_variance_power": 1.3}, True, True),
    "cross_entropy": ({}, True, True),
    "cross_entropy_lambda": ({}, True, True),
    "cross_entropy_lambda_unweighted": ({}, False, True),
}


@pytest.mark.parametrize("name", list(GRADIENTS))
def test_gradients_match_jax(name):
    objective = name.replace("_unweighted", "")
    params, weighted, transcendental = GRADIENTS[name]
    rng = np.random.default_rng(9)
    n = 20000
    y = labels_for(objective, rng.normal(size=n) * 2)
    w = (rng.uniform(0.2, 2.0, n).astype(np.float32) if weighted else None)
    score = (rng.normal(size=n) * 1.5).astype(np.float32)
    jm, tm = _metadata(y, w)
    p = dict({"objective": objective}, **params)
    jo = j_objective(JConfig.from_params(p))
    jo.init(jm, n)
    to = t_objective(TConfig.from_params(p))
    to.init(tm, n, torch.device("cpu"))
    gj, hj = (np.asarray(a) for a in jo.get_gradients(jnp.asarray(score)))
    gt, ht = (a.numpy() for a in to.get_gradients(torch.tensor(score)))
    assert gt.dtype == ht.dtype == np.float32
    np.testing.assert_allclose(to.boost_from_score(), jo.boost_from_score(),
                               rtol=1e-15, atol=0)
    if not transcendental:
        np.testing.assert_array_equal(gt, gj)
        np.testing.assert_array_equal(ht, hj)
        return
    # the f64 exp rounded once against XLA's f32 exp: a last-place unit
    # of the exp, carried through the formula's f32 operations; the
    # weighted lambda link subtracts nearly equal terms (``1 - y / z``,
    # ``c - 1`` and ``1 + w e - c`` with ``c = 1 / (1 - z)``), which
    # amplify it up to some 4e-4 of the value
    rel = 5e-4 if name == "cross_entropy_lambda" else 0.0
    for t, j in ((gt, gj), (ht, hj)):
        close = _ulps(t, j) <= 2
        scale = 16 * EPS32 * max(float(np.abs(j).max()), 1.0)
        assert np.all(close | (np.abs(t - j) <= scale + rel * np.abs(j)))


# -- (b) the leaf renewal ------------------------------------------------
def _renew_case(kind: str, seed: int):
    """(resid, w, leaf_id, valid, leaf_value0, L): 400 rows over 8 leaves
    with ties, a one-row leaf (6), an empty leaf (7), rows outside the
    bag and zero weights."""
    rng = np.random.default_rng(seed)
    n, L = 400, 8
    lid = rng.integers(0, 6, n).astype(np.int32)
    lid[17] = 6
    resid = rng.normal(size=n).astype(np.float32)
    resid[lid == 2] = np.round(resid[lid == 2])          # heavy ties
    resid[lid == 3] = 0.25                               # all tied
    valid = rng.random(n) > 0.1
    if kind == "exact":
        w = rng.integers(0, 5, n).astype(np.float32) * 0.5
    else:
        w = rng.uniform(0.0, 3.0, n).astype(np.float32)
    w[lid == 4] = np.where(rng.random((lid == 4).sum()) < 0.5, 0.0,
                           w[lid == 4])                  # zero cdf gaps
    lv0 = rng.normal(size=L).astype(np.float32)
    return resid, w, lid, valid, lv0, L


RENEW = [(kind, alpha, weighted) for kind in ("exact", "random")
         for alpha in (0.1, 0.5, 0.9) for weighted in (False, True)
         if weighted or kind == "exact"]


@pytest.mark.parametrize("kind,alpha,weighted", RENEW)
def test_renew_matches_jax(kind, alpha, weighted):
    for seed in range(2 if kind == "random" else 1):
        resid, w, lid, valid, lv0, L = _renew_case(kind, seed)
        want = np.asarray(device_renew_leaf_values(
            jnp.asarray(resid), jnp.asarray(w), jnp.asarray(lid),
            jnp.asarray(valid), jnp.asarray(lv0), L=L, alpha=alpha,
            weighted=weighted))
        got = renew_leaf_values(
            torch.from_numpy(resid), torch.from_numpy(w),
            torch.from_numpy(lid), torch.from_numpy(valid),
            torch.from_numpy(lv0), L=L, alpha=alpha,
            weighted=weighted).numpy()
        assert got.dtype == np.float32
        assert got[7] == lv0[7]                      # empty leaf
        assert got[6] == resid[17] or not valid[17]  # one row
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 256, 257, 4097, 70000])
def test_blocked_cumsum_is_xla_cumsum(n):
    """The weighted refit's prefix sums: bitwise ``jnp.cumsum`` on the
    CPU backend, at lengths around the blocks of 16 and past two
    levels of them."""
    x = np.random.default_rng(n).uniform(0.0, 3.0, n).astype(np.float32)
    got = blocked_cumsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.cumsum(
        jnp.asarray(x))))


def test_renew_unweighted_is_the_percentile_of_each_leaf():
    """Unweighted, the refit is PercentileFun: the order statistic
    (1 - alpha) * cnt from the largest, linearly interpolated."""
    resid, _, lid, valid, lv0, L = _renew_case("exact", 0)
    got = renew_leaf_values(
        torch.from_numpy(resid), torch.ones(len(resid)),
        torch.from_numpy(lid), torch.from_numpy(valid),
        torch.from_numpy(lv0), L=L, alpha=0.5, weighted=False).numpy()
    for leaf in range(6):
        v = np.sort(resid[valid & (lid == leaf)])
        cnt = len(v)
        fpos = np.float32(0.5) * np.float32(cnt)
        p = int(np.floor(fpos))
        if cnt <= 1 or p < 1:
            want = v[-1] if cnt else lv0[leaf]
        elif p >= cnt:
            want = v[0]
        else:
            v1, v2 = v[cnt - p], v[cnt - 1 - p]
            want = v1 - (v1 - v2) * np.float32(fpos - p)
        assert got[leaf] == np.float32(want), leaf


# -- (c) training ---------------------------------------------------------
# name -> (params over the base, weighted rows, the (tree, leaf) pairs
# whose gap passes 1.2e-5 of the largest leaf, held through their sums)
TRAIN = {
    "regression_l1": ({"objective": "regression_l1"}, False, []),
    "huber": ({"objective": "huber", "alpha": 0.7}, False, []),
    "fair": ({"objective": "fair"}, False, []),
    "poisson": ({"objective": "poisson"}, False, []),
    "quantile": ({"objective": "quantile", "alpha": 0.9}, False, []),
    "mape": ({"objective": "mape"}, False, []),
    "gamma": ({"objective": "gamma"}, False, []),
    "tweedie": ({"objective": "tweedie"}, False, []),
    "cross_entropy": ({"objective": "cross_entropy"}, False, []),
    "cross_entropy_lambda": ({"objective": "cross_entropy_lambda"}, True,
                             [(1, 13)]),
}


def _root_sums(bt, x, t: int):
    """(sum of |g|, sum of h) over the rows before tree ``t`` of the
    port's booster ``bt``, for its class: the scale of the f32 sums the
    root's histogram and every sibling subtraction below it round at."""
    inner = bt._inner
    k = inner.num_tree_per_iteration
    it, c = divmod(t, k)
    init = np.asarray(inner.objective.boost_from_score(), np.float32)
    if it == 0:
        score = np.broadcast_to(init[:, None], (k, len(x)))
    else:
        score = np.asarray(bt.predict(x, raw_score=True, num_iteration=it),
                           np.float32).reshape(len(x), k).T
    score = torch.from_numpy(np.ascontiguousarray(score, np.float32))
    g, h = inner.objective.get_gradients(score if k > 1 else score[0])
    g, h = g.reshape(k, -1)[c].double(), h.reshape(k, -1)[c].double()
    return float(g.abs().sum()), float(h.sum())


def hold_trees(bt, bj, x, rate: float = 0.1):
    """Hold the port's booster ``bt`` to the JAX booster ``bj`` (module
    docstring, (c)); returns the leaves held through their gradient and
    hessian sums as (tree, leaf) pairs, and both raw scores."""
    assert _first_divergence(bt._models, bj._models) is None
    res = compare_trees(bt._models, bj._models, rtol=LEAF_RTOL)
    assert res["ok"], res
    k = bt._inner.num_tree_per_iteration
    init = bt._inner.objective.boost_from_score()
    leaves_t = np.asarray(bt.predict(x, pred_leaf=True))
    # each row's raw gap as its trees' leaf gaps add up
    implied = np.zeros((x.shape[0], k))
    noisy = []
    for t, (a, b) in enumerate(zip(bt._models, bj._models)):
        big = float(np.abs(b.leaf_value).max())
        gap = np.abs(a.leaf_value - b.leaf_value)
        implied[:, t % k] += gap[leaves_t[:, t]]
        over = np.nonzero(gap > SETTING_LEAF_RTOL * big)[0]
        if not len(over):
            continue
        assert not bt._inner.objective.NEEDS_RENEW
        bias = init[t] if t < k and abs(init[t]) > 1e-35 else 0.0
        g_abs, h_sum = _root_sums(bt, x, t)
        for leaf in over:
            ht, hj = a.leaf_weight[leaf], b.leaf_weight[leaf]
            gt = -(a.leaf_value[leaf] - bias) / rate * ht
            gj = -(b.leaf_value[leaf] - bias) / rate * hj
            assert abs(ht - hj) <= 16 * np.spacing(np.float32(h_sum)), \
                (t, leaf, ht, hj)
            assert abs(gt - gj) <= 16 * np.spacing(np.float32(g_abs)), \
                (t, leaf, gt, gj)
            noisy.append((t, int(leaf)))
    raw_t = np.asarray(bt.predict(x, raw_score=True)).reshape(len(x), -1)
    raw_j = np.asarray(bj.predict(x, raw_score=True)).reshape(len(x), -1)
    serve = 4 * EPS32 * np.maximum(np.abs(raw_j), 1.0)
    assert np.all(np.abs(raw_t - raw_j)
                  <= np.maximum(SETTING_RAW_ATOL, implied) + serve)
    return noisy, raw_t, raw_j


@pytest.mark.parametrize("name", list(TRAIN))
def test_training_matches_jax(name):
    params, weighted, want_noisy = TRAIN[name]
    x, y_raw = _data(N_ROWS, 6, 11, "regression")
    y = labels_for(params["objective"], y_raw)
    ds_kw = {}
    if weighted:
        ds_kw["weight"] = np.random.default_rng(11).uniform(
            0.2, 2.0, len(y)).astype(np.float32)
    p = dict({"num_leaves": 15, "verbosity": -1}, **params)
    bj, _, _ = _jax_train(p, x, y, ROUNDS, route=ROW_ORDER_ROUTE,
                          ds_kw=ds_kw)
    bt = _port_train(p, x, y, ROUNDS, {}, ds_kw=ds_kw)
    assert bt._inner.grow.route.describe() == ROUTE
    assert len(bt._models) == len(bj._models) == ROUNDS
    assert all(t.num_leaves > 1 for t in bt._models)
    noisy, raw_t, raw_j = hold_trees(bt, bj, x)
    assert noisy == want_noisy
    conv_t, conv_j = bt.predict(x), np.asarray(bj.predict(x))
    assert conv_t.shape == (len(x),)
    # exp (poisson, gamma, tweedie) scales a raw gap by the output
    slope = np.maximum(np.abs(conv_j), 1.0)
    assert np.all(np.abs(conv_t - conv_j) <= slope * (
        np.abs(raw_t - raw_j)[:, 0] + 4 * EPS32))
    if bt._inner.objective.NEEDS_RENEW:
        # tree 0's leaves are the percentiles of the first residuals
        obj = bt._inner.objective
        init = np.float32(obj.boost_from_score()[0]
                          if p.get("boost_from_average", True) else 0.0)
        resid = (y - init).astype(np.float32)
        leaf = np.asarray(bt.predict(x, pred_leaf=True))[:, 0]
        t0 = bt._models[0]
        for j in range(t0.num_leaves):
            r = resid[leaf == j]
            lo, hi = r.min(), r.max()
            v = (t0.leaf_value[j] - init) / 0.1
            assert lo - 1e-4 <= v <= hi + 1e-4, (j, v, lo, hi)


def test_routes_grow_the_same_renewed_trees():
    """The slice-2 route and the row-order route grow the default
    route's l1 trees with the same renewed leaves, bit for bit."""
    x, y_raw = _data(2000, 5, 22, "regression")
    p = {"objective": "regression_l1", "num_leaves": 15, "verbosity": -1}
    a = _port_train(p, x, y_raw, 3, {})
    for env in ({"LGBM_TPU_STREAM": "0", "LGBM_TPU_FUSED": "0",
                 "LGBM_TPU_APPLY_IMPL": "xla"}, {"LGBM_TPU_PHYS": "0"}):
        b = _port_train(p, x, y_raw, 3, env)
        assert b._inner.grow.route.describe() != ROUTE
        for ta, tb in zip(a._models, b._models):
            assert ta.leaf_value.tobytes() == tb.leaf_value.tobytes()
        assert torch.equal(a._inner.train_score, b._inner.train_score)


# -- (d) metrics ----------------------------------------------------------
# metric -> (label kind, params)
METRICS = {
    "l2": ("reg", {}), "rmse": ("reg", {}), "l1": ("reg", {}),
    "quantile": ("reg", {"alpha": 0.3}), "mape": ("reg", {}),
    "huber": ("reg", {"alpha": 0.8}), "fair": ("reg", {"fair_c": 1.5}),
    "poisson": ("count", {}), "gamma": ("pos", {}),
    "gamma_deviance": ("pos", {}),
    "tweedie": ("count", {"tweedie_variance_power": 1.2}),
    "binary_logloss": ("bin", {}), "binary_error": ("bin", {}),
    "auc": ("bin", {}), "average_precision": ("bin", {}),
    "multi_logloss": ("multi", {}), "multi_error": ("multi", {}),
    "multi_error_top_2": ("multi", {"multi_error_top_k": 2}),
    "auc_mu": ("multi", {}), "cross_entropy": ("prob", {}),
    "cross_entropy_lambda": ("prob", {}), "kullback_leibler": ("prob", {}),
}


def _metric_inputs(kind: str, n: int, rng):
    """(label, prob, raw) for a metric of label ``kind``."""
    if kind == "multi":
        raw = rng.normal(size=(4, n))
        raw[:, :5] = 0.0                                  # tied rows
        e = np.exp(raw - raw.max(axis=0))
        return (rng.integers(0, 4, n).astype(np.float32),
                e / e.sum(axis=0), raw)
    raw = rng.normal(size=n)
    raw[:7] = raw[7]                                      # tied scores
    if kind == "bin":
        return ((rng.random(n) < 0.4).astype(np.float32),
                1.0 / (1.0 + np.exp(-raw)), raw)
    if kind == "prob":
        return (rng.random(n).astype(np.float32),
                1.0 / (1.0 + np.exp(-raw)), raw)
    if kind in ("count", "pos"):
        lab = (rng.poisson(2.0, n) if kind == "count"
               else rng.gamma(2.0, size=n) + 0.01)
        return lab.astype(np.float32), np.exp(raw), raw
    return (rng.normal(size=n) * 2).astype(np.float32), raw, raw


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", list(METRICS))
def test_metric_matches_jax(name, weighted):
    kind, extra = METRICS[name]
    metric = name.replace("_top_2", "")
    rng = np.random.default_rng(len(name))
    n = 3000
    y, prob, raw = _metric_inputs(kind, n, rng)
    w = rng.uniform(0.2, 2.0, n).astype(np.float32) if weighted else None
    jm, tm = _metadata(y, w)
    p = dict({"metric": metric}, **extra)
    (mj,), (mt,) = j_metrics(JConfig.from_params(p)), t_metrics(
        TConfig.from_params(p))
    mj.init(jm, n)
    mt.init(tm, n)
    got, want = mt.eval(prob, raw), mj.eval(prob, raw)
    assert [(a, c) for a, _, c in got] == [(a, c) for a, _, c in want]
    for (_, a, _), (_, b, _) in zip(got, want):
        assert np.isfinite(a) and abs(a - b) <= 1e-5 * max(abs(b), 1.0)


@pytest.mark.parametrize("name", ["lambdarank", "rank_xendcg"])
def test_ranking_objectives_raise(name):
    x, y = _data(300, 4, 1, "regression")
    with pytest.raises(LightGBMError, match="query information"):
        lgt.train({"objective": name, "verbosity": -1},
                  lgt.Dataset(x, label=np.abs(np.round(y))), 1,
                  device="cpu")


def test_default_metric_of_each_objective_trains():
    """With no ``metric`` each objective evaluates its default metric,
    the JAX package's name for it."""
    from lightgbm_tpu.metric.metrics import default_metric_for_objective
    x, y_raw = _data(600, 4, 2, "regression")
    for objective, _, _ in TRAIN.values():
        obj = objective["objective"]
        y = labels_for(obj, y_raw)
        ds = lgt.Dataset(x[:400], label=y[:400])
        bst = lgt.train({"objective": obj, "num_leaves": 7,
                         "verbosity": -1}, ds, 1,
                        valid_sets=[lgt.Dataset(x[400:], label=y[400:],
                                                reference=ds)],
                        device="cpu")
        assert list(bst.best_score["valid_0"]) == \
            [default_metric_for_objective(obj)]
