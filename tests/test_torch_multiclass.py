"""Multiclass training in the PyTorch port (softmax and one-vs-all, K
trees an iteration) against the JAX package, on the CPU.

Data: seeded numpy rows (2,000 x 6 with 10 % NaN, ``_mc_data``), the
label K balanced classes by quantiles of a noisy signal, 15 leaves, 3
iterations.  The port trains on the route it picks, ``path=physical
fused=1 tail=kernel (objective_not_streamable, multi_tree_iter)``, the
JAX package on its row-order route (``test_torch_train._jax_train``),
its class trees one after another like the port's (its batched scan
grows the same trees).  The bounds are ``test_torch_objectives.
hold_trees``': trees equal in structure, leaves within 1.2e-5 of each
tree's largest or, where a leaf's gap passes that (recorded per case),
its gradient and hessian sums within 16 ulps of the root's, and each
class's raw scores within 3.5e-6 or the sum of its trees' leaf gaps.
Converted predictions (softmax, sigmoid) hold within the raw bound,
``pred_leaf`` equal.  Also: ``class_need_train`` (a class no row
belongs to stumps out in the first iteration and gets zero stumps after
it, drawing no feature mask), ``init_score`` of ``K * n`` read
class-major (through ``convert.dataset_from_numpy``), feature fraction
0.5 drawn class by class, early stopping on ``multi_logloss`` with
``multi_error`` and ``auc_mu`` beside it, the model text, and the
port's other routes growing the default route's trees bit for bit.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.convert import dataset_from_numpy
from test_torch_objectives import EPS32, hold_trees
from test_torch_train import (ROW_ORDER_ROUTE, _jax_train, _port_train,
                              _text_lines_equal)

torch.set_num_threads(1)

ROUNDS = 3
N_ROWS = 2000
ROUTE = ("path=physical fused=1 tail=kernel (objective_not_streamable, "
         "multi_tree_iter)")


def _mc_data(n, f, seed, k):
    """Rows with 10 % NaN and K balanced classes cut from a noisy signal
    at its quantiles (the JAX package's tests/test_multiclass_batched
    generator, with noise)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan
    sig = (np.nan_to_num(x[:, 0]) + 0.5 * np.nan_to_num(x[:, 1] * x[:, 2])
           + 0.3 * rng.normal(size=n))
    edges = np.quantile(sig, np.linspace(0, 1, k + 1)[1:-1])
    return x, np.searchsorted(edges, sig).astype(np.float32)


def _base(objective, k, **extra):
    return dict({"objective": objective, "num_class": k, "num_leaves": 15,
                 "verbosity": -1}, **extra)


# name -> (params, the (tree, leaf) pairs held through their sums)
CASES = {
    "softmax_3": (_base("multiclass", 3), []),
    "softmax_5": (_base("multiclass", 5), [(14, 4)]),
    "ova_3": (_base("multiclassova", 3), []),
    "feature_fraction": (_base("multiclass", 3, feature_fraction=0.5), []),
}


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    params, noisy = CASES[request.param]
    k = params["num_class"]
    x, y = _mc_data(N_ROWS, 6, 11, k)
    bj, _, _ = _jax_train(params, x, y, ROUNDS, route=ROW_ORDER_ROUTE)
    bt = _port_train(params, x, y, ROUNDS, {})
    return dict(name=request.param, jax=bj, torch=bt, x=x, y=y, k=k,
                noisy=noisy, params=params)


def test_trees_and_class_scores_match_jax(pair):
    bt, bj, k = pair["torch"], pair["jax"], pair["k"]
    assert bt._inner.grow.route.describe() == ROUTE
    assert bt._inner.num_tree_per_iteration == k
    assert len(bt._models) == len(bj._models) == ROUNDS * k
    assert all(t.num_leaves > 1 for t in bt._models)
    noisy, _, _ = hold_trees(bt, bj, pair["x"])
    assert noisy == pair["noisy"]
    # the training scores, class-major, are the served raw scores
    ts = bt._inner.train_score.numpy().astype(np.float64)
    raw = bt.predict(pair["x"], raw_score=True)
    assert ts.shape == (k, N_ROWS) and raw.shape == (N_ROWS, k)
    tol = 64 * len(bt._models) * EPS32 * np.maximum(np.abs(ts), 1.0)
    assert np.all(np.abs(raw.T - ts) <= tol)


def test_predict_matches_jax(pair):
    bt, bj, x, k = pair["torch"], pair["jax"], pair["x"], pair["k"]
    raw_t = bt.predict(x, raw_score=True)
    raw_j = np.asarray(bj.predict(x, raw_score=True))
    conv_t, conv_j = bt.predict(x), np.asarray(bj.predict(x))
    assert conv_t.shape == conv_j.shape == (N_ROWS, k)
    # softmax and sigmoid move by at most the raw gap (times 2)
    gap = np.abs(raw_t - raw_j).max(axis=1, keepdims=True)
    assert np.all(np.abs(conv_t - conv_j) <= 2 * gap + 4 * EPS32)
    if pair["params"]["objective"] == "multiclass":
        np.testing.assert_allclose(conv_t.sum(axis=1), 1.0, rtol=0,
                                   atol=1e-12)
    leaf_t = bt.predict(x, pred_leaf=True)
    assert leaf_t.shape == (N_ROWS, ROUNDS * k)
    np.testing.assert_array_equal(leaf_t, bj.predict(x, pred_leaf=True))


def test_model_text_matches_jax(pair):
    text = pair["torch"].model_to_string()
    _text_lines_equal(text, pair["jax"].model_to_string())
    loaded = lgt.Booster(model_str=text, device="cpu")
    np.testing.assert_array_equal(loaded.predict(pair["x"]),
                                  pair["torch"].predict(pair["x"]))


def test_class_need_train_gates_an_empty_class(monkeypatch):
    """No row has label 2 of 3: its softmax hessians (p ~ 1e-10) never
    reach ``min_sum_hessian_in_leaf``, so its first tree is a stump; it
    then trains no more and gets zero stumps, drawing no feature mask,
    while classes 0 and 1 keep growing.  The JAX package grows the same
    trees."""
    x, y = _mc_data(1200, 6, 3, 2)
    params = _base("multiclass", 3)
    bj, _, _ = _jax_train(params, x, y, 3, route=ROW_ORDER_ROUTE)
    draws = []
    real = lgt.models.gbdt.GBDT._feature_mask

    def counted(self):
        draws.append(len(self.models))
        return real(self)
    monkeypatch.setattr(lgt.models.gbdt.GBDT, "_feature_mask", counted)
    bt = _port_train(params, x, y, 3, {})
    # reading the JAX models finishes its deferred trees
    leaves = [t.num_leaves for t in bt._models]
    assert leaves == [t.num_leaves for t in bj._models]
    assert bt._inner._class_need_train == [True, True, False]
    assert bj._inner._class_need_train == [True, True, False]
    assert leaves[2::3] == [1] * 3
    assert min(leaves[0::3] + leaves[1::3]) > 1
    # the stumps: the class's initial score, then zeros
    assert bt._models[2].leaf_value[0] == bj._models[2].leaf_value[0] \
        == pytest.approx(np.log(1e-10))
    assert all(t.leaf_value[0] == 0.0 for t in bt._models[5::3])
    # one mask a grown tree: class 2 draws in the first iteration only
    assert draws == [0, 1, 2, 3, 4, 6, 7]
    hold_trees(bt, bj, x)


def test_init_score_is_read_class_major():
    """An ``init_score`` of ``K * n`` values gives class k the k-th run
    of n; both packages start from it (the port's dataset made from the
    JAX binned dataset by ``convert.dataset_from_numpy``) and grow the
    same trees and training scores."""
    k = 3
    x, y = _mc_data(N_ROWS, 6, 12, k)
    init = np.random.default_rng(12).normal(0.0, 0.5, k * N_ROWS)
    params = _base("multiclass", k)
    bj, jbin, _ = _jax_train(params, x, y, 2, route=ROW_ORDER_ROUTE,
                             ds_kw={"init_score": init})
    ds = dataset_from_numpy(
        [m.to_dict() for m in jbin.mappers], jbin.bin_matrix, y,
        used_feature_map=jbin.used_feature_map,
        num_total_features=jbin.num_total_features, init_score=init)
    bt = lgt.train(params, ds, 2, device="cpu")
    hold_trees(bt, bj, x)
    ts = bt._inner.train_score.numpy()
    np.testing.assert_allclose(
        ts, np.asarray(bj._inner.train_score)[:, :N_ROWS], rtol=0,
        atol=1e-5)
    # the first trees carry no boost-from-average bias
    raw = bt.predict(x, raw_score=True)
    np.testing.assert_allclose(raw.T + init.reshape(k, N_ROWS), ts,
                               rtol=0, atol=1e-5)


def test_early_stopping_on_multi_logloss():
    """Early stopping on the first metric, ``multi_logloss`` of a
    holdout, stops both packages at the same iteration; the best
    scores, ``multi_error`` and ``auc_mu`` too, agree within 1e-5."""
    k = 3
    x, y = _mc_data(N_ROWS + 600, 6, 13, k)
    params = _base("multiclass", k, learning_rate=0.6, min_data_in_leaf=5,
                   metric=["multi_logloss", "multi_error", "auc_mu"],
                   early_stopping_round=2, first_metric_only=True)
    xt, yt, xv, yv = x[:N_ROWS], y[:N_ROWS], x[N_ROWS:], y[N_ROWS:]
    bj, _, _ = _jax_train(params, xt, yt, 20, xv, yv,
                          route=ROW_ORDER_ROUTE)
    ds = lgt.Dataset(xt, label=yt)
    bt = lgt.train(params, ds, 20, valid_sets=[lgt.Dataset(
        xv, label=yv, reference=ds)], device="cpu")
    assert bt.best_iteration == bj.best_iteration < 18
    got, want = bt.best_score["valid_0"], bj.best_score["valid_0"]
    assert set(got) == set(want) == {"multi_logloss", "multi_error",
                                     "auc_mu"}
    for name, v in got.items():
        assert abs(v - want[name]) <= 1e-5, name


ROUTES = {
    "slice2": {"LGBM_TPU_STREAM": "0", "LGBM_TPU_FUSED": "0",
               "LGBM_TPU_APPLY_IMPL": "xla"},
    "pack2": {"LGBM_TPU_COMB_PACK": "2"},
    "unfused": {"LGBM_TPU_FUSED": "0"},
    "3ph": {"LGBM_TPU_PART": "3ph"},
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_routes_grow_the_same_multiclass_trees(route, monkeypatch):
    """Slice 2's route, pack=2 and the unfused split grow the default
    route's softmax trees bit for bit, and the 3ph route the same
    structure (its right rows keep their order, so its sums differ in
    f32 noise)."""
    for knob in ("LGBM_TPU_COMB_PACK", "LGBM_TPU_PART"):
        monkeypatch.delenv(knob, raising=False)
    x, y = _mc_data(1500, 5, 21, 3)
    params = _base("multiclass", 3)
    a = _port_train(params, x, y, 2, {})
    for knob, value in ROUTES[route].items():
        if knob in ("LGBM_TPU_COMB_PACK", "LGBM_TPU_PART"):
            monkeypatch.setenv(knob, value)
    b = _port_train(params, x, y, 2, ROUTES[route])
    assert b._inner.grow.route.describe() != ROUTE
    for ta, tb in zip(a._models, b._models):
        assert ta.num_leaves == tb.num_leaves > 1
        assert np.array_equal(ta.threshold_bin, tb.threshold_bin)
        if route != "3ph":
            assert ta.leaf_value.tobytes() == tb.leaf_value.tobytes()
    if route != "3ph":
        assert torch.equal(a._inner.train_score, b._inner.train_score)


def test_multiclass_checks_labels_and_class_count():
    x, y = _mc_data(300, 4, 1, 3)
    with pytest.raises(lgt.LightGBMError, match=r"Label must be in \[0, 3\)"):
        lgt.train(_base("multiclass", 3), lgt.Dataset(x, label=y + 1), 1,
                  device="cpu")
    with pytest.raises(lgt.LightGBMError, match="integers"):
        lgt.train(_base("multiclass", 3), lgt.Dataset(x, label=y + 0.5),
                  1, device="cpu")
    with pytest.raises(lgt.LightGBMError, match="num_class must be > 1"):
        lgt.train(_base("multiclassova", 1), lgt.Dataset(x, label=y), 1,
                  device="cpu")


def test_mc_batch_knob_is_accepted_and_changes_nothing(monkeypatch):
    """The JAX package's ``LGBM_TPU_MC_BATCH`` (one dispatch for the K
    class trees) saves dispatches, not results: the port accepts it and
    grows the same trees on the same route."""
    x, y = _mc_data(1200, 5, 22, 3)
    params = _base("multiclass", 3)
    a = _port_train(params, x, y, 2, {})
    monkeypatch.setenv("LGBM_TPU_MC_BATCH", "1")
    b = _port_train(params, x, y, 2, {})
    assert b._inner.grow.route.describe() == ROUTE
    assert all(ta.leaf_value.tobytes() == tb.leaf_value.tobytes()
               for ta, tb in zip(a._models, b._models))
