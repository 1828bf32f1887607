"""The training API of the PyTorch port against the JAX package, on the
CPU: custom objectives and metrics, explicit gradients under bagging and
GOSS, ``cv``, ``reset_parameter``, ``refit``, ``dump_model``,
``feature_importance`` and the small ``Booster`` methods.

- A custom objective (numpy binary logloss) with a custom metric
  (``feval``, error rate and logloss) on ``test_torch_train``'s parity
  generator (3,072 x 6, a multiple of the JAX package's row padding so
  its GOSS counts the port's rows; 15 leaves, 3 iterations), plain,
  bagged (0.8 every iteration) and GOSS (0.2 / 0.1 at learning rate
  0.5, sampling from its third iteration): the port on
  ``path=physical fused=1 tail=kernel (objective_not_streamable...)``
  against the JAX package on its row-order route, trees equal in
  structure and leaves within ``test_torch_train.LEAF_RTOL`` of the
  tree's largest, raw scores within 1e-5, every ``feval`` value within
  1e-6 (the scores the two compute them from differ in f32 noise).
- A custom objective that returns the port's own binary gradients
  (``objective.get_gradients`` on the scores it is given, as tensors)
  grows the built-in objective's trees bit for bit, the built-in twin
  with ``boost_from_average=False`` and ``LGBM_TPU_STREAM=0`` (both on
  the physical kernel-tail route).
- ``cv``: the folds equal the JAX ``_make_n_folds`` index for index,
  the result lists within 1e-5 (AUC within 1e-3: over tied scores it
  moves by whole tie groups), each fold's booster recomputing the mean
  AUC within 1e-9.
- ``refit`` against the JAX refit of the same model (the objective
  named, as the JAX refit of a loaded model needs): leaf values within
  rtol 1e-5; the traversal kernel's leaf entry against
  ``Tree.predict_leaf`` on rows that are f32 values, equal.
- ``dump_model`` key for key the JAX dictionary (floats within the leaf
  tolerance), ``feature_importance`` split counts equal and gains within
  1e-4.
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke
import lightgbm_tpu_torch as lgt
from chip_smoke import compare_trees
from conftest import restore_env_knobs, save_env_knobs
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.objective import create_objective as t_objective
from lightgbm_tpu_torch.utils.log import LightGBMError
from test_torch_train import (LEAF_RTOL, ROUTE_KNOBS, ROW_ORDER_ROUTE,
                              _data, _first_divergence, _purge)

torch.set_num_threads(1)

ROWS = 3072
ROUNDS = 3
BASE = {"num_leaves": 15, "verbosity": -1}
SAMPLING = {
    "plain": {},
    "bagging": {"bagging_fraction": 0.8, "bagging_freq": 1},
    "goss": {"boosting": "goss", "learning_rate": 0.5, "top_rate": 0.2,
             "other_rate": 0.1},
}
FOBJ_ROUTE = "path=physical fused=1 tail=kernel (objective_not_streamable"
FLOAT_RTOL = LEAF_RTOL


def logloss_fobj(preds, dataset):
    labels = dataset._binned.metadata.label
    p = 1.0 / (1.0 + np.exp(-preds))
    return p - labels, p * (1 - p)


def err_feval(preds, eval_data):
    labels = eval_data.get_label()
    p = np.clip(preds, 1e-15, 1 - 1e-15)
    return [("my_err", float(np.mean((preds > 0.5) != labels)), False),
            ("my_logloss", float(-np.mean(labels * np.log(p)
                                          + (1 - labels) * np.log(1 - p))),
             False)]


def _jax(fn, route=ROW_ORDER_ROUTE):
    """``fn(lightgbm_tpu)`` on the JAX package's ``route``, knobs saved
    and restored and its modules purged around it."""
    saved = save_env_knobs(ROUTE_KNOBS)
    for k in ROUTE_KNOBS:
        os.environ.pop(k, None)
    os.environ.update(route)
    try:
        _purge()
        import lightgbm_tpu as lgb
        return fn(lgb)
    finally:
        restore_env_knobs(saved)
        _purge()


def _port_env(env, fn):
    saved = save_env_knobs(ROUTE_KNOBS)
    for k in ROUTE_KNOBS:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        return fn()
    finally:
        restore_env_knobs(saved)


def _fobj_run(pkg, params, x, y, xv, yv, **kw):
    """(booster, recorded evaluation) of a custom-objective run of
    ``pkg`` (either package) with ``err_feval`` on the training set and
    a holdout."""
    rec = {}
    ds = pkg.Dataset(x, label=y)
    valid = pkg.Dataset(xv, label=yv, reference=ds)
    bst = pkg.train(dict(params, objective=logloss_fobj), ds,
                    num_boost_round=ROUNDS, valid_sets=[ds, valid],
                    feval=err_feval,
                    callbacks=[pkg.record_evaluation(rec)], **kw)
    return bst, rec


@pytest.fixture(scope="module", params=list(SAMPLING))
def fobj_pair(request):
    x, y = _data(ROWS + 600, 6, 11)
    xt, yt, xv, yv = x[:ROWS], y[:ROWS], x[ROWS:], y[ROWS:]
    params = dict(BASE, **SAMPLING[request.param])
    bj, ej = _jax(lambda lgb: _fobj_run(lgb, params, xt, yt, xv, yv))
    bt, et = _fobj_run(lgt, params, xt, yt, xv, yv, device="cpu")
    return dict(jax=bj, torch=bt, ev_jax=ej, ev_torch=et, x=xt, xv=xv,
                name=request.param)


def test_custom_objective_matches_jax(fobj_pair):
    bt, bj = fobj_pair["torch"], fobj_pair["jax"]
    assert bt._inner.grow.route.describe().startswith(FOBJ_ROUTE)
    assert bt._inner.objective is None
    assert len(bt._models) == len(bj._models) == ROUNDS
    assert all(t.num_leaves > 1 for t in bt._models)
    assert _first_divergence(bt._models, bj._models) is None
    res = compare_trees(bt._models, bj._models, rtol=LEAF_RTOL)
    assert res["ok"], res
    np.testing.assert_allclose(
        bt.predict(fobj_pair["xv"], raw_score=True),
        np.asarray(bj.predict(fobj_pair["xv"], raw_score=True)),
        rtol=0, atol=1e-5)


def test_feval_matches_jax(fobj_pair):
    et, ej = fobj_pair["ev_torch"], fobj_pair["ev_jax"]
    assert et.keys() == ej.keys() == {"training", "valid_1"}
    for ds_name in et:
        assert et[ds_name].keys() == ej[ds_name].keys() \
            == {"my_err", "my_logloss"}
        for metric, vals in et[ds_name].items():
            assert len(vals) == ROUNDS
            np.testing.assert_allclose(vals, ej[ds_name][metric], rtol=0,
                                       atol=1e-6)


def test_feval_sees_the_converted_scores(fobj_pair):
    """A custom metric's predictions are the raw scores (no objective:
    no transform) of the set's rows; recomputed from ``predict`` they
    give the recorded value."""
    bt = fobj_pair["torch"]
    xv = fobj_pair["xv"]
    yv = bt._inner.valid_sets[0].data.metadata.label
    got = bt.eval_valid(err_feval)
    raw = bt.predict(xv, raw_score=True)
    want = err_feval(raw, type("E", (), {"get_label": lambda: yv}))
    assert [(r[1], r[2]) for r in got] == [
        (name, pytest.approx(v, abs=1e-6)) for name, v, _ in want]
    assert bt.eval(None, "valid_1", err_feval) == got


@pytest.mark.parametrize("name", list(SAMPLING))
def test_pass_through_fobj_grows_the_builtin_trees(name):
    x, y = _data(ROWS, 6, 12)
    extra = SAMPLING[name]
    twin = _port_env({"LGBM_TPU_STREAM": "0"}, lambda: lgt.train(
        dict(BASE, objective="binary", boost_from_average=False, **extra),
        lgt.Dataset(x, label=y), num_boost_round=ROUNDS, device="cpu"))
    ds = lgt.Dataset(x, label=y).construct()
    obj = t_objective(TConfig.from_params({"objective": "binary"}))
    obj.init(ds._binned.metadata, ds.num_data(), torch.device("cpu"))
    seen = []

    def fobj(preds, dataset):
        assert preds.dtype == np.float64 and preds.shape == (ROWS,)
        seen.append(preds)
        return obj.get_gradients(torch.as_tensor(preds, dtype=torch.float32))
    bst = lgt.train(dict(BASE, objective=fobj, **extra), ds,
                    num_boost_round=ROUNDS, device="cpu")
    assert twin._inner.grow.route.describe().startswith(
        "path=physical fused=1 tail=kernel")
    assert bst._inner.grow.route.describe().startswith(FOBJ_ROUTE)
    assert len(seen) == ROUNDS and not seen[0].any()
    assert len(bst._models) == len(twin._models) == ROUNDS
    res = compare_trees(bst._models, twin._models, rtol=0.0)
    assert res["ok"], res
    assert chip_smoke.leaves_bitwise(bst._models, twin._models)
    assert torch.equal(bst._inner.scores, twin._inner.scores)


def test_multiclass_fobj_takes_n_by_k():
    """A ``[n, K]`` custom objective's gradients are transposed, as the
    JAX package does: the softmax's own gradients grow its trees."""
    x, y = _data(2000, 6, 13)
    y = np.digitize(np.nan_to_num(x[:, 0]), [-0.4, 0.5]).astype(np.float32)
    p = dict(BASE, objective="multiclass", num_class=3,
             boost_from_average=False)
    twin = _port_env({"LGBM_TPU_STREAM": "0"}, lambda: lgt.train(
        p, lgt.Dataset(x, label=y), num_boost_round=2, device="cpu"))
    ds = lgt.Dataset(x, label=y).construct()
    obj = t_objective(TConfig.from_params(p))
    obj.init(ds._binned.metadata, ds.num_data(), torch.device("cpu"))

    def fobj(preds, dataset):
        assert preds.shape == (2000, 3)
        g, h = obj.get_gradients(torch.as_tensor(preds.T,
                                                 dtype=torch.float32))
        return g.numpy().T, h.numpy().T
    bst = lgt.train(dict(p, objective=fobj), ds, num_boost_round=2,
                    device="cpu")
    assert bst.num_model_per_iteration() == 3
    assert chip_smoke.leaves_bitwise(bst._models, twin._models)


def _refused_stream(x, y):
    bst = lgt.Booster(dict(BASE, objective="binary"),
                      lgt.Dataset(x, label=y), device="cpu")
    assert bst._inner.route.stream
    g = np.zeros(len(y), np.float32)
    bst._inner.train_one_iter(g, g + 1)


def _no_objective(x, y):
    lgt.Booster(dict(BASE, objective="none"), lgt.Dataset(x, label=y),
                device="cpu").update()


def _mesh_none(x, y):
    lgt.Booster(dict(BASE, objective="none", tree_learner="data"),
                lgt.Dataset(x, label=y), device="cpu")


@pytest.mark.parametrize("case,match", [
    (_refused_stream, "score-resident gradient streaming"),
    (_no_objective, "No objective function and no custom gradients"),
    (_mesh_none, "objective=none.*A10"),
], ids=["stream_route", "no_objective", "parallel_learner"])
def test_explicit_gradients_refusals(case, match):
    x, y = _data(500, 4, 3)
    with pytest.raises(LightGBMError, match=match):
        case(x, y)


# -- cv ---------------------------------------------------------------------
@pytest.mark.parametrize("stratified,shuffle", [(True, True), (False, True),
                                                (True, False)])
def test_cv_folds_match_jax(stratified, shuffle):
    x, y = _data(1001, 4, 5)
    from lightgbm_tpu_torch.engine import _make_n_folds
    got = list(_make_n_folds(lgt.Dataset(x, label=y), 3, 7, stratified,
                             shuffle))

    def jax_folds(lgb):
        from lightgbm_tpu.engine import _make_n_folds as j_folds
        return list(j_folds(lgb.Dataset(x, label=y), 3, {}, 7, stratified,
                            shuffle))
    want = _jax(jax_folds)
    assert len(got) == len(want) == 3
    for (a, b), (c, d) in zip(got, want):
        assert np.array_equal(a, c) and np.array_equal(b, d)


def test_cv_matches_jax():
    x, y = _data(1500, 6, 7)
    params = dict(BASE, objective="binary", metric=["auc", "binary_logloss"],
                  is_provide_training_metric=True)
    want = _jax(lambda lgb: lgb.cv(params, lgb.Dataset(x, label=y),
                                   num_boost_round=3, nfold=2, seed=3,
                                   eval_train_metric=True))
    got = lgt.cv(params, lgt.Dataset(x, label=y, free_raw_data=False),
                 num_boost_round=3, nfold=2, seed=3, eval_train_metric=True,
                 return_cvbooster=True, device="cpu")
    cvb = got.pop("cvbooster")
    assert got.keys() == want.keys()
    assert "valid auc-mean" in got and "train binary_logloss-stdv" in got
    for key, vals in got.items():
        assert len(vals) == 3
        # AUC over heavily tied scores (23 distinct values in a fold after
        # 2 trees of 15 leaves) moves by whole tie groups when f32 noise
        # splits or joins one; logloss is continuous in the scores
        np.testing.assert_allclose(vals, want[key], rtol=0,
                                   atol=1e-3 if " auc-" in key else 1e-5)
    # each fold's holdout AUC recomputed from its booster's predictions
    from lightgbm_tpu_torch.engine import _make_n_folds
    aucs = []
    for b, (_, test_idx) in zip(cvb.boosters, _make_n_folds(
            lgt.Dataset(x, label=y), 2, 3, True, True)):
        aucs.append(chip_smoke._weighted_auc_np(
            y[test_idx].astype(np.float64),
            b.predict(x[test_idx], raw_score=True)))
    assert abs(np.mean(aucs) - got["valid auc-mean"][-1]) <= 1e-9
    assert cvb.current_iteration() == [3, 3]


def test_cv_early_stopping_cuts_the_lists():
    x, y = _data(900, 4, 8)
    res = lgt.cv(dict(BASE, objective="binary", metric="binary_logloss",
                      learning_rate=3.0, early_stopping_round=1),
                 lgt.Dataset(x, label=y), num_boost_round=30, nfold=3,
                 return_cvbooster=True, device="cpu")
    n = len(res["valid binary_logloss-mean"])
    assert n < 30 and res["cvbooster"].best_iteration == n
    assert np.argmin(res["valid binary_logloss-mean"]) == n - 1


# -- reset_parameter -----------------------------------------------------------
def test_reset_parameter_sets_each_trees_shrinkage():
    x, y = _data(1500, 5, 9)
    rates = [0.3, 0.1, 0.05, 0.2]
    bst = lgt.train(dict(BASE, objective="binary"), lgt.Dataset(x, label=y),
                    num_boost_round=4, device="cpu",
                    callbacks=[lgt.reset_parameter(learning_rate=rates)])
    assert [t.shrinkage for t in bst._models] == rates
    assert bst._inner.config.learning_rate == rates[-1]
    fn = lgt.train(dict(BASE, objective="binary"), lgt.Dataset(x, label=y),
                   num_boost_round=4, device="cpu",
                   callbacks=[lgt.reset_parameter(
                       learning_rate=lambda i: rates[i])])
    assert chip_smoke.leaves_bitwise(bst._models, fn._models)
    with pytest.raises(ValueError, match="num_boost_round"):
        lgt.train(dict(BASE, objective="binary"), lgt.Dataset(x, label=y),
                  num_boost_round=3, device="cpu",
                  callbacks=[lgt.reset_parameter(learning_rate=rates)])


# -- refit ----------------------------------------------------------------------
REFIT = {
    "binary": (dict(BASE, objective="binary"), {"decay_rate": 0.9}),
    "binary_l1_l2": (dict(BASE, objective="binary"),
                     {"decay_rate": 0.5, "lambda_l1": 0.5,
                      "lambda_l2": 1.0}),
    "multiclass": (dict(BASE, objective="multiclass", num_class=3),
                   {"decay_rate": 0.9}),
}


@pytest.mark.parametrize("name", list(REFIT))
def test_refit_matches_jax(name):
    params, kw = REFIT[name]
    x, y = _data(2500, 6, 14)
    if params["objective"] == "multiclass":
        y = np.digitize(np.nan_to_num(x[:, 1]), [-0.3, 0.4]).astype(
            np.float32)
    xt, yt, xr, yr = x[:1500], y[:1500], x[1500:], y[1500:]
    bst = lgt.train(params, lgt.Dataset(xt, label=yt), num_boost_round=3,
                    device="cpu")
    got = bst.refit(xr, yr, **kw)
    text = bst.model_to_string()
    want = _jax(lambda lgb: lgb.Booster(model_str=text).refit(
        xr, yr, objective=params["objective"],
        num_class=params.get("num_class", 1), **kw)._models)
    assert len(got._models) == len(want) == len(bst._models)
    for a, b, c in zip(got._models, want, bst._models):
        assert a.num_leaves == c.num_leaves
        assert np.array_equal(a.split_feature, c.split_feature)
        assert np.array_equal(a.threshold, c.threshold)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-12)
        assert not np.array_equal(a.leaf_value, c.leaf_value)
    # a loaded model refits with its own objective, to the same bits
    loaded = lgt.Booster(model_str=text, device="cpu").refit(xr, yr, **kw)
    assert chip_smoke.leaves_bitwise(loaded._models, got._models)


def test_leaf_entry_equals_host_walk_on_f32_rows():
    x, y = _data(2000, 6, 15)
    bst = lgt.train(dict(BASE, objective="binary"), lgt.Dataset(x, label=y),
                    num_boost_round=3, device="cpu")
    xr = np.random.default_rng(4).normal(size=(3000, 6)).astype(np.float32)
    xr[::7, 2] = np.nan
    assert chip_smoke.refit_leaf_flips(bst, xr.astype(np.float64)) == 0


def test_leaf_flip_count_sees_f64_rows_across_a_threshold():
    """A row whose f64 value and its f32 rounding lie on two sides of a
    split threshold takes another leaf through the kernel's f32 entry;
    the count finds it.  The root's threshold is set to 0.1, which
    rounds up in f32: a row of 0.1 goes left on the host and right in
    the kernel."""
    x, y = _data(2000, 6, 15)
    bst = lgt.train(dict(BASE, objective="binary"), lgt.Dataset(x, label=y),
                    num_boost_round=1, device="cpu")
    loaded = lgt.Booster(model_str=bst.model_to_string(), device="cpu")
    t = loaded._models[0]
    t.threshold[0] = 0.1
    assert float(np.float32(0.1)) > 0.1
    rows = np.zeros((5, 6))
    rows[:, int(t.split_feature[0])] = 0.1
    rows[3:, int(t.split_feature[0])] = (float(np.float32(0.1)), 0.2)
    assert chip_smoke.refit_leaf_flips(loaded, rows) == 3


def _flip_model(x, y):
    """A 3-tree binary model whose root threshold is 0.1 (it rounds up
    in f32), loaded on the CPU, and the root's feature."""
    bst = lgt.train(dict(BASE, objective="binary"), lgt.Dataset(x, label=y),
                    num_boost_round=3, device="cpu")
    loaded = lgt.Booster(model_str=bst.model_to_string(), device="cpu")
    loaded._models[0].threshold[0] = 0.1
    return loaded, int(loaded._models[0].split_feature[0])


def test_refit_takes_the_host_walk_on_rows_that_flip():
    """A third of the refit rows hold 0.1 in the root's feature: the f64
    host walk sends them left, their f32 rounding right.  The refit takes
    the host walk's leaves on those rows, as the JAX refit does, and the
    kernel's on the rows equal to their f32 rounding."""
    x, y = _data(2500, 6, 15)
    loaded, f = _flip_model(x[:1500], y[:1500])
    xr, yr = x[1500:].astype(np.float64), y[1500:]
    xr[::3, f] = 0.1
    assert chip_smoke.refit_leaf_flips(loaded, xr) >= 300
    got = loaded.refit(xr, yr, decay_rate=0.9)
    text = loaded.model_to_string()
    want = _jax(lambda lgb: lgb.Booster(model_str=text).refit(
        xr, yr, objective="binary", decay_rate=0.9)._models)
    for a, b in zip(got._models, want):
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-12)
    from lightgbm_tpu_torch.basic import refit_leaves
    host = np.stack([t.predict_leaf(xr) for t in loaded._models], axis=1)
    assert np.array_equal(refit_leaves(loaded, xr), host)
    # f32 rows take the kernel's leaves alone, and equal the host walk's
    x32 = x[1500:].astype(np.float32)
    assert np.array_equal(refit_leaves(loaded, x32, f32_input=True),
                          np.stack([t.predict_leaf(x32.astype(np.float64))
                                    for t in loaded._models], axis=1))


# -- dump_model, feature_importance, model text --------------------------------
@pytest.fixture(scope="module")
def binary_pair():
    x, y = _data(2000, 6, 16)
    params = dict(BASE, objective="binary")
    bj = _jax(lambda lgb: lgb.train(params, lgb.Dataset(x, label=y),
                                    num_boost_round=ROUNDS))
    bt = lgt.train(params, lgt.Dataset(x, label=y), num_boost_round=ROUNDS,
                   device="cpu")
    return bt, bj


FLOAT_KEYS = ("split_gain", "leaf_value", "leaf_weight", "internal_value",
              "internal_weight")


def _same_dump(a, b, path="", scale=None):
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        if "tree_structure" in a:
            scale = None
        for k in a:
            _same_dump(a[k], b[k], f"{path}/{k}", scale)
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _same_dump(u, v, f"{path}[{i}]", scale)
    elif isinstance(a, float) and path.rsplit("/", 1)[-1] in FLOAT_KEYS:
        assert abs(a - b) <= FLOAT_RTOL * max(abs(b), 1.0), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _hold_dump(bt, bj, objective):
    dt, dj = bt.dump_model(), bj.dump_model()
    imp_t, imp_j = dt.pop("feature_importances"), dj.pop(
        "feature_importances")
    assert imp_t == imp_j
    _same_dump(dt, dj)
    assert dt["objective"] == objective
    part = bt.dump_model(num_iteration=1, start_iteration=1)
    assert len(part["tree_info"]) == 1
    assert part["tree_info"][0]["tree_structure"] == \
        dt["tree_info"][1]["tree_structure"]


def test_dump_model_matches_jax(binary_pair):
    _hold_dump(*binary_pair, "binary")


def test_custom_objective_dump_matches_jax(fobj_pair):
    _hold_dump(fobj_pair["torch"], fobj_pair["jax"], "")


def test_feature_importance_matches_jax(binary_pair):
    bt, bj = binary_pair
    split_t = bt.feature_importance("split")
    assert split_t.dtype == np.int32
    assert np.array_equal(split_t, bj.feature_importance("split"))
    assert np.array_equal(bt.feature_importance("split", iteration=1),
                          bj.feature_importance("split", iteration=1))
    gain_t = bt.feature_importance("gain")
    gain_j = np.asarray(bj.feature_importance("gain"))
    np.testing.assert_allclose(gain_t, gain_j, rtol=1e-4)
    # the loaded model's
    loaded = lgt.Booster(model_str=bt.model_to_string(), device="cpu")
    assert np.array_equal(loaded.feature_importance("split"), split_t)


def test_model_text_gain_importances(binary_pair):
    bt, bj = binary_pair

    def section(text):
        body = text.split("feature_importances:\n")[1].split("\n\n")[0]
        return dict(line.split("=") for line in body.splitlines())
    st, sj = (section(b.model_to_string(importance_type="gain"))
              for b in (bt, bj))
    assert st.keys() == sj.keys()
    for k in st:
        assert abs(float(st[k]) - float(sj[k])) <= 1e-4 * float(sj[k])
    assert section(bt.model_to_string()) == section(bj.model_to_string())


def test_small_booster_methods(binary_pair):
    bt, bj = binary_pair
    assert bt.num_model_per_iteration() == bj.num_model_per_iteration() == 1
    assert bt.feature_name() == bj.feature_name() == \
        [f"Column_{i}" for i in range(6)]
    assert bt.set_train_data_name("train") is bt
    assert bt._train_data_name == "train"
    assert bt.free_dataset() is bt and bt.free_network() is bt
    loaded = lgt.Booster(model_str=bt.model_to_string(), device="cpu")
    assert loaded.feature_name() == bt.feature_name()
    assert loaded.num_model_per_iteration() == 1
    d = loaded.dump_model()
    assert d["max_feature_idx"] == 5 and d["feature_names"] == \
        bt.feature_name()
    x, y = _data(400, 3, 2)
    named = lgt.train(dict(BASE, objective="binary"),
                      lgt.Dataset(x, label=y, feature_name=["a", "b", "c"]),
                      num_boost_round=1, device="cpu",
                      keep_training_booster=True)
    assert named.feature_name() == ["a", "b", "c"]
    with pytest.raises(TypeError, match="Dataset instance"):
        named.predict(lgt.Dataset(x))
    with pytest.raises(LightGBMError, match="Resetting train set"):
        named.update(train_set=lgt.Dataset(x, label=y))
