"""``pred_contrib`` (TreeSHAP) and ``pred_early_stop`` in the PyTorch port
against the JAX package, on the CPU.

One model text, trained by the port, is loaded into both packages.  The
port weighs each child by its data count, as LightGBM does
(``Tree::data_count``); the JAX package by its hessian sum.  So the JAX
recursion (``lightgbm_tpu.models.shap.predict_contrib``) runs on a
test-side copy of each tree whose ``internal_weight`` / ``leaf_weight``
are its counts, and the port's plain TreeSHAP (``device="cpu"``) equals
it within 1e-12 of each row's largest contribution: binary, 5-class
multiclass, a categorical model, a random forest (``average_output``)
and two chain trees of depth 45.  It is not bitwise: the port adds the
leaves' terms in left-then-right order and the JAX recursion hot child
first (a few ulps).  ``test_jax_shap_weighs_by_hessians`` witnesses the
JAX package's own weighting.

Prediction early stopping equals the JAX package's bit for bit when the
margin is given; the JAX package reads its default margin as 1e10
(``basic.py:565``), the port the config's 10.0, and the port follows
LightGBM's documentation on the objectives (classification and ranking
only; an rf model and a custom objective refuse): both witnessed.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from chip_smoke import chain_model_text, host_raw, make_rows
from lightgbm_tpu_torch.models import shap as tshap
from lightgbm_tpu_torch.models.tree import Tree
from lightgbm_tpu_torch.ops import shap_kernel as tsk
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

SHAP_RTOL = 1e-12
BASE = {"verbosity": -1, "min_data_in_leaf": 5}


def _jax():
    import lightgbm_tpu as lgb
    from lightgbm_tpu.models.shap import predict_contrib
    return lgb, predict_contrib


def _data(n=400, f=6, seed=0, classes=2, cat=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    x[rng.random(x.shape) < 0.08] = np.nan
    x[rng.random(x.shape) < 0.05] = 0.0
    if cat:
        x[:, 2] = rng.integers(0, 12, n)
        x[rng.random(n) < 0.05, 2] = np.nan
    s = (np.nan_to_num(x[:, 0]) + 0.6 * np.nan_to_num(x[:, 1])
         + (0.8 * (np.nan_to_num(x[:, 2]) % 3 == 1) if cat else 0)
         + 0.3 * rng.normal(size=n))
    if classes == 2:
        y = (s > 0).astype(np.float64)
    else:
        y = np.digitize(s, np.quantile(s, np.linspace(0, 1, classes + 1)
                                       [1:-1])).astype(np.float64)
    return x, y


def _model(kind: str) -> tuple:
    """(model text, rows) of a small model of ``kind`` trained by the
    port on the CPU."""
    if kind == "chain":
        return chain_model_text(45, 50, 3), make_rows(64, 50, 3)
    cat = kind == "categorical"
    classes = 5 if kind == "multiclass" else 2
    x, y = _data(classes=classes, cat=cat, seed=len(kind))
    params = dict(BASE, objective="multiclass" if classes > 2 else "binary",
                  num_leaves=31 if kind == "binary" else 15)
    rounds = 3 if classes > 2 else 4
    if classes > 2:
        params["num_class"] = classes
    if kind == "rf":
        params.update(boosting="rf", bagging_fraction=0.7, bagging_freq=1)
    if cat:
        params.update(min_data_per_group=5, cat_smooth=1.0)
    ds = lgt.Dataset(x, label=y, categorical_feature=[2] if cat else "auto")
    bst = lgt.train(params, ds, rounds, device="cpu")
    return bst.model_to_string(), x[:64]


def _count_weighted(jb):
    """The JAX booster's trees weighed by their data counts (a copy
    parsed from the model text, the test's own)."""
    for t in jb._models:
        t.internal_weight = np.asarray(t.internal_count, np.float64)
        t.leaf_weight = np.asarray(t.leaf_count, np.float64)
    return jb


def _jax_contrib(text, x, counts=True):
    lgb, predict_contrib = _jax()
    jb = lgb.Booster(model_str=text)
    if counts:
        _count_weighted(jb)
    n_it = len(jb._models) // jb._k
    return predict_contrib(jb, np.asarray(x, np.float64), 0, n_it)


@pytest.mark.parametrize("kind", ["binary", "multiclass", "categorical",
                                  "rf", "chain"])
def test_contributions_match_jax_on_count_weighted_trees(kind):
    text, x = _model(kind)
    bst = lgt.Booster(model_str=text, device="cpu")
    got = bst.predict(x, pred_contrib=True)
    want = _jax_contrib(text, x)
    assert got.shape == want.shape
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert np.all(np.abs(got - want) <= SHAP_RTOL * scale)
    if kind == "rf":
        assert bst._average_output
    if kind == "chain":
        assert max(tshap.tree_depth(t) for t in bst._models) == 45


@pytest.mark.parametrize("kind", ["binary", "categorical"])
def test_contributions_sum_to_the_f64_raw_scores(kind):
    text, x = _model(kind)
    bst = lgt.Booster(model_str=text, device="cpu")
    got = bst.predict(x, pred_contrib=True)
    raw = host_raw(bst, np.asarray(x, np.float64))
    assert np.abs(got.sum(axis=1) - raw).max() <= 1e-9 * np.abs(raw).max()


def test_jax_shap_weighs_by_hessians():
    """The JAX package's own contributions (hessian-weighted covers)
    differ from LightGBM's count-weighted ones on a binary model; each
    still sums to the row's score (the JAX package's within 1e-8: the
    model text keeps the hessian sums to a few digits, so a node's is
    not quite its children's)."""
    text, x = _model("binary")
    own = _jax_contrib(text, x, counts=False)
    counts = _jax_contrib(text, x)
    port = lgt.Booster(model_str=text, device="cpu")
    raw = host_raw(port, np.asarray(x, np.float64))
    assert np.abs(own - counts).max() > 1e-3
    assert np.abs(own.sum(axis=1) - raw).max() <= 1e-8
    for c in (counts, port.predict(x, pred_contrib=True)):
        assert np.abs(c.sum(axis=1) - raw).max() <= 1e-9


def test_predict_takes_the_trees_grown_after_train():
    """``train`` without early stopping leaves ``best_iteration`` unset,
    as LightGBM does: a booster grown further by ``update()`` predicts
    and explains with every tree, its contributions summing to the f64
    raw score of all of them.  Continued training from a model whose
    best iteration is below its trees takes the init score from all of
    them, the trees it keeps."""
    x, y = _data(n=300, seed=5)
    params = dict(BASE, objective="binary", num_leaves=7)
    bst = lgt.train(params, lgt.Dataset(x, label=y), 3, device="cpu",
                    keep_training_booster=True)
    assert bst.best_iteration <= 0
    bst.update()
    bst.update()
    assert bst.current_iteration() == bst.num_trees() == 5
    raw = host_raw(bst, x)
    np.testing.assert_allclose(bst.predict(x, raw_score=True), raw,
                               rtol=0, atol=1e-6)
    got = bst.predict(x, pred_contrib=True)
    assert np.abs(got.sum(axis=1) - raw).max() <= 1e-9 * np.abs(raw).max()
    assert bst.model_to_string().count("Tree=") == 5
    bst.best_iteration = 2
    ds = lgt.Dataset(x, label=y)
    lgt.train(params, ds, 1, init_model=bst, device="cpu")
    np.testing.assert_allclose(ds.init_score, raw, rtol=0, atol=1e-6)


def test_jax_pins_best_iteration_without_early_stop():
    """Witness of a JAX fault the port does not copy (ROADMAP C): the
    JAX package's ``train`` sets ``best_iteration`` to its last
    iteration, so after ``update()`` its ``predict`` leaves out the new
    trees; the port's takes them (the test above)."""
    lgb, _ = _jax()
    x, y = _data(n=300, seed=5)
    params = dict(BASE, objective="binary", num_leaves=7)
    jb = lgb.train(params, lgb.Dataset(x, label=y), 3,
                   keep_training_booster=True)
    assert jb.best_iteration == 3
    jb.update()
    assert jb.num_trees() == 4
    full = jb.predict(x, raw_score=True, num_iteration=4)
    assert np.abs(jb.predict(x, raw_score=True) - full).max() > 0


def test_expected_value_is_lightgbms():
    """Tree::ExpectedValue: the leaves' counts over the root's, in leaf
    order; a single leaf its value; against the JAX count-weighted mean."""
    text, _ = _model("binary")
    lgb, _ = _jax()
    jb = _count_weighted(lgb.Booster(model_str=text))
    from lightgbm_tpu.models.shap import tree_expected_value
    for t, jt in zip(lgt.Booster(model_str=text, device="cpu")._models,
                     jb._models):
        ev = tshap.expected_value(t)
        assert abs(ev - tree_expected_value(jt)) <= 1e-15 * max(
            np.abs(t.leaf_value).max(), 1e-300)
    assert tshap.expected_value(Tree.single_leaf(0.25)) == 0.25


def test_hot_child_is_the_host_walks():
    """``goes_left`` against ``Tree._decide`` on NaN, zero, +-inf, huge,
    negative and fractional values, numerical and categorical."""
    text, x = _model("categorical")
    vals = np.array([np.nan, 0.0, -0.0, 1e-36, -1e-36, np.inf, -np.inf,
                     1e300, -1e300, -0.5, -1.0, 0.5, 2.0, 3.99, 11.0, 12.0,
                     31.9, 32.0, 64.5, -3.0])
    for t in lgt.Booster(model_str=text, device="cpu")._models:
        for node in range(t.num_leaves - 1):
            fv = np.concatenate([vals, x[:, t.split_feature[node]]])
            want = t._decide(node, fv) == t.left_child[node]
            got = tshap.goes_left(t, node, torch.as_tensor(fv))
            assert np.array_equal(got.numpy(), want), node


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """``ops.shap_kernel.tree_shap`` on CPU rows is the plain version;
    the scratch layout's sizes."""
    text, x = _model("multiclass")
    bst = lgt.Booster(model_str=text, device="cpu")
    forest = tsk.pack_shap_forest(bst._models, bst._k, bst.num_feature(),
                                  bst.current_iteration(), False, "cpu")
    before = tsk.tree_shap.launches
    out = tsk.tree_shap(forest, torch.as_tensor(x, dtype=torch.float64))
    assert tsk.tree_shap.launches == before
    assert np.array_equal(out.numpy(), bst.predict(x, pred_contrib=True))
    assert tsk.path_elements(0) == 1 and tsk.path_elements(30) == 496
    assert tsk.row_bytes(30, 28) == 496 * 28 + 32 * 32 + 29 * 8
    assert tsk.chunk_rows(30, 28, 100) == 100
    big = tsk.chunk_rows(254, 28, 10 ** 7)
    assert big % tsk.THREADS == 0
    assert big * tsk.row_bytes(254, 28) <= tsk.SCRATCH_BYTES


def test_pred_contrib_refuses_linear_trees():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(300, 4))
    y = x[:, 0] * 2 + rng.normal(size=300) * 0.1
    bst = lgt.train(dict(BASE, objective="regression", linear_tree=True,
                         num_leaves=7),
                    lgt.Dataset(x, label=y, params={"linear_tree": True}), 2,
                    device="cpu")
    with pytest.raises(LightGBMError, match="linear"):
        bst.predict(x, pred_contrib=True)


# -- pred_early_stop ----------------------------------------------------------
def _es_model(objective="binary", **extra):
    x, y = _data(n=500, classes=3 if objective == "multiclass" else 2,
                 seed=7)
    params = dict(BASE, objective=objective, num_leaves=7,
                  learning_rate=0.5, **extra)
    if objective == "multiclass":
        params["num_class"] = 3
    if objective == "regression":
        y = y * 8.0
    bst = lgt.train(params, lgt.Dataset(x, label=y), 12, device="cpu")
    return bst, x


@pytest.mark.parametrize("objective,freq,margin", [
    ("binary", 2, 1.0), ("binary", 3, 4.0), ("multiclass", 2, 1.0),
    ("multiclass", 1, 3.0)])
def test_early_stop_matches_jax(objective, freq, margin):
    bst, x = _es_model(objective)
    lgb, _ = _jax()
    jb = lgb.Booster(model_str=bst.model_to_string())
    kw = dict(raw_score=True, pred_early_stop=True,
              pred_early_stop_freq=freq, pred_early_stop_margin=margin)
    got = bst.predict(x, **kw)
    assert np.array_equal(got, jb.predict(x, **kw))
    full = bst.predict(x, raw_score=True)
    assert not np.allclose(got, full)      # some rows stopped
    assert np.array_equal(bst.predict(x, pred_early_stop=True,
                                      pred_early_stop_freq=freq,
                                      pred_early_stop_margin=margin),
                          jb.predict(x, pred_early_stop=True,
                                     pred_early_stop_freq=freq,
                                     pred_early_stop_margin=margin))


def test_early_stop_of_linear_trees_matches_jax():
    """A binary model with linear leaves stops early as the JAX
    package's host walk does (its leaf models in f64 on each side)."""
    x, y = _data(n=500, seed=9)
    x = np.nan_to_num(x)
    bst = lgt.train(dict(BASE, objective="binary", num_leaves=7,
                         learning_rate=0.5, linear_tree=True),
                    lgt.Dataset(x, label=y, params={"linear_tree": True}), 8,
                    device="cpu")
    lgb, _ = _jax()
    jb = lgb.Booster(model_str=bst.model_to_string())
    kw = dict(raw_score=True, pred_early_stop=True, pred_early_stop_freq=2,
              pred_early_stop_margin=1.0)
    got = bst.predict(x, **kw)
    np.testing.assert_allclose(got, jb.predict(x, **kw), rtol=0, atol=1e-12)
    assert not np.allclose(got, bst.predict(x, raw_score=True))


def test_jax_early_stop_margin_ignores_config():
    """Without a margin the JAX package stops nothing (it reads 1e10);
    the port takes the config's 10.0, LightGBM's default."""
    bst, x = _es_model("binary")
    lgb, _ = _jax()
    jb = lgb.Booster(model_str=bst.model_to_string())
    kw = dict(raw_score=True, pred_early_stop=True, pred_early_stop_freq=2)
    full = jb.predict(x, raw_score=True)
    assert np.allclose(jb.predict(x, **kw), full)
    got = bst.predict(x, **kw)
    stopped = ~np.isclose(got, full)
    assert stopped.any()
    assert np.array_equal(got, jb.predict(x, pred_early_stop_margin=10.0,
                                          **kw))


def test_jax_early_stop_ignores_the_objective():
    """LightGBM stops early only for classification and ranking, and
    refuses rf and custom objectives; the JAX package stops a
    regression model's rows and an rf model's.  The port predicts a
    regression model in full and refuses the other two."""
    lgb, _ = _jax()
    kw = dict(raw_score=True, pred_early_stop=True, pred_early_stop_freq=1,
              pred_early_stop_margin=0.5)
    reg, x = _es_model("regression")
    jr = lgb.Booster(model_str=reg.model_to_string())
    assert not np.allclose(jr.predict(x, **kw), jr.predict(x,
                                                           raw_score=True))
    assert np.array_equal(reg.predict(x, **kw),
                          reg.predict(x, raw_score=True))
    rf, x = _es_model("binary", boosting="rf", bagging_fraction=0.7,
                      bagging_freq=1)
    jf = lgb.Booster(model_str=rf.model_to_string())
    assert not np.allclose(jf.predict(x, **kw), jf.predict(x,
                                                           raw_score=True))
    with pytest.raises(LightGBMError, match="rf"):
        rf.predict(x, **kw)

    def fobj(preds, ds):
        y = ds.get_label()
        p = 1.0 / (1.0 + np.exp(-preds))
        return p - y, p * (1.0 - p)
    x, y = _data(n=300, seed=8)
    custom = lgt.train(dict(BASE, objective=fobj, num_leaves=7),
                       lgt.Dataset(x, label=y), 3, device="cpu")
    with pytest.raises(LightGBMError, match="custom"):
        custom.predict(x, **kw)
