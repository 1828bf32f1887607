"""The scikit-learn estimators and the plots of the PyTorch port against the
JAX package, on the CPU.

The port's estimators (``device="cpu"``) and the JAX package's (its
row-order route, as ``tests/test_torch_api.py`` trains it) fit the same
rows: trees equal in structure, leaves within
``test_torch_train.LEAF_RTOL`` of the tree's largest (``compare_trees``),
probabilities and predictions within 1e-5, for the classifier (binary
and 3 classes, string labels), the regressor, the ranker and early
stopping on an ``eval_set``; ``clone`` and ``GridSearchCV`` (the port's
``device`` is a parameter like the others).  With ``sklearn`` hidden
from ``sys.modules``, as on a machine without it, the estimators stand
on plain bases and still fit, predict and report.  The plots' figure
data (bar widths and labels, line data, histogram bars, the tree's dot
source) equal the JAX package's for one model.
"""
import contextlib
import os
import sys

import matplotlib
matplotlib.use("Agg")

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from chip_smoke import compare_trees
from conftest import restore_env_knobs, save_env_knobs
from test_torch_train import (LEAF_RTOL, ROUTE_KNOBS, ROW_ORDER_ROUTE,
                              _data, _purge)

torch.set_num_threads(1)

PARAMS = dict(n_estimators=2, num_leaves=15, min_child_samples=5,
              verbosity=-1)


@contextlib.contextmanager
def jax_package():
    """The JAX package imported fresh on its row-order route, purged
    again after."""
    saved = save_env_knobs(ROUTE_KNOBS)
    for k in ROUTE_KNOBS:
        os.environ.pop(k, None)
    os.environ.update(ROW_ORDER_ROUTE)
    try:
        _purge()
        import lightgbm_tpu as lgb
        yield lgb
    finally:
        restore_env_knobs(saved)
        _purge()


def _fit_both(name, x, y, fit_kw=None, **params):
    kw = dict(PARAMS, **params)
    port = getattr(lgt, name)(device="cpu", **kw).fit(x, y, **(fit_kw or {}))
    with jax_package() as lgb:
        jax = getattr(lgb, name)(**kw).fit(x, y, **(fit_kw or {}))
    return port, jax


def _same(port, jax, x, proba=True):
    cmp = compare_trees(port.booster_._models, jax.booster_._models,
                        LEAF_RTOL)
    assert cmp["ok"], cmp
    got, want = port.predict(x), jax.predict(x)
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        assert np.mean(got == want) > 0.99
    if proba:
        np.testing.assert_allclose(port.predict_proba(x),
                                   jax.predict_proba(x), atol=1e-5)
    assert port.n_features_in_ == jax.n_features_in_
    np.testing.assert_array_equal(port.feature_importances_,
                                  jax.feature_importances_)


def test_classifier_binary_matches_jax():
    x, y = _data(1000, 6, 11)
    port, jax = _fit_both("LGBMClassifier", x, y.astype(int))
    _same(port, jax, x)
    assert list(port.classes_) == list(jax.classes_) == [0, 1]
    assert port.predict_proba(x).shape == (1000, 2)


def test_classifier_multiclass_and_string_labels_match_jax():
    x, y = _data(900, 6, 12, objective="regression")
    labels = np.array(["lo", "mid", "hi"])[np.digitize(y, [-0.5, 0.5])]
    port, jax = _fit_both("LGBMClassifier", x, labels)
    _same(port, jax, x)
    assert port.n_classes_ == 3 and list(port.classes_) == list(jax.classes_)
    assert set(port.predict(x)) <= {"lo", "mid", "hi"}


def test_regressor_matches_jax():
    x, y = _data(1000, 6, 13, objective="regression")
    port, jax = _fit_both("LGBMRegressor", x, y)
    _same(port, jax, x, proba=False)


def test_ranker_matches_jax():
    rng = np.random.default_rng(14)
    x = rng.normal(size=(200, 5))
    rel = np.clip((x[:, 0] * 2 + rng.normal(size=200) * 0.3).astype(int)
                  % 4, 0, 3)
    group = np.full(20, 10)
    port, jax = _fit_both("LGBMRanker", x, rel, fit_kw={"group": group})
    _same(port, jax, x, proba=False)


def test_early_stopping_on_an_eval_set_matches_jax():
    x, y = _data(900, 6, 15)
    yi = y.astype(int)
    kw = dict(PARAMS, n_estimators=20, learning_rate=0.8)
    fit_kw = {"eval_set": [(x[600:], yi[600:])],
              "eval_metric": "binary_logloss"}
    port = lgt.LGBMClassifier(device="cpu", **kw).fit(
        x[:600], yi[:600], callbacks=[lgt.early_stopping(3, verbose=False)],
        **fit_kw)
    with jax_package() as lgb:
        jax = lgb.LGBMClassifier(**kw).fit(
            x[:600], yi[:600],
            callbacks=[lgb.early_stopping(3, verbose=False)], **fit_kw)
    assert 0 < port.best_iteration_ == jax.best_iteration_ < 20
    np.testing.assert_allclose(
        port.evals_result_["valid_0"]["binary_logloss"],
        jax.evals_result_["valid_0"]["binary_logloss"], rtol=1e-5)
    np.testing.assert_allclose(port.predict_proba(x[600:]),
                               jax.predict_proba(x[600:]), atol=1e-5)


def test_clone_and_grid_search_match_jax():
    from sklearn.base import clone
    from sklearn.model_selection import GridSearchCV
    x, y = _data(300, 5, 16, objective="regression")
    est = lgt.LGBMRegressor(device="cpu", **PARAMS)
    twin = clone(est)
    assert twin.get_params() == est.get_params()
    assert twin.get_params()["device"] == "cpu"
    twin.set_params(num_leaves=7)
    assert twin.num_leaves == 7 and est.num_leaves == 15
    grid = {"num_leaves": [3, 15]}
    split = [(np.arange(200), np.arange(200, 300))]
    port = GridSearchCV(est, grid, cv=split).fit(x, y)
    with jax_package() as lgb:
        jax = GridSearchCV(lgb.LGBMRegressor(**PARAMS), grid,
                           cv=split).fit(x, y)
    assert port.best_params_ == jax.best_params_
    np.testing.assert_allclose(port.cv_results_["mean_test_score"],
                               jax.cv_results_["mean_test_score"],
                               atol=1e-5)
    cmp = compare_trees(port.best_estimator_.booster_._models,
                        jax.best_estimator_.booster_._models, LEAF_RTOL)
    assert cmp["ok"], cmp


def test_estimators_without_scikit_learn(monkeypatch):
    """sklearn hidden from ``sys.modules`` (every import of it fails):
    the module imports fresh on its stand-in bases and the estimators
    fit, predict and report, as on the card's machine."""
    for name in [m for m in sys.modules if m == "sklearn"
                 or m.startswith("sklearn.")]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.delitem(sys.modules, "lightgbm_tpu_torch.sklearn")
    import importlib
    sk = importlib.import_module("lightgbm_tpu_torch.sklearn")
    assert sk._SKBase.__module__ == "lightgbm_tpu_torch.sklearn"
    x, y = _data(600, 5, 17)
    clf = sk.LGBMClassifier(device="cpu", **PARAMS).fit(x, y.astype(int))
    with pytest.raises(ImportError):
        import sklearn.base  # noqa: F401
    proba = clf.predict_proba(x)
    assert proba.shape == (600, 2)
    assert np.mean(clf.predict(x) == y) > 0.7
    assert clf.best_iteration_ == clf.booster_.best_iteration
    assert clf.feature_importances_.sum() > 0
    assert clf.get_params()["num_leaves"] == 15
    clf.set_params(num_leaves=7, extra_param=3)
    assert clf.get_params()["extra_param"] == 3
    reg = sk.LGBMRegressor(device="cpu", **PARAMS).fit(x, y)
    assert reg.predict(x).shape == (600,)


# -- plotting -----------------------------------------------------------------
@pytest.fixture(scope="module")
def plot_pair():
    x, y = _data(500, 6, 18)
    evals = {}
    bst = lgt.train({"objective": "binary", "num_leaves": 15,
                     "metric": "auc", "verbosity": -1},
                    lgt.Dataset(x, label=y), 8,
                    valid_sets=[lgt.Dataset(x, label=y)],
                    valid_names=["train"],
                    callbacks=[lgt.record_evaluation(evals)], device="cpu")
    text = bst.model_to_string()
    with jax_package() as lgb:
        jb = lgb.Booster(model_str=text)
    return lgt.Booster(model_str=text, device="cpu"), jb, evals, lgb


def _bars(ax):
    return [(p.get_x(), p.get_y(), p.get_width(), p.get_height())
            for p in ax.patches]


def test_plot_importance_matches_jax(plot_pair):
    import matplotlib.pyplot as plt
    port, jb, _, lgb = plot_pair
    for kw in ({}, {"importance_type": "gain", "max_num_features": 3}):
        a, b = lgt.plot_importance(port, **kw), lgb.plot_importance(jb, **kw)
        assert len(a.patches) > 0
        np.testing.assert_allclose(_bars(a), _bars(b), rtol=1e-12)
        assert ([t.get_text() for t in a.get_yticklabels()]
                == [t.get_text() for t in b.get_yticklabels()])
        assert a.get_title() == b.get_title()
        plt.close("all")


def test_plot_metric_and_split_histogram_match_jax(plot_pair):
    import matplotlib.pyplot as plt
    port, jb, evals, lgb = plot_pair
    a, b = lgt.plot_metric(evals), lgb.plot_metric(evals)
    assert len(a.lines) == len(b.lines) == 1
    np.testing.assert_array_equal(a.lines[0].get_xydata(),
                                  b.lines[0].get_xydata())
    assert a.get_ylabel() == b.get_ylabel() == "auc"
    a = lgt.plot_split_value_histogram(port, feature=0)
    b = lgb.plot_split_value_histogram(jb, feature=0)
    assert len(a.patches) > 0
    np.testing.assert_allclose(_bars(a), _bars(b), rtol=1e-12)
    plt.close("all")


def test_tree_digraph_matches_jax(plot_pair):
    """The dot source of each tree equals the JAX package's; without the
    graphviz package both raise ImportError."""
    from lightgbm_tpu.plotting import _tree_to_dot as jax_dot
    from lightgbm_tpu_torch.plotting import _tree_to_dot
    port, jb, _, lgb = plot_pair
    for i, (t, jt) in enumerate(zip(port._models, jb._models)):
        assert (_tree_to_dot(t, i, port.feature_name())
                == jax_dot(jt, i, jb.feature_name()))
    try:
        import graphviz  # noqa: F401
    except ImportError:
        for fn in (lgt.create_tree_digraph, lgt.plot_tree):
            with pytest.raises(ImportError):
                fn(port)
    else:  # pragma: no cover
        assert (lgt.create_tree_digraph(port, 1).source
                == lgb.create_tree_digraph(jb, 1).source)
