"""The port's metric factory (``metric.create_metrics``) against the JAX
package's, on the CPU.

The ranking metrics ``ndcg`` and ``map`` on a dataset without query
groups raise ``LightGBMError``, from ``train`` and from
``Booster.add_valid``, as LightGBM's metric ``Init`` does: training on
without them would stop early stopping at another iteration.  ``binary_error``, ``rmse``
and its alias ``l2_root``, which once raised, equal the JAX package's
(tests/test_torch_objectives.py holds every metric).  A name neither package
knows warns and is dropped in both.  The JAX package trains on its
physical, unfused route with the XLA split tail (knobs saved and
restored and its modules purged around each run, as
tests/test_torch_train.py does); the port with ``device="cpu"``.
Inputs are made with numpy from seed 11 (the parity data of
tests/test_torch_train.py: 3,000 training rows, 600 validation rows).
Early stopping must stop both packages at the same iteration, and the
best scores agree within 1e-5.
"""
import os
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from conftest import restore_env_knobs, save_env_knobs
from lightgbm_tpu_torch.utils import log as tlog
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

ROUTE = {"LGBM_TPU_PHYS": "interpret", "LGBM_TPU_STREAM": "0",
         "LGBM_TPU_FUSED": "0"}
ROUTE_KNOBS = ("LGBM_TPU_PHYS", "LGBM_TPU_STREAM", "LGBM_TPU_FUSED",
               "LGBM_TPU_APPLY_IMPL")
N_TRAIN, N_VALID = 3000, 600


def _purge():
    for m in [k for k in list(sys.modules) if k.startswith("lightgbm_tpu")
              and not k.startswith("lightgbm_tpu_torch")]:
        del sys.modules[m]


def _data(objective="binary"):
    rng = np.random.default_rng(11)
    n = N_TRAIN + N_VALID
    x = rng.normal(size=(n, 6)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan
    y_raw = (np.nan_to_num(x[:, 0]) + 0.5 * np.nan_to_num(x[:, 1] * x[:, 2])
             + 0.3 * rng.normal(size=n))
    y = ((y_raw > 0).astype(np.float32) if objective == "binary"
         else y_raw.astype(np.float32))
    return x[:N_TRAIN], y[:N_TRAIN], x[N_TRAIN:], y[N_TRAIN:]


def _logged(run):
    """(result of ``run(log_lines)``, the lines logged meanwhile)."""
    lines = []
    verbosity = tlog.get_verbosity()
    try:
        return run(lines), lines
    finally:
        lgt.register_log_callback(None)
        tlog.set_verbosity(verbosity)


def _jax_train(params, rounds, objective="binary", callbacks=None,
               lines=None):
    saved = save_env_knobs(ROUTE_KNOBS)
    for k in ROUTE_KNOBS:
        os.environ.pop(k, None)
    os.environ.update(ROUTE)
    try:
        _purge()
        import lightgbm_tpu as lgb
        from lightgbm_tpu.utils import log as jlog
        if lines is not None:
            jlog.register_log_callback(lines.append)
        xt, yt, xv, yv = _data(objective)
        ds = lgb.Dataset(xt, label=yt)
        bst = lgb.train(params, ds, num_boost_round=rounds,
                        valid_sets=[lgb.Dataset(xv, label=yv, reference=ds)],
                        callbacks=callbacks(lgb) if callbacks else None)
        return bst
    finally:
        restore_env_knobs(saved)
        _purge()


def _port_train(params, rounds, objective="binary", callbacks=None):
    xt, yt, xv, yv = _data(objective)
    ds = lgt.Dataset(xt, label=yt)
    return lgt.train(params, ds, num_boost_round=rounds,
                     valid_sets=[lgt.Dataset(xv, label=yv, reference=ds)],
                     callbacks=callbacks(lgt) if callbacks else None,
                     device="cpu")


@pytest.mark.parametrize("entry", ["train", "booster"])
@pytest.mark.parametrize("name,objective", [
    ("ndcg", "regression"), ("map", "regression"),
    ("mean_average_precision", "binary")])
def test_unported_metric_raises(name, objective, entry):
    """A ranking metric (``ndcg``, ``map``) on data without query groups
    raises, naming the missing query information, whether training asks
    for it or a validation set is added to a Booster."""
    params = {"objective": objective, "metric": name, "num_leaves": 7,
              "verbosity": -1}
    with pytest.raises(LightGBMError,
                       match=r"(NDCG|MAP) metric requires query information"):
        if entry == "train":
            _port_train(params, 2, objective)
        else:
            xt, yt, xv, yv = _data(objective)
            ds = lgt.Dataset(xt, label=yt)
            bst = lgt.Booster(params, train_set=ds, device="cpu")
            bst.add_valid(lgt.Dataset(xv, label=yv, reference=ds), "v")


@pytest.mark.parametrize("name,objective,key", [
    ("binary_error", "binary", "binary_error"),
    ("rmse", "regression", "rmse"), ("l2_root", "regression", "rmse")])
def test_formerly_unported_metric_matches_jax(name, objective, key):
    """The metrics this file once held as raising now train, and equal
    the JAX package's within 1e-5 after 3 rounds."""
    params = {"objective": objective, "metric": name, "num_leaves": 7,
              "verbosity": -1}
    bt = _port_train(params, 3, objective)
    bj = _jax_train(params, 3, objective)
    got = bt.best_score["valid_0"][key]
    want = bj.best_score["valid_0"][key]
    assert np.isfinite(got)
    assert abs(got - want) <= 1e-5 * max(abs(want), 1.0)


def test_alias_of_a_ported_metric_still_trains():
    """``mean_squared_error`` is an alias of ``l2``: it is computed as
    before, and equals the JAX package's ``l2`` within 1e-5."""
    params = {"objective": "regression", "metric": "mean_squared_error",
              "num_leaves": 7, "verbosity": -1}
    bt = _port_train(params, 3, "regression")
    bj = _jax_train(params, 3, "regression")
    got = bt.best_score["valid_0"]["l2"]
    want = bj.best_score["valid_0"]["l2"]
    assert np.isfinite(got)
    assert abs(got - want) <= 1e-5 * max(abs(want), 1.0)


def test_unknown_metric_warns_and_is_dropped_as_in_jax():
    """A name neither package knows is logged as a warning and dropped in
    both packages: no metric is evaluated, and training runs every
    round."""
    params = {"objective": "binary", "metric": "no_such_metric",
              "num_leaves": 7, "verbosity": 0}

    def port(lines):
        lgt.register_log_callback(lines.append)
        return _port_train(params, 3)

    def jax(lines):
        return _jax_train(params, 3, lines=lines)

    bt, port_lines = _logged(port)
    bj, jax_lines = _logged(jax)
    for lines in (port_lines, jax_lines):
        assert any("[Warning] Unknown metric no_such_metric" in ln
                   for ln in lines), lines
    assert not bt.best_score.get("valid_0")
    assert not bj.best_score.get("valid_0")
    assert bt.current_iteration() == bj.current_iteration() == 3


def test_auc_early_stopping_stops_where_jax_does():
    """Early stopping on ``auc`` stops the port at the JAX package's
    iteration, with the same best iteration and best score within
    1e-5."""
    params = {"objective": "binary", "metric": "auc", "num_leaves": 15,
              "verbosity": -1}

    def stop(pkg):
        return [pkg.early_stopping(3, verbose=False)]
    bt = _port_train(params, 20, callbacks=stop)
    bj = _jax_train(params, 20, callbacks=stop)
    assert bt.best_iteration == bj.best_iteration
    assert bt.current_iteration() == bj.current_iteration()
    assert bt.current_iteration() < 20
    got = bt.best_score["valid_0"]["auc"]
    want = bj.best_score["valid_0"]["auc"]
    assert abs(got - want) <= 1e-5


def test_alias_table_is_the_jax_packages():
    """The port's copy of the alias table names every metric the JAX
    package knows, to the same canonical metric; the port computes all
    of them."""
    from lightgbm_tpu.metric import metrics as jax_metrics
    from lightgbm_tpu_torch.metric import metrics as port_metrics
    assert port_metrics._METRIC_ALIASES == jax_metrics._METRIC_ALIASES
    ported = set(port_metrics._METRIC_REGISTRY)
    assert ported == set(jax_metrics._METRIC_REGISTRY)
