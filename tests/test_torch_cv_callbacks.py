"""``cv``'s callbacks and ``init_model`` in the PyTorch port, on the CPU.

The reference's ``cv`` runs its callbacks every round (the ``CVBooster``
as the model, the aggregated ``("cv_agg", "<set> <metric>", mean,
higher_better, stdv)`` as the results), stops every fold on an
``EarlyStopException`` and starts every fold from ``init_model``.  The
JAX package's ``cv`` accepts both and uses neither (a witness below);
the port's does what the reference does:

- an after-iteration callback sees each round's aggregate, the same
  numbers as the returned history; a before-iteration callback runs
  before the folds' update (``reset_parameter`` sets every fold's
  shrinkage);
- ``early_stopping`` as a callback cuts the history and every fold where
  ``early_stopping_round`` does; a callback's own ``EarlyStopException``
  cuts them at its best iteration;
- ``init_model`` (a booster, its text or its file): each fold's first
  scores are the model's raw predictions of the fold's rows, and its
  trees head each fold's model.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.callback import EarlyStopException
from lightgbm_tpu_torch.engine import CVBooster, _make_n_folds
from test_torch_api import BASE, _jax
from test_torch_train import _data

torch.set_num_threads(1)

PARAMS = dict(BASE, objective="binary", metric=["binary_logloss", "auc"])


def test_cv_runs_callbacks_each_round():
    x, y = _data(900, 4, 21)
    seen, before = [], []

    def after(env):
        assert isinstance(env.model, CVBooster)
        seen.append((env.iteration, list(env.evaluation_result_list)))

    def first(env):
        assert env.evaluation_result_list is None
        before.append(env.model.current_iteration())
    first.before_iteration = True
    res = lgt.cv(dict(PARAMS, is_provide_training_metric=True),
                 lgt.Dataset(x, label=y), num_boost_round=3, nfold=3,
                 eval_train_metric=True, callbacks=[after, first],
                 device="cpu")
    assert [it for it, _ in seen] == [0, 1, 2]
    assert before == [[0, 0, 0], [1, 1, 1], [2, 2, 2]]
    for it, items in seen:
        assert [i[1] for i in items] == [
            "valid binary_logloss", "valid auc", "train binary_logloss",
            "train auc"]
        for ds, key, mean, hb, stdv in items:
            assert ds == "cv_agg" and hb == key.endswith("auc")
            assert res[f"{key}-mean"][it] == mean
            assert res[f"{key}-stdv"][it] == stdv


def test_cv_reset_parameter_sets_every_fold():
    x, y = _data(900, 4, 22)
    rates = [0.3, 0.1, 0.05]
    res = lgt.cv(PARAMS, lgt.Dataset(x, label=y), num_boost_round=3, nfold=2,
                 callbacks=[lgt.reset_parameter(learning_rate=rates)],
                 return_cvbooster=True, device="cpu")
    for b in res["cvbooster"].boosters:
        assert [t.shrinkage for t in b._models] == rates


def test_cv_early_stopping_callback_cuts_every_fold():
    x, y = _data(900, 4, 8)
    params = dict(BASE, objective="binary", metric="binary_logloss",
                  learning_rate=3.0)
    built_in = lgt.cv(dict(params, early_stopping_round=1),
                      lgt.Dataset(x, label=y), num_boost_round=30, nfold=3,
                      return_cvbooster=True, device="cpu")
    by_callback = lgt.cv(params, lgt.Dataset(x, label=y), num_boost_round=30,
                         nfold=3, return_cvbooster=True, device="cpu",
                         callbacks=[lgt.early_stopping(1, verbose=False)])
    n = built_in["cvbooster"].best_iteration
    assert 0 < n < 30
    for res in (built_in, by_callback):
        cvb = res.pop("cvbooster")
        assert cvb.best_iteration == n
        assert [b.best_iteration for b in cvb.boosters] == [n] * 3
    assert by_callback == built_in
    assert all(len(v) == n for v in by_callback.values())


def test_cv_callback_exception_stops_at_its_best_iteration():
    x, y = _data(900, 4, 23)
    calls = []

    def stop_at_four(env):
        calls.append(env.iteration)
        if env.iteration == 3:
            raise EarlyStopException(1, env.evaluation_result_list)
    res = lgt.cv(PARAMS, lgt.Dataset(x, label=y), num_boost_round=10,
                 nfold=2, callbacks=[stop_at_four], return_cvbooster=True,
                 device="cpu")
    cvb = res.pop("cvbooster")
    assert calls == [0, 1, 2, 3]
    assert cvb.best_iteration == 2
    assert [b.best_iteration for b in cvb.boosters] == [2, 2]
    assert cvb.current_iteration() == [4, 4]
    assert all(len(v) == 2 for v in res.values())


@pytest.mark.parametrize("form", ["booster", "string", "file"])
def test_cv_starts_each_fold_from_init_model(form, tmp_path):
    x, y = _data(1200, 5, 24)
    base = lgt.train(dict(BASE, objective="binary"), lgt.Dataset(x, label=y),
                     num_boost_round=2, device="cpu")
    init = {"booster": base, "string": base.model_to_string()}.get(form)
    if init is None:
        init = str(tmp_path / "init.txt")
        base.save_model(init)
    raw = base.predict(x, raw_score=True)
    first = []

    def scores(env):
        if env.iteration == 0:
            first.extend(b._inner.scores.clone() for b in env.model.boosters)
    scores.before_iteration = True
    res = lgt.cv(dict(BASE, objective="binary", metric="binary_logloss"),
                 lgt.Dataset(x, label=y), num_boost_round=2, nfold=3,
                 init_model=init, callbacks=[scores], return_cvbooster=True,
                 device="cpu")
    folds = list(_make_n_folds(lgt.Dataset(x, label=y), 3, 0, True, True))
    for s, (train_idx, _) in zip(first, folds):
        want = torch.as_tensor(raw[train_idx].astype(np.float32))
        assert torch.equal(s[0], want)
    for b in res["cvbooster"].boosters:
        assert len(b._models) == 4
        assert all(a.num_leaves == t.num_leaves and
                   np.array_equal(a.leaf_value, t.leaf_value)
                   for a, t in zip(b._models[:2], base._models))
    # the folds' holdout logloss starts from the model's, not from zero
    cold = lgt.cv(dict(BASE, objective="binary", metric="binary_logloss"),
                  lgt.Dataset(x, label=y), num_boost_round=2, nfold=3,
                  device="cpu")
    assert (res["valid binary_logloss-mean"][0]
            < cold["valid binary_logloss-mean"][0])


def test_jax_cv_calls_no_callback():
    """The witness: the JAX package's ``cv`` builds its callback list and
    never calls it, before or after an iteration."""
    x, y = _data(600, 4, 25)
    calls = []

    def after(env):
        calls.append(("after", env.iteration))

    def before(env):
        calls.append(("before", env.iteration))
    before.before_iteration = True
    res = _jax(lambda lgb: lgb.cv(
        dict(BASE, objective="binary", metric="binary_logloss"),
        lgb.Dataset(x, label=y), num_boost_round=3, nfold=2,
        callbacks=[after, before]))
    assert len(res["valid binary_logloss-mean"]) == 3
    assert calls == []
