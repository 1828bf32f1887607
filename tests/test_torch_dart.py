"""The DART booster of the PyTorch port against the JAX package, on the
CPU, with the repairs that came with it.

- Drop sets: each iteration's drop set equals the JAX package's over 8
  iterations, under ``uniform_drop``, ``xgboost_dart_mode`` and
  ``max_drop`` (the same PCG64 ``random()`` calls in the same order).
- Training, 15 leaves, 5 iterations at ``drop_rate`` 0.5 and
  ``skip_drop`` 0 (drop sets [], [], [1], [0], [0, 1]), binary (seed
  12) and lambdarank, and multiclass K = 3 for 3 iterations, the port
  against
  the JAX package on its row-order route: trees held by
  ``test_torch_objectives.hold_trees``, the training scores within
  4e-6 of the JAX package's and the validation scores within 1e-5 of
  its predictions.  Two departures are corrected on the JAX side:
  - for a drop set of k > 1 trees the JAX package scales the dropped
    trees by 1 / (k + 1), where its training scores and LightGBM take
    k / (k + 1) (``models/dart.py``; witnessed below), so its trees of
    such an iteration are multiplied by k before they are compared;
  - a drop subtracts each dropped tree's f32 outputs, which leaves
    documents that tied in a query (one leaf of every kept tree) 1 ulp
    apart, differently in each package (witnessed below), and the
    lambdarank gradients follow the ranks those ulps set.  The
    lambdarank case therefore starts from a seeded init score that ties
    no two documents.
- The port's physical routes (default, pack=2, ``FUSED=0``, 3ph, slice
  2's knobs) grow the same lambdarank DART trees bit for bit; the
  row-order route trains them too; a sorted-subset categorical model
  trains under DART with its replicas' membership words.
- A DART model saved and loaded predicts the booster's training scores;
  a lambdarank DART model of the JAX package loads and predicts within
  f32 noise.
- ``boosting=rf`` with a dataset ``init_score`` raises ``LightGBMError``
  (ROADMAP C3), and every unported parameter's message names its own
  ROADMAP item.
"""
import functools
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from chip_smoke import compare_trees
from conftest import restore_env_knobs, save_env_knobs
from lightgbm_tpu_torch.ops.grow import StageTimer
from lightgbm_tpu_torch.utils.log import LightGBMError
from test_cat_physical import _cat_problem
from test_torch_objectives import hold_trees
from test_torch_rank import (RANK_BASE, jax_rank_train, port_rank_train,
                             rank_data)
from test_torch_train import (ROUTE_KNOBS, SETTING_LEAF_RTOL, _data,
                              _first_divergence, _purge)

torch.set_num_threads(1)

DART = {"boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0}
TRAIN_SCORE_ATOL = 4e-6
VALID_SCORE_ATOL = 1e-5
PORT_KNOBS = ("LGBM_TPU_PHYS", "LGBM_TPU_STREAM", "LGBM_TPU_FUSED",
              "LGBM_TPU_APPLY_IMPL", "LGBM_TPU_PART", "LGBM_TPU_POOL_TAIL",
              "LGBM_TPU_COMB_PACK")


@pytest.fixture(scope="module")
def jax_lgb():
    """The JAX package imported once for the drop-set cases (each fresh
    import compiles anew); its CPU default is its row-order route."""
    saved = save_env_knobs(ROUTE_KNOBS)
    for k in ROUTE_KNOBS:
        os.environ.pop(k, None)
    _purge()
    import lightgbm_tpu as lgb
    yield lgb
    restore_env_knobs(saved)
    _purge()


def _drop_sets(bst, iters):
    """Each iteration's drop set of ``iters`` updates."""
    inner = bst._inner
    out = []
    for _ in range(iters):
        bst.update()
        out.append(list(inner.drop_index if hasattr(inner, "drop_index")
                        else inner._drop_index))
    return out


def _lightgbm_factor(bj, drops):
    """The JAX booster's trees with LightGBM's rescaling: a tree dropped
    in an iteration of k > 1 drops multiplied by k (k / (k + 1) where
    the JAX package keeps 1 / (k + 1)); only the last iteration may
    have such a set, so no later iteration read the JAX package's
    scale."""
    k_tree = bj._inner.num_tree_per_iteration
    for it, drop in enumerate(drops):
        if len(drop) > 1:
            assert it == len(drops) - 1, drops
            for i in drop:
                for c in range(k_tree):
                    bj._inner.models[i * k_tree + c].apply_shrinkage(
                        float(len(drop)))


def _hold_scores(bt, bj, xv):
    """The training scores against the JAX package's, the validation
    scores against its (corrected) predictions and the port's own."""
    k = bt._inner.num_tree_per_iteration
    n = bt._inner.train_set.num_data
    tj = np.asarray(bj._inner.train_score)[:, :n]
    tt = bt._inner.scores.numpy()
    assert np.abs(tt - tj).max() <= TRAIN_SCORE_ATOL
    vt = bt._inner.valid_sets[0].scores.numpy()
    pj = np.asarray(bj.predict(xv, raw_score=True)).reshape(len(xv), k).T
    pt = bt.predict(xv, raw_score=True).reshape(len(xv), k).T
    assert np.abs(vt - pj).max() <= VALID_SCORE_ATOL
    assert np.abs(vt - pt).max() <= 4e-7


# ---------------------------------------------------------------------
# drop sets
# ---------------------------------------------------------------------
@pytest.mark.parametrize("uniform_drop,xgboost_dart_mode,max_drop", [
    (False, False, 50), (True, False, 50), (False, True, 2),
    (True, True, 2), (False, False, 1)])
def test_drop_sets_match_jax(jax_lgb, uniform_drop, xgboost_dart_mode,
                             max_drop):
    x, y = _data(200, 3, 3)
    params = {"objective": "binary", "boosting": "dart", "num_leaves": 2,
              "verbosity": -1, "drop_rate": 0.6, "skip_drop": 0.2,
              "drop_seed": 11, "uniform_drop": uniform_drop,
              "xgboost_dart_mode": xgboost_dart_mode, "max_drop": max_drop}
    want = _drop_sets(jax_lgb.Booster(params, jax_lgb.Dataset(x, label=y)),
                      8)
    got = _drop_sets(lgt.Booster(params, lgt.Dataset(x, label=y),
                                 device="cpu"), 8)
    assert got == want
    assert sum(map(len, got)) >= 3
    assert max(map(len, got)) <= max_drop


# ---------------------------------------------------------------------
# training
# ---------------------------------------------------------------------
def _dart_pair(params, x, y, group, rounds, valid, init_score=None):
    dj, dt = [], []
    bj = jax_rank_train(params, x, y, group, rounds, valid=valid,
                        init_score=init_score,
                        record=lambda b: dj.append(
                            list(b._inner._drop_index)))
    bt = port_rank_train(params, x, y, group, rounds, valid=valid,
                         init_score=init_score,
                         record=lambda b: dt.append(
                             list(b._inner.drop_index)))
    assert dt == dj
    return bt, bj, dt


@functools.lru_cache(maxsize=None)
def _binary_pair():
    """Binary DART in both packages, 5 iterations, seed 12 (at seed 11,
    and 14, one node's NaN direction is a near tie the two packages' f32
    sums break apart: tree 4, node 5, gain 10.83618 with NaN left in
    the port, 10.83588 right in the JAX package; the trees equal each
    other everywhere else).  Also the JAX model's gap between its
    predictions and its training scores, before any correction."""
    x, y = _data(3000, 6, 12)
    xv, yv = _data(600, 6, 112)
    params = dict(RANK_BASE, objective="binary", **DART)
    bt, bj, drops = _dart_pair(params, x, y, None, 5, (xv, yv, None))
    gap_j = np.abs(np.asarray(bj.predict(x, raw_score=True))
                   - np.asarray(bj._inner.train_score)[0, :len(y)])
    dropped = sum(t.leaf_value[t.predict_leaf(x.astype(np.float64))]
                  for t in bj._models[:2])
    return bt, bj, drops, x, xv, gap_j, dropped


def test_dart_binary_matches_jax():
    bt, bj, drops, x, xv, _, _ = _binary_pair()
    assert drops == [[], [], [1], [0], [0, 1]]
    assert bt._inner.grow.route.describe() == (
        "path=physical fused=1 tail=kernel (boosting_not_gbdt)")
    _lightgbm_factor(bj, drops)
    hold_trees(bt, bj, x)
    _hold_scores(bt, bj, xv)


@functools.lru_cache(maxsize=None)
def _lambdarank_pair():
    """Lambdarank DART in both packages, 5 iterations, from a seeded init
    score that ties no two documents; also the JAX model's text and its
    predictions on other rows, before any correction."""
    x, y, sizes = rank_data(80, 11)
    xv, yv, gv = rank_data(15, 12)
    init = np.random.default_rng(5).uniform(-1.0, 1.0, len(y))
    params = dict(RANK_BASE, objective="lambdarank", metric="ndcg",
                  eval_at=[1, 3], **DART)
    bt, bj, drops = _dart_pair(params, x, y, sizes, 5, (xv, yv, gv),
                               init_score=init)
    xs = rank_data(10, 33)[0]
    return (bt, bj, drops, x, xv, bj.model_to_string(), xs,
            np.asarray(bj.predict(xs, raw_score=True)))


def test_dart_lambdarank_matches_jax():
    bt, bj, drops, x, xv = _lambdarank_pair()[:5]
    assert drops == [[], [], [1], [0], [0, 1]]
    assert bt._inner.grow.route.describe() == (
        "path=physical fused=1 tail=kernel (objective_not_streamable, "
        "boosting_not_gbdt)")
    _lightgbm_factor(bj, drops)
    hold_trees(bt, bj, x)
    _hold_scores(bt, bj, xv)
    et = bt.eval_valid()
    assert [r[1] for r in et] == ["ndcg@1", "ndcg@3"]
    assert all(0.0 < r[2] <= 1.0 for r in et)


def test_dart_multiclass_matches_jax():
    x, y_raw = _data(1500, 6, 11, "regression")
    y = np.digitize(y_raw, [-0.5, 0.5]).astype(np.float32)
    xv, yv_raw = _data(400, 6, 12, "regression")
    yv = np.digitize(yv_raw, [-0.5, 0.5]).astype(np.float32)
    params = dict(RANK_BASE, objective="multiclass", num_class=3, **DART)
    bt, bj, drops = _dart_pair(params, x, y, None, 3, (xv, yv, None))
    assert drops == [[], [], [1]]
    assert len(bt._models) == len(bj._models) == 9
    hold_trees(bt, bj, x)
    _hold_scores(bt, bj, xv)


def test_jax_dart_model_misses_its_training_scores():
    """The witness of the JAX package's scale at k > 1 (ROADMAP C): after
    the iteration that drops two trees its model predicts other scores
    than its training scores by (k - 1) / (k + 1) of the dropped trees;
    the port's model predicts its own."""
    bt, _, drops, x, _, gap_j, dropped = _binary_pair()
    assert drops[-1] == [0, 1]
    gap_t = np.abs(bt.predict(x, raw_score=True)
                   - bt._inner.train_score.numpy())
    # trees 0 and 1 at 1/3 of themselves where the scores hold 2/3
    np.testing.assert_allclose(gap_j, np.abs(dropped), rtol=1e-4,
                               atol=1e-6)
    assert gap_j.max() > 1e-2
    assert gap_t.max() <= 4e-7


def test_drop_leaves_f32_noise_on_tied_documents():
    """Iteration 2 drops tree 1: its dropped basis is tree 0's outputs up
    to the f32 rounding of adding tree 1 and taking it away, so
    documents one leaf of tree 0 tied are no longer all tied."""
    x, y, sizes = rank_data(80, 11)
    params = dict(RANK_BASE, objective="lambdarank", **DART)
    bst = port_rank_train(params, x, y, sizes, 2)
    basis = bst._inner.get_training_score()[0].numpy()
    assert bst._inner.drop_index == [1]
    t0 = bst._models[0]
    tree0 = t0.leaf_value[t0.predict_leaf(x.astype(np.float64))].astype(
        np.float32)
    qb = np.concatenate([[0], np.cumsum(sizes)])

    def ties(s):
        return sum(qb[i + 1] - qb[i] - len(np.unique(s[qb[i]:qb[i + 1]]))
                   for i in range(len(sizes)))
    assert np.abs(basis - tree0).max() <= 2 * np.spacing(
        np.abs(tree0).max())
    assert ties(basis) < ties(tree0)


# ---------------------------------------------------------------------
# routes, categorical words, the stage
# ---------------------------------------------------------------------
ROUTES = {
    "pack2": ({"LGBM_TPU_COMB_PACK": "2"}, "pack=2"),
    "unfused": ({"LGBM_TPU_FUSED": "0"}, "fused=0"),
    "3ph": ({"LGBM_TPU_PART": "3ph"}, "scheme=3ph"),
    "slice2": ({"LGBM_TPU_STREAM": "0", "LGBM_TPU_FUSED": "0",
                "LGBM_TPU_APPLY_IMPL": "xla"}, "tail=xla"),
}


@functools.lru_cache(maxsize=None)
def _route_case(route: str):
    """4 iterations of lambdarank DART on the route (drop sets [], [],
    [1], [0]), from a seeded init score that ties no two documents."""
    x, y, sizes = rank_data(60, 21)
    init = np.random.default_rng(6).uniform(-1.0, 1.0, len(y))
    env = dict(ROUTES[route][0]) if route in ROUTES else {}
    if route == "row_order":
        env = {"LGBM_TPU_PHYS": "0"}
    saved = save_env_knobs(PORT_KNOBS)
    try:
        params = dict(RANK_BASE, objective="lambdarank", **DART)
        bst = port_rank_train(params, x, y, sizes, 4, env=env,
                              init_score=init)
        return bst, x, init
    finally:
        restore_env_knobs(saved)


@pytest.mark.parametrize("route", list(ROUTES))
def test_dart_routes_grow_the_same_trees(route):
    """Bit for bit, but 3ph, whose right children add their rows in
    ascending order: equal in structure, leaves within 1.2e-5 of the
    tree's largest (as tests/test_torch_sampling.py holds it)."""
    base = _route_case("default")[0]
    bst = _route_case(route)[0]
    assert ROUTES[route][1] in bst._inner.grow.route.describe()
    assert bst._inner.drop_index == base._inner.drop_index == [0]
    assert _first_divergence(bst._models, base._models) is None
    if route == "3ph":
        res = compare_trees(bst._models, base._models,
                            rtol=SETTING_LEAF_RTOL)
        assert res["ok"], res
        return
    for a, b in zip(bst._models, base._models):
        assert a.leaf_value.tobytes() == b.leaf_value.tobytes()
    assert torch.equal(bst._inner.scores, base._inner.scores)


def test_dart_row_order_route_trains():
    bst, x, init = _route_case("row_order")
    assert bst._inner.grow.route.path == "row_order"
    assert all(t.num_leaves > 1 for t in bst._models)
    gap = np.abs(bst.predict(x, raw_score=True) + init
                 - bst._inner.train_score.numpy())
    assert gap.max() <= 4e-7


def test_dart_categorical_subset_keeps_the_words():
    x, y = _cat_problem()
    params = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
              "min_data_in_leaf": 5, "min_data_per_group": 5,
              "cat_smooth": 2.0, "max_cat_to_onehot": 4, "max_bin": 63,
              **DART}
    bst = lgt.train(params, lgt.Dataset(
        x, label=y, categorical_feature=[0],
        params={"max_bin": 63, "min_data_in_bin": 1}), 5, device="cpu")
    inner = bst._inner
    assert inner.hp.use_cat_subset
    assert any(r.nodes.cat_members is not None for r in inner.replicas)
    assert any(len(d) for d in [inner.drop_index])
    gap = np.abs(bst.predict(x, raw_score=True) - inner.train_score.numpy())
    assert gap.max() <= 4e-7


def test_dart_stage_is_timed():
    x, y = _data(800, 4, 2)
    timer = StageTimer(enabled=True)
    lgt.train(dict(RANK_BASE, objective="binary", **DART),
              lgt.Dataset(x, label=y), 3, device="cpu", timer=timer)
    assert {"dart", "gradients", "score_update"} <= set(timer.totals_ms())


# ---------------------------------------------------------------------
# the model text
# ---------------------------------------------------------------------
def test_dart_model_saves_and_loads():
    bst, x, init = _route_case("default")
    text = bst.model_to_string()
    assert "[boosting: dart]" in text.splitlines()
    loaded = lgt.Booster(model_str=text, device="cpu")
    raw = loaded.predict(x, raw_score=True)
    assert raw.tobytes() == bst.predict(x, raw_score=True).tobytes()
    assert np.abs(raw + init - bst._inner.train_score.numpy()).max() <= 4e-7


def test_jax_dart_model_loads_in_the_port():
    """The JAX package's lambdarank DART model text, as it wrote it."""
    bj, text, xs, want = (_lambdarank_pair()[i] for i in (1, 5, 6, 7))
    assert "[boosting: dart]" in text.splitlines()
    loaded = lgt.Booster(model_str=text, device="cpu")
    got = loaded.predict(xs, raw_score=True)
    eps = np.finfo(np.float32).eps
    assert np.all(np.abs(got - want)
                  <= 4 * len(bj._models) * eps * np.maximum(np.abs(want),
                                                            1.0))


# ---------------------------------------------------------------------
# the repairs
# ---------------------------------------------------------------------
def test_rf_refuses_a_dataset_init_score():
    x, y = _data(2000, 6, 11)
    params = {"objective": "binary", "boosting": "rf", "num_leaves": 7,
              "bagging_fraction": 0.7, "bagging_freq": 1, "verbosity": -1}
    with pytest.raises(LightGBMError, match="rf.*init_score"):
        lgt.Booster(params, lgt.Dataset(x, label=y,
                                        init_score=np.full(len(y), 0.5)),
                    device="cpu")
    bst = lgt.train(params, lgt.Dataset(x, label=y), 3, device="cpu")
    assert len(bst._models) == 3 and bst._inner.average_output
    raw = bst.predict(x, raw_score=True)
    assert np.abs(raw - bst._inner.train_score.numpy() / 3).max() <= 4e-7


@pytest.mark.parametrize("params,item", [
    ({"tree_learner": "data", "boosting": "dart"}, "A10"),
    ({"tree_learner": "voting", "boosting": "dart"}, "A10"),
    ({"pre_partition": True}, "A11")])
def test_unported_messages_name_their_item(params, item):
    x, y = _data(300, 4, 1)
    with pytest.raises(LightGBMError, match=rf"ROADMAP\.md, {item}\)"):
        lgt.train(dict({"objective": "binary", "verbosity": -1}, **params),
                  lgt.Dataset(x, label=y), 1, device="cpu")


@pytest.mark.parametrize("params,rule", [
    ({"interaction_constraints": "[[0, 1]]"}, "tail_interaction"),
    ({"cegb_penalty_split": 0.5}, "tail_cegb"),
    ({"feature_fraction_bynode": 0.5}, "tail_bynode"),
    ({"extra_trees": True}, "tail_extra_trees")])
def test_dart_trains_the_split_options(params, rule):
    """A9's split options, which raised before slice 22, train a DART
    booster on the PyTorch tail under their rule."""
    x, y = _data(300, 4, 1)
    bst = lgt.train(dict({"objective": "binary", "boosting": "dart",
                          "verbosity": -1}, **params),
                    lgt.Dataset(x, label=y), 2, device="cpu")
    assert bst._inner.grow.route.describe() == (
        f"path=physical fused=1 tail=xla (boosting_not_gbdt, {rule})")


def test_callable_objective_names_a5():
    """A callable objective (ROADMAP A5, ported since) trains a DART
    booster as objective none with its gradients, the drop taken before
    the objective reads the scores."""
    x, y = _data(300, 4, 1)
    seen = []

    def fobj(p, d):
        seen.append(p.copy())
        return p - d.get_label(), np.ones_like(p)
    bst = lgt.train({"objective": fobj, "boosting": "dart", "drop_rate": 0.5,
                     "verbosity": -1}, lgt.Dataset(x, label=y), 3,
                    device="cpu")
    assert bst._inner.objective is None and len(bst._models) == 3
    assert [p.shape for p in seen] == [(300,)] * 3 and not seen[0].any()
    assert bst._inner.grow.route.describe().startswith(
        "path=physical fused=1 tail=kernel (objective_not_streamable")
