"""The split options of ``tests/test_torch_split_options.py`` with other
settings (basic and intermediate monotone constraints, the sorted-subset
categorical search, pack=2, multiclass), a forced split that cannot be
taken, and the raw-column witnesses, against the JAX package on the CPU
with that file's bounds.
"""
import json

import numpy as np
import torch

import lightgbm_tpu_torch as lgt
from chip_smoke import compare_trees, interaction_violations
from test_torch_split_options import (BASE, FORCED, ROUNDS, STREAM_XLA,
                                      forced_file, hold, pair)
from test_torch_train import (LEAF_RTOL, ROW_ORDER_ROUTE, _data,
                              _first_divergence, _jax_train, _port_train)

torch.set_num_threads(1)


def test_interaction_with_basic_monotone():
    x, y = _data(3000, 6, 11)
    params = dict(BASE, interaction_constraints="[[0, 1, 2], [2, 3, 4, 5]]",
                  monotone_constraints=[1, 0, -1, 0, 1, 0])
    bt, bj = pair(params, x, y)
    assert bt._inner.grow.route.describe() == STREAM_XLA.format(
        "tail_interaction")
    hold(bt, bj, x)
    assert interaction_violations(bt._models, [[0, 1, 2], [2, 3, 4, 5]]) == 0


def test_interaction_with_intermediate_monotone():
    """The intermediate method searches tightened leaves again with each
    leaf's own mask and draws (``_SearchPlan.leaf_mask``)."""
    x, y = _data(2000, 6, 12)
    params = dict(BASE, interaction_constraints="[[0, 1, 2], [2, 3, 4, 5]]",
                  monotone_constraints=[1, 0, -1, 0, 1, 0],
                  monotone_constraints_method="intermediate",
                  feature_fraction_bynode=0.8, extra_trees=True)
    bt, bj = pair(params, x, y)
    assert bt._inner.grow.route.describe() == STREAM_XLA.format(
        "tail_mono_intermediate, tail_interaction, tail_bynode, "
        "tail_extra_trees")
    hold(bt, bj, x)


def _cat_problem(seed=5, n=2500):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    # a categorical column of 12 values; bin 0 (other / NaN) stays empty
    x[:, 3] = rng.integers(0, 12, n)
    effect = rng.normal(size=12)
    y = ((x[:, 0] + effect[x[:, 3].astype(int)]
          + 0.3 * rng.normal(size=n)) > 0).astype(np.float32)
    return x, y


def test_extra_trees_with_the_sorted_subset_search():
    """The subset search keeps one random prefix size a feature, drawn
    from the node key's ``fold_in(key, 1)`` stream."""
    x, y = _cat_problem()
    params = dict(BASE, extra_trees=True, min_data_per_group=5,
                  cat_smooth=2.0, max_cat_to_onehot=4)
    ds_kw = {"categorical_feature": [3]}
    bj = _jax_train(params, x, y, ROUNDS, route=ROW_ORDER_ROUTE,
                    cat=[3])[0]
    bt = lgt.train(params, lgt.Dataset(x, label=y, **ds_kw), ROUNDS,
                   device="cpu")
    assert bt._inner.hp.use_cat_subset and bt._inner.hp.use_extra_trees
    assert bt._inner.grow.route.describe() == STREAM_XLA.format(
        "tail_cat_subset, tail_extra_trees")
    assert any((t.decision_type[:t.num_leaves - 1] & 1).any()
               for t in bt._models)
    # tests/test_torch_cat_subset.py's bounds: the subset's rank-order
    # prefix sums are f64 rounded in the port, f32 in the JAX package
    assert _first_divergence(bt._models, bj._models) is None
    res = compare_trees(bt._models, bj._models, rtol=LEAF_RTOL)
    assert res["ok"], res
    np.testing.assert_allclose(bt.predict(x, raw_score=True),
                               np.asarray(bj.predict(x, raw_score=True)),
                               rtol=1e-4, atol=1e-5)


def test_forced_splits_at_pack2_equal_pack1(tmp_path, monkeypatch):
    x, y = _data(3000, 6, 11)
    params = dict(BASE, forcedsplits_filename=forced_file(tmp_path, FORCED))
    b1 = _port_train(params, x, y, ROUNDS, {})
    monkeypatch.setenv("LGBM_TPU_COMB_PACK", "2")
    bt, bj = pair(params, x, y)
    assert bt._inner.grow.route.describe() == (
        "path=stream fused=1 tail=xla pack=2 (tail_forced)")
    hold(bt, bj, x)
    for a, b in zip(bt._models, b1._models):
        assert a.leaf_value.tobytes() == b.leaf_value.tobytes()


def test_multiclass_with_bynode():
    x, y = _data(2400, 6, 13, objective="regression")
    y = np.digitize(y, np.quantile(y, [0.33, 0.66])).astype(np.float32)
    params = dict(BASE, objective="multiclass", num_class=3,
                  feature_fraction_bynode=0.5, num_leaves=7)
    bt, bj = pair(params, x, y, rounds=2)
    assert bt._inner.grow.route.describe() == (
        "path=physical fused=1 tail=xla (objective_not_streamable, "
        "multi_tree_iter, tail_bynode)")
    hold(bt, bj, x)


def test_a_forced_split_with_an_empty_child_is_skipped(tmp_path):
    """A forced split whose right child would be empty (column 1 has no
    NaN and every value lies below the threshold) gives way to the best
    split of that step, as in the JAX package: the first node is the
    unforced tree's, and the next step's forced split (the new right
    leaf on column 2) is taken."""
    x, y = _data(3000, 6, 11)
    x[:, 1] = np.nan_to_num(x[:, 1])
    tree = {"feature": 1, "threshold": 1e9,
            "right": {"feature": 2, "threshold": 0.0}}
    params = dict(BASE, forcedsplits_filename=forced_file(tmp_path, tree))
    bt, bj = pair(params, x, y)
    hold(bt, bj, x)
    free = _port_train(BASE, x, y, ROUNDS, {})
    for t, f in zip(bt._models, free._models):
        assert t.split_feature[0] == f.split_feature[0] != 1
        assert t.threshold_bin[0] == f.threshold_bin[0]
        assert int(t.split_feature[1]) == 2
    assert _first_divergence(bt._models, free._models) is not None


# -- the raw-column witnesses ------------------------------------------
def _dropped_column_data(n=3000, seed=5):
    """Column 0 is constant (dropped by the dataset), so raw column c is
    inner feature c - 1; the label follows columns 1 and 2."""
    g = np.random.default_rng(seed)
    x = g.normal(size=(n, 6)).astype(np.float32)
    x[:, 0] = 1.0
    y = (x[:, 1] + 0.8 * x[:, 1] * x[:, 2] + 0.5 * x[:, 3]
         + 0.3 * g.normal(size=n) > 0).astype(np.float32)
    return x, y


def test_interaction_sets_follow_raw_columns_past_a_dropped_one():
    """The port allows raw columns {1, 2} and {3, 4, 5} and no path of
    its model mixes them; the JAX package reads the sets by inner
    feature (raw {2, 3} and {4, 5}), so its paths leave the raw sets
    (ROADMAP C)."""
    x, y = _dropped_column_data()
    sets = [[1, 2], [3, 4, 5]]
    params = dict(BASE, interaction_constraints=json.dumps(sets))
    bt = _port_train(params, x, y, ROUNDS, {})
    assert bt._inner.train_set.used_feature_map.tolist() == [1, 2, 3, 4, 5]
    assert bt._inner.grow._ic.tolist() == [[1, 1, 0, 0, 0], [0, 0, 1, 1, 1]]
    assert interaction_violations(bt._models, sets) == 0
    bj = _jax_train(params, x, y, ROUNDS, route=ROW_ORDER_ROUTE)[0]
    assert interaction_violations(bj._models, sets) > 0


def test_forced_feature_follows_raw_columns_past_a_dropped_one(tmp_path):
    """A forced node on raw column 2 splits raw column 2 in the port and
    raw column 3 (inner feature 2) in the JAX package (ROADMAP C); a
    node on the dropped column is skipped with its subtree."""
    x, y = _dropped_column_data()
    tree = {"feature": 2, "threshold": 0.1,
            "left": {"feature": 0, "threshold": 1.0,
                     "left": {"feature": 3, "threshold": 0.0}},
            "right": {"feature": 1, "threshold": -0.2}}
    params = dict(BASE, forcedsplits_filename=forced_file(tmp_path, tree))
    bt = _port_train(params, x, y, ROUNDS, {})
    assert bt._inner.grow._forced == [(0, 1, int(
        bt._inner.train_set.mappers[1].values_to_bins(np.array([0.1]))[0]),
        False), (1, 0, int(bt._inner.train_set.mappers[0].values_to_bins(
            np.array([-0.2]))[0]), False)]
    for t in bt._models:
        assert [int(v) for v in t.split_feature[:2]] == [2, 1]
    bj = _jax_train(params, x, y, ROUNDS, route=ROW_ORDER_ROUTE)[0]
    assert all(int(t.split_feature[0]) == 3 for t in bj._models)
