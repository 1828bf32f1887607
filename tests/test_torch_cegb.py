"""CEGB (cost-effective gradient boosting: the split penalty, coupled and
lazy feature costs, the tradeoff) in the PyTorch port, against the JAX
package on the CPU, and the split options under every ported boosting.

As in ``tests/test_torch_split_options.py``: the port on the route it
picks (``tail=xla (tail_cegb)``; lazy costs take the row-order path,
rule ``cegb_lazy``), the JAX package on its row-order route, trees equal
in structure, leaves within ``SETTING_LEAF_RTOL`` of the tree's largest,
raw scores within ``SETTING_RAW_ATOL``.  Lazy CEGB's paid mask (``[F,
n]``, kept across trees) equals the JAX package's after 3 trees, with
bagging choosing the rows that pay.  The cost lists are read by raw
column (witnessed past a dropped column; the JAX package reads them by
inner feature, ROADMAP C).
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.models.constraints import (build_grow_constraints,
                                                   cegb_enabled)
from lightgbm_tpu_torch.config import Config
from test_torch_split_combos import _dropped_column_data
from test_torch_split_options import BASE, ROUNDS, forced_file, hold, pair
from test_torch_train import (ROW_ORDER_ROUTE, _data, _jax_train,
                              _port_train)

torch.set_num_threads(1)

CEGB_XLA = "path=stream fused=1 tail=xla (tail_cegb)"
LAZY_ROUTE = "path=row_order fused=0 tail=xla (cegb_lazy, tail_cegb)"
COSTS = [0.02, 0.005, 0.0, 0.05, 0.0, 0.01]

CASES = {
    "split": ({"cegb_penalty_split": 0.002}, CEGB_XLA),
    "coupled": ({"cegb_penalty_feature_coupled": [30, 0, 5, 60, 0, 10]},
                CEGB_XLA),
    "coupled_tradeoff": ({"cegb_penalty_feature_coupled": [30, 0, 5, 60, 0,
                                                           10],
                          "cegb_penalty_split": 0.001,
                          "cegb_tradeoff": 0.7}, CEGB_XLA),
    "lazy": ({"cegb_penalty_feature_lazy": COSTS}, LAZY_ROUTE),
    "lazy_coupled": ({"cegb_penalty_feature_lazy": COSTS,
                      "cegb_penalty_feature_coupled": [0, 20, 0, 0, 40, 0]},
                     LAZY_ROUTE),
}


@pytest.mark.parametrize("name", list(CASES))
def test_cegb_matches_jax(name):
    extra, route = CASES[name]
    x, y = _data(3000, 6, 11)
    bt, bj = pair(dict(BASE, **extra), x, y)
    assert bt._inner.grow.route.describe() == route
    assert all(t.num_leaves > 1 for t in bt._models)
    hold(bt, bj, x)
    free = _port_train(BASE, x, y, ROUNDS, {})
    assert any(a.split_feature.tolist() != b.split_feature.tolist()
               for a, b in zip(bt._models, free._models))


def test_lazy_with_bagging_and_its_paid_mask_after_three_trees():
    """The in-bag rows of a split pay for its feature; the mask carries
    from tree to tree (and is the JAX package's after 3 trees)."""
    x, y = _data(3000, 6, 11)
    params = dict(BASE, cegb_penalty_feature_lazy=COSTS,
                  bagging_fraction=0.7, bagging_freq=1)
    bt, bj = pair(params, x, y)
    assert bt._inner.grow.route.describe() == (
        "path=row_order fused=0 tail=xla (cegb_lazy, tail_cegb)")
    hold(bt, bj, x)
    paid = bt._inner._cegb_paid
    assert paid.dtype == torch.bool and tuple(paid.shape) == (6, 3000)
    want = np.asarray(bj._inner._cegb_paid)[:6, :3000]
    np.testing.assert_array_equal(paid.numpy(), want)
    # rows out of every bag never pay; some rows paid for every feature
    assert 0 < int(paid.sum()) < paid.numel()


def test_cegb_switch_and_tradeoff_alone():
    """``cegb_tradeoff < 1`` alone turns CEGB on (IsEnable) with no
    penalty to pay: the PyTorch tail grows the kernel tail's trees."""
    assert not cegb_enabled(Config.from_params({}))
    assert cegb_enabled(Config.from_params({"cegb_tradeoff": 0.5}))
    x, y = _data(2000, 6, 11)
    a = _port_train(dict(BASE, cegb_tradeoff=0.5), x, y, 2, {})
    b = _port_train(BASE, x, y, 2, {})
    assert a._inner.grow.route.describe() == CEGB_XLA
    assert b._inner.grow.route.describe() == "path=stream fused=1 " \
        "tail=kernel"
    for ta, tb in zip(a._models, b._models):
        assert ta.leaf_value.tobytes() == tb.leaf_value.tobytes()


def test_lazy_costs_are_ignored_under_the_intermediate_method():
    x, y = _data(2000, 6, 11)
    params = dict(BASE, cegb_penalty_feature_lazy=COSTS,
                  monotone_constraints=[1, 0, 0, 0, 0, 0],
                  monotone_constraints_method="intermediate")
    bt = _port_train(params, x, y, 2, {})
    assert bt._inner.grow_options.cegb_lazy is None
    assert bt._inner._cegb_paid is None
    assert bt._inner.grow.route.describe() == (
        "path=stream fused=1 tail=xla (tail_mono_intermediate, tail_cegb)")


def test_cost_lists_follow_raw_columns_past_a_dropped_one():
    """Coupled and lazy costs on raw column 1 keep the port off column 1
    (the label's strongest); the JAX package puts them on inner feature
    1, raw column 2, and splits on column 1 (ROADMAP C)."""
    x, y = _dropped_column_data()
    for key in ("cegb_penalty_feature_coupled", "cegb_penalty_feature_lazy"):
        costs = [0.0, 1e6, 0.0, 0.0, 0.0, 0.0]
        params = dict(BASE, **{key: costs})
        bt = _port_train(params, x, y, 2, {})
        cfg = Config.from_params(params)
        opts = build_grow_constraints(cfg, bt._inner.train_set)[2]
        got = opts.cegb_coupled if "coupled" in key else opts.cegb_lazy
        assert got.tolist() == [1e6, 0.0, 0.0, 0.0, 0.0]
        assert all(1 not in t.split_feature.tolist() for t in bt._models)
        bj = _jax_train(params, x, y, 2, route=ROW_ORDER_ROUTE)[0]
        assert any(1 in t.split_feature.tolist() for t in bj._models)


# -- every ported boosting takes the options -------------------------------
OPTIONS = {"interaction_constraints": "[[0, 1, 2], [2, 3, 4, 5]]",
           "cegb_penalty_feature_coupled": [0, 5, 0, 5, 0, 0],
           "feature_fraction_bynode": 0.8, "extra_trees": True}
BOOSTINGS = {
    "dart": ({"boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0},
             "boosting_not_gbdt"),
    "goss": ({"boosting": "goss", "learning_rate": 0.5},
             "boosting_not_gbdt"),
    "rf": ({"boosting": "rf", "bagging_fraction": 0.7, "bagging_freq": 1},
           "boosting_not_gbdt, bagging_on"),
}


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("boosting", list(BOOSTINGS))
def test_every_boosting_trains_the_options(boosting, lazy, tmp_path):
    extra, why = BOOSTINGS[boosting]
    x, y = _data(1500, 6, 14)
    params = dict(BASE, **extra, **OPTIONS, forcedsplits_filename=forced_file(
        tmp_path, {"feature": 0, "threshold": 0.0}))
    tails = ("tail_interaction, tail_cegb, tail_forced, tail_bynode, "
             "tail_extra_trees")
    if lazy:
        params["cegb_penalty_feature_lazy"] = [0.0, 0.01, 0.0, 0.0, 0.0,
                                               0.02]
        want = f"path=row_order fused=0 tail=xla (cegb_lazy, {tails})"
    else:
        want = f"path=physical fused=1 tail=xla ({why}, {tails})"
    bt = _port_train(params, x, y, 3, {})
    assert bt._inner.grow.route.describe() == want
    assert len(bt._models) == 3
    assert all(int(t.split_feature[0]) == 0 for t in bt._models)
    raw = bt.predict(x, raw_score=True)
    assert np.all(np.isfinite(raw))
