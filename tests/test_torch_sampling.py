"""Bagging, GOSS and random-forest boosting in the PyTorch port against
the JAX package, on the CPU.

- Draws: ``utils/random.uniform`` equals ``jax.random.uniform`` on the
  same ``PRNGKey`` bit for bit (the partitionable threefry the installed
  JAX uses, which this file checks); the bagging mask (plain, pos/neg,
  the ``bagging_freq`` cache) equals the JAX ``_bagging_mask`` on the
  real rows; GOSS's ``(grad, hess, inbag)`` equals JAX ``GOSS._sample``
  at K = 1 and K = 5 on a row count the JAX package does not pad.
- Training, 15 leaves, 2 to 6 iterations on ``test_torch_train``'s
  parity generator (seed 11, 3,000 x 6; GOSS 3,072 rows, sampling from
  its third iteration at learning rate 0.5), the port on the route it picks
  against the JAX package on its row-order route: trees equal in
  structure, leaves and raw scores held by
  ``test_torch_objectives.hold_trees`` (1.2e-5 of the tree's largest
  leaf, or the root-sum noise rule; raw scores within 3.5e-6 or the
  leaves' implied gap).
- The port's routes (default, pack=2, ``FUSED=0``, 3ph, slice 2's knobs)
  grow the bagged and GOSS trees bit for bit the same.
- Witnesses of two faults of the JAX package the port does not copy
  (ROADMAP C): its RF trees leave the init score out, and its GOSS
  counts the padding rows in ``top_k``.
"""
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from chip_smoke import compare_trees
from conftest import restore_env_knobs, save_env_knobs
from lightgbm_tpu_torch.utils.log import LightGBMError
from lightgbm_tpu_torch.utils.random import prng_key, uniform
from test_torch_objectives import hold_trees
from test_torch_train import (ROW_ORDER_ROUTE, SETTING_LEAF_RTOL, _data,
                              _jax_train, _purge)

torch.set_num_threads(1)

KNOBS = ("LGBM_TPU_PHYS", "LGBM_TPU_STREAM", "LGBM_TPU_FUSED",
         "LGBM_TPU_APPLY_IMPL", "LGBM_TPU_PART", "LGBM_TPU_POOL_TAIL",
         "LGBM_TPU_COMB_PACK")
BASE = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
# a multiple of the JAX package's row padding (512): its GOSS then
# counts the same rows as the port's
GOSS_ROWS = 3072


def _env(env):
    saved = save_env_knobs(KNOBS)
    for k in KNOBS:
        os.environ.pop(k, None)
    os.environ.update(env)
    return saved


def _port(params, x, y, rounds, env=None):
    saved = _env(env or {})
    try:
        return lgt.train(params, lgt.Dataset(x, label=y),
                         num_boost_round=rounds, device="cpu")
    finally:
        restore_env_knobs(saved)


def _jax_booster(params, x, y):
    """An untrained JAX booster on its row-order route (its sampling
    hooks read nothing the route changes)."""
    saved = _env(ROW_ORDER_ROUTE)
    try:
        _purge()
        import lightgbm_tpu as lgb
        return lgb.Booster(params, lgb.Dataset(x, label=y))._inner
    finally:
        restore_env_knobs(saved)
        _purge()


# ---------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------
def test_jax_threefry_is_partitionable():
    """The port draws row ``i`` from the key and ``i`` alone; a JAX that
    stopped doing so would draw other masks."""
    import jax
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed,n", [
    (0, 1), (3, 7), (1520856339, 1000), (1520856339, 1536),
    (0x7FFFFFFF, 4099), (12345, 3000), (2654435761 & 0x7FFFFFFF, 65537),
])
def test_uniform_matches_jax(seed, n):
    import jax
    key = jax.random.PRNGKey(seed)
    assert tuple(int(w) for w in np.asarray(key)) == prng_key(seed)
    want = np.asarray(jax.random.uniform(key, (n,)))
    got = uniform(prng_key(seed), n, "cpu").numpy()
    assert got.dtype == np.float32
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("extra,iters", [
    ({"bagging_fraction": 0.8, "bagging_freq": 1}, range(4)),
    ({"pos_bagging_fraction": 0.5, "neg_bagging_fraction": 0.9,
      "bagging_freq": 1, "bagging_seed": 7}, range(3)),
    ({"pos_bagging_fraction": 0.3, "bagging_freq": 2}, range(5)),
    ({"bagging_fraction": 0.6, "bagging_freq": 3, "bagging_seed": 11},
     range(8)),
], ids=["plain", "pos_neg", "pos_only_freq2", "freq3_cache"])
def test_bagging_mask_matches_jax(extra, iters):
    """Called at successive iterations, as training does, so the cache
    between draws is held too."""
    x, y = _data(3000, 6, 11)
    params = dict(BASE, **extra)
    j = _jax_booster(params, x, y)
    t = lgt.Booster(params, lgt.Dataset(x, label=y), device="cpu")._inner
    for it in iters:
        mj = np.asarray(j._bagging_mask(it))
        mt = t._bagging_mask(it).numpy()
        assert mt.shape == (3000,)
        assert mt.tobytes() == mj[:3000].tobytes(), it
    assert 0.2 < mt.mean() < 0.95


@pytest.fixture(scope="module")
def goss_pair():
    x, y = _data(GOSS_ROWS, 6, 11)
    params = dict(BASE, boosting="goss", top_rate=0.2, other_rate=0.1,
                  learning_rate=0.5)
    j = _jax_booster(params, x, y)
    t = lgt.Booster(params, lgt.Dataset(x, label=y), device="cpu")._inner
    assert j._n_rows_host == GOSS_ROWS
    return j, t


@pytest.mark.parametrize("k,it", [(1, 0), (1, 2), (5, 3)])
def test_goss_sample_matches_jax(goss_pair, k, it):
    """``(grad, hess, inbag)`` bit for bit: inside the warm-up
    (iteration 0 at learning rate 0.5) and sampling at K = 1 and K = 5,
    where the magnitude is an f32 sum over the classes; magnitudes
    repeat, so rows tie at the threshold."""
    import jax.numpy as jnp
    j, t = goss_pair
    rng = np.random.default_rng(40 + k)
    g = rng.normal(size=(k, GOSS_ROWS)).astype(np.float32)
    h = rng.uniform(0.05, 0.3, size=(k, GOSS_ROWS)).astype(np.float32)
    g[:, ::7] = g[:, :1]
    h[:, ::7] = h[:, :1]
    out_j = j._sample(jnp.asarray(g), jnp.asarray(h), it)
    out_t = t._sample(torch.from_numpy(g), torch.from_numpy(h), it)
    for a, b in zip(out_t, out_j):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    inbag = out_t[2].numpy()
    if it >= 2:
        top_k = int(GOSS_ROWS * 0.2)
        assert top_k < inbag.sum() < top_k + 0.2 * GOSS_ROWS
    else:
        assert inbag.min() == 1.0


# ---------------------------------------------------------------------
# training against the JAX package
# ---------------------------------------------------------------------
BAG_ROUTE = "path=physical fused=1 tail=kernel (bagging_on)"
# (extra params, objective, rows, rounds, the port's route)
TRAIN = {
    "bagging_binary": ({"bagging_fraction": 0.8, "bagging_freq": 1},
                       "binary", 3000, 2, BAG_ROUTE),
    "pos_neg_bagging": ({"pos_bagging_fraction": 0.5,
                         "neg_bagging_fraction": 0.7, "bagging_freq": 1},
                        "binary", 3000, 2, BAG_ROUTE),
    "bagging_freq_5": ({"bagging_fraction": 0.6, "bagging_freq": 5},
                       "binary", 3000, 6, BAG_ROUTE),
    "bagging_softmax": ({"bagging_fraction": 0.7, "bagging_freq": 1,
                         "objective": "multiclass", "num_class": 3},
                        "multiclass", 3000, 2,
                        "path=physical fused=1 tail=kernel "
                        "(objective_not_streamable, multi_tree_iter, "
                        "bagging_on)"),
    "bagging_l1": ({"bagging_fraction": 0.7, "bagging_freq": 1,
                    "objective": "regression_l1"}, "regression", 3000, 2,
                   "path=physical fused=1 tail=kernel "
                   "(objective_not_streamable, bagging_on)"),
    "goss_binary": ({"boosting": "goss", "learning_rate": 0.5}, "binary",
                    GOSS_ROWS, 3,
                    "path=physical fused=1 tail=kernel (boosting_not_gbdt)"),
    "goss_softmax": ({"boosting": "goss", "learning_rate": 0.5,
                      "objective": "multiclass", "num_class": 3},
                     "multiclass", GOSS_ROWS, 3,
                     "path=physical fused=1 tail=kernel "
                     "(objective_not_streamable, boosting_not_gbdt, "
                     "multi_tree_iter)"),
    "rf_binary": ({"boosting": "rf", "bagging_fraction": 0.7,
                   "bagging_freq": 1, "boost_from_average": False},
                  "binary", 3000, 3,
                  "path=physical fused=1 tail=kernel "
                  "(boosting_not_gbdt, bagging_on)"),
}


def _labels(objective, x, y):
    if objective == "multiclass":
        v = np.nan_to_num(x[:, 0]) + 0.5 * np.nan_to_num(x[:, 1])
        return np.digitize(v, [-0.4, 0.5]).astype(np.float32)
    return y


@pytest.mark.parametrize("name", list(TRAIN))
def test_training_matches_jax(name):
    extra, objective, n, rounds, route = TRAIN[name]
    x, y = _data(n, 6, 11, "binary" if objective == "multiclass"
                 else objective)
    y = _labels(objective, x, y)
    params = dict(BASE, **extra)
    bj, _, _ = _jax_train(params, x, y, rounds, route=ROW_ORDER_ROUTE)
    bt = _port(params, x, y, rounds)
    assert bt._inner.grow.route.describe() == route
    k = bt._inner.num_tree_per_iteration
    assert len(bt._models) == len(bj._models) == rounds * k
    assert all(t.num_leaves > 1 for t in bt._models)
    hold_trees(bt, bj, x, rate=bt._inner.shrinkage_rate)
    if extra.get("boosting") == "rf":
        assert bt._inner.average_output and bj._inner.average_output
        np.testing.assert_allclose(bt.predict(x), np.asarray(bj.predict(x)),
                                   rtol=0, atol=1e-6)


# the port's routes over the bagged and the GOSS configurations: each
# grows the default's trees bit for bit but 3ph, whose right children add
# their rows in ascending order (tests/test_torch_part3ph.py): equal
# structure, leaves within f32 noise
ROUTES = {
    "pack2": {"LGBM_TPU_COMB_PACK": "2"},
    "unfused": {"LGBM_TPU_FUSED": "0"},
    "pack2_unfused": {"LGBM_TPU_COMB_PACK": "2", "LGBM_TPU_FUSED": "0"},
    "3ph": {"LGBM_TPU_PART": "3ph"},
    "slice2": {"LGBM_TPU_STREAM": "0", "LGBM_TPU_FUSED": "0",
               "LGBM_TPU_APPLY_IMPL": "xla"},
    "pool_tail_off": {"LGBM_TPU_POOL_TAIL": "0"},
}


@pytest.fixture(scope="module", params=["bagging_binary", "goss_binary"])
def route_base(request):
    extra, objective, n, rounds, _ = TRAIN[request.param]
    x, y = _data(n, 6, 11, objective)
    params = dict(BASE, **extra)
    return params, x, y, rounds, _port(params, x, y, rounds)


@pytest.mark.parametrize("route", list(ROUTES))
def test_routes_grow_the_same_trees(route_base, route):
    params, x, y, rounds, a = route_base
    b = _port(params, x, y, rounds, ROUTES[route])
    assert b._inner.grow.route.describe() != a._inner.grow.route.describe()
    assert len(a._models) == len(b._models) == rounds
    if route == "3ph":
        res = compare_trees(b._models, a._models, rtol=SETTING_LEAF_RTOL)
        assert res["ok"], res
        return
    for ta, tb in zip(a._models, b._models):
        assert ta.num_leaves == tb.num_leaves > 1
        for f in ("split_feature", "threshold_bin", "decision_type",
                  "left_child", "right_child", "leaf_value", "leaf_count",
                  "leaf_weight"):
            assert getattr(ta, f).tobytes() == getattr(tb, f).tobytes(), f
    assert torch.equal(a._inner.train_score, b._inner.train_score)


def test_row_order_route_grows_the_bagged_trees():
    """``max_bin`` 1023 (u16 bins) takes the row-order route; its bagged
    trees hold the JAX package's row-order trees."""
    extra = dict(TRAIN["bagging_binary"][0], max_bin=1023,
                 min_data_in_bin=1)
    x, y = _data(3000, 6, 11)
    params = dict(BASE, **extra)
    bj, _, _ = _jax_train(params, x, y, 2, route=ROW_ORDER_ROUTE)
    bt = _port(params, x, y, 2)
    assert bt._inner.grow.route.describe().startswith("path=row_order")
    hold_trees(bt, bj, x)


# ---------------------------------------------------------------------
# the booster around the sample
# ---------------------------------------------------------------------
def test_rf_eval_averages_what_predict_averages():
    """RF's training and validation scores hold the per-tree outputs
    ``predict`` averages (the init score included): ``eval``'s metric is
    the metric of ``predict``'s output."""
    x, y = _data(3000, 6, 12)
    xv, yv = _data(1000, 6, 13)
    params = dict(BASE, boosting="rf", bagging_fraction=0.7,
                  bagging_freq=1, metric=["binary_logloss", "auc"])
    ds = lgt.Dataset(x, label=y)
    ev = {}
    bst = lgt.train(params, ds, num_boost_round=4,
                    valid_sets=[lgt.Dataset(xv, label=yv, reference=ds)],
                    valid_names=["v"], callbacks=[lgt.record_evaluation(ev)],
                    device="cpu")
    p = np.clip(bst.predict(xv).astype(np.float64), 1e-15, 1 - 1e-15)
    logloss = -np.mean(yv * np.log(p) + (1 - yv) * np.log(1 - p))
    assert abs(ev["v"]["binary_logloss"][-1] - logloss) < 1e-6
    raw = bst.predict(xv, raw_score=True)
    vs = bst._inner.valid_sets[0]
    np.testing.assert_allclose(vs.score.numpy() / 4, raw, rtol=0, atol=1e-6)
    assert "average_output" in bst.model_to_string().splitlines()


@pytest.mark.parametrize("params,reasons", [
    ({"pos_bagging_fraction": 0.5, "bagging_freq": 1}, ["bagging_on"]),
    ({"boosting": "random_forest", "bagging_fraction": 0.7,
      "bagging_freq": 1}, ["boosting_not_gbdt", "bagging_on"]),
    ({"boosting": "goss"}, ["boosting_not_gbdt"]),
], ids=["pos_only", "random_forest", "goss"])
def test_sampling_takes_the_stream_away(params, reasons):
    """A mask cannot ride the stream route: the positive fraction alone
    counts as bagging, and ``random_forest`` routes as ``rf``."""
    x, y = _data(600, 4, 2)
    bst = lgt.Booster(dict(BASE, **params), lgt.Dataset(x, label=y),
                      device="cpu")
    route = bst._inner.grow.route
    assert not route.stream and route.physical
    assert list(route.reasons) == reasons


def test_create_boosting_names():
    x, y = _data(600, 4, 2)
    kinds = {}
    for name in ("gbdt", "gbrt", "GOSS", "rf", "random_forest", "dart"):
        p = dict(BASE, boosting=name, bagging_fraction=0.7, bagging_freq=1)
        kinds[name] = type(lgt.Booster(p, lgt.Dataset(x, label=y),
                                       device="cpu")._inner).__name__
    assert kinds == {"gbdt": "GBDT", "gbrt": "GBDT", "GOSS": "GOSS",
                     "rf": "RF", "random_forest": "RF", "dart": "DART"}
    with pytest.raises(LightGBMError, match="Unknown boosting"):
        lgt.Booster(dict(BASE, boosting="bogus"), lgt.Dataset(x, label=y),
                    device="cpu")


# ---------------------------------------------------------------------
# witnesses of the JAX package's faults (ROADMAP C)
# ---------------------------------------------------------------------
def _rare_positive(n, seed):
    """Labels drawn at probability ``sigmoid(-2 + x0 / 2 + x1 x2 / 4)``:
    a label mean near 0.13, so a large negative init score."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(2.0 - 0.5 * x[:, 0] - 0.25 * x[:, 1] * x[:, 2]))
    return x, (rng.random(n) < p).astype(np.float32)


def test_rf_carries_the_init_score():
    """LightGBM's RF adds the init score to every tree (rf.hpp
    ``AddBias``); the JAX package grows at the init score but leaves it
    out of its trees, so its forest predicts near 0.5 on a rare label.
    The port's trees are the JAX package's plus the init score."""
    x, y = _rare_positive(3000, 17)
    params = dict(BASE, boosting="rf", bagging_fraction=0.7,
                  bagging_freq=1)
    bj, _, _ = _jax_train(params, x, y, 5, route=ROW_ORDER_ROUTE)
    bt = _port(params, x, y, 5)
    init = bt._inner.objective.boost_from_score()[0]
    assert init < -1.5
    assert abs(bt.predict(x).mean() - y.mean()) < 0.05
    assert abs(np.asarray(bj.predict(x)).mean() - y.mean()) > 0.2
    unbiased = []
    for t in bt._models:
        u = type(t).__new__(type(t))
        u.__dict__.update(t.__dict__)
        u.leaf_value = t.leaf_value - init
        unbiased.append(u)
    res = compare_trees(unbiased, bj._models, rtol=SETTING_LEAF_RTOL)
    assert res["ok"], res


def test_goss_top_count_excludes_padding():
    """At 3,000 rows the JAX package pads to 3,072 and keeps
    ``int(3072 * 0.2)`` = 614 top rows; the port keeps ``int(3000 *
    0.2)`` = 600, as LightGBM does.  The top sets differ only by the
    rows between the two thresholds."""
    import jax.numpy as jnp
    n, top = 3000, 0.2
    x, y = _data(n, 6, 11)
    params = dict(BASE, boosting="goss", top_rate=top, learning_rate=0.5)
    j = _jax_booster(params, x, y)
    t = lgt.Booster(params, lgt.Dataset(x, label=y), device="cpu")._inner
    npad = j._n_rows_host
    assert npad == 3072
    rng = np.random.default_rng(5)
    g = rng.normal(size=(1, n)).astype(np.float32)
    h = rng.uniform(0.05, 0.3, size=(1, n)).astype(np.float32)
    pad = ((0, 0), (0, npad - n))
    gj, hj, bj = j._sample(jnp.asarray(np.pad(g, pad)),
                           jnp.asarray(np.pad(h, pad)), 2)
    gt, ht, bt = t._sample(torch.from_numpy(g), torch.from_numpy(h), 2)
    # a top row keeps its hessian; a sampled small row's is amplified
    top_j = (np.asarray(bj)[:n] > 0) & (np.asarray(hj)[0, :n] == h[0])
    top_t = (bt.numpy() > 0) & (ht.numpy()[0] == h[0])
    assert top_j.sum() == int(npad * top) == 614
    assert top_t.sum() == int(n * top) == 600
    assert not (top_t & ~top_j).any()
    mag = np.abs(g[0] * h[0])
    extra = mag[top_j & ~top_t]
    assert extra.max() < mag[top_t].min()
    assert extra.min() >= np.sort(mag)[n - 614]
