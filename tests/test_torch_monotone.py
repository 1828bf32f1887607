"""Monotone-constrained training in the port against the JAX package, on
the CPU.

- (a) The port's plain split tail (``apply_find_ref``,
  ``apply_find_pool_ref``; the kernel tail's plain version) against the
  JAX package's ``make_apply_find(..., interpret=True)`` with non-zero
  ``mono_s`` (the basic method, with path smoothing, with
  ``monotone_penalty`` 2.0) on a real split whose winner lies on a
  monotone feature: the winning feature, bin and direction equal, the
  rest of the best rows within 1e-5 relative, the children's bounds in
  ``lstate`` equal.
- (b) ``find_best_split`` with output bounds, depths and signs, the
  sorted-subset candidates included, against the JAX ``find_best_split``.
- (c) Whole training against the JAX package on its row-order route
  (its XLA tail): the basic method, intermediate, ``advanced`` (which
  warns and grows intermediate's trees) and ``monotone_penalty`` 1.0,
  within ``test_training_setting_matches_jax``'s bounds (structure
  equal, leaves within 1.2e-5 of the tree's largest, raw scores within
  3.5e-6).  At ``monotone_penalty`` 2.0 the two packages' f32 hessian
  sums of one 20-row leaf differ by 1.2e-4 (each a few ulps of the
  root's sum off the f64 sum of its rows; a test witnesses it): the
  structure is equal, the leaves within ``test_torch_train.LEAF_RTOL``
  and the raw scores within 3.5e-6 plus the output gap those sums
  imply.
- The signs follow the raw columns past a column the dataset drops.
- (d) Both packages' models are monotone on a grid: raw predictions
  never move against a feature's sign as it sweeps its range.
- (e) The penalty table within 1 ulp of the JAX
  ``monotone_penalty_factor``.
- (f) The routing rule ``tail_mono_intermediate``; the kernel launch
  refused under the intermediate method.

The data is ``test_torch_train``'s parity generator (3,000 x 6, seed
11), 15 leaves, 4 trees; each JAX model is trained once per module.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lightgbm_tpu_torch as lgt
from chip_smoke import compare_trees
from lightgbm_tpu.ops.split import SplitHyperParams as JHP
from lightgbm_tpu.ops.split import find_best_split as jax_find_best_split
from lightgbm_tpu.ops.split import monotone_penalty_factor
from lightgbm_tpu_torch.ops.apply_find import (BB, BDL, BF, SDEP, SMN, SMX,
                                               _scalars,
                                               apply_find_pool,
                                               apply_find_ref, tail_geometry)
from lightgbm_tpu_torch.ops.routing import (RULES, RouteInputs, decide,
                                            enumerate_matrix)
from lightgbm_tpu_torch.ops.split import (SplitHyperParams, find_best_split,
                                          monotone_penalty_table)
from lightgbm_tpu_torch.utils.log import LightGBMError
from test_torch_apply_find import _close, _copy, _jax_tail, _split
from test_torch_train import (LEAF_RTOL, ROW_ORDER_ROUTE, SETTING_LEAF_RTOL,
                              SETTING_RAW_ATOL, _data, _first_divergence,
                              _jax_train, _port_train)

torch.set_num_threads(1)

SIGNS = [1, -1, 0, 1, 0, -1]
ROUNDS = 4
BASE = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
        "monotone_constraints": SIGNS}
# (c): the JAX run each case is held against, and the bounds
SETTINGS = {
    "basic": ({}, "basic", True),
    "intermediate": ({"monotone_constraints_method": "intermediate"},
                     "intermediate", True),
    "advanced": ({"monotone_constraints_method": "advanced"},
                 "intermediate", True),
    "penalty_1": ({"monotone_penalty": 1.0}, "penalty_1", True),
    "penalty_2": ({"monotone_penalty": 2.0}, "penalty_2", False),
}
JAX_RUNS = {"basic": {}, "intermediate": SETTINGS["intermediate"][0],
            "penalty_1": {"monotone_penalty": 1.0},
            "penalty_2": {"monotone_penalty": 2.0}}


@pytest.fixture(scope="module")
def data():
    return _data(3000, 6, 11)


@pytest.fixture(scope="module")
def jax_models(data):
    x, y = data
    return {k: _jax_train(dict(BASE, **kw), x, y, ROUNDS,
                          route=ROW_ORDER_ROUTE)[0]
            for k, kw in JAX_RUNS.items()}


# -- (a) the plain tail against the JAX kernel tail ------------------------
TAIL_MONO = np.array([1, -1, 1, 1, -1, 0], np.int32)   # feature 5 one-hot
TAILS = {"basic": {}, "path_smooth": {"path_smooth": 2.0,
                                      "min_data_in_leaf": 5},
         "penalty_2": {"monotone_penalty": 2.0}}


@pytest.mark.parametrize("name", list(TAILS))
def test_plain_tail_matches_jax_constrained_tail(name):
    kw = dict(TAILS[name])
    smooth = kw.get("path_smooth", 0.0) > 0
    hp_t = SplitHyperParams(use_smoothing=smooth, use_monotone=True, **kw)
    hp_j = JHP(use_smoothing=smooth, use_monotone=True, **kw)
    # the root's split found without the penalty (at depth 0 it would
    # scale the monotone features' gains to the 1e-15 floor), so its
    # winner lies on a monotone feature and the children's bounds are
    # pinned to its midpoint; the split then taken as at depth 2, where
    # the children's factor is 0.75
    grower, st, pair, nleft, fmask, at = _split(
        hp_t._replace(monotone_penalty=0.0), monotone=TAIL_MONO)
    st.lstate[at.leaf, SDEP] = 2.0
    grower.finder = grower.finder._replace(penalty=torch.from_numpy(
        monotone_penalty_table(hp_t.monotone_penalty, 16)))
    feat = int(st.best[at.leaf, BF])
    assert TAIL_MONO[feat] != 0
    sp = _copy(st)
    apply_find_pool(pair[0], pair[1], nleft, sp, grower.finder, fmask, hp_t,
                    grower.max_depth, at)
    h2 = torch.stack([sp.pool[at.leaf], sp.pool[at.right]])
    port = _copy(st)
    apply_find_ref(h2, nleft, port, grower.finder, fmask, hp_t,
                   grower.max_depth, at)
    best_j, lstate_j, nodes_j, seg_j = _jax_tail(
        hp_j, grower, st, h2, nleft, fmask, at, mono=TAIL_MONO)
    pinned = 0
    for tgt in (at.leaf, at.right):
        bt, bj = port.best[tgt].numpy(), best_j[tgt]
        np.testing.assert_array_equal(bt[[BF, BB, BDL]], bj[[BF, BB, BDL]])
        assert _close(bt, bj), (bt, bj)
        lt = port.lstate[tgt].numpy()
        np.testing.assert_array_equal(lt[[SMN, SMX]], lstate_j[tgt][[5, 6]])
        assert _close(lt, lstate_j[tgt])
        pinned += int(np.isfinite(lt[[SMN, SMX]]).sum())
        # the winner's outputs lie within the child's bounds
        assert lt[SMN] <= bt[8] <= lt[SMX] and lt[SMN] <= bt[9] <= lt[SMX]
    assert pinned == 2
    # the pool entry wrote the plain entry's rows
    for a, b in zip(sp[1:], port[1:]):
        assert torch.equal(a, b)


def test_done_leaves_a_constrained_state_untouched():
    hp_t = SplitHyperParams(use_monotone=True, monotone_penalty=2.0)
    grower, st, pair, nleft, fmask, at = _split(hp_t, monotone=TAIL_MONO)
    sk = _copy(st)
    apply_find_pool(pair[0], pair[1], nleft, sk, grower.finder, fmask, hp_t,
                    grower.max_depth, at._replace(done=1))
    for a, b in zip(sk, st):
        assert torch.equal(a, b)


# -- (b) find_best_split ----------------------------------------------------
STRENGTH = np.array([1.0, 0.6, 0.3, 0.8, 0.5, 0.5], np.float32)


def _leaves(seed=7, k=4, f=6, b=32):
    """K seeded leaves' histograms: features 0-3 numerical (1 with a NaN
    bin), 4 one-hot categorical (4 bins), 5 categorical over 20 bins
    (the subset search); bin 0 of the categorical features empty; a
    gradient step at the middle bin, of each feature's own strength."""
    g = np.random.default_rng(seed)
    nb = np.array([30, 32, 25, 28, 4, 20], np.int32)
    has_nan = np.array([False, True, False, False, False, False])
    is_cat = np.array([False, False, False, False, True, True])
    hist = np.zeros((k, f, b, 2), np.float32)
    for i in range(k):
        rows = g.integers(5, 60, size=(f, b)).astype(np.float32)
        rows[np.arange(b)[None, :] >= nb[:, None]] = 0
        rows[is_cat, 0] = 0
        # the same rows in every feature: equal sums
        rows *= rows[0].sum() / rows.sum(axis=1, keepdims=True)
        rows = np.floor(rows)
        step = np.where(np.arange(b) < b // 2, -0.3, 0.35)[None, :] * (
            1 if i % 2 else -1)
        hist[i, :, :, 0] = ((g.normal(size=(f, b)) * 0.2 + step) * rows
                            * STRENGTH[:, None])
        hist[i, :, :, 1] = rows * 0.25
    return hist, nb, has_nan, is_cat


def test_find_best_split_matches_jax_with_bounds_and_subsets():
    hist, nb, has_nan, is_cat = _leaves()
    k, f = hist.shape[:2]
    kw = dict(use_monotone=True, monotone_penalty=2.0, use_cat_subset=True,
              max_cat_to_onehot=4, min_data_per_group=5, cat_smooth=1.0,
              min_data_in_leaf=5)
    hp_t, hp_j = SplitHyperParams(**kw), JHP(**kw)
    sign = np.array([1, -1, 0, -1, 0, 1], np.int32)
    mn = np.array([-np.inf, -0.05, 0.0, -np.inf], np.float32)
    mx = np.array([np.inf, 0.05, np.inf, -0.01], np.float32)
    depth = np.array([0.0, 1.0, 2.0, 3.0], np.float32)
    sg = hist[..., 0].sum(axis=2)[:, 0].astype(np.float32)
    sh = hist[..., 1].sum(axis=2)[:, 0].astype(np.float32)
    cnt = np.round(sh * 4).astype(np.float32)
    po = np.clip(-sg / sh, mn, mx).astype(np.float32)
    fmask = np.ones(f, np.float32)
    pen = torch.from_numpy(monotone_penalty_table(2.0, 16))
    t = torch.from_numpy
    si = find_best_split(
        t(hist), t(sg), t(sh), t(cnt), t(nb), t(has_nan), t(is_cat),
        t(fmask), torch.ones(k, dtype=torch.bool), hp_t,
        parent_output=t(po), monotone=t(sign), mn=t(mn), mx=t(mx),
        depth=t(depth), penalty=pen)
    # the JAX search of each leaf (vmapped, as its grower runs it)
    sj = jax.jit(jax.vmap(lambda h, g, s, c, lo, hi, p, d: jax_find_best_split(
        h, g, s, c, jnp.asarray(nb), jnp.asarray(has_nan),
        jnp.asarray(is_cat), jnp.asarray(fmask), jnp.asarray(True), hp_j,
        monotone=jnp.asarray(sign), mn=lo, mx=hi, parent_output=p,
        depth=d)))(*(jnp.asarray(a) for a in (
            hist, sg, sh, cnt, mn, mx, po, depth.astype(np.int32))))
    kinds = set()
    for i in range(k):
        for name in ("feature", "threshold_bin", "default_left",
                     "is_categorical"):
            assert int(getattr(si, name)[i]) == int(getattr(sj, name)[i]), \
                (i, name)
        for name in ("gain", "left_sum_g", "left_sum_h", "left_count",
                     "left_output", "right_output"):
            a, b = float(getattr(si, name)[i]), float(getattr(sj, name)[i])
            assert abs(a - b) <= 1e-5 * max(abs(b), 1e-6), (i, name, a, b)
        lo, ro = float(si.left_output[i]), float(si.right_output[i])
        assert mn[i] <= lo <= mx[i] and mn[i] <= ro <= mx[i]
        feat = int(si.feature[i])
        kinds.add("subset" if int(si.threshold_bin[i]) >= hist.shape[2]
                  else "monotone" if sign[feat] else "free")
    # the winners cover a subset split, a monotone feature (at depth 3,
    # its bounds clipping, the penalty 0.75) and a free feature
    assert kinds == {"subset", "monotone", "free"}


# -- (c) whole training -----------------------------------------------------
@pytest.mark.parametrize("name", list(SETTINGS))
def test_training_matches_jax(name, data, jax_models, capsys):
    extra, jax_key, strict = SETTINGS[name]
    x, y = data
    params = dict(BASE, **extra)
    if name == "advanced":
        params["verbosity"] = 0
    bt = _port_train(params, x, y, ROUNDS, {})
    if name == "advanced":
        assert "advanced not implemented; using 'intermediate'" in \
            capsys.readouterr().err
    route = bt._inner.grow.route.describe()
    assert route == ("path=stream fused=1 tail=xla (tail_mono_intermediate)"
                     if jax_key == "intermediate"
                     else "path=stream fused=1 tail=kernel")
    bj = jax_models[jax_key]
    assert len(bt._models) == len(bj._models) == ROUNDS
    assert _first_divergence(bt._models, bj._models) is None
    res = compare_trees(bt._models, bj._models,
                        rtol=SETTING_LEAF_RTOL if strict else LEAF_RTOL)
    assert res["ok"], res
    np.testing.assert_allclose(
        bt.predict(x, raw_score=True),
        np.asarray(bj.predict(x, raw_score=True)), rtol=0,
        atol=SETTING_RAW_ATOL if strict else _hessian_gap_atol(bt, bj))


def _hessian_gap_atol(bt, bj) -> float:
    """The raw-score bound where tree 0's leaf hessian sums differ
    between the packages: ``SETTING_RAW_ATOL`` plus the largest output
    gap the sums imply (``|v| * |dH| / H``; an output is ``-lr G / H``),
    which the later trees' gradients carry on, each adding at most the
    rate times it."""
    ta, tb = bt._models[0], bj._models[0]
    e0 = float(np.max(np.abs(tb.leaf_value) * np.abs(
        ta.leaf_weight - tb.leaf_weight) / tb.leaf_weight))
    return SETTING_RAW_ATOL + e0 * (1.0 + 0.1) ** (ROUNDS - 1)


def test_penalty_2_leaf_gap_is_hessian_sum_noise(data, jax_models):
    """Why the penalty-2.0 case is held to ``LEAF_RTOL``: its largest
    leaf gap, above 1.2e-5 of the largest leaf, is tree 0's 20-row leaf,
    whose hessian sums differ by more than an ulp of the root's sum.
    Both packages derive that small leaf's sum in f32 from sums near the
    root's (749.76, an ulp 6.1e-5) and land a few of those ulps off the
    f64 sum of its rows, each in its own order.  Scaled by the ratio of
    the two sums, the JAX leaf is within 1.2e-5 of the largest again."""
    x, y = data
    bt = _port_train(dict(BASE, monotone_penalty=2.0), x, y, ROUNDS, {})
    ta, tb = bt._models[0], jax_models["penalty_2"]._models[0]
    gap = np.abs(ta.leaf_value - tb.leaf_value)
    leaf, big = int(np.argmax(gap)), float(np.abs(tb.leaf_value).max())
    assert gap[leaf] > SETTING_LEAF_RTOL * big
    rows = np.asarray(bt.predict(x, pred_leaf=True))[:, 0] == leaf
    assert np.array_equal(rows, np.asarray(jax_models["penalty_2"].predict(
        x, pred_leaf=True))[:, 0] == leaf)
    assert rows.sum() == 20
    # tree 0's row hessians: every score the initial one
    obj = bt._inner.objective
    score = torch.full((len(y),), float(np.float32(
        obj.boost_from_score()[0])), dtype=torch.float32)
    h = obj.get_gradients(score)[1].numpy().astype(np.float64)
    exact, ulp = h[rows].sum(), float(np.spacing(np.float32(h.sum())))
    ht, hj = ta.leaf_weight[leaf], tb.leaf_weight[leaf]
    assert abs(ht - hj) > ulp
    assert abs(ht - exact) <= 4 * ulp and abs(hj - exact) <= 4 * ulp
    scaled = tb.leaf_value[leaf] * hj / ht
    assert abs(ta.leaf_value[leaf] - scaled) <= SETTING_LEAF_RTOL * big


def test_unknown_method_warns_and_grows_basic_trees(data, capsys):
    x, y = data
    bt = _port_train(dict(BASE, verbosity=0,
                          monotone_constraints_method="nearest"),
                     x, y, 2, {})
    assert "monotone_constraints_method=nearest unknown; using 'basic'" in \
        capsys.readouterr().err
    basic = _port_train(BASE, x, y, 2, {})
    assert all(np.array_equal(a.leaf_value, b.leaf_value)
               and np.array_equal(a.threshold, b.threshold)
               for a, b in zip(bt._models, basic._models))


# the routes that grow the default route's trees bit for bit
ROUTES = {"pack2": {"LGBM_TPU_COMB_PACK": "2"},
          "unfused": {"LGBM_TPU_FUSED": "0"},
          "pack2_unfused": {"LGBM_TPU_COMB_PACK": "2", "LGBM_TPU_FUSED": "0"},
          "pool_tail_off": {"LGBM_TPU_POOL_TAIL": "0"},
          "xla_tail": {"LGBM_TPU_APPLY_IMPL": "xla"},
          "slice2": {"LGBM_TPU_STREAM": "0", "LGBM_TPU_FUSED": "0",
                     "LGBM_TPU_APPLY_IMPL": "xla"}}


@pytest.mark.parametrize("route", list(ROUTES))
def test_routes_grow_the_same_monotone_trees(route, data):
    import os

    from conftest import restore_env_knobs, save_env_knobs
    x, y = data
    params = dict(BASE, monotone_penalty=2.0)
    ref = _port_train(params, x, y, 2, {})
    saved = save_env_knobs(tuple(ROUTES[route]))
    os.environ.update(ROUTES[route])
    try:
        bt = lgt.train(params, lgt.Dataset(x, label=y), num_boost_round=2,
                       device="cpu")
    finally:
        restore_env_knobs(saved)
    assert bt._inner.grow.route.describe() != ref._inner.grow.route.describe()
    for a, b in zip(bt._models, ref._models):
        assert a.num_leaves == b.num_leaves
        assert np.array_equal(a.threshold, b.threshold)
        assert np.array_equal(a.leaf_value, b.leaf_value)


# -- (d) monotone on a grid -------------------------------------------------
GRID = np.linspace(-3.0, 3.0, 61, dtype=np.float32)


def _violations(predict, x, signs=SIGNS) -> int:
    """Grid points where a prediction moves against its raw column's
    sign, over 64 rows and each constrained column."""
    rows = np.nan_to_num(x[:64])
    bad = 0
    for j, s in enumerate(signs):
        if s == 0:
            continue
        xs = np.repeat(rows, len(GRID), axis=0)
        xs[:, j] = np.tile(GRID, len(rows))
        p = np.asarray(predict(xs)).reshape(len(rows), len(GRID))
        bad += int((s * np.diff(p, axis=1) < 0).sum())
    return bad


@pytest.mark.parametrize("name", ["basic", "intermediate", "penalty_2"])
def test_predictions_are_monotone_in_both_packages(name, data, jax_models):
    x, y = data
    extra = {"intermediate": SETTINGS["intermediate"][0],
             "penalty_2": {"monotone_penalty": 2.0}}.get(name, {})
    bt = _port_train(dict(BASE, **extra), x, y, ROUNDS, {})
    assert _violations(lambda a: bt.predict(a, raw_score=True), x) == 0
    bj = jax_models[name]
    assert _violations(lambda a: bj.predict(a, raw_score=True), x) == 0
    # unconstrained, the same data moves against the signs
    free = _port_train(dict(BASE, monotone_constraints=[]), x, y, ROUNDS, {})
    assert _violations(lambda a: free.predict(a, raw_score=True), x) > 0


def test_signs_follow_raw_columns_past_a_dropped_one():
    """``monotone_constraints`` holds one sign a raw column.  A constant
    column 0 is dropped from the dataset (``feature_pre_filter``), so
    raw column 1 is inner feature 0: the port constrains column 1, which
    the label falls with, and its model does not fall in it.  The JAX
    package gives inner feature 0 the sign of column 0, so it constrains
    column 2 and leaves column 1 free (ROADMAP C): its model falls."""
    g = np.random.default_rng(5)
    x = g.normal(size=(3000, 5)).astype(np.float32)
    x[:, 0] = 1.0
    y = (-1.5 * x[:, 1] + x[:, 2] + 0.3 * g.normal(size=3000)
         > 0).astype(np.float32)
    signs = [0, 1, 0, 0, 0]
    params = dict(BASE, monotone_constraints=signs)
    bt = _port_train(params, x, y, ROUNDS, {})
    assert bt._inner.train_set.used_feature_map.tolist() == [1, 2, 3, 4]
    assert bt._inner.grow.finder.mono.tolist() == [1, 0, 0, 0]
    assert _violations(lambda a: bt.predict(a, raw_score=True), x,
                       signs) == 0
    bj = _jax_train(params, x, y, ROUNDS, route=ROW_ORDER_ROUTE)[0]
    assert _violations(lambda a: np.asarray(bj.predict(a, raw_score=True)),
                       x, signs) > 0


def test_row_order_route_trains_monotone_trees(data):
    x, y = data
    bt = lgt.train(dict(BASE, max_bin=1023),
                   lgt.Dataset(x, label=y, params={"max_bin": 1023,
                                                   "min_data_in_bin": 1}),
                   num_boost_round=2, device="cpu")
    assert bt._inner.grow.route.describe().startswith(
        "path=row_order fused=0 tail=kernel")
    assert _violations(lambda a: bt.predict(a, raw_score=True), x) == 0


# -- (e) the penalty table --------------------------------------------------
@pytest.mark.parametrize("penalty", [0.5, 1.0, 2.0, 3.7])
def test_penalty_table_within_an_ulp_of_jax(penalty):
    table = monotone_penalty_table(penalty, 256)
    want = np.asarray(monotone_penalty_factor(
        jnp.arange(256, dtype=jnp.int32), penalty), np.float32)
    assert table.dtype == np.float32
    ulps = np.abs(table.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    # the floor at the depths below the penalty, 1 - 2^-d' above
    assert (table[0] == np.float32(1e-15)) == (penalty >= 1.0)
    assert 0.0 < table.min() and table.max() <= 1.0


# -- (f) the route and the kernel's refusal ---------------------------------
def test_intermediate_takes_the_pytorch_tail():
    assert "tail_mono_intermediate" in {r.name for r in RULES}
    d = decide(RouteInputs(mono_intermediate=True))
    assert d.describe() == \
        "path=stream fused=1 tail=xla (tail_mono_intermediate)"
    assert not d.pool_tail
    d = decide(RouteInputs(mono_intermediate=True, bins_u8=False))
    assert d.describe() == ("path=row_order fused=0 tail=xla (non_u8_bins, "
                            "tail_mono_intermediate)")
    cells = enumerate_matrix()["cells"]
    mono_cells = [v for k, v in cells.items() if "mono=1" in k]
    assert mono_cells and all("tail=xla" in v for v in mono_cells)
    assert all("mono=0" in k for k, v in cells.items() if "mono=1" not in k)
    # the basic method keeps the kernel tail
    assert decide(RouteInputs()).tail == "kernel"


def test_kernel_launch_refuses_the_intermediate_method():
    from lightgbm_tpu_torch.ops.apply_find import (SplitAt,
                                                   build_finder_consts)
    fc = build_finder_consts(torch.tensor([4, 4], dtype=torch.int32),
                             torch.zeros(2, dtype=torch.bool),
                             torch.zeros(2, dtype=torch.bool), 8)
    geo = tail_geometry(2, 8)
    hp = SplitHyperParams(use_monotone=True, mono_intermediate=True)
    with pytest.raises(LightGBMError, match="intermediate"):
        _scalars(SplitAt(0, 1, 0, 0, 10), -1, hp, fc, 2, 8, geo)
    args = _scalars(SplitAt(0, 1, 0, 0, 10), -1,
                    hp._replace(mono_intermediate=False,
                                monotone_penalty=2.0), fc, 2, 8, geo)
    assert args[-1] == 1
    assert _scalars(SplitAt(0, 1, 0, 0, 10), -1, SplitHyperParams(), fc,
                    2, 8, geo)[-1] == 0


def test_constraints_raise_naming_the_roadmap(tmp_path):
    """With monotone constraints, the split options slice 22 ported
    (which raised before) train on the PyTorch tail, and linear trees
    (slice 23) on the kernel tail without the stream."""
    x, y = _data(300, 4, 1)
    forced = tmp_path / "forced.json"
    forced.write_text('{"feature": 1, "threshold": 0.0}')
    for extra, rule in (
            ({"interaction_constraints": "[[0, 1]]"}, "tail_interaction"),
            ({"cegb_penalty_split": 0.5}, "tail_cegb"),
            ({"forcedsplits_filename": str(forced)}, "tail_forced")):
        bst = lgt.train(dict(BASE, monotone_constraints=[1, 0, 0, -1],
                             **extra),
                        lgt.Dataset(x, label=y), num_boost_round=1,
                        device="cpu")
        assert bst._inner.grow.route.describe() == (
            f"path=stream fused=1 tail=xla ({rule})")
    bst = lgt.train(dict(BASE, monotone_constraints=[1, 0, 0, -1],
                         linear_tree=True),
                    lgt.Dataset(x, label=y), num_boost_round=1,
                    device="cpu")
    assert bst._inner.grow.route.describe() == (
        "path=physical fused=1 tail=kernel (linear_tree)")
    assert all(t.is_linear for t in bst._models if t.num_leaves > 1)
    # a sign vector shorter than the features pads with zeros
    bst = lgt.train(dict(BASE, monotone_constraints=[1]),
                    lgt.Dataset(x, label=y), num_boost_round=1, device="cpu")
    assert bst._inner.grow.finder.mono.tolist() == [1, 0, 0, 0]
