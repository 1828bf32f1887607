"""Linear trees, continued training (``init_model``) and
``rollback_one_iter`` in the PyTorch port, against the JAX package on the
CPU.

The same seeded numpy rows go to both packages; the port takes the JAX
dataset's bins and raw values (``convert.dataset_from_numpy``), so both
grow from identical bins.  The JAX package trains on its row-order route
(``LGBM_TPU_STREAM=0 LGBM_TPU_FUSED=0``, its modules purged around each
run).

Tolerances: tree structure (split features, threshold bins, decision
types, leaf counts) and each leaf's model features are equal; leaf values
agree within ``LEAF_RTOL`` of the tree's largest leaf, as in
``test_torch_train.py``.  The leaf models' constants and coefficients
agree within ``LINEAR_TOL`` times max(1, the tree's largest): the JAX
package accumulates the moments and solves in f32, the port in f64 (as
LightGBM does; ROADMAP C), and a few thousand rows' f32 sums carry
~1e-5 of relative noise into the solution (3e-5 seen).  Training scores
after ``init_model`` and ``rollback_one_iter`` agree within
``SCORE_ATOL`` (f32 sums in other orders over a few trees).  The linear
moments' plain version agrees with a direct f64 numpy sum within 1e-12
relative (another order of the same f64 additions).
"""
import functools

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from chip_smoke import compare_trees
from lightgbm_tpu_torch.convert import dataset_from_numpy
from lightgbm_tpu_torch.models.linear import (leaf_path_features,
                                              solve_leaves)
from lightgbm_tpu_torch.ops.linear_kernel import (linear_moments,
                                                  linear_moments_ref,
                                                  moment_layout)
from lightgbm_tpu_torch.utils.log import LightGBMError
from test_torch_train import ROW_ORDER_ROUTE, _jax_train

torch.set_num_threads(1)

LEAF_RTOL = 1e-4
LINEAR_TOL = 5e-4
SCORE_ATOL = 1e-5
BASE = {"objective": "regression", "num_leaves": 15, "min_data_in_leaf": 20,
        "learning_rate": 0.5, "verbosity": -1, "linear_tree": True}


def _problem(n=2000, f=5, seed=2, nan_frac=0.05):
    """Piecewise-linear target: a stump and linear leaves fit it; NaN in
    a share of the values."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, size=(n, f)).astype(np.float32)
    x[rng.random(x.shape) < nan_frac] = np.nan
    z = np.nan_to_num(x)
    y = (np.where(z[:, 0] > 0, 2.0 * z[:, 1] + 1.0, -1.5 * z[:, 2] - 0.5)
         + 0.1 * rng.normal(size=n))
    return x, y.astype(np.float32)


def _port_ds(binned, label=None):
    return dataset_from_numpy(
        [m.to_dict() for m in binned.mappers], binned.bin_matrix,
        binned.metadata.label if label is None else label,
        used_feature_map=binned.used_feature_map,
        num_total_features=binned.num_total_features,
        raw_matrix=binned.raw_matrix)


def _hold_linear(models_t, models_j):
    res = compare_trees(models_t, models_j, rtol=LEAF_RTOL)
    assert res["ok"], res
    for a, b in zip(models_t, models_j):
        assert a.is_linear == b.is_linear
        if not a.is_linear:
            continue
        scale = max(1.0, float(np.abs(b.leaf_const).max()))
        np.testing.assert_allclose(a.leaf_const, b.leaf_const,
                                   atol=LINEAR_TOL * scale, rtol=0)
        for fa, fb, ca, cb in zip(a.leaf_features, b.leaf_features,
                                  a.leaf_coeff, b.leaf_coeff):
            np.testing.assert_array_equal(fa, fb)
            np.testing.assert_allclose(ca, cb, atol=LINEAR_TOL * scale,
                                       rtol=0)


CASES = {
    "lambda_0": dict(params={}, n=2000),
    "lambda_0.1": dict(params={"linear_lambda": 0.1}, n=2000),
    "multiclass": dict(params={"objective": "multiclass", "num_class": 3,
                               "num_leaves": 7, "learning_rate": 0.3},
                       n=1500, label="class"),
    "bagging": dict(params={"bagging_fraction": 0.8, "bagging_freq": 1,
                            "linear_lambda": 0.05}, n=2000),
    "categorical_on_path": dict(params={"max_cat_to_onehot": 8}, n=2000,
                                cat=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_linear_trees_match_jax(name):
    case = CASES[name]
    x, y = _problem(case["n"])
    if case.get("label") == "class":
        y = np.digitize(y, np.quantile(y, [1 / 3, 2 / 3])).astype(np.float32)
    cat = None
    if case.get("cat"):
        x[:, 4] = np.arange(len(x)) % 5
        cat = [4]
    params = dict(BASE, **case["params"])
    bj, binned, _ = _jax_train(params, x, y, 3, ds_params=params, cat=cat,
                               route=ROW_ORDER_ROUTE)
    bt = lgt.train(params, _port_ds(binned), 3, device="cpu")
    assert bt._inner.route.describe().endswith("(linear_tree)") or \
        "linear_tree" in bt._inner.route.reasons
    assert any(t.is_linear for t in bt._models)
    _hold_linear(bt._models, bj._models)
    np.testing.assert_allclose(bt.predict(x, raw_score=True),
                               bj.predict(x, raw_score=True), atol=2e-4)


def test_linear_trees_beat_constant_leaves():
    x, y = _problem(800, 4, nan_frac=0.0)
    p = dict(BASE, num_leaves=4)
    bst = lgt.train(p, lgt.Dataset(x, label=y), 20, device="cpu")
    mse_lin = float(np.mean((bst.predict(x) - y) ** 2))
    const = lgt.train(dict(p, linear_tree=False), lgt.Dataset(x, label=y),
                      20, device="cpu")
    mse_const = float(np.mean((const.predict(x) - y) ** 2))
    assert mse_lin < 0.5 * mse_const, (mse_lin, mse_const)


def test_linear_model_text_round_trip(tmp_path):
    """Saved and loaded, a linear model predicts the trained booster's
    bits, and ``Booster.predict`` agrees with the f64 host walk."""
    x, y = _problem()
    bst = lgt.train(BASE, lgt.Dataset(x, label=y), 4, device="cpu")
    path = tmp_path / "linear.txt"
    bst.save_model(str(path))
    text = path.read_text()
    assert "is_linear=1" in text and "leaf_coeff=" in text
    again = lgt.Booster(model_file=str(path), device="cpu")
    p1, p2 = bst.predict(x), again.predict(x)
    assert p1.tobytes() == p2.tobytes()
    # the trees' text (a loaded model writes no training parameters)
    tree_part = lambda t: t.split("end of trees")[0]  # noqa: E731
    assert tree_part(again.model_to_string()) == tree_part(text)
    host = sum(t.predict(x.astype(np.float64)) for t in bst._models)
    np.testing.assert_allclose(p1, host, rtol=1e-12, atol=1e-12)


def test_nan_rows_keep_the_leaf_value():
    """A row with NaN in a leaf's model feature takes the leaf's constant
    value, on the device and in the host walk."""
    x, y = _problem()
    bst = lgt.train(BASE, lgt.Dataset(x, label=y), 3, device="cpu")
    t = bst._models[0]
    leaf = t.predict_leaf(x)
    found = None
    for lf in range(t.num_leaves):
        for f in t.leaf_features[lf]:
            xn = x[np.flatnonzero(leaf == lf)].copy()
            xn[:, f] = np.nan
            # a NaN row walks its default direction: keep those still in lf
            still = t.predict_leaf(xn) == lf
            if still.any():
                found = (lf, xn[still])
                break
        if found:
            break
    assert found is not None
    lf, xn = found
    np.testing.assert_array_equal(t.predict(xn), t.leaf_value[lf])
    p = bst.predict(xn, raw_score=True)
    host = sum(tr.predict(xn.astype(np.float64)) for tr in bst._models)
    assert np.all(np.isfinite(p))
    np.testing.assert_allclose(p, host, rtol=1e-12, atol=1e-12)


def test_valid_eval_equals_predict():
    x, y = _problem()
    xv, yv = _problem(600, seed=9)
    ds = lgt.Dataset(x, label=y)
    dv = lgt.Dataset(xv, label=yv, reference=ds)
    bst = lgt.train(dict(BASE, metric="l2"), ds, 4, valid_sets=[dv],
                    device="cpu")
    recorded = bst.best_score["valid_0"]["l2"]
    direct = float(np.mean((bst.predict(xv) - yv) ** 2))
    assert abs(recorded - direct) < 1e-5 * max(1.0, direct)


def test_continued_training_inherits_linear_tree(tmp_path):
    """``init_model`` of a linear model: linear_tree comes from the model,
    the new trees start from its raw predictions, the iterations count
    both parts, and the fit improves."""
    x, y = _problem()
    bst = lgt.train(BASE, lgt.Dataset(x, label=y), 3, device="cpu")
    path = tmp_path / "m.txt"
    bst.save_model(str(path))
    cont = lgt.train({"objective": "regression", "num_leaves": 15,
                      "learning_rate": 0.5, "verbosity": -1},
                     lgt.Dataset(x, label=y), 2, init_model=str(path),
                     device="cpu")
    assert cont.num_trees() == 5 and cont.current_iteration() == 5
    assert all(t.is_linear for t in cont._models)
    mse = float(np.mean((cont.predict(x) - y) ** 2))
    mse0 = float(np.mean((bst.predict(x) - y) ** 2))
    assert mse < mse0
    # the new trees' scores: the old model's predictions plus their own
    np.testing.assert_allclose(cont._inner.train_score.numpy(),
                               cont.predict(x, raw_score=True), atol=2e-5)


def test_contrib_and_serving_refuse_linear_trees():
    # the package's current modules, all from one import: a JAX test run
    # earlier in this process may have dropped every lightgbm_tpu* module,
    # and a class of the old modules would not match the new ones'
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.serve import (ServingEngine, ServingModel,
                                          ServingQueue)
    from lightgbm_tpu_torch.utils.log import LightGBMError
    x, y = _problem(600)
    bst = lgt.train(BASE, lgt.Dataset(x, label=y), 2, device="cpu")
    with pytest.raises(LightGBMError, match="linear trees"):
        bst.predict(x, pred_contrib=True)
    with pytest.raises(LightGBMError, match="predict_linear_tree"):
        ServingModel.from_booster(bst, device="cpu")
    with pytest.raises(LightGBMError, match="predict_linear_tree"):
        bst.serving_engine()
    sm = ServingModel.from_booster(bst, device="cpu", leaves_only=True)
    eng = ServingEngine(sm, device="cpu")
    assert eng.predict_leaves(x[:5]).shape == (5, 2)
    with pytest.raises(LightGBMError, match="predict_linear_tree"):
        ServingQueue(eng)
    with pytest.raises(LightGBMError, match="predict_linear_tree"):
        eng.predict(x[:5])


@pytest.mark.parametrize("params,match", [
    ({"boosting": "dart"}, "boosting=dart"),
    ({"boosting": "rf", "bagging_fraction": 0.5, "bagging_freq": 1},
     "boosting=rf"),
    ({"objective": "regression_l1"}, "percentile refit"),
])
def test_linear_refusals(params, match):
    x, y = _problem(400)
    with pytest.raises(LightGBMError, match=match):
        lgt.train(dict(BASE, **params), lgt.Dataset(x, label=y), 1,
                  device="cpu")


def test_linear_needs_raw_values():
    x, y = _problem(400)
    ds = lgt.Dataset(x, label=y).construct()
    with pytest.raises(LightGBMError, match="kept no raw"):
        lgt.train(BASE, ds, 1, device="cpu")


def test_jax_linear_model_predicts_in_the_port():
    """The model text crosses both ways: a JAX linear model loads and
    predicts in the port, and the port's loads in the JAX package."""
    import lightgbm_tpu as lgb
    x, y = _problem(1500)
    bj, binned, _ = _jax_train(BASE, x, y, 3, ds_params=BASE,
                               route=ROW_ORDER_ROUTE)
    text_j = bj.model_to_string()
    port = lgt.Booster(model_str=text_j, device="cpu")
    xq = x.astype(np.float64)
    np.testing.assert_allclose(port.predict(xq), bj.predict(xq),
                               rtol=1e-9, atol=1e-9)
    bt = lgt.train(BASE, _port_ds(binned), 3, device="cpu")
    jax_side = lgb.Booster(model_str=bt.model_to_string())
    np.testing.assert_allclose(jax_side.predict(xq), bt.predict(xq),
                               rtol=1e-9, atol=1e-9)


def test_goss_and_multiclass_linear_train():
    """GOSS (the in-bag weights weight the fit) and multiclass linear
    trees train, and the predictions equal the training scores."""
    x, y = _problem(1024)
    g = lgt.train(dict(BASE, boosting="goss", top_rate=0.3,
                       other_rate=0.2), lgt.Dataset(x, label=y), 4,
                  device="cpu")
    assert "boosting_not_gbdt" in g._inner.route.reasons
    np.testing.assert_allclose(g.predict(x, raw_score=True),
                               g._inner.train_score.numpy(), atol=2e-5)
    yc = (np.nan_to_num(x[:, 0]) > 0).astype(np.float32) + (
        np.nan_to_num(x[:, 1]) > 1)
    m = lgt.train(dict(BASE, objective="multiclass", num_class=3,
                       num_leaves=7), lgt.Dataset(x, label=yc), 2,
                  device="cpu")
    assert len(m._models) == 6
    np.testing.assert_allclose(m.predict(x, raw_score=True),
                               m._inner.scores.numpy().T, atol=2e-5)


# -- the fit's pieces -----------------------------------------------------------
def _direct_moments(raw, leaf, g, h, w, fi):
    """The moments as a plain f64 numpy sum over each leaf's rows."""
    L, kmax = fi.shape
    k1 = kmax + 1
    p, e = moment_layout(kmax)
    iu, ju = np.triu_indices(k1)
    out = np.zeros((L, e))
    for lf in range(L):
        rows = np.flatnonzero(leaf == lf)
        f = fi[lf]
        x = np.where(f >= 0, raw[rows][:, np.maximum(f, 0)], 0.0).astype(
            np.float64)
        nan = np.isnan(x).any(axis=1)
        x = np.nan_to_num(x)
        xa = np.concatenate([x, np.ones((len(rows), 1))], axis=1)
        wf = np.where(nan, 0.0, w[rows].astype(np.float64))
        a, b = wf * h[rows], wf * g[rows]
        hx = (xa * a[:, None]).T @ xa
        out[lf, :p] = hx[iu, ju]
        out[lf, p:p + k1] = xa.T @ b
        out[lf, p + k1] = wf.sum()
    return out


def test_linear_moments_plain_version_against_numpy():
    rng = np.random.default_rng(4)
    n, f, L = 700, 6, 5
    raw = rng.normal(size=(n, f)).astype(np.float32)
    raw[rng.random(raw.shape) < 0.05] = np.nan
    leaf = rng.integers(0, L, n)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.1, 1, n).astype(np.float32)
    w = (rng.random(n) < 0.8).astype(np.float32)
    fi = np.array([[0, 2, -1], [1, -1, -1], [3, 4, 5], [-1, -1, -1],
                   [5, 0, 1]], np.int32)
    got = linear_moments(torch.tensor(raw), torch.tensor(leaf),
                         torch.tensor(g), torch.tensor(h), torch.tensor(w),
                         torch.tensor(fi))
    want = _direct_moments(raw, leaf, g, h, w, fi)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    # the chunk size sets the order only: another chunk, the same sums
    again = linear_moments_ref(torch.tensor(raw), torch.tensor(leaf),
                               torch.tensor(g), torch.tensor(h),
                               torch.tensor(w), torch.tensor(fi), chunk=7)
    np.testing.assert_allclose(again.numpy(), want, rtol=1e-12, atol=1e-12)


def _moment_inputs(n, f, leaves, kmax, spread, seed):
    """Seeded moments inputs: NaN in 3 % of the values, leaves even,
    skewed (half the rows in leaf 0) or with leaf 1 empty, each leaf up
    to kmax distinct path features (-1 padded)."""
    rng = np.random.default_rng(seed)
    raw = rng.normal(size=(n, f)).astype(np.float32)
    raw[rng.random(raw.shape) < 0.03] = np.nan
    leaf = rng.integers(0, leaves, n)
    if spread == "skewed":
        leaf[rng.random(n) < 0.5] = 0
    elif spread == "empty":
        leaf[leaf == 1] = 0
    fi = np.full((leaves, kmax), -1, np.int32)
    for lf in range(leaves):
        k = kmax if lf == 0 else rng.integers(0, kmax + 1)
        fi[lf, :k] = rng.choice(f, size=k, replace=False)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.1, 1, n).astype(np.float32)
    w = (rng.random(n) < 0.9).astype(np.float32)
    return [torch.tensor(a) for a in (raw, leaf.astype(np.int32), g, h, w,
                                      fi)]


@pytest.mark.parametrize("n,f,leaves,kmax,spread,budget", [
    (3000, 8, 20, 5, "even", None), (3000, 8, 20, 5, "skewed", None),
    (3000, 8, 20, 5, "empty", 5_000), (500, 4, 6, 1, "even", None),
    (2000, 30, 12, 28, "skewed", 60_000), (700, 140, 4, 136, "even", None)])
def test_kernel_model_equals_plain_bitwise(n, f, leaves, kmax, spread, budget,
                                           monkeypatch):
    """The redesigned kernel's order of operations (passes of entries
    staged from their first column, batches of chunks, the XtG and count
    entries as products by 1, ``chunk_chain``'s chunk-order sums onto the
    zeroed output) gives the plain version's bits; a small scratch
    budget cuts the chunks into several batches."""
    from lightgbm_tpu_torch.ops import linear_kernel as lk
    if budget:
        monkeypatch.setattr(lk, "SCRATCH_BYTES", budget)
        assert lk.chunk_batch(kmax, lk.scratch_chunks(n, leaves), n) < (
            lk.scratch_chunks(n, leaves))
    args = _moment_inputs(n, f, leaves, kmax, spread, n + kmax)
    want = linear_moments_ref(*args)
    got = lk.linear_moments_model(*args)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))


def test_kernel_layout_at_one_million_rows():
    """At 1M rows and 255 leaves, for every kmax up to MAX_FEATURES: the
    scratch (a batch of chunk sums, and the rows' g, h, w where the
    entries take more than one pass) stays within 64 MB, a pass is every
    entry or whole tiles, a block's stages fit the card's 227 KB and a
    stage holds at least one row; kmax 9 and 28 take one pass and one
    batch."""
    from lightgbm_tpu_torch.ops import linear_kernel as lk
    n = 1_000_000
    cmax = lk.scratch_chunks(n, 255)
    assert cmax == 15_625 + 255
    for kmax in range(1, lk.MAX_FEATURES + 1):
        _, e = moment_layout(kmax)
        ep = lk.pass_entries(kmax)
        cb = lk.chunk_batch(kmax, cmax, n)
        kept = 12 * n if ep < e else 0        # g, h, w by position
        assert 1 <= cb <= cmax and cb * ep * 8 + kept <= 64_000_000
        assert ep == e or ep == lk.WARPS * 32 * lk.MAX_SLOTS
        assert lk.stage_rows(kmax + 1, 1) >= 1
        assert lk.smem_bytes(kmax) <= 227 * 1024
    for kmax in (9, 28):
        e = moment_layout(kmax)[1]
        assert lk.pass_entries(kmax) == e
        assert lk.chunk_batch(kmax, cmax, n) == cmax


def test_singular_and_thin_leaves_are_not_ok():
    """A singular system (a duplicated path feature at linear_lambda 0)
    and a leaf with fewer than 2 * nfeat rows keep their leaf value and
    get no features; the other leaves solve."""
    rng = np.random.default_rng(6)
    n = 400
    x0 = rng.normal(size=n)
    raw = np.stack([x0, x0, rng.normal(size=n)], axis=1).astype(np.float32)
    leaf = np.zeros(n, np.int64)
    leaf[200:] = 1
    leaf[396:] = 2                      # 4 rows, 2 features: 4 < 6
    fi = np.array([[0, 1], [2, -1], [0, 2]], np.int32)
    g = rng.normal(size=n).astype(np.float32)
    h = np.ones(n, np.float32)
    w = np.ones(n, np.float32)
    m = linear_moments(*(torch.tensor(a) for a in (raw, leaf, g, h, w, fi)))
    lv = np.array([0.25, -0.5, 0.75])
    coef, const, ok = solve_leaves(m.numpy(), fi, lv, 0.0)
    assert ok.tolist() == [False, True, False]
    np.testing.assert_array_equal(const[[0, 2]], lv[[0, 2]])
    assert not coef[[0, 2]].any() and np.isfinite(coef[1]).all()


def test_leaf_path_features_skip_categorical_and_repeat():
    from lightgbm_tpu_torch.ops.grow import TreeArrays
    z = np.zeros(3, np.float32)
    # node 0 on f2, node 1 (left) on f2 again, node 2 (right) on the
    # categorical f1; leaves 0, 1 under node 1, 2 and 3 under node 2
    ta = TreeArrays(split_feature=np.array([2, 2, 1]),
                    threshold_bin=np.zeros(3, np.int32), split_gain=z,
                    default_left=np.zeros(3, bool),
                    is_categorical=np.array([False, False, True]),
                    left_child=np.array([1, ~0, ~2]),
                    right_child=np.array([2, ~1, ~3]),
                    internal_value=z, internal_weight=z, internal_count=z,
                    leaf_value=np.zeros(4, np.float32),
                    leaf_weight=np.zeros(4, np.float32),
                    leaf_count=np.zeros(4, np.float32), num_leaves=4)
    fi = leaf_path_features(ta, np.array([False, True, False]), 4)
    assert fi.tolist() == [[2], [2], [2], [2]]


# -- init_model and rollback_one_iter against the JAX package ----------------
@functools.lru_cache(maxsize=None)
def _jax_continued(linear: bool):
    """The JAX package trained 2 rounds, continued 2 through init_model
    (its tree count, current_iteration and default and full predictions
    then), then rolled back once (its training scores)."""
    import os

    from conftest import restore_env_knobs, save_env_knobs
    from test_torch_train import ROUTE_KNOBS, _purge
    x, y = _problem(1200)
    params = dict(BASE, linear_tree=linear, num_leaves=7)
    saved = save_env_knobs(ROUTE_KNOBS)
    for k in ROUTE_KNOBS:
        os.environ.pop(k, None)
    os.environ.update(ROW_ORDER_ROUTE)
    try:
        _purge()
        import lightgbm_tpu as lgb
        b0 = lgb.train(params, lgb.Dataset(x, label=y, params=params), 2)
        b1 = lgb.train(params, lgb.Dataset(x, label=y, params=params), 2,
                       init_model=b0)
        counts = (b1.num_trees(), b1.current_iteration())
        preds = (b1.predict(x), b1.predict(x, num_iteration=4))
        b1.rollback_one_iter()
        score = np.asarray(b1._inner.get_training_score())[0, :len(x)]
        return counts, preds, b1.num_trees(), score
    finally:
        restore_env_knobs(saved)
        _purge()


@pytest.mark.parametrize("linear", [False, True])
def test_init_model_and_rollback_match_jax(linear):
    x, y = _problem(1200)
    params = dict(BASE, linear_tree=linear, num_leaves=7)
    _, _, trees_j, score_j = _jax_continued(linear)
    b0 = lgt.train(params, lgt.Dataset(x, label=y), 2, device="cpu")
    b1 = lgt.train(params, lgt.Dataset(x, label=y), 2, init_model=b0,
                   device="cpu")
    b1.rollback_one_iter()
    assert b1.num_trees() == trees_j == 3
    np.testing.assert_allclose(b1._inner.train_score.numpy(), score_j,
                               atol=SCORE_ATOL)


def test_jax_continued_model_counts_only_new_iterations():
    """Witness of a JAX fault the port does not copy (ROADMAP C): after
    init_model the JAX package's current_iteration leaves out the earlier
    model's iterations, so its predict scores only as many iterations as
    it trained anew; the port counts both, as LightGBM does."""
    counts, (default, full), _, _ = _jax_continued(False)
    assert counts == (4, 2)
    assert np.abs(default - full).max() > 0
    x, y = _problem(1200)
    params = dict(BASE, linear_tree=False, num_leaves=7)
    t0 = lgt.train(params, lgt.Dataset(x, label=y), 2, device="cpu")
    t1 = lgt.train(params, lgt.Dataset(x, label=y), 2, init_model=t0,
                   device="cpu")
    assert (t1.num_trees(), t1.current_iteration()) == (4, 4)
    np.testing.assert_array_equal(t1.predict(x),
                                  t1.predict(x, num_iteration=4))


def test_rollback_restores_scores_bitwise_on_the_stream_route():
    """The latest iteration rolls back to its scores bit for bit (training
    and validation); the next tree rebuilds the stream rows from the
    scores; an older iteration is subtracted."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2000, 6)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] * x[:, 2] > 0).astype(np.float32)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
    ds = lgt.Dataset(x, label=y)
    bst = lgt.Booster(p, ds, device="cpu")
    bst.add_valid(lgt.Dataset(x[:300], label=y[:300], reference=ds), "v")
    assert bst._inner.route.stream
    for _ in range(3):
        bst.update()
    s2 = bst._inner.scores.clone()
    v2 = bst._inner.valid_sets[0].scores.clone()
    bst.update()
    bst.rollback_one_iter()
    assert torch.equal(bst._inner.scores, s2)
    assert torch.equal(bst._inner.valid_sets[0].scores, v2)
    assert bst.num_trees() == 3 and bst.current_iteration() == 3
    bst.update()
    rows = bst._inner.grow.rows.fields()
    assert torch.equal(rows.score, bst._inner.train_score[rows.rid.long()])
    # two back: the second is subtracted
    bst.rollback_one_iter()
    bst.rollback_one_iter()
    assert bst.num_trees() == 2
    want = sum(t.predict(x.astype(np.float64)) for t in bst._models)
    np.testing.assert_allclose(bst._inner.train_score.numpy(), want,
                               atol=2e-6)
    np.testing.assert_allclose(bst._inner.valid_sets[0].score.numpy(),
                               want[:300], atol=2e-6)


def test_rollback_refuses_dart():
    x, y = _problem(400)
    bst = lgt.train({"objective": "regression", "boosting": "dart",
                     "verbosity": -1}, lgt.Dataset(x, label=y), 2,
                    device="cpu")
    with pytest.raises(LightGBMError, match="dart"):
        bst.rollback_one_iter()


def test_init_model_text_and_rebinned_categorical_trees():
    """A model string as init_model; a categorical model's rebinned
    trees replay a validation set as their text predicts it."""
    x, y = _problem(1500, nan_frac=0.0)
    x[:, 3] = np.arange(len(x)) % 9
    y = y + np.where(x[:, 3] % 3 == 0, 3.0, 0.0).astype(np.float32)
    p = {"objective": "regression", "num_leaves": 7, "verbosity": -1,
         "min_data_per_group": 5, "cat_smooth": 1.0}
    ds = lgt.Dataset(x, label=y, categorical_feature=[3])
    b0 = lgt.train(p, ds, 2, device="cpu")
    assert any(t.num_cat for t in b0._models)
    text = b0.model_to_string()
    ds2 = lgt.Dataset(x, label=y, categorical_feature=[3])
    dv = lgt.Dataset(x[:400], label=y[:400], reference=ds2)
    b1 = lgt.train(p, ds2, 1, init_model=text, valid_sets=[dv],
                   device="cpu")
    assert b1.num_trees() == 3
    want = b1.predict(x[:400], raw_score=True)
    np.testing.assert_allclose(b1._inner.valid_sets[0].score.numpy(), want,
                               atol=2e-6)

