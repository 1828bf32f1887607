"""Training in the PyTorch port (``lightgbm_tpu_torch.train``) against
the JAX package, on the CPU.

The JAX package trains on its physical, unfused route with the XLA
split tail (``LGBM_TPU_PHYS=interpret LGBM_TPU_STREAM=0
LGBM_TPU_FUSED=0``; knobs saved and restored and its modules purged
around each run, as tests/test_fused.py does) and, for the whole of
slice 3, on its default route (stream, fused split and the Pallas split
tail, ``LGBM_TPU_PHYS=interpret LGBM_TPU_APPLY_IMPL=pallas_interpret``);
the port trains with ``device="cpu"`` on its default route, where its
kernels' plain versions run, and on slice 2's route, whose trees it
must equal leaf byte for leaf byte.  Inputs are made with numpy from a
seed and handed to both.

Tolerances: bin boundaries, binned matrices and tree structure (leaf
counts, split features, threshold bins, decision types, default
directions) are equal.  Leaf values agree within 1e-4 relative to the
tree's largest leaf: the two packages sum in other orders, and the
subtraction trick (sibling = parent - child) carries the root
histogram's absolute f32 noise down to the smallest leaves, where it is
largest relative to their sums (up to 1.6e-5 seen; the card and the
CPU run of the port itself agree bit for bit, see chip_smoke.py).  Raw
predictions and AUC agree within 1e-5.  Gradients: the binary gradient within
2 f32 ulps (the two ``exp`` implementations), its hessian within 4 f32
eps of its maximum s^2/4 (``s - abs_r`` cancels near 1), the l2
gradient exactly.  Model text is equal line by line outside its
float-valued fields.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from chip_smoke import compare_trees
from conftest import restore_env_knobs, save_env_knobs
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.convert import dataset_from_numpy
from lightgbm_tpu_torch.io.dataset_core import BinnedDataset as TBinned
from lightgbm_tpu_torch.io.dataset_core import Metadata as TMetadata
from lightgbm_tpu_torch.objective import create_objective as t_objective
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
EPS32 = float(np.finfo(np.float32).eps)
ROUTE = {"LGBM_TPU_PHYS": "interpret", "LGBM_TPU_STREAM": "0",
         "LGBM_TPU_FUSED": "0"}
# the JAX package's default route off the TPU (stream and fused at their
# defaults, the Pallas split tail through its interpreter)
DEFAULT_ROUTE = {"LGBM_TPU_PHYS": "interpret",
                 "LGBM_TPU_APPLY_IMPL": "pallas_interpret"}
SLICE2_ROUTE = {"LGBM_TPU_STREAM": "0", "LGBM_TPU_FUSED": "0",
                "LGBM_TPU_APPLY_IMPL": "xla"}
ROUTE_KNOBS = ("LGBM_TPU_PHYS", "LGBM_TPU_STREAM", "LGBM_TPU_FUSED",
               "LGBM_TPU_APPLY_IMPL")
# model-text fields holding floats computed from f32 sums
FLOAT_KEYS = ("tree_sizes", "split_gain", "leaf_value", "leaf_weight",
              "internal_value", "internal_weight")
LEAF_RTOL = 1e-4


def _purge():
    for m in [k for k in list(sys.modules) if k.startswith("lightgbm_tpu")
              and not k.startswith("lightgbm_tpu_torch")]:
        del sys.modules[m]


def _jax_train(params, x, y, rounds, xv=None, yv=None, ds_params=None,
               cat=None, route=None, ds_kw=None):
    """JAX training on the route under test (slice 2's unless ``route``
    names the knobs of another): (booster, binned dataset, validation
    raw scores).  ``ds_kw`` (weight, init_score) go to the Dataset."""
    route = ROUTE if route is None else route
    saved = save_env_knobs(ROUTE_KNOBS)
    for k in ROUTE_KNOBS:
        os.environ.pop(k, None)
    os.environ.update(route)
    try:
        _purge()
        import lightgbm_tpu as lgb
        ds = lgb.Dataset(x, label=y, params=ds_params,
                         categorical_feature=cat or "auto", **(ds_kw or {}))
        valid = ([lgb.Dataset(xv, label=yv, reference=ds)]
                 if xv is not None else None)
        bst = lgb.train(params, ds, num_boost_round=rounds,
                        valid_sets=valid)
        if route is ROUTE:
            assert bst._inner._routing.path == "physical"
        raw_v = (np.asarray(bst.predict(xv, raw_score=True))
                 if xv is not None else None)
        return bst, ds._binned, raw_v
    finally:
        restore_env_knobs(saved)
        _purge()


def _data(n, f, seed, objective="binary", nan_frac=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random(x.shape) < nan_frac] = np.nan
    y_raw = (np.nan_to_num(x[:, 0]) + 0.5 * np.nan_to_num(x[:, 1] * x[:, 2])
             + 0.3 * rng.normal(size=n))
    y = ((y_raw > 0).astype(np.float32) if objective == "binary"
         else y_raw.astype(np.float32))
    return x, y


def _text_lines_equal(a: str, b: str) -> None:
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb)
    for p, q in zip(la, lb):
        if p.split("=", 1)[0] in FLOAT_KEYS:
            continue
        assert p == q


CONFIGS = {
    "binary_nan": dict(
        params={"objective": "binary", "num_leaves": 15, "metric": "auc"},
        n=3000, f=6, rounds=4),
    "regression_l2": dict(
        params={"objective": "regression", "num_leaves": 31,
                "lambda_l2": 1.0, "min_data_in_leaf": 10},
        n=2500, f=7, rounds=3, objective="regression"),
    "binary_onehot_depth": dict(
        params={"objective": "binary", "num_leaves": 31, "max_depth": 4,
                "feature_fraction": 0.8, "metric": "auc"},
        n=2000, f=6, rounds=3, cat=True),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    cfg = CONFIGS[request.param]
    x, y = _data(cfg["n"] + 800, cfg["f"], 11,
                 cfg.get("objective", "binary"))
    cat = None
    if cfg.get("cat"):
        x[:, 5] = np.random.default_rng(3).integers(0, 3, x.shape[0])
        y = ((y > 0) | (x[:, 5] == 2)).astype(np.float32)
        cat = [5]
    xt, yt, xv, yv = x[:cfg["n"]], y[:cfg["n"]], x[cfg["n"]:], y[cfg["n"]:]
    params = dict(cfg["params"], verbosity=-1)
    bj, binned_j, raw_vj = _jax_train(params, xt, yt, cfg["rounds"], xv, yv,
                                      cat=cat)
    ds = lgt.Dataset(xt, label=yt, categorical_feature=cat or "auto")
    valid = lgt.Dataset(xv, label=yv, reference=ds)
    bt = lgt.train(params, ds, num_boost_round=cfg["rounds"],
                   valid_sets=[valid], device="cpu")
    return dict(jax=bj, torch=bt, binned_j=binned_j, raw_vj=raw_vj, xv=xv,
                xt=xt, yt=yt, params=params, rounds=cfg["rounds"],
                name=request.param)


def test_trees_match_jax(pair):
    res = compare_trees(pair["torch"]._models, pair["jax"]._models,
                        rtol=LEAF_RTOL)
    assert res["ok"], res
    for a, b in zip(pair["torch"]._models, pair["jax"]._models):
        assert a.num_leaves > 1
        ni = a.num_leaves - 1
        assert np.array_equal(a.left_child[:ni], b.left_child[:ni])
        assert np.array_equal(a.right_child[:ni], b.right_child[:ni])
        assert np.array_equal(a.threshold[:ni], b.threshold[:ni])


def test_predictions_and_metric_match_jax(pair):
    raw_t = pair["torch"].predict(pair["xv"], raw_score=True)
    np.testing.assert_allclose(raw_t, pair["raw_vj"], rtol=0, atol=1e-5)
    ev_t = pair["torch"].best_score
    ev_j = pair["jax"].best_score
    assert ev_t.keys() == ev_j.keys()
    for ds_name in ev_t:
        for metric, v in ev_t[ds_name].items():
            assert abs(v - ev_j[ds_name][metric]) <= 1e-5, metric


def test_model_text_matches_jax(pair):
    text_t = pair["torch"].model_to_string()
    _text_lines_equal(text_t, pair["jax"].model_to_string())
    # and the text crosses back: the port loads what it wrote
    loaded = lgt.Booster(model_str=text_t, device="cpu")
    np.testing.assert_allclose(
        loaded.predict(pair["xv"], raw_score=True),
        pair["torch"].predict(pair["xv"], raw_score=True), rtol=0,
        atol=1e-6)


def test_trained_predict_equals_training_scores(pair):
    """Serving the trained booster (slice 1's engine) reproduces the
    scores training accumulated, within 64 f32 ulps per tree."""
    bst = pair["torch"]
    raw = bst.predict(pair["xt"], raw_score=True)
    score = bst._inner.train_score.numpy().astype(np.float64)
    tol = 64 * len(bst._models) * EPS32 * np.maximum(np.abs(score), 1.0)
    assert np.all(np.abs(raw - score) <= tol)


def test_dataset_from_jax_bins_trains_the_same_trees(pair):
    """convert.dataset_from_numpy: the JAX package's bin mappers and
    binned matrix make a port Dataset that grows the same trees."""
    bj = pair["binned_j"]
    ds = dataset_from_numpy(
        [m.to_dict() for m in bj.mappers], bj.bin_matrix, bj.metadata.label,
        used_feature_map=bj.used_feature_map,
        num_total_features=bj.num_total_features)
    bt = lgt.train(pair["params"], ds, num_boost_round=pair["rounds"],
                   device="cpu")
    res = compare_trees(bt._models, pair["jax"]._models, rtol=LEAF_RTOL)
    assert res["ok"], res


@pytest.mark.parametrize("kw", [{}, {"max_bin": 63, "min_data_in_bin": 5},
                                {"zero_as_missing": True},
                                {"use_missing": False}])
def test_binning_matches_jax(kw):
    """Bin mappers, the used-feature map and the binned matrix equal the
    JAX BinnedDataset's, with NaN, exact zeros, a constant column and a
    categorical column."""
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset_core import BinnedDataset as JBinned
    rng = np.random.default_rng(8)
    x = rng.normal(size=(4000, 7))
    x[rng.random(x.shape) < 0.1] = np.nan
    x[rng.random(4000) < 0.2, 1] = 0.0
    x[:, 3] = 2.5                                    # dropped: one bin
    x[:, 4] = rng.integers(0, 9, 4000)
    x[:, 5] = np.round(x[:, 5], 1)                   # few distinct values
    j = JBinned.construct(x, JConfig.from_params(kw), label=x[:, 0] > 0,
                          categorical_indices=[4])
    t = TBinned.construct(x, TConfig.from_params(kw), label=x[:, 0] > 0,
                          categorical_indices=[4])
    np.testing.assert_array_equal(t.used_feature_map, j.used_feature_map)
    assert len(t.mappers) == len(j.mappers)
    for a, b in zip(t.mappers, j.mappers):
        assert a.to_dict() == b.to_dict()
    assert t.bin_matrix.dtype == j.bin_matrix.dtype
    np.testing.assert_array_equal(t.bin_matrix, j.bin_matrix)


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_gradients_match_jax(objective):
    import jax.numpy as jnp
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset_core import Metadata as JMetadata
    from lightgbm_tpu.objective import create_objective as j_objective
    rng = np.random.default_rng(9)
    n = 20000
    y = ((rng.random(n) < 0.4).astype(np.float32) if objective == "binary"
         else rng.normal(size=n).astype(np.float32))
    score = (rng.normal(size=n) * 3).astype(np.float32)
    jm, tm = JMetadata(), TMetadata()
    jm.set_label(y)
    tm.set_label(y)
    jo = j_objective(JConfig.from_params({"objective": objective}))
    jo.init(jm, n)
    to = t_objective(TConfig.from_params({"objective": objective}))
    to.init(tm, n, torch.device("cpu"))
    gj, hj = (np.asarray(a) for a in jo.get_gradients(jnp.asarray(score)))
    gt, ht = (a.numpy() for a in to.get_gradients(torch.tensor(score)))
    assert gt.dtype == ht.dtype == np.float32
    np.testing.assert_array_equal(jo.boost_from_score(),
                                  to.boost_from_score())
    if objective == "regression":
        np.testing.assert_array_equal(gt, gj)
        np.testing.assert_array_equal(ht, hj)
        return
    ulps = np.abs(gt.view(np.int32).astype(np.int64)
                  - gj.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2
    assert np.abs(ht - hj).max() <= 4 * EPS32 * 0.25


@pytest.mark.parametrize("params", [
    {"pre_partition": True},
    {"tree_learner": "data", "bagging_fraction": 0.5, "bagging_freq": 1},
])
def test_unported_parameters_raise(params):
    x, y = _data(300, 4, 1)
    p = dict({"objective": "binary", "verbosity": -1}, **params)
    with pytest.raises(LightGBMError, match="ROADMAP"):
        lgt.train(p, lgt.Dataset(x, label=y), num_boost_round=1,
                  device="cpu")


@pytest.mark.parametrize("params,rule", [
    ({"cegb_penalty_split": 0.5}, "tail_cegb"),
    ({"interaction_constraints": "[[0, 1]]"}, "tail_interaction"),
    ({"extra_trees": True}, "tail_extra_trees"),
    ({"feature_fraction_bynode": 0.5}, "tail_bynode"),
])
def test_split_options_train_on_the_pytorch_tail(params, rule):
    """The split options that raised before slice 22 train, on the
    PyTorch split tail under their rule (tests/test_torch_split_options.py
    holds them against the JAX package)."""
    x, y = _data(300, 4, 1)
    p = dict({"objective": "binary", "verbosity": -1}, **params)
    bst = lgt.train(p, lgt.Dataset(x, label=y), num_boost_round=1,
                    device="cpu")
    assert bst._inner.grow.route.describe() == (
        f"path=stream fused=1 tail=xla ({rule})")


def test_categorical_subset_raises():
    """A categorical feature with more bins than max_cat_to_onehot now
    trains with the sorted-subset search (tests/test_torch_cat_subset.py
    holds it against the JAX package); what raises beside it is what
    raises without it, an unported parameter."""
    x, y = _data(500, 4, 2)
    x[:, 3] = np.arange(500) % 12
    bst = lgt.train({"objective": "binary", "verbosity": -1},
                    lgt.Dataset(x, label=y, categorical_feature=[3]),
                    num_boost_round=1, device="cpu")
    assert bst._inner.hp.use_cat_subset
    assert bst._inner.route.tail == "xla"
    with pytest.raises(LightGBMError, match="ROADMAP"):
        lgt.train({"objective": "binary", "verbosity": -1,
                   "tree_learner": "data"},
                  lgt.Dataset(x, label=y, categorical_feature=[3]),
                  num_boost_round=1, device="cpu")


def test_training_imports_no_jax():
    """Training and serving on the CPU pull in no JAX and nothing of
    the JAX package."""
    code = (
        "import sys, numpy as np, lightgbm_tpu_torch as lgt\n"
        "import lightgbm_tpu_torch.convert, lightgbm_tpu_torch.engine\n"
        "import lightgbm_tpu_torch.ops.grow, lightgbm_tpu_torch.ops.split\n"
        "import lightgbm_tpu_torch.ops.hist_kernel2\n"
        "import lightgbm_tpu_torch.ops.partition_kernel\n"
        "import lightgbm_tpu_torch.ops.stream_grad\n"
        "import lightgbm_tpu_torch.ops.fused_split\n"
        "import lightgbm_tpu_torch.ops.apply_find\n"
        "import lightgbm_tpu_torch.ops.routing\n"
        "rng = np.random.default_rng(0)\n"
        "x = rng.normal(size=(500, 4)); y = (x[:, 0] > 0) * 1.0\n"
        "b = lgt.train({'objective': 'binary', 'num_leaves': 7,\n"
        "               'verbosity': -1}, lgt.Dataset(x, label=y),\n"
        "              num_boost_round=2, device='cpu')\n"
        "b.predict(x)\n"
        "assert b._inner.grow.route.describe() == "
        "'path=stream fused=1 tail=kernel'\n"
        "import os; os.environ['LGBM_TPU_PART'] = '3ph'\n"
        "os.environ['LGBM_TPU_POOL_TAIL'] = '0'\n"
        "b = lgt.train({'objective': 'binary', 'num_leaves': 7,\n"
        "               'verbosity': -1}, lgt.Dataset(x, label=y),\n"
        "              num_boost_round=2, device='cpu')\n"
        "assert b._inner.grow.route.describe() == ('path=stream scheme=3ph "
        "fused=0 tail=kernel pool_tail=0 (part_3ph)')\n"
        "del os.environ['LGBM_TPU_PART'], os.environ['LGBM_TPU_POOL_TAIL']\n"
        "os.environ['LGBM_TPU_COMB_PACK'] = '2'\n"
        "b = lgt.train({'objective': 'binary', 'num_leaves': 7,\n"
        "               'verbosity': -1}, lgt.Dataset(x, label=y),\n"
        "              num_boost_round=2, device='cpu')\n"
        "assert b._inner.grow.route.describe() == "
        "'path=stream fused=1 tail=kernel pack=2'\n"
        "b.predict(x)\n"
        "del os.environ['LGBM_TPU_COMB_PACK']\n"
        "import json, tempfile\n"
        "fs = os.path.join(tempfile.mkdtemp(), 'forced.json')\n"
        "json.dump({'feature': 0, 'threshold': 0.0}, open(fs, 'w'))\n"
        "for extra in ({'interaction_constraints': [[0, 1], [1, 2, 3]],\n"
        "               'cegb_penalty_feature_coupled': [0, 1, 0, 2],\n"
        "               'forcedsplits_filename': fs,\n"
        "               'feature_fraction_bynode': 0.5,\n"
        "               'extra_trees': True},\n"
        "              {'cegb_penalty_feature_lazy': [0, 0.01, 0, 0]}):\n"
        "    b = lgt.train(dict({'objective': 'binary', 'num_leaves': 7,\n"
        "                        'verbosity': -1}, **extra),\n"
        "                  lgt.Dataset(x, label=y), num_boost_round=2,\n"
        "                  device='cpu')\n"
        "    assert 'tail=xla' in b._inner.grow.route.describe()\n"
        "    b.predict(x)\n"
        "bad = [m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'lightgbm_tpu' "
        "or m.startswith('lightgbm_tpu.')]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_train_defaults_to_cuda():
    """The entry points run on the card unless the CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the default device is usable")
    x, y = _data(200, 3, 4)
    with pytest.raises(LightGBMError, match="device='cpu'"):
        lgt.train({"objective": "binary", "verbosity": -1},
                  lgt.Dataset(x, label=y), num_boost_round=1)


def _port_train(params, x, y, rounds, env, ds_kw=None):
    saved = save_env_knobs(ROUTE_KNOBS)
    for k in ROUTE_KNOBS:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        return lgt.train(params, lgt.Dataset(x, label=y, **(ds_kw or {})),
                         num_boost_round=rounds, device="cpu")
    finally:
        restore_env_knobs(saved)


ROUTE_CONFIGS = {
    "binary": ({"objective": "binary", "num_leaves": 15,
                "verbosity": -1}, "binary"),
    "l2_lambda": ({"objective": "regression", "num_leaves": 31,
                           "lambda_l2": 1.0, "min_data_in_leaf": 10,
                           "verbosity": -1}, "regression"),
}
PARTIAL_ROUTES = {
    "slice2": SLICE2_ROUTE,
    "stream_only_off": {"LGBM_TPU_STREAM": "0"},
    "fused_only_off": {"LGBM_TPU_FUSED": "0"},
    "tail_only_xla": {"LGBM_TPU_APPLY_IMPL": "xla"},
}


@pytest.mark.parametrize("route", list(PARTIAL_ROUTES))
@pytest.mark.parametrize("config", list(ROUTE_CONFIGS))
def test_default_route_grows_slice2_trees(config, route):
    """The default route and each route with some of its parts switched
    off grow trees of equal structure and equal leaf-value bytes, and
    equal predictions and training scores."""
    params, objective = ROUTE_CONFIGS[config]
    x, y = _data(3000, 6, 21, objective)
    a = _port_train(params, x, y, 4, {})
    b = _port_train(params, x, y, 4, PARTIAL_ROUTES[route])
    assert a._inner.grow.route.describe() == \
        "path=stream fused=1 tail=kernel"
    assert b._inner.grow.route.reasons
    assert len(a._models) == len(b._models) == 4
    for ta, tb in zip(a._models, b._models):
        assert ta.num_leaves == tb.num_leaves > 1
        ni = ta.num_leaves - 1
        for k in ("split_feature", "threshold_bin", "decision_type",
                  "left_child", "right_child"):
            assert np.array_equal(getattr(ta, k)[:ni], getattr(tb, k)[:ni])
        assert ta.leaf_value.tobytes() == tb.leaf_value.tobytes()
        assert ta.leaf_count.tobytes() == tb.leaf_count.tobytes()
    np.testing.assert_array_equal(a.predict(x), b.predict(x))
    assert torch.equal(a._inner.train_score, b._inner.train_score)


@pytest.mark.parametrize("config", list(ROUTE_CONFIGS))
def test_stream_scores_equal_training_scores(config):
    """The score each row carries on the stream route is the booster's
    training score of its row id, bit for bit."""
    params, objective = ROUTE_CONFIGS[config]
    x, y = _data(2000, 5, 22, objective)
    bst = _port_train(params, x, y, 3, {})
    rows = bst._inner.grow.rows
    ts = bst._inner.train_score
    assert torch.equal(rows.score, ts[rows.rid.long()])


@pytest.mark.parametrize("config", list(ROUTE_CONFIGS))
def test_default_route_matches_jax_default_route(config):
    """The whole of slice 3: the port's default route on the CPU against
    the JAX package's default route (stream, fused split, Pallas split
    tail in interpret mode): equal structure, leaf values within 1e-4
    of the tree's largest leaf."""
    params, objective = ROUTE_CONFIGS[config]
    x, y = _data(3000, 6, 23, objective)
    bj, _, _ = _jax_train(params, x, y, 4, route=DEFAULT_ROUTE)
    inner = bj._inner
    assert inner._stream_grad and inner.grow.fused is True
    bt = _port_train(params, x, y, 4, {})
    res = compare_trees(bt._models, bj._models, rtol=LEAF_RTOL)
    assert res["ok"], res


# (params over the binary / l2 base, objective, Dataset extras, the route
# the port picks by default, the recorded f32 tie: None, or the (tree,
# node) where the two packages' gains for two candidate splits agree to
# f32 noise and each takes another, after which their trees differ)
DEFAULT = "path=stream fused=1 tail=kernel"
SETTINGS = {
    "lambda_l1": ({"lambda_l1": 1.0}, "binary", {}, DEFAULT, None),
    "max_delta_step": ({"max_delta_step": 0.3}, "binary", {}, DEFAULT,
                       None),
    "path_smooth": ({"path_smooth": 2.0}, "binary", {}, DEFAULT, None),
    "is_unbalance": ({"is_unbalance": True}, "binary", {}, DEFAULT, None),
    "scale_pos_weight": ({"scale_pos_weight": 3.0}, "binary", {}, DEFAULT,
                         None),
    "sigmoid": ({"sigmoid": 0.6}, "binary", {}, DEFAULT, None),
    "weights_binary": ({}, "binary", {"weight": True}, DEFAULT, None),
    "weights_l2": ({}, "regression", {"weight": True}, DEFAULT, None),
    "init_score": ({}, "binary", {"init_score": True}, DEFAULT, None),
    "boost_from_average_false": ({"boost_from_average": False}, "binary",
                                 {}, DEFAULT, None),
    "reg_sqrt": ({"reg_sqrt": True}, "regression", {}, DEFAULT, None),
    "max_bin_15": ({"max_bin": 15}, "binary", {}, DEFAULT, (2, 3)),
    "max_depth_3": ({"max_depth": 3}, "binary", {}, DEFAULT, None),
    "feature_fraction": ({"feature_fraction": 0.5}, "binary", {}, DEFAULT,
                         None),
    "min_data_in_leaf_200": ({"min_data_in_leaf": 200}, "binary", {},
                             DEFAULT, (2, 8)),
    "learning_rate": ({"learning_rate": 0.5}, "binary", {}, DEFAULT, None),
}
# the JAX package's row-order path on the CPU, with the stream route and
# the fused split off
ROW_ORDER_ROUTE = {"LGBM_TPU_STREAM": "0", "LGBM_TPU_FUSED": "0"}
SETTING_LEAF_RTOL = 1.2e-5
# raw scores at the default learning rate 0.1; a score is the rate times
# the leaf sums, so the bound grows with the rate
SETTING_RAW_ATOL = 3.5e-6
NODE_KEYS = ("split_feature", "threshold_bin", "decision_type", "left_child",
             "right_child")


def _first_divergence(models_a, models_b):
    """(tree, node) of the first node, in tree and node order, where the
    two forests differ in a structural field; None where none does."""
    for t, (a, b) in enumerate(zip(models_a, models_b)):
        ni = min(a.num_leaves, b.num_leaves) - 1
        for i in range(ni):
            if any(getattr(a, k)[i] != getattr(b, k)[i] for k in NODE_KEYS):
                return t, i
        if a.num_leaves != b.num_leaves:
            return t, ni
    return None


@pytest.mark.parametrize("name", list(SETTINGS))
def test_training_setting_matches_jax(name):
    """Sixteen training settings the configurations above leave out,
    parity generator seed 11 (3,000 x 6), 15 leaves, 3 trees: the port
    on the route it picks by default (recorded per case) against the
    JAX package on its row-order route.  Several reach the refresh's
    gradient constants (weights, is_unbalance, scale_pos_weight,
    sigmoid, init_score, boost_from_average).  Trees equal in structure,
    leaves within 1.2e-5 of the tree's largest, raw scores within 3.5e-6
    times the learning rate over 0.1 (at least 1).  Where the case
    records an f32 tie, the trees are equal in structure up to that node
    and first differ there, the node's two gains agree within 1e-3 of
    the gain (a gain is a difference of sums some 1e3 times larger, so
    its f32 noise is), and the trees before it hold this file's
    ``LEAF_RTOL``."""
    extra, objective, data, route, tie = SETTINGS[name]
    x, y = _data(3000, 6, 11, objective)
    rng = np.random.default_rng(11)
    ds_kw = {}
    if data.get("weight"):
        ds_kw["weight"] = rng.uniform(0.2, 2.0, len(y)).astype(np.float32)
    if data.get("init_score"):
        ds_kw["init_score"] = rng.normal(0.0, 0.3, len(y))
    params = dict({"objective": objective, "num_leaves": 15,
                   "verbosity": -1}, **extra)
    bj, _, _ = _jax_train(params, x, y, 3, route=ROW_ORDER_ROUTE,
                          ds_kw=ds_kw)
    bt = _port_train(params, x, y, 3, {}, ds_kw=ds_kw)
    assert bt._inner.grow.route.describe() == route
    assert len(bt._models) == len(bj._models) == 3
    assert _first_divergence(bt._models, bj._models) == tie
    trees = 3 if tie is None else tie[0]
    if tie is not None:
        ga = bt._models[tie[0]].split_gain[tie[1]]
        gb = bj._models[tie[0]].split_gain[tie[1]]
        assert abs(ga - gb) <= 1e-3 * abs(gb)
    res = compare_trees(bt._models[:trees], bj._models[:trees],
                        rtol=SETTING_LEAF_RTOL if tie is None else LEAF_RTOL)
    assert res["ok"], res
    rate = params.get("learning_rate", 0.1)
    np.testing.assert_allclose(
        bt.predict(x, raw_score=True, num_iteration=trees),
        np.asarray(bj.predict(x, raw_score=True, num_iteration=trees)),
        rtol=0, atol=SETTING_RAW_ATOL * max(1.0, rate / 0.1))
