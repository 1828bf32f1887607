"""The row-order path of the PyTorch port (u16 bins at ``max_bin >
255``, or ``LGBM_TPU_PHYS=0``) against the JAX package, on the CPU.

The JAX package trains on its CPU default, which is already its
``row_order`` path (rule ``backend_not_tpu``; route knobs unset, its
modules purged around each run as ``tests/test_torch_train.py`` does);
the port trains with ``device="cpu"``, where ``hist_rows`` runs its
plain version.  Inputs are made with numpy from a seed and handed to
both.

Tolerances: bin mappers, binned matrices and tree structure (leaf
counts, split features, threshold bins, decision types) are equal; leaf
values agree within 1e-4 of the tree's largest leaf, as in slices 2 and
3 (the two packages sum the same rows in other orders); raw predictions
and AUC within 1e-5.  Served scores of a trained booster equal its
training scores within 64 f32 ulps per tree.
"""
import os
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from chip_smoke import compare_trees, score_tolerance
from conftest import restore_env_knobs, save_env_knobs
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset_core import BinnedDataset as TBinned
from lightgbm_tpu_torch.ops.device_data import bins_i32
from lightgbm_tpu_torch.ops.grow import predict_leaf_bins
from lightgbm_tpu_torch.ops.routing import RouteInputs, decide, inputs_from_env
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

ROUTE_KNOBS = ("LGBM_TPU_PHYS", "LGBM_TPU_STREAM", "LGBM_TPU_FUSED",
               "LGBM_TPU_APPLY_IMPL", "LGBM_TPU_HIST_IMPL")
LEAF_RTOL = 1e-4
WIDE = {"max_bin": 1023, "min_data_in_bin": 1}


def _purge():
    for m in [k for k in list(sys.modules) if k.startswith("lightgbm_tpu")
              and not k.startswith("lightgbm_tpu_torch")]:
        del sys.modules[m]


def _data(n, f, seed, nan_frac=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random(x.shape) < nan_frac] = np.nan
    y = ((np.nan_to_num(x[:, 0]) + 0.5 * np.nan_to_num(x[:, 1] * x[:, 2])
          + 0.3 * rng.normal(size=n)) > 0).astype(np.float32)
    return x, y


class _env:
    """The route knobs set as ``env`` says (the others unset) inside the
    block, restored after it."""

    def __init__(self, env):
        self.env = env

    def __enter__(self):
        self.saved = save_env_knobs(ROUTE_KNOBS)
        for k in ROUTE_KNOBS:
            os.environ.pop(k, None)
        os.environ.update(self.env)

    def __exit__(self, *exc):
        restore_env_knobs(self.saved)


def _jax_train(params, x, y, rounds, xv, yv):
    """The JAX package on its CPU default (row_order): (booster, binned
    dataset, validation raw scores)."""
    with _env({}):
        try:
            _purge()
            import lightgbm_tpu as lgb
            ds = lgb.Dataset(x, label=y)
            valid = lgb.Dataset(xv, label=yv, reference=ds)
            bst = lgb.train(params, ds, num_boost_round=rounds,
                            valid_sets=[valid])
            assert bst._inner._routing.path == "row_order"
            return (bst, ds._binned,
                    np.asarray(bst.predict(xv, raw_score=True)))
        finally:
            _purge()


def _port_train(params, x, y, rounds, env, xv=None, yv=None):
    with _env(env):
        ds = lgt.Dataset(x, label=y)
        valid = ([lgt.Dataset(xv, label=yv, reference=ds)]
                 if xv is not None else None)
        return lgt.train(params, ds, num_boost_round=rounds,
                         valid_sets=valid, device="cpu")


# -- routing ---------------------------------------------------------------
@pytest.mark.parametrize("inputs,path,reason,tail", [
    (dict(bins_u8=False), "row_order", "non_u8_bins", "kernel"),
    (dict(bins_u8=False, tail_ok=False), "row_order", "non_u8_bins", "xla"),
    (dict(phys_env="0"), "row_order", "phys_env_off", "kernel"),
    (dict(phys_env="interpret"), "stream", None, "kernel"),
])
def test_route_rules(inputs, path, reason, tail):
    """Wide bins and LGBM_TPU_PHYS=0 take the physical path away, with
    the JAX package's rule names; stream and fused are then off, and the
    tail keeps its own rules."""
    r = decide(RouteInputs(**inputs))
    assert r.path == path and r.tail == tail
    assert r.describe().startswith(f"path={path}")
    if reason:
        assert r.reasons[0] == reason
        assert not r.stream and not r.fused
        assert r.describe().startswith(f"path=row_order fused=0 tail={tail}")
    else:
        assert r.reasons == ()


@pytest.mark.parametrize("max_bin,env,b,desc", [
    (1023, {}, 1024, "path=row_order fused=0 tail=kernel (non_u8_bins)"),
    (255, {"LGBM_TPU_PHYS": "0"}, 256,
     "path=row_order fused=0 tail=kernel (phys_env_off)"),
    (255, {}, 256, "path=stream fused=1 tail=kernel"),
])
def test_booster_route(max_bin, env, b, desc):
    """The booster's route at 28 features: max_bin=1023 gives u16 bins,
    B = 1024 and the kernel tail (both children's histograms spread over
    a cluster's blocks); LGBM_TPU_PHYS=0 at max_bin=255 keeps the
    one-kernel tail; the default route at max_bin <= 255 is unchanged."""
    x, y = _data(1500, 28, 3, nan_frac=0.0)
    params = {"objective": "binary", "num_leaves": 7, "max_bin": max_bin,
              "min_data_in_bin": 1, "verbosity": -1}
    with _env(env):
        bst = lgt.Booster(params, lgt.Dataset(x, label=y), device="cpu")
    g = bst._inner.grow
    assert g.route.describe() == desc
    assert bst._inner.dd.padded_bins == b
    assert bst._inner.dd.bins.dtype == (torch.uint16 if max_bin > 255
                                        else torch.uint8)
    assert type(g).__name__ == ("SerialGrower" if desc.startswith(
        "path=stream") else "RowOrderGrower")


@pytest.mark.parametrize("impl,ok", [("auto", True), ("pallas2", True),
                                     ("pallas", True), ("matmul", False),
                                     ("scatter", False)])
def test_hist_impl_knob(impl, ok):
    """LGBM_TPU_HIST_IMPL: the JAX package's two Pallas kernels (and
    auto) select hist_rows; its XLA formulations raise."""
    x, y = _data(400, 4, 5)
    params = dict(WIDE, objective="binary", num_leaves=7, verbosity=-1)
    with _env({"LGBM_TPU_HIST_IMPL": impl}):
        if ok:
            bst = lgt.train(params, lgt.Dataset(x, label=y),
                            num_boost_round=1, device="cpu")
            assert bst._inner.grow.route.path == "row_order"
        else:
            with pytest.raises(LightGBMError, match="HIST_IMPL"):
                lgt.train(params, lgt.Dataset(x, label=y),
                          num_boost_round=1, device="cpu")


def test_inputs_from_env_reads_phys():
    assert inputs_from_env({"LGBM_TPU_PHYS": "0"}).phys_env == "0"
    assert inputs_from_env({}).phys_env == "auto"


# -- u16 bins --------------------------------------------------------------
@pytest.mark.parametrize("kw", [WIDE, {"max_bin": 255, "min_data_in_bin": 1,
                                       "max_bin_by_feature": [255, 1023,
                                                              63, 255, 255]}])
def test_u16_binning_matches_jax(kw):
    """Bin mappers and the u16 binned matrix equal the JAX
    BinnedDataset's at max_bin=1023, and when max_bin_by_feature makes
    one feature wide."""
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.io.dataset_core import BinnedDataset as JBinned
    rng = np.random.default_rng(12)
    x = rng.normal(size=(5000, 5))
    x[rng.random(x.shape) < 0.1] = np.nan
    x[rng.random(5000) < 0.2, 3] = 0.0
    j = JBinned.construct(x, JConfig.from_params(kw), label=x[:, 0] > 0)
    t = TBinned.construct(x, TConfig.from_params(kw), label=x[:, 0] > 0)
    assert len(t.mappers) == len(j.mappers)
    for a, b in zip(t.mappers, j.mappers):
        assert a.to_dict() == b.to_dict()
    assert t.bin_matrix.dtype == j.bin_matrix.dtype == np.uint16
    assert int(t.bin_matrix.max()) > 255
    np.testing.assert_array_equal(t.bin_matrix, j.bin_matrix)


def test_bins_i32_reads_u16_bits():
    """bins_i32: whole matrix, rows and one column, u8 and u16 (bins
    above 32,767 too, whose int16 view is negative)."""
    rng = np.random.default_rng(1)
    wide = rng.integers(0, 65536, size=(50, 4)).astype(np.uint16)
    for a in (wide, (wide % 256).astype(np.uint8)):
        t = torch.from_numpy(a)
        rows = torch.tensor([7, 3, 3, 49])
        want = a.astype(np.int32)
        assert bins_i32(t).dtype == torch.int32
        np.testing.assert_array_equal(bins_i32(t).numpy(), want)
        np.testing.assert_array_equal(bins_i32(t, rows).numpy(),
                                      want[[7, 3, 3, 49]])
        np.testing.assert_array_equal(bins_i32(t, rows, 2).numpy(),
                                      want[[7, 3, 3, 49], 2])


# -- training against the JAX package ---------------------------------------
TRAIN_CONFIGS = {
    "max_bin_1023": (dict(WIDE), {}),
    "max_bin_255_phys_off": ({"max_bin": 255, "min_data_in_bin": 1},
                             {"LGBM_TPU_PHYS": "0"}),
}


@pytest.fixture(scope="module", params=list(TRAIN_CONFIGS))
def pair(request):
    ds_kw, env = TRAIN_CONFIGS[request.param]
    x, y = _data(3800, 6, 31)
    xt, yt, xv, yv = x[:3000], y[:3000], x[3000:], y[3000:]
    params = dict(ds_kw, objective="binary", num_leaves=15, metric="auc",
                  verbosity=-1)
    bj, binned_j, raw_vj = _jax_train(params, xt, yt, 3, xv, yv)
    bt = _port_train(params, xt, yt, 3, env, xv, yv)
    return dict(jax=bj, torch=bt, binned_j=binned_j, raw_vj=raw_vj, xt=xt,
                xv=xv, name=request.param)


def test_row_order_trees_match_jax(pair):
    """Equal structure, leaf values within 1e-4 of the tree's largest
    leaf; the port ran its row-order path."""
    assert pair["torch"]._inner.grow.route.path == "row_order"
    assert pair["torch"]._inner.dd.bins.dtype == (
        torch.uint16 if pair["name"] == "max_bin_1023" else torch.uint8)
    np.testing.assert_array_equal(pair["torch"]._inner.train_set.bin_matrix,
                                  pair["binned_j"].bin_matrix)
    res = compare_trees(pair["torch"]._models, pair["jax"]._models,
                        rtol=LEAF_RTOL)
    assert res["ok"], res
    assert all(t.num_leaves == 15 for t in pair["torch"]._models)


def test_row_order_valid_scores_match_jax(pair):
    """The validation set scored on the device during training (its bins
    u16 at max_bin=1023) gives the JAX package's raw predictions and
    AUC; predict on raw rows gives them too."""
    bt = pair["torch"]
    vs = bt._inner.valid_sets[0]
    np.testing.assert_allclose(vs.score.numpy(), pair["raw_vj"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(bt.predict(pair["xv"], raw_score=True),
                               pair["raw_vj"], rtol=0, atol=1e-5)
    auc_t = bt.best_score["valid_0"]["auc"]
    assert abs(auc_t - pair["jax"].best_score["valid_0"]["auc"]) <= 1e-5


def test_row_order_model_text_round_trip(pair):
    """At max_bin=1023 the trees split on bins above 255; the model text
    reloads and serves the training scores."""
    bt = pair["torch"]
    if pair["name"] == "max_bin_1023":
        assert max(int(t.threshold_bin.max()) for t in bt._models) > 255
    text = bt.model_to_string()
    loaded = lgt.Booster(model_str=text, device="cpu")
    assert loaded.model_to_string() == lgt.Booster(
        model_str=loaded.model_to_string(), device="cpu").model_to_string()
    raw = loaded.predict(pair["xt"], raw_score=True)
    score = bt._inner.train_score.numpy().astype(np.float64)
    assert np.all(np.abs(raw - score)
                  <= score_tolerance(score, len(bt._models)))


def test_predict_leaf_bins_on_u16_matches_host_walk(pair):
    """The bin-space walk on u16 bins gives the host walk's leaves."""
    bt = pair["torch"]
    inner = bt._inner
    xv64 = pair["xv"].astype(np.float64)
    bins = inner.valid_sets[0].bins
    for ta_tree in bt._models:
        from lightgbm_tpu_torch.models.gbdt import _bin_tree
        inner_map = {int(o): i for i, o in
                     enumerate(inner.train_set.used_feature_map)}
        got = predict_leaf_bins(_bin_tree(ta_tree, inner_map), bins,
                                inner.dd.num_bins, inner.dd.has_nan)
        np.testing.assert_array_equal(got.numpy(),
                                      ta_tree.predict_leaf(xv64))


def test_valid_set_added_after_training_on_u16():
    """A validation set that joins after trees exist is scored by
    walking the finished trees over its u16 bins."""
    x, y = _data(2600, 5, 41)
    params = dict(WIDE, objective="binary", num_leaves=7, metric="auc",
                  verbosity=-1)
    ds = lgt.Dataset(x[:2000], label=y[:2000])
    bst = lgt.Booster(params, ds, device="cpu")
    for _ in range(3):
        bst.update()
    valid = lgt.Dataset(x[2000:], label=y[2000:], reference=ds)
    bst.add_valid(valid, "late")
    vs = bst._inner.valid_sets[0]
    assert vs.bins.dtype == torch.uint16
    np.testing.assert_allclose(vs.score.numpy(),
                               bst.predict(x[2000:], raw_score=True),
                               rtol=0, atol=1e-5)
