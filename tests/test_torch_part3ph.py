"""The 3-phase partition route (``LGBM_TPU_PART=3ph``) of the PyTorch port
against the JAX package, on the CPU; the plain stream refresh, the
``LGBM_TPU_POOL_TAIL=0`` tail and the pack rules.

Kernel level: the port's ``partition_3ph_ref`` against the JAX
package's ``make_partition(..., interpret=True)``, the emulation of the
3-phase kernel's contract that moves rows exactly (the compiled TPU
kernel rounds value columns to bf16 on every move, a TPU artifact):
rows packed as its f32 [n, 128] comb (bins, values, row-id bytes,
score, constants), the port's five row arrays beside it.  Tolerance:
none, rows and ``nleft`` are equal.  ``stream_refresh_plain_ref``
against ``make_refresh(root_hist=False, interpret=True)`` with the
tolerances of ``tests/test_torch_stream.py`` (scores of at most 16
significant bits; g*w within 2 ulps, h*w within 4 eps of its maximum).

Training: the port's 3ph route on the CPU against the JAX package's 3ph
route (``LGBM_TPU_PHYS=interpret LGBM_TPU_PART=3ph
LGBM_TPU_APPLY_IMPL=pallas_interpret``; its ``PART_IMPL`` is read when
``lightgbm_tpu.ops.grow`` is imported, so the knobs are set before the
import and its modules purged around each run): equal structure, leaf
values within 1e-4 of the tree's largest leaf, as in
``tests/test_torch_train.py``.  Routes that must grow the default
route's trees do so leaf byte for leaf byte.  Inputs are made with numpy
from a seed.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightgbm_tpu_torch as lgt
from chip_smoke import (compare_trees, leaves_bitwise, random_row_matrix,
                        rows_on)
from conftest import restore_env_knobs, save_env_knobs
from lightgbm_tpu.ops.pallas import stream_grad as jsg
from lightgbm_tpu.ops.pallas.partition_kernel import make_partition
from lightgbm_tpu_torch.convert import rows_from_stream_comb
from lightgbm_tpu_torch.ops.device_data import empty_rows_like
from lightgbm_tpu_torch.ops.partition_kernel import (go_left, partition_3ph,
                                                     partition_3ph_ref)
from lightgbm_tpu_torch.ops.routing import (PACK_RULES, RouteInputs, decide,
                                            inputs_from_env, jax_feature_pad,
                                            resolve_layout)
from lightgbm_tpu_torch.ops.stream_grad import stream_refresh_plain
from lightgbm_tpu_torch.utils.log import LightGBMError
from test_torch_stream import (B as S_B, C as S_C, F as S_F, N as S_N,
                               N_ALLOC as S_N_ALLOC, R as S_R,
                               _assert_rows_match, _inputs, _jax_init,
                               _port_init)
from test_torch_train import CONFIGS, LEAF_RTOL, _data, _purge

torch.set_num_threads(1)

N, C, F, R = 6000, 128, 6, 512
NAN_BIN = 200
KNOBS = ("LGBM_TPU_PHYS", "LGBM_TPU_STREAM", "LGBM_TPU_FUSED",
         "LGBM_TPU_APPLY_IMPL", "LGBM_TPU_PART", "LGBM_TPU_POOL_TAIL",
         "LGBM_TPU_COMB_PACK", "LGBM_TPU_PART_INTERP")
JAX_3PH = {"LGBM_TPU_PHYS": "interpret", "LGBM_TPU_PART": "3ph",
           "LGBM_TPU_APPLY_IMPL": "pallas_interpret"}
# bitset words as i32: word 2 has bit 31 set, word 7 is bit 31 alone
WORDS = [0x0F0F0F0F, 0x12345678, -0x7FFF0000, 0, 0x7FFFFFFF, 0x55555555,
         0x00010001, -0x80000000]

# (s0, cnt, feat, sbin, default_left, is_cat, nan_bin), then any words
CASES = {
    "numerical_nan_left": (70, 2950, 0, 90, 1, 0, NAN_BIN),
    "numerical_nan_right": (513, 1701, 0, 120, 0, 0, NAN_BIN),
    "numerical_no_nan": (0, N, 3, 33, 0, 0, -1),
    "onehot_categorical": (301, 1599, 4, 17, 0, 1, -1),
    "mid_segment": (2047, 1031, 2, 140, 0, 0, -1),
    "bitset_categorical": (129, 4100, 5, 0, 0, 1, -1, 0, *WORDS),
    "bitset_numerical_ignores_words": (11, 3000, 1, 77, 0, 0, -1, 0,
                                       *WORDS),
    "dead_split": (100, 0, 1, 10, 0, 0, -1),
}


def _comb(bins, vals, rid, score, consts):
    """The JAX package's comb rows: bins, (g*w, h*w, w), row-id bytes,
    score and the two constants, f32 [n, 128]."""
    comb = np.zeros((bins.shape[0], C), np.float32)
    comb[:, :F] = bins
    comb[:, F:F + 3] = vals
    comb[:, F + 3] = rid // 65536
    comb[:, F + 4] = (rid // 256) % 256
    comb[:, F + 5] = rid % 256
    comb[:, F + 6] = score
    comb[:, F + 7:F + 9] = consts
    return comb


@pytest.fixture(scope="module")
def rows_np():
    """Seeded rows: bins below 256 with 5% of feature 0 in the NaN bin
    (bins of feature 5 over the whole u8 range, for the bitset)."""
    r = random_row_matrix(N, F, 31, n_bins=NAN_BIN + 1, nan_bin=NAN_BIN)
    r[0][:, 5] = np.random.default_rng(32).integers(0, 256, N)
    return r


def _sel_array(case):
    sel = np.zeros(max(8, len(case)), np.int32)
    sel[:len(case)] = case
    return sel


@pytest.mark.parametrize("case", list(CASES))
def test_partition_3ph_ref_matches_jax(case, rows_np):
    sel = CASES[case]
    s0, cnt = sel[:2]
    part = make_partition(N, C, R=R, size=max(cnt, 1), interpret=True)
    out_j, _, nl_j = part(jnp.asarray(_sel_array(sel)),
                          jnp.asarray(_comb(*rows_np)),
                          jnp.zeros((N, C), jnp.float32))
    out_j = np.asarray(out_j)
    rows = rows_on(rows_np, "cpu")
    nleft = torch.full((1,), -1, dtype=torch.int32)
    partition_3ph(rows, empty_rows_like(rows), sel, nleft)
    assert int(nleft) == int(nl_j)
    seg = slice(s0, s0 + cnt)
    np.testing.assert_array_equal(rows.bins.numpy()[seg], out_j[seg, :F])
    np.testing.assert_array_equal(rows.vals.numpy()[seg],
                                  out_j[seg, F:F + 3])
    rid_j = (out_j[seg, F + 3] * 65536 + out_j[seg, F + 4] * 256
             + out_j[seg, F + 5]).astype(np.int32)
    np.testing.assert_array_equal(rows.rid.numpy()[seg], rid_j)
    np.testing.assert_array_equal(rows.score.numpy()[seg], out_j[seg, F + 6])
    np.testing.assert_array_equal(rows.consts.numpy()[seg],
                                  out_j[seg, F + 7:F + 9])
    # rows outside the segment are untouched
    for a, b in zip(rows, rows_np):
        np.testing.assert_array_equal(a.numpy()[:s0], b[:s0])
        np.testing.assert_array_equal(a.numpy()[s0 + cnt:], b[s0 + cnt:])


def test_partition_3ph_keeps_both_sides_in_order(rows_np):
    """Left rows in ascending original order, then right rows in
    ascending original order (the single-scan kernel reverses them)."""
    sel = CASES["numerical_nan_right"]
    s0, cnt = sel[:2]
    rows = rows_on(rows_np, "cpu")
    nleft = torch.zeros(1, dtype=torch.int32)
    partition_3ph_ref(rows, empty_rows_like(rows), sel, nleft)
    col = rows_np[0][s0:s0 + cnt, 0].astype(np.int64)
    gl = np.where(col == NAN_BIN, False, col <= sel[3])
    nl = int(nleft)
    assert nl == int(gl.sum())
    rid = rows_np[2][s0:s0 + cnt]
    np.testing.assert_array_equal(rows.rid.numpy()[s0:s0 + nl], rid[gl])
    np.testing.assert_array_equal(rows.rid.numpy()[s0 + nl:s0 + cnt],
                                  rid[~gl])


def test_member_bits_exact_for_bit_31():
    """The bitset predicate reads bit ``bin % 32`` of word ``bin // 32``
    as the JAX package's ``_member_bit``, bit 31 of a negative i32 word
    included."""
    col = torch.arange(256, dtype=torch.int32)
    sel = (0, 256, 0, 0, 0, 1, -1, 0, *WORDS)
    got = go_left(col, sel).numpy()
    words = np.array(WORDS, np.int64) & 0xFFFFFFFF
    want = ((words[np.arange(256) >> 5] >> (np.arange(256) & 31)) & 1) > 0
    np.testing.assert_array_equal(got, want)
    assert got[2 * 32 + 31] and got[7 * 32 + 31] and not got[7 * 32 + 30]


@pytest.mark.parametrize("kind,sigmoid", [("binary", 1.0), ("binary", 0.7),
                                          ("l2", 1.0)])
def test_stream_refresh_plain_matches_jax(kind, sigmoid):
    """The inputs of ``test_torch_stream.test_stream_refresh_matches_jax``
    through the refresh without the histogram."""
    inp = _inputs(kind, 2)
    lv = inp[4]
    comb0 = _jax_init(kind, sigmoid, *inp[:4])
    refresh = jsg.make_refresh(kind=kind, sigmoid=sigmoid, f=S_F,
                               n_alloc=S_N_ALLOC, n_pad=S_N, C=S_C, R=S_R,
                               interpret=True, root_hist=False,
                               padded_bins=S_B)
    comb1 = refresh(comb0, jnp.asarray(lv)[None, :])
    port = _port_init(kind, sigmoid, *inp[:4])
    bins0 = port.bins.clone()
    stream_refresh_plain(port, torch.tensor(lv), kind=kind, sigmoid=sigmoid)
    _assert_rows_match(port, rows_from_stream_comb(
        np.asarray(comb1), f=S_F, n=S_N, kind=kind), kind)
    assert torch.equal(port.bins, bins0)


# -- routing ---------------------------------------------------------
def test_3ph_route_is_unfused():
    d = decide(inputs_from_env({"LGBM_TPU_PART": "3ph"}))
    assert (d.stream, d.fused, d.scheme, d.reasons) == (
        True, False, "3ph", ("part_3ph",))
    assert d.describe() == \
        "path=stream scheme=3ph fused=0 tail=kernel (part_3ph)"
    d = decide(inputs_from_env({"LGBM_TPU_PART": "3ph",
                                "LGBM_TPU_STREAM": "0"}))
    assert d.describe() == ("path=physical scheme=3ph fused=0 tail=kernel "
                            "(stream_env_off, part_3ph)")


def test_wide_bins_with_3ph_take_row_order():
    d = decide(inputs_from_env({"LGBM_TPU_PART": "3ph"}, bins_u8=False))
    assert (d.path, d.scheme, d.fused, d.reasons) == (
        "row_order", "none", False, ("non_u8_bins",))


@pytest.mark.parametrize("env,scheme,pool_tail,describe", [
    ({}, "permute", True, "path=stream fused=1 tail=kernel"),
    ({"LGBM_TPU_POOL_TAIL": "0"}, "permute", False,
     "path=stream fused=1 tail=kernel pool_tail=0"),
    ({"LGBM_TPU_POOL_TAIL": "0", "LGBM_TPU_APPLY_IMPL": "xla"}, "permute",
     False, "path=stream fused=1 tail=xla (tail_env_xla)"),
    ({"LGBM_TPU_PART": "ss"}, "permute", True,
     "path=stream fused=1 tail=kernel"),
])
def test_knob_decisions(env, scheme, pool_tail, describe):
    d = decide(inputs_from_env(env))
    assert (d.scheme, d.pool_tail, d.describe()) == (scheme, pool_tail,
                                                      describe)


def test_pack2_decides_pack2_and_raises_naming_b9():
    """pack=2 is decided on the fused route and without the fused split
    (also with the stream off), and the port trains both: the unfused
    pack=2 route's knobs give the route they decide."""
    d = decide(inputs_from_env({"LGBM_TPU_COMB_PACK": "2"}))
    assert (d.pack, d.pack_reasons) == (2, ())
    env = {"LGBM_TPU_COMB_PACK": "2", "LGBM_TPU_FUSED": "0"}
    unfused = decide(inputs_from_env(env))
    assert (unfused.pack, unfused.fused, unfused.scheme) == (2, False,
                                                             "permute")
    off = decide(inputs_from_env(dict(env, LGBM_TPU_STREAM="0")))
    assert (off.pack, off.stream, off.fused) == (2, False, False)
    assert decide(inputs_from_env({})).pack == 1
    x, y = _data(300, 6, 26, "binary")
    p = {"objective": "binary", "num_leaves": 7, "verbosity": -1}
    for e, want in ((env, unfused), (dict(env, LGBM_TPU_STREAM="0"), off)):
        bst = _port_train(p, x, y, 1, e)
        assert bst._inner.grow.route == want
        assert bst._models[0].num_leaves > 1


@pytest.mark.parametrize("kw,reasons", [
    ({"wide_layout": True}, ("pack_layout_too_wide",)),
    ({"part_env": "3ph"}, ("pack_part_3ph",)),
    ({"phys_env": "0"}, ("pack_requires_physical",)),
    ({"bins_u8": False, "part_env": "3ph"}, ("pack_requires_physical",)),
])
def test_pack_rules_keep_pack1(kw, reasons):
    d = decide(RouteInputs(pack_env="2", **kw))
    assert (d.pack, d.pack_reasons) == (1, reasons)
    assert {r.name for r in PACK_RULES} == {"pack_layout_too_wide",
                                            "pack_part_3ph"}


@pytest.mark.parametrize("env,match", [
    ({"LGBM_TPU_PART": "bisect"}, "LGBM_TPU_PART must be ss or 3ph"),
    ({"LGBM_TPU_COMB_PACK": "4"}, "must be 1 or 2"),
])
def test_bad_knob_values_raise(env, match):
    with pytest.raises(LightGBMError, match=match):
        inputs_from_env(env)


@pytest.mark.parametrize("kind,f,b", [("binary", 28, 256), ("binary", 60, 256),
                                      ("l2", 50, 64), ("none", 20, 16),
                                      ("l2", 45, 128), ("binary", 52, 256)])
def test_pack_layout_width_matches_jax(kind, f, b):
    """The port's model of the JAX comb width (padded features plus the
    stream or plain extra columns) decides ``wide_layout`` as the JAX
    package's ``resolve_layout`` does."""
    from lightgbm_tpu.ops import routing as jr
    from lightgbm_tpu.ops.histogram import feature_group_size
    g = feature_group_size(b)
    f_pad = -(-f // g) * g
    assert jax_feature_pad(f, b) == f_pad
    want = jr.resolve_layout(jr.RouteInputs(objective_kind=kind),
                             f_pad=f_pad, padded_bins=b).wide_layout
    got = resolve_layout(RouteInputs(objective_kind=kind), num_features=f,
                         padded_bins=b).wide_layout
    assert got == want


# -- training --------------------------------------------------------
def _jax_train(params, x, y, rounds, env, cat=None):
    saved = save_env_knobs(KNOBS)
    for k in KNOBS:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        _purge()
        import lightgbm_tpu as lgb
        ds = lgb.Dataset(x, label=y, categorical_feature=cat or "auto")
        bst = lgb.train(params, ds, num_boost_round=rounds)
        routing = bst._inner._routing
        return bst, (routing.path, routing.scheme, routing.fused)
    finally:
        restore_env_knobs(saved)
        _purge()


def _port_train(params, x, y, rounds, env, cat=None):
    saved = save_env_knobs(KNOBS)
    for k in KNOBS:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        return lgt.train(params, lgt.Dataset(x, label=y,
                                             categorical_feature=cat
                                             or "auto"),
                         num_boost_round=rounds, device="cpu")
    finally:
        restore_env_knobs(saved)


def _config_data(name, seed):
    cfg = CONFIGS[name]
    x, y = _data(cfg["n"], cfg["f"], seed, cfg.get("objective", "binary"))
    cat = None
    if cfg.get("cat"):
        x[:, 5] = np.random.default_rng(3).integers(0, 3, x.shape[0])
        y = ((y > 0) | (x[:, 5] == 2)).astype(np.float32)
        cat = [5]
    return x, y, cat, dict(cfg["params"], verbosity=-1), cfg["rounds"]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_3ph_route_matches_jax_3ph_route(name):
    """The whole slice: the port's 3ph route on the CPU against the JAX
    package's 3ph route (Pallas split tail in interpret mode), on the
    three configurations of ``tests/test_torch_train.py`` with the data
    of ``test_default_route_matches_jax_default_route`` (seed 23): equal
    structure, leaf values within 1e-4 of the tree's largest leaf, raw
    predictions within the sum of those bounds over the trees."""
    x, y, cat, params, rounds = _config_data(name, 23)
    bj, route_j = _jax_train(params, x, y, rounds, JAX_3PH, cat)
    assert route_j == ("stream", "3ph", False)
    bt = _port_train(params, x, y, rounds, {"LGBM_TPU_PART": "3ph"}, cat)
    assert bt._inner.grow.route.describe() == \
        "path=stream scheme=3ph fused=0 tail=kernel (part_3ph)"
    res = compare_trees(bt._models, bj._models, rtol=LEAF_RTOL)
    assert res["ok"], res
    tol = sum(LEAF_RTOL * float(np.abs(t.leaf_value).max())
              for t in bj._models)
    np.testing.assert_allclose(bt.predict(x, raw_score=True),
                               bj.predict(x, raw_score=True), rtol=0,
                               atol=tol)


def test_exact_tie_broken_by_the_jax_pallas_tail():
    """On ``binary_nan``'s data at seed 11 (``tests/test_torch_train.py``)
    tree 0's 9th split is an exact tie: tree 0's binary gradients take
    two values, and two candidates of feature 1 (bin <= 31 with NaN
    right, bin <= 199 with NaN left) cut off 65 rows of the same labels.
    The JAX package's two split tails break it differently by f32 noise
    on its 3ph route; the port's 3ph route takes the JAX XLA tail's
    candidate.  Not a fault of either package (ROADMAP.md C)."""
    x, y, cat, params, _ = _config_data("binary_nan", 11)
    xla = {"LGBM_TPU_PHYS": "interpret", "LGBM_TPU_PART": "3ph"}
    bj_xla, _ = _jax_train(params, x, y, 1, xla, cat)
    bj_pallas, _ = _jax_train(params, x, y, 1, JAX_3PH, cat)
    bt = _port_train(params, x, y, 1, {"LGBM_TPU_PART": "3ph"}, cat)
    res = compare_trees(bt._models, bj_xla._models, rtol=LEAF_RTOL)
    assert res["ok"], res
    a, b = bj_xla._models[0], bj_pallas._models[0]
    diff = [i for i in range(a.num_leaves - 1)
            if a.threshold_bin[i] != b.threshold_bin[i]]
    assert diff and diff[0] == 8
    assert (a.split_feature[8], b.split_feature[8]) == (1, 1)
    assert (a.threshold_bin[8], b.threshold_bin[8]) == (31, 199)
    assert a.internal_count[8] == b.internal_count[8] == 441
    assert abs(a.split_gain[8] - b.split_gain[8]) <= 1e-4 * a.split_gain[8]


ROUTE_PARAMS = {
    "binary": {"objective": "binary", "num_leaves": 15, "verbosity": -1},
    "l2_lambda": {"objective": "regression", "num_leaves": 31,
                  "lambda_l2": 1.0, "min_data_in_leaf": 10,
                  "verbosity": -1},
}
SAME_TREES = {
    # (route, the route whose trees it must grow bit for bit)
    "pool_tail_off": ({"LGBM_TPU_POOL_TAIL": "0"}, {}),
    "stream_unfused": ({"LGBM_TPU_FUSED": "0"}, {}),
    "3ph_pool_tail_off": ({"LGBM_TPU_PART": "3ph",
                           "LGBM_TPU_POOL_TAIL": "0"},
                          {"LGBM_TPU_PART": "3ph"}),
    "3ph_slice2": ({"LGBM_TPU_PART": "3ph", "LGBM_TPU_STREAM": "0",
                    "LGBM_TPU_APPLY_IMPL": "xla"}, {"LGBM_TPU_PART": "3ph"}),
}


@pytest.mark.parametrize("route", list(SAME_TREES))
@pytest.mark.parametrize("config", list(ROUTE_PARAMS))
def test_route_grows_the_same_trees(config, route):
    """``LGBM_TPU_POOL_TAIL=0`` and the stream route without the fused
    split (the plain refresh, the root histogram per tree) grow the
    default route's trees leaf byte for leaf byte; the 3ph route's own
    variants grow the 3ph route's."""
    params = ROUTE_PARAMS[config]
    env, base_env = SAME_TREES[route]
    x, y = _data(3000, 6, 24, params["objective"])
    a = _port_train(params, x, y, 4, base_env)
    b = _port_train(params, x, y, 4, env)
    assert len(a._models) == len(b._models) == 4
    for ta, tb in zip(a._models, b._models):
        assert ta.num_leaves == tb.num_leaves > 1
        for k in ("split_feature", "threshold_bin", "decision_type",
                  "left_child", "right_child"):
            assert np.array_equal(getattr(ta, k), getattr(tb, k))
    assert leaves_bitwise(a._models, b._models)
    assert torch.equal(a._inner.train_score, b._inner.train_score)
    if not b._inner.grow.route.fused:
        assert b._inner.grow._root_hist is None   # built per tree


def test_3ph_route_differs_from_default_only_by_noise():
    """Reported, not a route identity: the 3ph route's right children
    add their rows in ascending order, so its trees equal the default
    route's in structure here and its leaves within f32 noise."""
    params = ROUTE_PARAMS["binary"]
    x, y = _data(3000, 6, 25, "binary")
    a = _port_train(params, x, y, 3, {})
    b = _port_train(params, x, y, 3, {"LGBM_TPU_PART": "3ph"})
    res = compare_trees(b._models, a._models, rtol=LEAF_RTOL)
    assert res["ok"], res


def test_training_takes_pack2_unfused():
    """``LGBM_TPU_COMB_PACK=2 LGBM_TPU_FUSED=0`` trains on 28 features
    (the records of the main path's width) on the unfused stream route
    at pack=2."""
    x, y = _data(300, 28, 26, "binary")
    bst = _port_train({"objective": "binary", "verbosity": -1}, x, y, 1,
                      {"LGBM_TPU_COMB_PACK": "2", "LGBM_TPU_FUSED": "0"})
    grow = bst._inner.grow
    assert grow.route.describe() == ("path=stream fused=0 tail=kernel "
                                     "pack=2 (fused_env_off)")
    assert grow.rows.buf.shape == (300, 64)
    assert bst._models[0].num_leaves > 1


@pytest.mark.parametrize("env,params,match", [
    ({"LGBM_TPU_COMB_PACK": "2", "LGBM_TPU_PART": "3ph"}, {},
     "requires the single-scan partition kernel; unset LGBM_TPU_PART=3ph"),
    ({"LGBM_TPU_COMB_PACK": "2"}, {"max_bin": 1023},
     "LGBM_TPU_COMB_PACK=2 requires max_bin <= 256"),
    ({"LGBM_TPU_COMB_PACK": "0"}, {}, "must be 1 or 2"),
    ({"LGBM_TPU_PART": "matmul"}, {}, "must be ss or 3ph"),
])
def test_training_refuses_pack2(env, params, match):
    x, y = _data(300, 28, 26, "binary")
    p = dict({"objective": "binary", "verbosity": -1}, **params)
    with pytest.raises(LightGBMError, match=match):
        _port_train(p, x, y, 1, env)


def test_wide_layout_trains_pack1_as_jax_does():
    """60 features at B = 256 do not fit the pack=2 half line: the JAX
    package trains pack=1 there, and so does the port."""
    x, y = _data(500, 60, 27, "binary")
    bst = _port_train({"objective": "binary", "num_leaves": 7,
                       "verbosity": -1}, x, y, 1,
                      {"LGBM_TPU_COMB_PACK": "2"})
    route = bst._inner.grow.route
    assert (route.pack, route.pack_reasons) == (1, ("pack_layout_too_wide",))
