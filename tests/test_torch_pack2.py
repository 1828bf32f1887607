"""pack=2 (``LGBM_TPU_COMB_PACK=2``) in the PyTorch port, on the CPU.

The port keeps each row as one record (``device_data.RecordLayout``,
``PackedRows``) and its pack=2 kernels' plain versions are the pack=1
plain versions over the records' fields, so here:

* the record layout round-trips the five row arrays, pad bytes zero;
* each pack=2 op (init, root histogram, fused split, copyback, refresh
  with the next root histogram) equals its pack=1 op on the same logical
  rows bit for bit, at odd offsets and counts and at ``cnt = 0``;
* the fused split's row order equals the JAX package's pack=2 partition
  kernel (``make_partition_p2`` through the Pallas interpreter) exactly,
  on the harness of ``tests/test_partition_perm.py``;
* the root histogram agrees with the JAX package's pack=2 comb-direct
  histogram within ``4 * n * eps_f32 * max|v|`` (the JAX kernel adds a
  line's even rows, then its odd rows: another order of f32 sums);
* training at pack=2 grows pack=1's trees bit for bit (leaf values and
  counts, structure, training scores) on the default route and under
  ``LGBM_TPU_STREAM=0``, binary and l2, and the JAX package's pack=2
  trees in structure with leaves within 1e-4 of the tree's largest leaf
  (``tests/test_torch_train.py``'s tolerance: the two packages sum in
  other orders).

Inputs are made from seeds with numpy and handed to both packages.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightgbm_tpu_torch as lgt
from chip_smoke import (compare_trees, hist_tolerance, leaves_bitwise,
                        random_row_matrix, rows_on, stream_aux)
from conftest import restore_env_knobs, save_env_knobs
from lightgbm_tpu.ops.pallas.hist_kernel2 import build_histogram_comb as \
    jax_comb_histogram
from lightgbm_tpu.ops.pallas.layout import LANE
from lightgbm_tpu.ops.pallas.partition_kernel3 import make_partition_p2
from lightgbm_tpu_torch.ops.device_data import (RecordLayout,
                                                empty_packed_like,
                                                empty_rows_like,
                                                init_packed_rows, init_rows,
                                                pack_rows)
from lightgbm_tpu_torch.ops.fused_split import fused_split, fused_split_p2
from lightgbm_tpu_torch.ops.hist_kernel2 import (build_histogram_comb,
                                                 build_histogram_comb_p2)
from lightgbm_tpu_torch.ops.partition_kernel import copyback, copyback_p2
from lightgbm_tpu_torch.ops.routing import (RouteDecision, RouteInputs,
                                            decide)
from lightgbm_tpu_torch.ops.stream_grad import (stream_init, stream_init_p2,
                                                stream_refresh,
                                                stream_refresh_p2)

torch.set_num_threads(1)

LEAF_RTOL = 1e-4
N, F, B = 3000, 28, 256
ROUTE_KNOBS = ("LGBM_TPU_PHYS", "LGBM_TPU_STREAM", "LGBM_TPU_FUSED",
               "LGBM_TPU_APPLY_IMPL", "LGBM_TPU_PART_INTERP",
               "LGBM_TPU_COMB_PACK")
# the JAX package's default route off the TPU at pack=2: the real pack=2
# partition kernels through the Pallas interpreter, the Pallas split tail
JAX_PACK2 = {"LGBM_TPU_PHYS": "interpret", "LGBM_TPU_PART_INTERP": "kernel",
             "LGBM_TPU_APPLY_IMPL": "pallas_interpret",
             "LGBM_TPU_COMB_PACK": "2"}
# (s0, cnt, feature, bin, default_left, is_cat, nan_bin)
SPLITS = {
    "whole_nan_left": (0, N, 0, 120, 1, 0, 254),
    "odd_offset_odd_count": (101, 1333, 3, 60, 0, 0, -1),
    "one_row_at_odd_offset": (2001, 1, 5, 200, 0, 0, -1),
    "onehot_categorical": (7, 999, 4, 17, 0, 1, -1),
    "dead_split": (1500, 0, 1, 10, 0, 0, -1),
}
RANGES = {"root": (0, 0, N), "odd_start_odd_count": (333, 5, 1001),
          "past_the_end": (N - 7, 0, 100), "empty": (1500, 0, 0)}


def _rows(n=N, f=F, seed=3):
    """A seeded row matrix (``chip_smoke.random_row_matrix``) with a NaN
    bin of 254 in feature 0, as ``Rows`` and as records."""
    rows = rows_on(random_row_matrix(n, f, seed, nan_bin=254), "cpu")
    return rows, pack_rows(rows)


def _same(a, b) -> bool:
    """Row matrices (or fields) bitwise equal."""
    return all(x.dtype == y.dtype and x.shape == y.shape
               and x.numpy().tobytes() == y.numpy().tobytes()
               for x, y in zip(a, b))


# -- the record layout -----------------------------------------------------

@pytest.mark.parametrize("f,fb,stride", [(6, 8, 48), (28, 28, 64),
                                         (40, 40, 80)])
def test_packed_rows_round_trip(f, fb, stride):
    lay = RecordLayout(f)
    assert (lay.fb, lay.stride) == (fb, stride)
    rows, packed = _rows(257, f, 5)
    assert packed.buf.shape == (257, stride) and packed.buf.is_contiguous()
    assert _same(packed.fields(), rows)
    # the pads: bytes [F, Fb) and [Fb + 28, S) of every record are zero
    pads = torch.cat([packed.buf[:, f:fb], packed.buf[:, fb + 28:]], 1)
    assert pads.numel() == 257 * (stride - f - 28)
    assert not pads.any()
    # the fields are views: a write through them lands in the record
    packed.fields().score[3] = 2.5
    off = fb + 16
    assert packed.buf[3, off:off + 4].view(torch.float32).item() == 2.5


def test_init_packed_rows_matches_init_rows():
    bins = torch.tensor(random_row_matrix(500, 6, 1)[0])
    packed = init_packed_rows(bins)
    assert _same(packed.fields(), init_rows(bins))
    assert not packed.buf[:, 6:8].any()
    scratch = empty_packed_like(packed)
    assert scratch.buf.shape == packed.buf.shape
    assert scratch.layout == packed.layout


# -- each pack=2 op against its pack=1 op on the same logical rows ----------

@pytest.mark.parametrize("kind", ["binary", "l2"])
def test_stream_init_p2_matches_pack1(kind):
    rows, _ = _rows()
    score, valid, consts = stream_aux(N, kind, 7, "cpu")
    kw = dict(kind=kind, sigmoid=1.0)
    p1 = stream_init(rows.bins, score, valid, consts, **kw)
    p2 = stream_init_p2(rows.bins, score, valid, consts, **kw)
    assert p2.layout == RecordLayout(F)
    assert _same(p2.fields(), p1)
    assert not p2.buf[:, F + 28:].any()


@pytest.mark.parametrize("rng", list(RANGES))
def test_hist_comb_p2_matches_pack1(rng):
    rows, packed = _rows()
    r = torch.tensor(RANGES[rng], dtype=torch.int32)
    max_rows = max(RANGES[rng][2], 1)
    h1 = build_histogram_comb(rows, r, padded_bins=B, max_rows=max_rows)
    h2 = build_histogram_comb_p2(packed, r, padded_bins=B,
                                 max_rows=max_rows)
    assert torch.equal(h1.view(torch.int32), h2.view(torch.int32))


@pytest.mark.parametrize("case", list(SPLITS))
def test_fused_split_p2_and_copyback_match_pack1(case):
    """Scratch segment, nleft and both histograms, then the whole row
    matrix after the copyback, bit for bit; rows outside the segment
    untouched."""
    sel = SPLITS[case]
    s0, cnt = sel[0], sel[1]
    rows, packed = _rows()
    before = packed.buf.clone()
    sc1, sc2 = empty_rows_like(rows), empty_packed_like(packed)
    n1 = torch.full((1,), -1, dtype=torch.int32)
    n2 = torch.full((1,), -2, dtype=torch.int32)
    h1 = fused_split(rows, sc1, sel, n1, padded_bins=B)
    h2 = fused_split_p2(packed, sc2, sel, n2, padded_bins=B)
    assert int(n1) == int(n2)
    assert torch.equal(h1.view(torch.int32), h2.view(torch.int32))
    seg = slice(s0, s0 + cnt)
    assert _same([a[seg] for a in sc2.fields()], [a[seg] for a in sc1])
    copyback(rows, sc1, s0, cnt)
    copyback_p2(packed, sc2, s0, cnt)
    assert _same(packed.fields(), rows)
    assert torch.equal(packed.buf[:s0], before[:s0])
    assert torch.equal(packed.buf[s0 + cnt:], before[s0 + cnt:])


@pytest.mark.parametrize("kind", ["binary", "l2"])
def test_stream_refresh_p2_matches_pack1(kind):
    rows, _ = _rows()
    score, valid, consts = stream_aux(N, kind, 8, "cpu")
    kw = dict(kind=kind, sigmoid=1.0)
    p1 = stream_init(rows.bins, score, valid, consts, **kw)
    p2 = stream_init_p2(rows.bins, score, valid, consts, **kw)
    lv = torch.tensor(np.random.default_rng(9).normal(size=N) * 0.1,
                      dtype=torch.float32)
    h1 = stream_refresh(p1, lv, padded_bins=B, **kw)
    h2 = stream_refresh_p2(p2, lv, padded_bins=B, **kw)
    assert _same(p2.fields(), p1)
    assert torch.equal(h1.view(torch.int32), h2.view(torch.int32))


# -- against the JAX package's pack=2 kernels --------------------------------

@pytest.mark.parametrize("cfg", [(64, 400, 3, 15), (65, 401, 3, 15),
                                 (101, 333, 5, 7), (0, 512, 0, 16),
                                 (200, 0, 1, 9), (129, 1, 4, 31)])
def test_fused_split_p2_order_matches_jax_partition_p2(cfg):
    """The port's pack=2 split leaves the logical rows in the order the
    JAX package's pack=2 partition kernel leaves them, exactly: left
    rows in order, right rows reversed, the rest untouched
    (``tests/test_partition_perm.py::test_pack2_kernel_contract``'s
    harness; the port's records carry the same 8 bins and a row id)."""
    r2, size2 = 64, 512
    n2 = size2 + 4 * r2 + 256
    rng = np.random.default_rng(2)
    logical = np.zeros((n2, LANE // 2), np.float32)
    logical[:, :8] = rng.integers(0, 32, size=(n2, 8))
    logical[:, 8] = rng.normal(size=n2)
    s0, cnt, feat, sbin = cfg
    sel = np.zeros((8,), np.int32)
    sel[:4], sel[6] = (s0, cnt, feat, sbin), -1
    part = make_partition_p2(n2, R=r2, size=size2, interpret=True,
                             interpret_kernel=True, cb_block=64)
    packed_j = jnp.asarray(logical.reshape(n2 // 2, LANE))
    out_j, _, nl_j = part(jnp.asarray(sel), packed_j,
                          jnp.zeros_like(packed_j))
    out_j = np.asarray(out_j).reshape(n2, LANE // 2)

    rows = init_rows(torch.tensor(logical[:, :8].astype(np.uint8)))
    rows.vals[:, 0] = torch.tensor(logical[:, 8])
    packed = pack_rows(rows)
    scratch = empty_packed_like(packed)
    nleft = torch.zeros(1, dtype=torch.int32)
    fused_split_p2(packed, scratch, (s0, cnt, feat, sbin, 0, 0, -1), nleft,
                   padded_bins=32)
    copyback_p2(packed, scratch, s0, cnt)
    assert int(nleft) == int(nl_j)
    order = packed.fields().rid.long().numpy()
    np.testing.assert_array_equal(out_j[:, :9], logical[order, :9])


@pytest.mark.parametrize("start,off,count", [(0, 0, 2048), (512, 0, 900),
                                             (513, 0, 901), (77, 3, 333),
                                             (100, 0, 0)])
def test_hist_comb_p2_matches_jax_pack2(start, off, count):
    """The JAX side: ``build_histogram_comb(pack=2, interpret=True)``
    over two logical rows per 128-lane line, values rounded to bf16 as
    its physical path rounds them (``tests/test_torch_hist.py``)."""
    n_alloc, f_pad, b = 2048 + 512, 16, 64
    rng = np.random.default_rng(0)
    logical = np.zeros((n_alloc, LANE // 2), np.float32)
    logical[:, :f_pad] = rng.integers(0, b, size=(n_alloc, f_pad))
    gh = torch.tensor(rng.normal(size=(n_alloc, 2)).astype(np.float32))
    logical[:, f_pad:f_pad + 2] = gh.bfloat16().float().numpy()
    want = np.asarray(jax_comb_histogram(
        jnp.asarray(logical.reshape(n_alloc // 2, LANE)), jnp.int32(start),
        jnp.int32(off), jnp.int32(count), f_pad=f_pad, size=2048,
        padded_bins=b, rows_per_block=256, interpret=True, pack=2))
    rows = init_rows(torch.tensor(logical[:, :f_pad].astype(np.uint8)))
    rows.vals[:, :2] = torch.tensor(logical[:, f_pad:f_pad + 2])
    got = build_histogram_comb_p2(
        pack_rows(rows), torch.tensor([start, off, count], dtype=torch.int32),
        padded_bins=b, max_rows=max(count, 1)).numpy()
    assert got.shape == want.shape == (f_pad, b, 2)
    assert np.abs(got - want).max() <= hist_tolerance(
        rows, (start, off, count))


# -- routing -----------------------------------------------------------------

def test_pack2_route_describe_and_refusal():
    """pack=2 is decided with and without the fused split, and the
    unfused pack=2 route trains (its grower holds records)."""
    fused = decide(RouteInputs(pack_env="2"))
    assert fused.pack == 2
    assert fused.describe() == "path=stream fused=1 tail=kernel pack=2"
    unfused = decide(RouteInputs(pack_env="2", fused_env="0"))
    assert unfused.describe() == ("path=stream fused=0 tail=kernel pack=2 "
                                  "(fused_env_off)")
    assert RouteDecision(stream=True, fused=True, tail="kernel").describe() \
        == "path=stream fused=1 tail=kernel"
    x, y = _data(300, 6, 30, "binary")
    bst = _port_train(PARAMS["binary"], x, y, 1,
                      {"LGBM_TPU_COMB_PACK": "2", "LGBM_TPU_FUSED": "0"})
    grow = bst._inner.grow
    assert grow.route == unfused
    assert grow.rows.buf.shape == (300, 48)
    assert bst._models[0].num_leaves > 1


# -- training --------------------------------------------------------------

PARAMS = {
    "binary": {"objective": "binary", "num_leaves": 15, "verbosity": -1},
    "l2": {"objective": "regression", "num_leaves": 15, "lambda_l2": 1.0,
           "min_data_in_leaf": 10, "verbosity": -1},
}
ROUTES = {"default": {}, "stream_off": {"LGBM_TPU_STREAM": "0"}}


def _data(n, f, seed, objective):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan
    y = (np.nan_to_num(x[:, 0]) + 0.5 * np.nan_to_num(x[:, 1] * x[:, 2])
         + 0.3 * rng.normal(size=n))
    return x, ((y > 0).astype(np.float32) if objective == "binary"
               else y.astype(np.float32))


def _with_env(env, fn):
    saved = save_env_knobs(ROUTE_KNOBS)
    for k in ROUTE_KNOBS:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        return fn()
    finally:
        restore_env_knobs(saved)


def _port_train(params, x, y, rounds, env):
    return _with_env(env, lambda: lgt.train(
        params, lgt.Dataset(x, label=y), num_boost_round=rounds,
        device="cpu"))


def _purge():
    for m in [k for k in list(sys.modules) if k.startswith("lightgbm_tpu")
              and not k.startswith("lightgbm_tpu_torch")]:
        del sys.modules[m]


def _jax_train(params, x, y, rounds, env):
    def run():
        _purge()
        import lightgbm_tpu as lgb
        return lgb.train(params, lgb.Dataset(x, label=y),
                         num_boost_round=rounds)
    try:
        return _with_env(env, run)
    finally:
        _purge()


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("objective", list(PARAMS))
def test_pack2_trains_pack1_trees_and_jax_pack2_trees(objective, route):
    params = PARAMS[objective]
    x, y = _data(2000, 6, 31, objective)
    env = ROUTES[route]
    a = _port_train(params, x, y, 3, env)
    b = _port_train(params, x, y, 3, dict(env, LGBM_TPU_COMB_PACK="2"))
    grow = b._inner.grow
    assert grow.route.pack == 2 and grow.route.fused
    assert grow.route.describe().startswith(
        ("path=stream" if route == "default" else "path=physical")
        + " fused=1 tail=kernel pack=2")
    assert grow.rows.buf.shape == (2000, 48)
    assert len(a._models) == len(b._models) == 3
    for ta, tb in zip(a._models, b._models):
        assert ta.num_leaves == tb.num_leaves > 1
        for k in ("split_feature", "threshold_bin", "decision_type",
                  "left_child", "right_child"):
            assert np.array_equal(getattr(ta, k), getattr(tb, k))
        assert ta.leaf_count.tobytes() == tb.leaf_count.tobytes()
    assert leaves_bitwise(a._models, b._models)
    assert torch.equal(a._inner.train_score, b._inner.train_score)
    if route == "default":
        rows = grow.rows.fields()
        assert torch.equal(rows.score, b._inner.train_score[rows.rid.long()])

    bj = _jax_train(params, x, y, 2, dict(env, **JAX_PACK2))
    assert int(bj._inner.grow.pack) == 2
    res = compare_trees(b._models[:2], bj._models, rtol=LEAF_RTOL)
    assert res["ok"], res
