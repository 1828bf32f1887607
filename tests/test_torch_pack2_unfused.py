"""pack=2 without the fused split (``LGBM_TPU_COMB_PACK=2
LGBM_TPU_FUSED=0``) in the PyTorch port, on the CPU.

The unfused pack=2 split is ``partition_scan_p2`` + ``copyback_p2``
(``partition_p2``) and the tree ends with ``stream_refresh_plain_p2``;
their plain versions are the pack=1 plain versions over the records'
fields, so here:

* the pack=2 scan + copyback equals the pack=1 scan + copyback bit for
  bit (every field, ``nleft``, the records outside the segment
  untouched) at odd offsets and counts, a NaN bin routed left, a one-hot
  split and ``cnt = 0``, at 28 features (64-byte records) and at 13
  (``F % 4 != 0``, 48-byte records);
* its row order equals the JAX package's pack=2 partition kernel
  (``make_partition_p2`` through the Pallas interpreter) exactly;
* the pack=2 plain refresh equals the pack=1 plain refresh bit for bit
  and leaves the bins untouched; against the JAX package's pack=2 plain
  refresh kernel (``_refresh_kernel_p2`` through the Pallas interpreter)
  bins, row ids, scores, constants and validity are equal and g*w, h*w
  within the kernel's bf16 rounding: ``|port - jax| <= 2**-8 * |port|``
  (half a bf16 ulp) plus 2 f32 ulps of the largest value (the JAX f32
  ``exp`` and division differ from the port's in the last places before
  that rounding);
* the three knob sets that reach the path decide its routes, and
  training on each, binary and l2, grows the same knobs' pack=1 trees
  bit for bit and the JAX package's pack=2 trees in structure with
  leaves within 1e-4 of the tree's largest leaf.

Inputs are made from seeds with numpy and handed to both packages.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from chip_smoke import compare_trees, leaves_bitwise
from lightgbm_tpu.ops.pallas import stream_grad as jsg
from lightgbm_tpu.ops.pallas.layout import LANE
from lightgbm_tpu.ops.pallas.partition_kernel3 import make_partition_p2
from lightgbm_tpu_torch.convert import rows_from_stream_comb
from lightgbm_tpu_torch.ops.device_data import (empty_packed_like,
                                                empty_rows_like, init_rows,
                                                pack_rows)
from lightgbm_tpu_torch.ops.partition_kernel import (copyback, copyback_p2,
                                                     partition_p2,
                                                     partition_scan,
                                                     partition_scan_p2)
from lightgbm_tpu_torch.ops.routing import decide, inputs_from_env
from lightgbm_tpu_torch.ops.stream_grad import (stream_init_ref,
                                                stream_refresh_plain,
                                                stream_refresh_plain_p2)
from test_torch_pack2 import (JAX_PACK2, PARAMS, SPLITS, _data, _jax_train,
                              _port_train, _rows, _same)
from test_torch_stream import (C as S_C, F as S_F, N as S_N,
                               N_ALLOC as S_N_ALLOC, R as S_R, _inputs)

torch.set_num_threads(1)

LEAF_RTOL = 1e-4
EPS32 = float(np.finfo(np.float32).eps)
# the knob sets that reach the unfused pack=2 path, and their routes
ROUTES = {
    "stream": ({"LGBM_TPU_FUSED": "0"},
               "path=stream fused=0 tail=kernel pack=2 (fused_env_off)"),
    "physical": ({"LGBM_TPU_STREAM": "0", "LGBM_TPU_FUSED": "0"},
                 "path=physical fused=0 tail=kernel pack=2 "
                 "(stream_env_off, fused_env_off)"),
    "slice2": ({"LGBM_TPU_STREAM": "0", "LGBM_TPU_FUSED": "0",
                "LGBM_TPU_APPLY_IMPL": "xla"},
               "path=physical fused=0 tail=xla pack=2 "
               "(stream_env_off, fused_env_off, tail_env_xla)"),
}


# -- the scan + copyback against pack=1 ---------------------------------------

@pytest.mark.parametrize("f", [28, 13])
@pytest.mark.parametrize("case", list(SPLITS))
def test_partition_scan_p2_matches_pack1(case, f):
    """Scratch segment and nleft after the scan, then the whole row
    matrix after the copyback, bit for bit; records outside the segment
    untouched; the one-call ``partition_p2`` leaves the same records."""
    sel = SPLITS[case]
    s0, cnt = sel[0], sel[1]
    rows, packed = _rows(f=f)
    before = packed.buf.clone()
    again = pack_rows(rows)
    sc1, sc2 = empty_rows_like(rows), empty_packed_like(packed)
    n1 = torch.full((1,), -1, dtype=torch.int32)
    n2 = torch.full((1,), -2, dtype=torch.int32)
    partition_scan(rows, sc1, sel, n1)
    partition_scan_p2(packed, sc2, sel, n2)
    assert int(n1) == int(n2)
    seg = slice(s0, s0 + cnt)
    assert _same([a[seg] for a in sc2.fields()], [a[seg] for a in sc1])
    copyback(rows, sc1, s0, cnt)
    copyback_p2(packed, sc2, s0, cnt)
    assert _same(packed.fields(), rows)
    assert torch.equal(packed.buf[:s0], before[:s0])
    assert torch.equal(packed.buf[s0 + cnt:], before[s0 + cnt:])
    n3 = torch.full((1,), -3, dtype=torch.int32)
    partition_p2(again, empty_packed_like(again), sel, n3)
    assert int(n3) == int(n1)
    assert torch.equal(again.buf, packed.buf)


@pytest.mark.parametrize("cfg", [(64, 400, 3, 15), (65, 401, 3, 15),
                                 (101, 333, 5, 7), (0, 512, 0, 16),
                                 (200, 0, 1, 9), (129, 1, 4, 31)])
def test_partition_p2_order_matches_jax_partition_p2(cfg):
    """The unfused pack=2 split leaves the logical rows in the order
    the JAX package's pack=2 partition kernel leaves them, exactly:
    left rows in order, right rows reversed, the rest untouched (its
    real kernel through the Pallas interpreter, not the stable
    emulation its CPU default runs)."""
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
    nleft = torch.zeros(1, dtype=torch.int32)
    partition_p2(packed, empty_packed_like(packed),
                 (s0, cnt, feat, sbin, 0, 0, -1), nleft)
    assert int(nleft) == int(nl_j)
    order = packed.fields().rid.long().numpy()
    np.testing.assert_array_equal(out_j[:, :9], logical[order, :9])


# -- the plain refresh ----------------------------------------------------------

@pytest.mark.parametrize("kind,sigmoid", [("binary", 1.0), ("binary", 0.7),
                                          ("l2", 1.0)])
def test_stream_refresh_plain_p2_matches_pack1(kind, sigmoid):
    bins, score, valid, consts, lv = (torch.tensor(a)
                                      for a in _inputs(kind, 3))
    p1 = stream_init_ref(bins, score, valid, consts, kind=kind,
                         sigmoid=sigmoid)
    p2 = pack_rows(p1)
    before = p2.buf.clone()
    stream_refresh_plain(p1, lv, kind=kind, sigmoid=sigmoid)
    stream_refresh_plain_p2(p2, lv, kind=kind, sigmoid=sigmoid)
    assert _same(p2.fields(), p1)
    fb = p2.layout.fb
    assert torch.equal(p2.buf[:, :fb], before[:, :fb])
    assert not torch.equal(p2.buf, before)


@pytest.mark.parametrize("kind,sigmoid", [("binary", 1.0), ("binary", 0.7),
                                          ("l2", 1.0)])
def test_stream_refresh_plain_p2_matches_jax(kind, sigmoid):
    """The inputs of ``test_torch_stream`` (scores of at most 16
    significant bits, so the JAX layout's bf16x3 score split is exact)
    through the JAX package's pack=2 init reference and its pack=2
    plain refresh kernel, unpacked to one logical row per 64 columns."""
    bins, score, valid, consts, lv = _inputs(kind, 2)
    split = jsg.binary_consts if kind == "binary" else jsg.l2_consts
    aux = jsg.build_aux(kind, jnp.asarray(score), jnp.asarray(valid),
                        split(jnp.asarray(consts[:, 0]),
                              jnp.asarray(consts[:, 1])))
    kw = dict(kind=kind, sigmoid=sigmoid, n_alloc=S_N_ALLOC, n_pad=S_N,
              C=S_C, R=S_R, pack=2)
    init = jsg.make_init(f_real=S_F, f=S_F, interpret=True, **kw)
    comb0 = init(jnp.zeros((S_N_ALLOC // 2, S_C), jnp.float32),
                 jnp.asarray(bins), aux)
    refresh = jsg.make_refresh(f=S_F, kernel_interpret=True, **kw)
    comb1 = np.asarray(refresh(comb0, jnp.asarray(lv)[None, :]))
    jb, jv, jrid, jscore, jconsts = rows_from_stream_comb(
        comb1.reshape(S_N_ALLOC, S_C // 2), f=S_F, n=S_N, kind=kind)

    t = torch.tensor
    port = pack_rows(stream_init_ref(t(bins), t(score), t(valid), t(consts),
                                     kind=kind, sigmoid=sigmoid))
    stream_refresh_plain_p2(port, t(lv), kind=kind, sigmoid=sigmoid)
    got = port.fields()
    np.testing.assert_array_equal(got.bins.numpy(), jb)
    np.testing.assert_array_equal(got.rid.numpy(), jrid)
    np.testing.assert_array_equal(got.score.numpy(), jscore)
    np.testing.assert_array_equal(got.consts.numpy(), jconsts)
    np.testing.assert_array_equal(got.vals[:, 2].numpy(), jv[:, 2])
    for k in (0, 1):
        a, b = got.vals[:, k].numpy(), jv[:, k]
        tol = 2.0 ** -8 * np.abs(a) + 2 * EPS32 * np.abs(a).max()
        assert np.all(np.abs(a - b) <= tol), np.abs(a - b).max()


# -- routing and training --------------------------------------------------------

@pytest.mark.parametrize("route", list(ROUTES))
def test_unfused_pack2_knobs_decide_their_routes(route):
    env, want = ROUTES[route]
    d = decide(inputs_from_env(dict(env, LGBM_TPU_COMB_PACK="2")))
    assert (d.pack, d.fused, d.scheme) == (2, False, "permute")
    assert d.describe() == want


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("objective", list(PARAMS))
def test_unfused_pack2_trains_pack1_trees_and_jax_pack2_trees(objective,
                                                              route):
    params = PARAMS[objective]
    x, y = _data(2000, 6, 31, objective)
    env, want = ROUTES[route]
    a = _port_train(params, x, y, 3, env)
    b = _port_train(params, x, y, 3, dict(env, LGBM_TPU_COMB_PACK="2"))
    grow = b._inner.grow
    assert grow.route.describe() == want
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
    if grow.route.stream:
        rows = grow.rows.fields()
        assert torch.equal(rows.score, b._inner.train_score[rows.rid.long()])

    # the JAX package under the same knobs, its pack=2 kernels through
    # the Pallas interpreter (the route's own tail knob wins)
    bj = _jax_train(params, x, y, 2, dict(JAX_PACK2, **env))
    assert int(bj._inner.grow.pack) == 2 and not bj._inner.grow.fused
    res = compare_trees(b._models[:2], bj._models, rtol=LEAF_RTOL)
    assert res["ok"], res
