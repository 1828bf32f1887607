"""The split tail as one thread-block cluster over the features
(``ops/apply_find.py``), on the CPU.

- ``tail_geometry``: every feature in exactly one block, no empty block,
  at most 16 blocks, each block's shared memory within the card's
  232,448 bytes, at the routes' shapes and at the first shapes it
  refuses.
- ``cluster_winner_ref`` (each block's winner over its feature range,
  then block 0's merge) picks ``find_best_split``'s winner: on seeded
  splits, and on equal keys placed across every block boundary (exact:
  the same ranks).
- Both entries' plain versions against the JAX package's
  ``make_apply_find`` and ``make_apply_find_pool`` run in interpret mode
  at a small shape: the winning feature, bin and direction equal, sums
  and gains within 1e-5 relative (the JAX tail's prefix sums are an f32
  matmul, the port's f64 sums rounded once), the pool rows exactly the
  subtraction trick's.
- ``done`` leaves every state tensor untouched; the routes at
  ``max_bin=1023`` and at 136 features take ``tail=kernel``, and their
  trees are the trees the PyTorch tail grew (bit for bit).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightgbm_tpu.ops.pallas.apply_find as jaf
from chip_smoke import make_higgs_like
from lightgbm_tpu.ops.split import SplitHyperParams as JHP
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.models import gbdt
from lightgbm_tpu_torch.ops.apply_find import (
    BB, BCAT, BDL, BF, MAX_CLUSTER, NO_RANK, PORTABLE_CLUSTER,
    STATIC_RESERVE, apply_find, apply_find_pool, apply_find_pool_ref,
    apply_find_ref, apply_find_supported, block_winners_ref,
    cluster_winner_ref, tail_geometry, tail_smem_bytes)
from lightgbm_tpu_torch.ops.hist_kernel2 import MAX_SMEM
from lightgbm_tpu_torch.ops.split import (_candidate_tensors,
                                          find_best_split, selection_key)
from lightgbm_tpu_torch.tools.profile_apply_find import (_h2,
                                                         synthetic_split)

torch.set_num_threads(1)

RTOL = 1e-5
SHAPES = [(28, 256), (28, 1024), (136, 256), (136, 1024), (208, 1024),
          (832, 256), (1, 16), (17, 64)]


def _covers(geo, f):
    owner = [k for k, (lo, hi) in enumerate(geo.ranges(f))
             for _ in range(lo, hi)]
    return owner == sorted(owner) and len(owner) == f and all(
        hi > lo for lo, hi in geo.ranges(f))


@pytest.mark.parametrize("f,b", SHAPES)
def test_geometry_covers_every_feature_once(f, b):
    geo = tail_geometry(f, b)
    assert geo is not None and apply_find_supported(f, b)
    assert _covers(geo, f)
    assert 1 <= geo.blocks <= MAX_CLUSTER
    assert geo.smem == tail_smem_bytes(geo.feats, b)
    assert geo.smem + STATIC_RESERVE <= MAX_SMEM == 232_448


@pytest.mark.parametrize("f,b", [(209, 1024), (833, 256), (28, 12),
                                 (0, 256)])
def test_geometry_refuses_what_16_blocks_cannot_hold(f, b):
    """The first shapes past the budget (13 features a block at B = 1024,
    52 at B = 256, sixteen blocks), bins not a multiple of 8 and no
    features: no geometry, and the route's tail_smem rule."""
    assert tail_geometry(f, b) is None and not apply_find_supported(f, b)
    if f:
        assert apply_find_supported(f - 1, b) or b % 8


@pytest.mark.parametrize("max_blocks", [1, 2, 4, 8, 16])
def test_geometry_at_each_cluster_size(max_blocks):
    geo = tail_geometry(28, 256, max_blocks)
    assert _covers(geo, 28) and geo.blocks <= max_blocks
    # fewer blocks than asked only where a block's share rounds up
    assert geo.blocks == -(-28 // -(-28 // max_blocks))


def test_geometry_refuses_a_share_that_does_not_fit():
    """At B = 1024 eight blocks of 17 features do not fit a block's
    shared memory, sixteen of 9 do (one cluster above the portable 8)."""
    assert tail_geometry(136, 1024, 8) is None
    assert 17 * (17 * 1024 + 24) > MAX_SMEM - STATIC_RESERVE
    geo = tail_geometry(136, 1024)
    assert (geo.blocks, geo.feats) == (16, 9)
    assert geo.blocks > PORTABLE_CLUSTER


def test_smem_formula_is_the_kernels_layout():
    """Both children's [feats, B, 2] f32 histograms, [2, feats, 2] f32
    NaN-bin values, the NaN bin and categorical flag (i32 each), one
    validity byte a (feature, bin)."""
    feats, b = 9, 1024
    layout = 2 * feats * b * 2 * 4 + 2 * feats * 2 * 4 + 2 * feats * 4 \
        + feats * b
    assert tail_smem_bytes(feats, b) == layout


def _keys_and_winner(case):
    """The candidates' selection keys [2, F * 2B] in rank order and
    find_best_split's winning rank per child, on ``case``'s children."""
    h2 = _h2(case)
    brow = case.st.best[case.at.leaf]
    lrow = case.st.lstate[case.at.leaf]
    sg = torch.stack([brow[5], lrow[0] - brow[5]])
    sh = torch.stack([brow[6], lrow[1] - brow[6]])
    cc = torch.stack([brow[7], lrow[2] - brow[7]])
    fc, f, b = case.fc, h2.shape[1], h2.shape[2]
    args = (h2, sg, sh, cc, fc.num_bins, fc.has_nan, fc.is_cat, case.fmask,
            torch.ones(2, dtype=torch.bool), case.hp)
    gains = _candidate_tensors(*args)[0]
    keys = selection_key(gains.permute(0, 2, 1, 3).reshape(2, -1))
    si = find_best_split(*args)
    rank = (si.feature * 2 * b + si.default_left.long() * b
            + si.threshold_bin)
    return keys, rank


@pytest.mark.parametrize("f,b,seed", [(28, 256, 0), (28, 1024, 1),
                                      (136, 256, 2), (17, 64, 3)])
def test_decomposition_picks_find_best_splits_winner(f, b, seed):
    case = synthetic_split(f, b, seed=seed, cnt=100_000, leaves=9)
    keys, rank = _keys_and_winner(case)
    geos = {tail_geometry(f, b, m) for m in (1, 4, 8, 16)} - {None}
    assert len(geos) >= 2
    for geo in geos:
        assert torch.equal(cluster_winner_ref(keys, geo, b), rank)


@pytest.mark.parametrize("f,b,max_blocks", [(28, 256, 16), (28, 256, 4),
                                            (136, 256, 16), (28, 1024, 16),
                                            (17, 64, 8)])
def test_decomposition_breaks_ties_across_every_block_boundary(
        f, b, max_blocks):
    """A strong feature at the end of every block copied into the first
    feature of the next: each pair's keys are equal across a boundary,
    and the smaller feature of the best pair wins, as in
    find_best_split."""
    geo = tail_geometry(f, b, max_blocks)
    js = tuple(k * geo.feats - 1 for k in range(1, geo.blocks))
    case = synthetic_split(f, b, cnt=100_000, leaves=9, ties=js, strong=js)
    keys, rank = _keys_and_winner(case)
    got = cluster_winner_ref(keys, geo, b)
    assert torch.equal(got, rank)
    assert all(int(r) // (2 * b) in js for r in got)
    bq, br = block_winners_ref(keys, geo, b)
    for r in got:       # the pair's second key is equal, in the next block
        k = int(r) // (2 * b) // geo.feats
        assert bq[0, k] == bq[0, k + 1] or bq[1, k] == bq[1, k + 1]


def test_decomposition_on_equal_keys_everywhere_and_nan():
    """Every key equal: rank 0 in block 0 wins; a block of NaN keys keeps
    no rank and loses the merge; the winner in the last block."""
    f, b = 28, 256
    geo = tail_geometry(f, b)
    n = f * 2 * b
    keys = torch.full((3, n), 5.0)
    keys[1, : geo.feats * 2 * b] = float("nan")
    keys[2] = float("-inf")
    last = (f - 1) * 2 * b + b + 7
    keys[2, last] = 1.0
    bq, br = block_winners_ref(keys, geo, b)
    assert int(br[1, 0]) == NO_RANK and bq[1, 0] == float("-inf")
    assert cluster_winner_ref(keys, geo, b).tolist() == [
        0, geo.feats * 2 * b, last]


@pytest.mark.parametrize("f,b", [(28, 1024), (136, 256)])
def test_done_leaves_every_tensor_untouched(f, b):
    case = synthetic_split(f, b, cnt=100_000, leaves=9)
    done = case.at._replace(done=1)
    for entry, hists in ((apply_find_pool, (case.h_a, case.h_b)),
                         (apply_find, (_h2(case),))):
        st = case.clone()
        entry(*hists, *st.args()[:-1], done)
        assert all(torch.equal(a, b) for a, b in zip(st.st, case.st))


# -- the plain versions against the JAX package's kernels in interpret mode
L, F_J, B_J = 9, 6, 128


def _jax_interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode
    (``make_apply_find_pool`` has no interpret switch of its own)."""
    real = jaf.pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        k.pop("compiler_params", None)
        return real(*a, **k)
    monkeypatch.setattr(jaf.pl, "pallas_call", interp)


def _jax_inputs(case):
    fc, at = case.fc, case.at
    sel_f = np.concatenate([case.st.best[at.leaf].numpy(),
                            case.st.lstate[at.leaf].numpy(), np.zeros(6)])
    consts = jaf.build_finder_consts(jnp.asarray(fc.num_bins.numpy()),
                                     jnp.asarray(fc.has_nan.numpy()),
                                     jnp.asarray(fc.is_cat.numpy()), B_J)
    return sel_f, consts


def _channel_second(h):
    """[..., F, B, 2] -> the JAX layout [..., F, 4, B]."""
    h = h.numpy()
    out = np.zeros(h.shape[:-2] + (4, h.shape[-2]), np.float32)
    out[..., :2, :] = np.swapaxes(h, -1, -2)
    return jnp.asarray(out)


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    same_inf = np.isinf(a) & np.isinf(b) & (np.sign(a) == np.sign(b))
    with np.errstate(invalid="ignore"):
        return bool(np.all(same_inf | (np.abs(a - b)
                                       <= RTOL * np.maximum(np.abs(b),
                                                            1e-6))))


def _assert_rows_match(port, best_j, lstate_j, seg_j, at):
    for tgt in (at.leaf, at.right):
        bt, bj = port.best[tgt].numpy(), np.asarray(best_j)[tgt]
        np.testing.assert_array_equal(bt[[BF, BB, BDL, BCAT]],
                                      bj[[BF, BB, BDL, BCAT]])
        assert _close(bt, bj), (bt, bj)
        assert _close(port.lstate[tgt].numpy(), np.asarray(lstate_j)[tgt])
        np.testing.assert_array_equal(port.seg[tgt].numpy(),
                                      np.asarray(seg_j)[tgt])


def _small_case():
    return synthetic_split(F_J, B_J, seed=5, cnt=5000, leaves=L,
                           strong=(2,))


def test_plain_entry_matches_jax_make_apply_find(monkeypatch):
    _jax_interpret(monkeypatch)
    case = _small_case()
    h2 = _h2(case)
    port = case.clone()
    apply_find_ref(h2, *port.args())
    sel_f, consts = _jax_inputs(case)
    at = case.at
    sel_i = jnp.array([at.leaf, at.right, at.node, 0, int(case.nleft),
                       at.s0, at.cnt, 0], jnp.int32)
    fn = jaf.make_apply_find(JHP(), L=L, f=F_J, b=B_J, max_depth=-1)
    out = fn(sel_i, jnp.asarray(sel_f, jnp.float32), _channel_second(h2),
             jnp.ones((1, F_J)), consts,
             jnp.asarray(case.fc.is_cat.numpy().astype(np.int32)),
             jnp.zeros((F_J,), jnp.int32), jnp.asarray(case.st.best.numpy()),
             jnp.asarray(case.st.lstate.numpy()),
             jnp.zeros((L - 1, 10), jnp.float32),
             jnp.asarray(case.st.seg.numpy()))
    _assert_rows_match(port.st, out[0], out[1], out[3], at)


def test_pool_entry_matches_jax_make_apply_find_pool(monkeypatch):
    _jax_interpret(monkeypatch)
    case = _small_case()
    port = case.clone()
    apply_find_pool_ref(case.h_a, case.h_b, *port.args())
    sel_f, consts = _jax_inputs(case)
    at = case.at
    sel_i = jnp.array([at.leaf, at.right, at.node, 0, int(case.nleft),
                       at.s0, at.cnt, 1], jnp.int32)
    fn = jaf.make_apply_find_pool(JHP(), L=L, f=F_J, b=B_J, max_depth=-1)
    out = fn(sel_i, jnp.asarray(sel_f, jnp.float32),
             _channel_second(case.h_a), jnp.ones((1, F_J)), consts,
             jnp.asarray(case.fc.is_cat.numpy().astype(np.int32)),
             jnp.zeros((F_J,), jnp.int32), jnp.asarray(case.st.best.numpy()),
             jnp.asarray(case.st.lstate.numpy()),
             jnp.zeros((L - 1, 10), jnp.float32),
             jnp.asarray(case.st.seg.numpy()), _channel_second(case.st.pool))
    _assert_rows_match(port.st, out[0], out[1], out[3], at)
    pool_j = np.asarray(out[4])[:, :, :2, :].swapaxes(-1, -2)
    np.testing.assert_array_equal(port.st.pool.numpy(), pool_j)


# -- the routes that the cluster puts on the kernel tail -------------------
def _train(x, y, params, tail_ok_rule=None, monkeypatch=None):
    if tail_ok_rule is not None:
        monkeypatch.setattr(gbdt, "apply_find_supported", tail_ok_rule)
    return lgt.train(dict(params, verbosity=-1), lgt.Dataset(x, label=y), 2,
                     device="cpu")


@pytest.mark.parametrize("features,max_bin,route", [
    (28, 1023, "path=row_order fused=0 tail=kernel (non_u8_bins)"),
    (136, 255, "path=stream fused=0 tail=kernel (fused_smem)"),
])
def test_routes_take_the_kernel_tail_and_grow_the_same_trees(
        features, max_bin, route, monkeypatch):
    """The row-order route at max_bin=1023 and the wide route name
    tail=kernel; their trees equal, bit for bit, those of the same route
    with the tail the rules gave before (the PyTorch tail, forced here
    through the tail_smem rule)."""
    x, y = make_higgs_like(1500, features, seed=features)
    params = {"objective": "binary", "num_leaves": 7, "max_bin": max_bin,
              "min_data_in_bin": 1}
    now = _train(x, y, params)
    assert now._inner.grow.route.describe() == route
    before = _train(x, y, params, lambda f, b: False, monkeypatch)
    assert before._inner.grow.route.tail == "xla"
    assert "tail_smem" in before._inner.grow.route.describe()
    for a, b in zip(now._models, before._models):
        assert a.num_leaves == b.num_leaves
        assert np.array_equal(a.split_feature, b.split_feature)
        assert np.array_equal(a.threshold_bin, b.threshold_bin)
        assert a.leaf_value.tobytes() == b.leaf_value.tobytes()
