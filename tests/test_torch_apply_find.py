"""The port's split tail (``ops/apply_find.py``) against the JAX
package's ``make_apply_find(..., interpret=True)``, on the CPU.

Both take the same two children's histograms and the same parent rows:
a real split of seeded Higgs-style rows (10 % NaN, one one-hot
categorical feature, 128 padded bins, the width the JAX tail needs),
the root's state built by the port's grower and its best split applied
by the fused split.  The JAX side gets the histograms in its
channel-second ``[2, F, 4, B]`` layout and its own
``build_finder_consts``.

Tolerances: the winning feature, bin and default direction of each
child are equal, and so are the seg rows; gains, sums and outputs agree
within 1e-5 relative (the JAX interpret tail's prefix sums are an f32
matmul, the port's f64 sums rounded once); the pool rows are exactly
the subtraction trick's; ``done`` leaves every state row untouched.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from chip_smoke import make_higgs_like, random_row_matrix, split_state
from lightgbm_tpu.ops.pallas.apply_find import (
    build_finder_consts as jax_finder_consts, make_apply_find)
from lightgbm_tpu.ops.split import SplitHyperParams as JHP
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops.apply_find import (BB, BCAT, BDL, BF, TreeState,
                                               apply_find, apply_find_pool,
                                               apply_find_ref,
                                               apply_find_supported,
                                               build_finder_consts)
from lightgbm_tpu_torch.ops.device_data import init_rows, to_device
from lightgbm_tpu_torch.ops.grow import SerialGrower, StreamSpec
from lightgbm_tpu_torch.ops.routing import RouteInputs, decide
from lightgbm_tpu_torch.ops.split import SplitHyperParams

torch.set_num_threads(1)

L = 15
RTOL = 1e-5
HPS = {
    "default": {},
    "l1_l2_max_delta": {"lambda_l1": 0.5, "lambda_l2": 1.0,
                        "max_delta_step": 0.3},
    "path_smooth": {"path_smooth": 2.0, "min_data_in_leaf": 5},
    "min_gain": {"min_gain_to_split": 5.0, "min_sum_hessian_in_leaf": 1.0},
}


def _hp(kw):
    t = SplitHyperParams(use_smoothing=kw.get("path_smooth", 0.0) > 0, **kw)
    j = JHP(use_smoothing=t.use_smoothing, **kw)
    return t, j


def _split(hp, max_depth=-1, monotone=None):
    x, y = make_higgs_like(5000, 6, seed=8)
    x[np.random.default_rng(8).random(x.shape) < 0.1] = np.nan
    x[:, 5] = np.random.default_rng(9).integers(0, 4, 5000)
    ds = lgt.Dataset(x, label=y, categorical_feature=[5],
                     params={"max_bin": 127}).construct()
    dd = to_device(ds._binned, torch.device("cpu"))
    assert dd.padded_bins == 128
    grower = SerialGrower(hp, num_leaves=L, max_depth=max_depth, dd=dd,
                          route=decide(RouteInputs()),
                          stream=StreamSpec("binary", 1.0),
                          monotone=monotone)
    rows = init_rows(dd.bins)
    rows.vals.copy_(torch.as_tensor(random_row_matrix(5000, 1, 10)[1]))
    st, pair, nleft, fmask, at = split_state(grower, rows)
    return grower, st, pair, nleft, fmask, at


def _copy(st):
    return TreeState(*(a.clone() for a in st))


def _jax_tail(hp_j, grower, st, h2, nleft, fmask, at, done=0, mono=None):
    """The JAX tail on the port's inputs; ``mono`` the features' monotone
    signs (its ``mono_s`` operand and the consts' fifth row), zeros when
    None."""
    dd = grower.dd
    f, b = dd.num_features, dd.padded_bins
    h4 = np.zeros((2, f, 4, b), np.float32)
    h4[:, :, :2, :] = h2.numpy().transpose(0, 1, 3, 2)
    sel_i = np.array([at.leaf, at.right, at.node, done, int(nleft), at.s0,
                      at.cnt, 0], np.int32)
    sel_f = np.concatenate([st.best[at.leaf].numpy(),
                            st.lstate[at.leaf].numpy(), np.zeros(6)])
    mono_s = jnp.asarray(np.zeros(f, np.int32) if mono is None else mono,
                         jnp.int32)
    consts = jax_finder_consts(jnp.asarray(dd.num_bins.numpy()),
                               jnp.asarray(dd.has_nan.numpy()),
                               jnp.asarray(dd.is_cat.numpy()), b,
                               monotone=None if mono is None else mono_s)
    fn = make_apply_find(hp_j, L=L, f=f, b=b, max_depth=grower.max_depth,
                         interpret=True)
    out = fn(jnp.asarray(sel_i), jnp.asarray(sel_f, jnp.float32),
             jnp.asarray(h4), jnp.asarray(fmask.numpy()[None]), consts,
             jnp.asarray(dd.is_cat.numpy().astype(np.int32)),
             mono_s, jnp.asarray(st.best.numpy()),
             jnp.asarray(st.lstate.numpy()),
             jnp.zeros((L - 1, 10), jnp.float32),
             jnp.asarray(st.seg.numpy()))
    return [np.asarray(a) for a in out]


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    same_inf = np.isinf(a) & np.isinf(b) & (np.sign(a) == np.sign(b))
    scale = np.maximum(np.abs(b), 1e-6)
    with np.errstate(invalid="ignore"):
        return bool(np.all(same_inf | (np.abs(a - b) <= RTOL * scale)))


@pytest.mark.parametrize("name", list(HPS))
def test_apply_find_ref_matches_jax(name):
    hp_t, hp_j = _hp(HPS[name])
    grower, st, pair, nleft, fmask, at = _split(hp_t)
    # the children's histograms by the subtraction trick (pool entry)
    sp = _copy(st)
    apply_find_pool(pair[0], pair[1], nleft, sp, grower.finder, fmask, hp_t,
                    grower.max_depth, at)
    h2 = torch.stack([sp.pool[at.leaf], sp.pool[at.right]])
    port = _copy(st)
    apply_find_ref(h2, nleft, port, grower.finder, fmask, hp_t,
                   grower.max_depth, at)
    best_j, lstate_j, nodes_j, seg_j = _jax_tail(hp_j, grower, st, h2, nleft,
                                                 fmask, at)
    for tgt in (at.leaf, at.right):
        bt, bj = port.best[tgt].numpy(), best_j[tgt]
        np.testing.assert_array_equal(bt[[BF, BB, BDL, BCAT]],
                                      bj[[BF, BB, BDL, BCAT]])
        assert _close(bt, bj), (bt, bj)
        assert _close(port.lstate[tgt].numpy(), lstate_j[tgt])
        np.testing.assert_array_equal(port.seg[tgt].numpy(), seg_j[tgt])
    assert _close(port.nodes[at.node].numpy(), nodes_j[at.node][[2, 7, 8, 9]])
    # the pool entry wrote the same rows as the plain entry
    for a, b in zip(sp[1:], port[1:]):
        assert torch.equal(a, b)


def test_pool_rows_are_the_subtraction():
    hp_t, _ = _hp({})
    grower, st, pair, nleft, fmask, at = _split(hp_t)
    nl = int(nleft)
    small_left = nl * 2 <= at.cnt
    h_small = pair[0] if small_left else pair[1]
    parent = st.pool[at.leaf].clone()
    sp = _copy(st)
    apply_find_pool(pair[0], pair[1], nleft, sp, grower.finder, fmask, hp_t,
                    grower.max_depth, at)
    h_left = h_small if small_left else parent - h_small
    assert torch.equal(sp.pool[at.leaf], h_left)
    assert torch.equal(sp.pool[at.right], parent - h_left)
    assert torch.equal(sp.seg[at.leaf], torch.tensor([0, nl],
                                                     dtype=torch.int32))
    assert torch.equal(sp.seg[at.right], torch.tensor(
        [nl, at.cnt - nl], dtype=torch.int32))


def test_done_leaves_every_state_row_untouched():
    hp_t, hp_j = _hp({})
    grower, st, pair, nleft, fmask, at = _split(hp_t)
    done = at._replace(done=1)
    for entry, hist in ((apply_find_pool, (pair[0], pair[1])),
                        (apply_find, (pair,))):
        sk = _copy(st)
        entry(*hist, nleft, sk, grower.finder, fmask, hp_t,
              grower.max_depth, done)
        for a, b in zip(sk, st):
            assert torch.equal(a, b)
    best_j, lstate_j, _, seg_j = _jax_tail(hp_j, grower, st, pair, nleft,
                                           fmask, at, done=1)
    np.testing.assert_array_equal(best_j, st.best.numpy())
    np.testing.assert_array_equal(lstate_j, st.lstate.numpy())
    np.testing.assert_array_equal(seg_j, st.seg.numpy())


def test_max_depth_blocks_both_children():
    """At max_depth the children get no valid split: gain -inf, the
    winner falls to rank 0, as in the JAX tail."""
    hp_t, hp_j = _hp({})
    grower, st, pair, nleft, fmask, at = _split(hp_t, max_depth=1)
    port = _copy(st)
    apply_find_ref(pair, nleft, port, grower.finder, fmask, hp_t,
                   grower.max_depth, at)
    best_j = _jax_tail(hp_j, grower, st, pair, nleft, fmask, at)[0]
    for tgt in (at.leaf, at.right):
        assert port.best[tgt, 0] == float("-inf") == best_j[tgt, 0]
        assert port.best[tgt, BF] == 0 == best_j[tgt, BF]


def test_finder_consts_match_jax():
    hp_t, _ = _hp({})
    grower = _split(hp_t)[0]
    dd = grower.dd
    want = np.asarray(jax_finder_consts(
        jnp.asarray(dd.num_bins.numpy()), jnp.asarray(dd.has_nan.numpy()),
        jnp.asarray(dd.is_cat.numpy()), dd.padded_bins))
    got = build_finder_consts(dd.num_bins, dd.has_nan, dd.is_cat,
                              dd.padded_bins).masks.numpy()
    # one difference: bin 0 of a categorical feature (other, NaN,
    # unseen) is no one-hot candidate in the port (ROADMAP C)
    cat = dd.is_cat.numpy()
    assert cat.any() and (want[0, cat, 0] == 1).all()
    assert (got[0, cat, 0] == 0).all()
    want = want[:4].copy()
    want[0, cat, 0] = 0
    np.testing.assert_array_equal(got, want)
    assert apply_find_supported(28, 256) and not apply_find_supported(209,
                                                                      1024)
