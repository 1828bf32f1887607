"""Sorted-subset categorical splits in the PyTorch port against the JAX
package, on the CPU.

* The split search: ``cat_subset_rank``, ``cat_subset_member``,
  ``find_best_split`` and ``per_feature_best_gain`` with the subset
  search on, against the JAX package's functions on seeded histograms
  (ties of the ratio, ``cat_smooth`` 0, ``max_cat_threshold``,
  ``min_data_per_group``, ``cat_l2``, path smoothing).  The candidates,
  ranks and members are equal; the winner's feature, encoded threshold
  and direction are equal, its gain and sums within 1e-5 relative (the
  port takes the rank-order prefix sums in f64 and rounds once, the JAX
  package sums in f32).  The histograms leave bin 0 of a categorical
  feature empty where the JAX package is the reference: the port never
  makes bin 0 (other, NaN, unseen) a categorical candidate, subset or
  one-hot, which ``test_bin0_is_never_a_subset_member`` pins.
* Bin 0 in training: the JAX package trains splits that send bin 0
  left and serves those rows right (its fault, witnessed for both
  searches); the port's trees are the JAX package's up to the first
  such split and differ there.
* The words: ``members_to_words`` equals ``_members_to_words`` bit for
  bit (bit 31 of every word included) and ``go_left`` reads them back.
* The plain partitions and the fused split with 8 membership words,
  against the JAX package's kernels in interpret mode with a descriptor
  of 16 slots (``make_partition_perm``, ``make_partition_p2``,
  ``make_partition``, ``make_fused_split``): rows and ``nleft`` equal.
* Training: the port's trees on the default route, pack=2, both
  ``FUSED=0`` routes, 3ph and ``max_bin`` 1023 against the JAX
  package's on ``tests/test_cat_physical.py``'s problem and knobs:
  equal structure, equal ``cat_threshold`` bytes, leaves within 1e-4 of
  the tree's largest leaf (``tests/test_torch_train.py``'s tolerance);
  the port's routes against each other bit for bit (3ph, whose right
  rows come in another order, within the same tolerance).
* Predictions on negative, unseen and NaN categories, the model text's
  round trip, the holdout's bitset walk, ``host_reads`` (one a split)
  and the routing decisions (``tail=xla``, ``cat_overwide``).
"""
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightgbm_tpu_torch as lgt
from chip_smoke import compare_trees, leaves_bitwise, random_row_matrix, \
    rows_on
from conftest import restore_env_knobs, save_env_knobs
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu.ops.pallas.fused_split import make_fused_split
from lightgbm_tpu.ops.pallas.layout import LANE
from lightgbm_tpu.ops.pallas.partition_kernel import make_partition
from lightgbm_tpu.ops.pallas.partition_kernel3 import (make_partition_p2,
                                                       make_partition_perm)
from lightgbm_tpu.ops.predict import _members_to_words
from lightgbm_tpu_torch.ops import routing as troute
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops.device_data import (empty_packed_like,
                                                empty_rows_like, init_rows,
                                                pack_rows)
from lightgbm_tpu_torch.ops.fused_split import fused_split, fused_split_p2
from lightgbm_tpu_torch.ops.grow import predict_leaf_bins
from lightgbm_tpu_torch.ops.hist_kernel2 import build_histogram_comb_ref
from lightgbm_tpu_torch.ops.descriptor import (MAX_MEMBER_WORDS, member_words,
                                               members_to_words)
from lightgbm_tpu_torch.ops.partition_kernel import (
    copyback, copyback_p2, go_left, partition_3ph, partition_p2,
    partition_ref)
from lightgbm_tpu_torch.utils.log import LightGBMError
from test_cat_physical import _cat_problem, _fresh_train, _kernel_env

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
LEAF_RTOL = 1e-4
GAIN_RTOL = 1e-5


# -- the split search ---------------------------------------------------------

F, B = 6, 64
NUM_BINS = np.array([40, 64, 3, 50, 20, 33], np.int32)
IS_CAT = np.array([1, 0, 1, 1, 1, 1], bool)
HAS_NAN = np.zeros(F, bool)


def _hist(seed: int, ties: bool = False) -> np.ndarray:
    """A seeded [F, B, 2] histogram: counts below 60 a bin, bin 0 of the
    categorical features empty; ``ties`` repeats (g, h) pairs so that
    several bins share one ratio."""
    rng = np.random.default_rng(seed)
    h = np.zeros((F, B, 2), np.float32)
    for f in range(F):
        nb = NUM_BINS[f]
        cnt = rng.integers(0, 60, size=nb).astype(np.float32)
        if IS_CAT[f]:
            cnt[0] = 0
        g = (rng.normal(size=nb) * cnt * 0.3).astype(np.float32)
        hh = (cnt * 0.25).astype(np.float32)
        if ties:
            src = rng.integers(1, nb, size=nb // 3)
            dst = rng.integers(1, nb, size=nb // 3)
            g[dst], hh[dst] = g[src], hh[src]
        h[f, :nb, 0], h[f, :nb, 1] = g, hh
    return h


def _totals(h):
    sh = np.float32(h[1, :, 1].sum())
    return np.float32(h[1, :, 0].sum()), sh, np.float32(sh * 4)


HP_CASES = {
    "defaults": dict(min_data_per_group=5, cat_smooth=2.0),
    "ties": dict(min_data_per_group=5, cat_smooth=2.0),
    "cat_smooth_0": dict(min_data_per_group=5, cat_smooth=0.0),
    "max_cat_threshold_4": dict(min_data_per_group=5, cat_smooth=2.0,
                                max_cat_threshold=4),
    "min_data_per_group_50": dict(min_data_per_group=50, cat_smooth=2.0),
    "cat_l2_30": dict(min_data_per_group=5, cat_smooth=10.0, cat_l2=30.0),
    "path_smooth": dict(min_data_per_group=5, cat_smooth=2.0,
                        path_smooth=3.0),
}


def _hps(kw):
    kw = dict(kw, min_data_in_leaf=3, use_cat_subset=True,
              max_cat_to_onehot=4)
    t_kw = dict(kw, use_smoothing=kw.get("path_smooth", 0.0) > 0)
    return jsplit.SplitHyperParams(**t_kw), tsplit.SplitHyperParams(**t_kw)


@pytest.mark.parametrize("case", list(HP_CASES))
def test_cat_subset_rank_and_member_match_jax(case):
    jhp, thp = _hps(HP_CASES[case])
    for seed in range(6):
        h = _hist(seed, ties=case == "ties")
        _, sh, c = _totals(h)
        for f in np.flatnonzero(IS_CAT):
            hg, hh = h[f, :, 0], h[f, :, 1]
            hc_j = jsplit.derived_counts(jnp.asarray(hh), jnp.float32(c),
                                         jnp.float32(sh))
            hc_t = tsplit.derived_counts(torch.tensor(hh), torch.tensor(c),
                                         torch.tensor(sh))
            assert np.array_equal(np.asarray(hc_j), hc_t.numpy())
            valid = np.arange(B) < NUM_BINS[f]
            cj, rj, uj = (np.asarray(a) for a in jsplit.cat_subset_rank(
                jnp.asarray(hg), jnp.asarray(hh), hc_j, jnp.asarray(valid),
                jhp))
            ct, rt, ut = tsplit.cat_subset_rank(
                torch.tensor(hg), torch.tensor(hh), hc_t,
                torch.tensor(valid), thp)
            np.testing.assert_array_equal(ct.numpy(), cj)
            np.testing.assert_array_equal(rt.numpy()[cj], rj[cj])
            assert int(ut) == int(uj)
            for d in (0, 1):
                for k in (1, 2, int(uj) // 2, int(uj)):
                    mj = jsplit.cat_subset_member(
                        jnp.asarray(hg), jnp.asarray(hh), hc_j, NUM_BINS[f],
                        k, d, jhp)
                    mt = tsplit.cat_subset_member(
                        torch.tensor(hg), torch.tensor(hh), hc_t,
                        torch.tensor(NUM_BINS[f]), torch.tensor(k),
                        torch.tensor(d), thp)
                    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def _jax_best(h, jhp, po):
    sg, sh, c = _totals(h)
    return jsplit.find_best_split(
        jnp.asarray(h), jnp.float32(sg), jnp.float32(sh), jnp.float32(c),
        jnp.asarray(NUM_BINS), jnp.asarray(HAS_NAN), jnp.asarray(IS_CAT),
        jnp.ones(F, jnp.float32), jnp.asarray(True), jhp,
        parent_output=jnp.float32(po))


@pytest.mark.parametrize("case", list(HP_CASES))
def test_find_best_split_with_subsets_matches_jax(case):
    """Two leaves a call (the port's batch of K), each against the JAX
    package's search; subset winners are among the winners."""
    jhp, thp = _hps(HP_CASES[case])
    subset_wins = 0
    for seed in range(0, 16, 2):
        hs = [_hist(seed, ties=case == "ties"),
              _hist(seed + 1, ties=case == "ties")]
        tot = [_totals(h) for h in hs]
        po = [0.05, -0.1]
        t = tsplit.find_best_split(
            torch.tensor(np.stack(hs)),
            *(torch.tensor([tt[i] for tt in tot]) for i in range(3)),
            torch.tensor(NUM_BINS), torch.tensor(HAS_NAN),
            torch.tensor(IS_CAT), torch.ones(F), torch.tensor([True, True]),
            thp, parent_output=torch.tensor(po, dtype=torch.float32))
        for i, h in enumerate(hs):
            j = _jax_best(h, jhp, po[i])
            assert int(t.feature[i]) == int(j.feature), (seed, i)
            assert int(t.threshold_bin[i]) == int(j.threshold_bin), (seed, i)
            assert bool(t.default_left[i]) == bool(j.default_left)
            assert bool(t.is_categorical[i]) == bool(j.is_categorical)
            for a, b in ((t.gain, j.gain), (t.left_sum_g, j.left_sum_g),
                         (t.left_sum_h, j.left_sum_h),
                         (t.left_count, j.left_count),
                         (t.left_output, j.left_output),
                         (t.right_output, j.right_output)):
                np.testing.assert_allclose(float(a[i]), float(b),
                                           rtol=GAIN_RTOL, atol=1e-6)
            subset_wins += int(j.threshold_bin) >= B
    assert subset_wins > 0


def test_per_feature_best_gain_matches_jax():
    jhp, thp = _hps(HP_CASES["defaults"])
    for seed in range(4):
        h = _hist(seed)
        sg, sh, c = _totals(h)
        want = np.asarray(jsplit.per_feature_best_gain(
            jnp.asarray(h), jnp.float32(sg), jnp.float32(sh), jnp.float32(c),
            jnp.asarray(NUM_BINS), jnp.asarray(HAS_NAN), jnp.asarray(IS_CAT),
            jnp.ones(F, jnp.float32), jhp))
        got = tsplit.per_feature_best_gain(
            torch.tensor(h)[None], torch.tensor([sg]), torch.tensor([sh]),
            torch.tensor([c]), torch.tensor(NUM_BINS), torch.tensor(HAS_NAN),
            torch.tensor(IS_CAT), torch.ones(F), thp)[0].numpy()
        np.testing.assert_allclose(got, want, rtol=GAIN_RTOL, atol=1e-6)


def test_bin0_is_never_a_subset_member():
    """Bin 0 (other, NaN, negative and unseen categories) holds no raw
    value in the model's bitset, so the port keeps it out of every
    subset: a bin 0 the JAX package ranks first is no candidate here,
    and the rest keep their order."""
    _, thp = _hps(HP_CASES["defaults"])
    hg = torch.tensor([-50.0, 1.0, -2.0, 3.0, 0.5, -1.0])
    hh = torch.tensor([20.0, 5.0, 5.0, 5.0, 5.0, 5.0])
    hc = hh * 4
    cand, rank, used = tsplit.cat_subset_rank(hg, hh, hc,
                                              torch.ones(6, dtype=torch.bool),
                                              thp)
    assert not bool(cand[0]) and int(used) == 5
    assert rank[cand].tolist() == [3, 0, 4, 2, 1]
    for d in (0, 1):
        m = tsplit.cat_subset_member(hg, hh, hc, torch.tensor(6),
                                     torch.tensor(5), torch.tensor(d), thp)
        assert not bool(m[0]) and int(m.sum()) == 5


# -- the words ------------------------------------------------------------------

def test_members_to_words_matches_jax_and_reads_back():
    rng = np.random.default_rng(5)
    m = rng.random((7, 256)) < 0.4
    m[0] = True                           # every bit, bit 31 of each word
    m[1] = False
    m[2] = False
    m[2, 31::32] = True                   # bit 31 alone
    m[3] = False
    m[3, 255] = True                      # the last bin alone
    want = np.asarray(_members_to_words(jnp.asarray(m)))
    got = members_to_words(torch.tensor(m))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0].tolist() == [-1] * 8
    assert got[2].tolist() == [-(1 << 31)] * 8
    col = torch.arange(256, dtype=torch.int32)
    for i in range(7):
        sel = (0, 256, 0, 0, 0, 1, -1, 0, *got[i].tolist())
        assert member_words(sel) == [int(w) & 0xFFFFFFFF
                                     for w in got[i].tolist()]
        np.testing.assert_array_equal(go_left(col, sel).numpy(), m[i])
    # an odd bin count pads the last word with zeros
    np.testing.assert_array_equal(
        members_to_words(torch.tensor(m[:, :40])).numpy(),
        np.asarray(_members_to_words(jnp.asarray(m[:, :40]))))


# -- the plain partitions and the fused split with 8 words ----------------------

R, C, PF = 128, 128, 8
SIZE = 1024
N = SIZE + 3 * R + 4096
CAT_FEAT = 5
# membership words as i32
WORD_CASES = {
    "all_zero": [0] * 8,
    "all_set": [-1] * 8,
    "bit31_every_word": [-(1 << 31)] * 8,
    "single_bit": [0, 0, 1 << 13, 0, 0, 0, 0, 0],
    "last_word": [0] * 7 + [-0x7FFF0000],
    "mixed": [0x0F0F0F0F, 0x12345678, -0x7FFF0000, 0, 0x7FFFFFFF,
              0x55555555, 0x00010001, -0x80000000],
}
# (s0, cnt, feat, sbin, default_left, is_cat, nan_bin) before the words
HEADS = {
    "categorical": (129, 1001, CAT_FEAT, 300, 0, 1, -1),
    "numerical_ignores_words": (11, 900, 1, 77, 0, 0, -1),
    "numerical_nan_bin": (300, 700, 0, 90, 1, 0, 200),
}
CASES = dict({f"categorical_{k}": HEADS["categorical"] + (0, *w)
              for k, w in WORD_CASES.items()},
             numerical_ignores_words=HEADS["numerical_ignores_words"]
             + (0, *WORD_CASES["mixed"]),
             numerical_nan_bin=HEADS["numerical_nan_bin"]
             + (0, *WORD_CASES["all_set"]))


def _comb(bins, vals, rid, score, consts):
    comb = np.zeros((bins.shape[0], C), np.float32)
    comb[:, :PF] = bins
    comb[:, PF:PF + 3] = vals
    comb[:, PF + 3] = rid // 65536
    comb[:, PF + 4] = (rid // 256) % 256
    comb[:, PF + 5] = rid % 256
    comb[:, PF + 6] = score
    comb[:, PF + 7:PF + 9] = consts
    return comb


@pytest.fixture(scope="module")
def rows_np():
    """Seeded rows: feature 0 with 5% of its rows in the NaN bin 200,
    the categorical feature over every u8 bin, g*w and h*w bf16-exact
    (the JAX fused split's histogram operands)."""
    r = list(random_row_matrix(N, PF, 41, n_bins=201, nan_bin=200))
    r[0][:, CAT_FEAT] = np.random.default_rng(42).integers(0, 256, N)
    r[1] = torch.tensor(r[1]).bfloat16().float().numpy()
    return tuple(r)


def _assert_rows(rows, out_j, rows_np, s0, cnt):
    seg = slice(s0, s0 + cnt)
    np.testing.assert_array_equal(rows.bins.numpy()[seg], out_j[seg, :PF])
    np.testing.assert_array_equal(rows.vals.numpy()[seg],
                                  out_j[seg, PF:PF + 3])
    rid_j = (out_j[seg, PF + 3] * 65536 + out_j[seg, PF + 4] * 256
             + out_j[seg, PF + 5]).astype(np.int32)
    np.testing.assert_array_equal(rows.rid.numpy()[seg], rid_j)
    np.testing.assert_array_equal(rows.score.numpy()[seg],
                                  out_j[seg, PF + 6])
    for a, b in zip(rows, rows_np):
        np.testing.assert_array_equal(a.numpy()[:s0], b[:s0])
        np.testing.assert_array_equal(a.numpy()[s0 + cnt:], b[s0 + cnt:])


@pytest.fixture(scope="module")
def jax_kernels():
    return {
        "perm": make_partition_perm(N, C, R=R, size=SIZE, interpret=True,
                                    interpret_kernel=True),
        "3ph": make_partition(N, C, R=R, size=SIZE, interpret=True),
        "fused": make_fused_split(N, C, f_pad=PF, padded_bins=256, R=R,
                                  size=SIZE, interpret=True,
                                  interpret_kernel=True),
    }


@pytest.mark.parametrize("scheme", ["perm", "3ph", "fused"])
@pytest.mark.parametrize("case", list(CASES))
def test_partitions_with_words_match_jax(case, scheme, rows_np,
                                         jax_kernels):
    sel = CASES[case]
    assert len(sel) == 16
    s0, cnt = sel[:2]
    comb = jnp.asarray(_comb(*rows_np))
    out = jax_kernels[scheme](jnp.asarray(np.asarray(sel, np.int32)), comb,
                              jnp.zeros_like(comb))
    out_j, nl_j = np.asarray(out[0]), int(out[2])
    rows = rows_on(rows_np, "cpu")
    nleft = torch.full((1,), -1, dtype=torch.int32)
    if scheme == "perm":
        partition_ref(rows, empty_rows_like(rows), sel, nleft)
    elif scheme == "3ph":
        partition_3ph(rows, empty_rows_like(rows), sel, nleft)
    else:
        scratch = empty_rows_like(rows)
        hists = fused_split(rows, scratch, sel, nleft, padded_bins=256)
        copyback(rows, scratch, s0, cnt)
        for side, start, n in ((0, s0, int(nleft)),
                               (1, s0 + int(nleft), cnt - int(nleft))):
            want = build_histogram_comb_ref(
                rows, torch.tensor([start, 0, n], dtype=torch.int32),
                padded_bins=256, max_rows=cnt // 2 + 1)
            assert torch.equal(hists[side], want)
    assert int(nleft) == nl_j
    col = rows_np[0][s0:s0 + cnt, sel[2]].astype(np.int64)
    assert int(nleft) == int(go_left(torch.tensor(col), sel).sum())
    _assert_rows(rows, out_j, rows_np, s0, cnt)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("words", ["mixed", "bit31_every_word", "last_word"])
def test_pack2_with_words_matches_jax_partition_p2(words, fused):
    """The pack=2 scan and the fused split at pack=2 leave the logical
    rows in the JAX package's pack=2 partition kernel's order with 8
    membership words (``tests/test_torch_pack2.py``'s harness, bins over
    the whole u8 range)."""
    r2, size2 = 64, 512
    n2 = size2 + 4 * r2 + 256
    rng = np.random.default_rng(6)
    logical = np.zeros((n2, LANE // 2), np.float32)
    logical[:, :8] = rng.integers(0, 256, size=(n2, 8))
    logical[:, 8] = rng.normal(size=n2)
    s0, cnt, feat = 65, 401, 3
    sel = (s0, cnt, feat, 0, 0, 1, -1, 0, *WORD_CASES[words])
    part = make_partition_p2(n2, R=r2, size=size2, interpret=True,
                             interpret_kernel=True, cb_block=64)
    packed_j = jnp.asarray(logical.reshape(n2 // 2, LANE))
    out_j, _, nl_j = part(jnp.asarray(np.asarray(sel, np.int32)), packed_j,
                          jnp.zeros_like(packed_j))
    out_j = np.asarray(out_j).reshape(n2, LANE // 2)
    rows = init_rows(torch.tensor(logical[:, :8].astype(np.uint8)))
    rows.vals[:, 0] = torch.tensor(logical[:, 8])
    packed = pack_rows(rows)
    nleft = torch.zeros(1, dtype=torch.int32)
    if fused:
        scratch = empty_packed_like(packed)
        fused_split_p2(packed, scratch, sel, nleft, padded_bins=256)
        copyback_p2(packed, scratch, s0, cnt)
    else:
        partition_p2(packed, empty_packed_like(packed), sel, nleft)
    assert int(nleft) == int(nl_j)
    order = packed.fields().rid.long().numpy()
    np.testing.assert_array_equal(out_j[:, :9], logical[order, :9])


def test_more_than_eight_words_raise_on_the_kernels():
    """A descriptor of more than 8 words (the cat_overwide route's) is
    refused by every kernel entry, on the CPU as on the card."""
    from lightgbm_tpu_torch.ops.partition_kernel import check_words
    sel = (0, 10, 0, 0, 0, 1, -1, 0) + (1,) * (MAX_MEMBER_WORDS + 1)
    with pytest.raises(LightGBMError, match="membership words"):
        check_words(sel)
    assert check_words(sel[:16]) == 8 and check_words(sel[:7]) == 0
    assert troute.cat_bitset_fit(32 * MAX_MEMBER_WORDS)
    assert not troute.cat_bitset_fit(32 * MAX_MEMBER_WORDS + 1)


# -- training ---------------------------------------------------------------------

KNOBS = ("LGBM_TPU_PHYS", "LGBM_TPU_STREAM", "LGBM_TPU_FUSED",
         "LGBM_TPU_APPLY_IMPL", "LGBM_TPU_PART", "LGBM_TPU_POOL_TAIL",
         "LGBM_TPU_COMB_PACK", "LGBM_TPU_PART_INTERP", "LGBM_TPU_PARTITION")
# the port's knobs of each route, the JAX package's (tests/
# test_cat_physical.py's), and the route the port describes
ROUTES = {
    "default": ({}, _kernel_env("permute", "1"),
                "path=stream fused=1 tail=xla (tail_cat_subset)"),
    "pack2": ({"LGBM_TPU_COMB_PACK": "2"}, _kernel_env("permute", "1", "2"),
              "path=stream fused=1 tail=xla pack=2 (tail_cat_subset)"),
    "unfused": ({"LGBM_TPU_FUSED": "0"}, _kernel_env("permute", "0"),
                "path=stream fused=0 tail=xla (fused_env_off, "
                "tail_cat_subset)"),
    "pack2_unfused": ({"LGBM_TPU_FUSED": "0", "LGBM_TPU_COMB_PACK": "2"},
                      _kernel_env("permute", "0", "2"),
                      "path=stream fused=0 tail=xla pack=2 (fused_env_off, "
                      "tail_cat_subset)"),
    "3ph": ({"LGBM_TPU_PART": "3ph"},
            {"LGBM_TPU_PHYS": "interpret", "LGBM_TPU_PART": "3ph"},
            "path=stream scheme=3ph fused=0 tail=xla (part_3ph, "
            "tail_cat_subset)"),
    "max_bin_1023": ({}, {"LGBM_TPU_PHYS": "0"},
                     "path=row_order fused=0 tail=xla (cat_overwide, "
                     "non_u8_bins, tail_cat_subset)"),
}
PARAMS = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
          "min_data_in_leaf": 5, "min_data_per_group": 5, "cat_smooth": 2.0,
          "max_cat_to_onehot": 4, "max_bin": 63}
ROUNDS = 3


def _with_env(env, fn):
    saved = save_env_knobs(KNOBS)
    for k in KNOBS:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        return fn()
    finally:
        restore_env_knobs(saved)


def _params(route):
    return dict(PARAMS, max_bin=1023) if route == "max_bin_1023" else PARAMS


def _port_train(route, x, y, rounds=ROUNDS, valid=None):
    p = _params(route)

    def run():
        ds = lgt.Dataset(x, label=y, categorical_feature=[0],
                         params={"max_bin": p["max_bin"],
                                 "min_data_in_bin": 1})
        vs = ([lgt.Dataset(valid[0], label=valid[1], reference=ds)]
              if valid is not None else [])
        return lgt.train(dict(p, metric="auc"), ds, num_boost_round=rounds,
                         valid_sets=vs, device="cpu")
    return _with_env(ROUTES[route][0], run)


def _cat_digest(models):
    return [(np.asarray(t.cat_boundaries).tobytes(),
             np.asarray(t.cat_threshold, np.uint32).tobytes())
            for t in models]


def _n_multicat(models):
    n = 0
    for t in models:
        for i in range(t.num_leaves - 1):
            if t.decision_type[i] & 1:
                slot = int(t.threshold[i])
                lo, hi = t.cat_boundaries[slot], t.cat_boundaries[slot + 1]
                n += sum(bin(int(w)).count("1")
                         for w in t.cat_threshold[lo:hi]) > 1
    return n


@pytest.fixture(scope="module")
def port_runs():
    x, y = _cat_problem()
    return {r: _port_train(r, x, y) for r in ROUTES}


@pytest.mark.parametrize("route", list(ROUTES))
def test_trees_match_jax(route, port_runs):
    bst = port_runs[route]
    assert bst._inner.grow.route.describe() == ROUTES[route][2]
    ref = _fresh_train(ROUTES[route][1], rounds=ROUNDS,
                       max_bin=_params(route)["max_bin"])
    jm = ref["bst"]._models
    assert _n_multicat(bst._models) > 0
    res = compare_trees(bst._models, jm, rtol=LEAF_RTOL)
    assert res["ok"], res
    assert _cat_digest(bst._models) == _cat_digest(jm)
    for a, b in zip(bst._models, jm):
        np.testing.assert_array_equal(a.decision_type, b.decision_type)
    np.testing.assert_allclose(bst.predict(ref["x"], raw_score=True),
                               ref["pred"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("route", ["pack2", "unfused", "pack2_unfused", "3ph"])
def test_routes_grow_the_default_routes_trees(route, port_runs):
    a, b = port_runs["default"]._models, port_runs[route]._models
    res = compare_trees(a, b, rtol=0.0 if route != "3ph" else LEAF_RTOL)
    assert res["ok"], res
    assert _cat_digest(a) == _cat_digest(b)
    if route != "3ph":
        assert leaves_bitwise(a, b)


@pytest.mark.parametrize("route", list(ROUTES))
def test_host_reads_one_per_split(route, port_runs):
    """One descriptor read a split (the words ride it), and one for the
    split a tree stops at."""
    bst = port_runs[route]
    L = PARAMS["num_leaves"]
    want = sum(t.num_leaves - 1 + (t.num_leaves < L) for t in bst._models)
    assert bst._inner.grow.host_reads == want


# -- bin 0: the one place the port leaves the JAX package --------------------------

def _bin0_problem(seed=3):
    """30 frequent categories (50 rows each) and 400 categories seen
    once, which ``min_data_in_bin`` 3 merges into bin 0; the rare rows
    lean to label 1 with ten of the frequent categories, a dense feature
    decides the rest."""
    rng = np.random.default_rng(seed)
    c = np.concatenate([np.repeat(np.arange(30), 50), 1000 + np.arange(400)])
    good = (c < 10) | (c >= 1000)
    dense = rng.normal(size=(c.size, 3)).astype(np.float32)
    y = (0.6 * good + dense[:, 0] + 0.2 * rng.normal(size=c.size)
         > 0.3).astype(np.float32)
    x = np.hstack([c[:, None].astype(np.float32), dense])
    p = rng.permutation(c.size)
    return x[p], y[p]


BIN0_PARAMS = dict(PARAMS, min_data_in_bin=3)
# the subset search (max_cat_to_onehot 4) and the one-hot search over
# every bin of the 31-bin feature
BIN0_MODES = {"subset": 4, "onehot": 64}


def _bin0_runs(mode):
    x, y = _bin0_problem()
    p = dict(BIN0_PARAMS, max_cat_to_onehot=BIN0_MODES[mode])
    ds_params = {"max_bin": p["max_bin"], "min_data_in_bin": 3}
    saved = save_env_knobs(KNOBS)
    for k in KNOBS:
        os.environ.pop(k, None)
    os.environ["LGBM_TPU_PHYS"] = "0"
    purge = lambda: [sys.modules.pop(m) for m in list(sys.modules)  # noqa
                     if m.startswith("lightgbm_tpu.")
                     or m == "lightgbm_tpu"]
    try:
        purge()
        import lightgbm_tpu as lgb
        jb = lgb.train(p, lgb.Dataset(x, label=y, categorical_feature=[0],
                                      params=ds_params), num_boost_round=3)
        jscore = np.asarray(jb._inner.train_score)[0, :len(y)]
    finally:
        restore_env_knobs(saved)
        purge()
    pb = _with_env({}, lambda: lgt.train(
        p, lgt.Dataset(x, label=y, categorical_feature=[0],
                       params=ds_params), num_boost_round=3, device="cpu"))
    return x, jb, jscore, pb


def _first_bin0_split(models):
    """(tree, node) of the first categorical split whose bitset over bins
    holds bin 0, else None."""
    for ti, t in enumerate(models):
        for i in range(t.num_leaves - 1):
            if t.decision_type[i] & 1:
                lo = t.cat_boundaries_inner[int(t.threshold[i])]
                if t.cat_threshold_inner[lo] & 1:
                    return ti, i
    return None


def _node(t, i):
    lo, hi = (t.cat_boundaries_inner[int(t.threshold[i])],
              t.cat_boundaries_inner[int(t.threshold[i]) + 1])
    words = (np.asarray(t.cat_threshold_inner[lo:hi], np.uint32).tobytes()
             if t.decision_type[i] & 1 else float(t.threshold[i]))
    return int(t.split_feature[i]), int(t.decision_type[i]), words


@pytest.mark.parametrize("mode", list(BIN0_MODES))
def test_jax_trains_bin0_left_and_serves_it_right(mode):
    """The reference's fault (ROADMAP C), witnessed: the JAX package puts
    bin 0 in a categorical split, its training scores send the rare
    categories left, and its served model, whose bitset over raw values
    cannot hold them, sends them right.  The port's two agree."""
    x, jb, jscore, pb = _bin0_runs(mode)
    assert _first_bin0_split(jb._models) is not None
    rare = x[:, 0] >= 1000
    gap = np.abs(jscore - jb.predict(x, raw_score=True))
    # the rare rows that reach the node disagree, and no other row
    assert gap[rare].max() > 0.1 and gap[~rare].max() < 1e-5
    assert _first_bin0_split(pb._models) is None
    np.testing.assert_allclose(pb._inner.train_score.numpy(),
                               pb.predict(x, raw_score=True), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", list(BIN0_MODES))
def test_port_leaves_jax_exactly_at_its_first_bin0_split(mode):
    """The trees are the JAX package's up to its first split holding bin
    0 (below the root here), and differ at that node."""
    _, jb, _, pb = _bin0_runs(mode)
    ti, ni = _first_bin0_split(jb._models)
    assert (ti, ni) > (0, 0)
    res = compare_trees(pb._models[:ti], jb._models[:ti], rtol=LEAF_RTOL)
    assert res["ok"], res
    a, b = pb._models[ti], jb._models[ti]
    for i in range(ni):
        assert _node(a, i) == _node(b, i), i
    assert _node(a, ni) != _node(b, ni)


def test_edge_categories_predict_as_jax():
    """Negative, unseen and NaN categories and NaN dense values route
    right through a categorical node in the port's served model, the
    host walk, the holdout's bitset walk and the JAX package's trees
    (``tests/test_cat_physical.py::
    test_cat_edge_predictions_negative_unseen_nan``)."""
    x, y = _cat_problem()
    xq = x[:64].copy()
    xq[:16, 0] = -3.0
    xq[16:32, 0] = 1000.0
    xq[32:48, 0] = np.nan
    xq[48:, 1:] = np.nan
    bst = _port_train("default", x, y, rounds=4, valid=(xq, y[:64]))
    ref = _fresh_train({"LGBM_TPU_PHYS": "0"}, rounds=4)
    pp = bst.predict(xq, raw_score=True)
    np.testing.assert_allclose(pp, ref["bst"].predict(xq, raw_score=True),
                               rtol=5e-3, atol=1e-3)
    host = sum(t.leaf_value[t.predict_leaf(np.asarray(xq, np.float64))]
               for t in bst._models)
    np.testing.assert_allclose(pp, host, rtol=1e-6, atol=1e-6)
    # the holdout's scores walk the trees' bins by membership (the rows
    # of edge categories; a NaN dense value of a feature trained without
    # NaN bins to the last bin but is served as 0.0, in both packages:
    # ROADMAP C)
    np.testing.assert_allclose(bst._inner.valid_sets[0].score.numpy()[:48],
                               pp[:48], rtol=1e-5, atol=1e-5)
    assert np.isfinite(pp).all()


def test_predict_leaf_bins_walks_the_members():
    """A categorical node sends a bin left where its member row holds
    it, whatever ``threshold_bin`` says, and bin 0 right."""
    from lightgbm_tpu_torch.ops.grow import TreeArrays
    members = np.zeros((1, 8), bool)
    members[0, [2, 5, 7]] = True
    z = np.zeros(1, np.float32)
    ta = TreeArrays(
        split_feature=np.array([0], np.int32),
        threshold_bin=np.array([8 + 2], np.int32), split_gain=z,
        default_left=np.array([False]), is_categorical=np.array([True]),
        left_child=np.array([~0], np.int32),
        right_child=np.array([~1], np.int32), internal_value=z,
        internal_weight=z, internal_count=z,
        leaf_value=np.zeros(2, np.float32), leaf_weight=z, leaf_count=z,
        num_leaves=2, cat_members=members)
    bins = torch.arange(8, dtype=torch.uint8)[:, None]
    got = predict_leaf_bins(ta, bins, torch.tensor([8], dtype=torch.int32),
                            torch.tensor([False]))
    assert got.tolist() == [1, 1, 0, 1, 1, 0, 1, 0]


def test_model_text_round_trip(port_runs):
    bst = port_runs["default"]
    text = bst.model_to_string()
    again = lgt.Booster(model_str=text, device="cpu")
    trees = text.split("end of trees")[0]
    assert "cat_threshold=" in trees
    assert again.model_to_string().split("end of trees")[0] == trees
    x, _ = _cat_problem()
    np.testing.assert_array_equal(again.predict(x, raw_score=True),
                                  bst.predict(x, raw_score=True))
    for a, b in zip(again._models, bst._models):
        np.testing.assert_array_equal(a.cat_threshold, b.cat_threshold)
        np.testing.assert_array_equal(a.cat_boundaries, b.cat_boundaries)


def test_a_later_validation_set_walks_the_members(port_runs):
    """A validation set added after the trees exist is scored through
    the trees' bitsets over bins (``Tree.bin_members``), as the
    predictions are."""
    bst = port_runs["default"]
    x, y = _cat_problem(n=400, seed=9)
    xq = x.copy()
    xq[:20, 0] = -1.0
    vs = lgt.Dataset(xq, label=y, reference=bst.train_set).construct()
    bst._inner.add_valid(vs._binned, "late", [])
    np.testing.assert_allclose(bst._inner.valid_sets[-1].score.numpy(),
                               bst.predict(xq, raw_score=True), rtol=1e-5,
                               atol=1e-5)


# -- routing ------------------------------------------------------------------------

def test_routing_decisions():
    d = troute.decide(troute.RouteInputs(cat_subset=True))
    assert d.describe() == "path=stream fused=1 tail=xla (tail_cat_subset)"
    d = troute.decide(troute.RouteInputs(cat_subset=True, bins_u8=False))
    assert d.path == "row_order"
    assert d.reasons[:2] == ("cat_overwide", "non_u8_bins")
    assert troute.cat_bitset_fit(256) and not troute.cat_bitset_fit(257)
    assert not troute.cat_bitset_fit(0)
    d = troute.decide(troute.RouteInputs(cat_subset=True, pack_env="2"))
    assert d.pack == 2 and d.tail == "xla"
    d = troute.decide(troute.RouteInputs(cat_subset=False))
    assert d.tail == "kernel"


def test_cat_cells_match_the_jax_golden():
    """Every cat=1 cell of the JAX package's golden matrix the port can
    express decides the port's path, pack, scheme, fused and physical
    reasons."""
    golden = json.loads((REPO / "lightgbm_tpu" / "analysis" /
                         "routing_matrix.json").read_text())["cells"]
    other = {"learner": "serial", "shards": "1", "efb": "0", "over": "0",
             "ew": "0", "fdiv": "1", "dp": "0", "cegb": "0", "forced": "0",
             "mono": "0", "cegbc": "0", "part": "permute", "ob": "0",
             "pg": "auto", "mcb": "auto"}
    compared = 0
    for key, enc in golden.items():
        kf = dict(p.split("=", 1) for p in key.split(";"))
        if kf.get("cat") != "1" or any(kf.get(k, v) != v
                                       for k, v in other.items()):
            continue
        if (kf["be"], kf["phys"]) not in (("tpu", "auto"), ("tpu", "0"),
                                          ("cpu", "0")):
            continue
        i = troute.RouteInputs(
            objective_kind=kf["obj"], boosting=kf["boost"],
            multi_tree=kf["k"] == "multi", bagging=kf["bag"] == "1",
            linear_tree=kf["lin"] == "1", bins_u8=kf["u8"] == "1",
            phys_env=kf["phys"], stream_env=kf["stream"],
            fused_env="1" if kf["fused"] == "1" else "0",
            part_env=kf["impl"], pack_env=kf["pack"],
            wide_layout=kf["wide"] == "1", cat_subset=True)
        want = troute.decode_cell(enc)
        got = troute.decode_cell(troute.encode_cell(troute.decide(i)))
        for f in ("path", "pack", "scheme", "fused", "why"):
            assert got[f] == want[f], (key, f)
        compared += 1
    assert compared >= 2


def test_overwide_bitset_is_refused_at_grower_build():
    """The physical grower refuses a subset model over more bins than
    the descriptor's words hold (the JAX package's grow-build
    defense)."""
    from lightgbm_tpu_torch.ops.device_data import to_device
    from lightgbm_tpu_torch.ops.grow import SerialGrower
    from lightgbm_tpu_torch.ops.routing import RouteInputs, decide
    x, y = _cat_problem(n=300)
    ds = lgt.Dataset(x, label=y, categorical_feature=[0],
                     params={"max_bin": 1023, "min_data_in_bin": 1}
                     ).construct()
    dd = to_device(ds._binned, torch.device("cpu"))
    with pytest.raises(ValueError, match="cat_overwide"):
        SerialGrower(tsplit.SplitHyperParams(use_cat_subset=True),
                     num_leaves=7, max_depth=-1, dd=dd,
                     route=decide(RouteInputs(fused_env="0",
                                              stream_env="0")))
