"""The port's split finder against the JAX package's, on the CPU.

Both packages search the same histograms (built once from seeded rows
and handed to both as f32 arrays): numerical features with and without
a NaN bin, a one-hot categorical feature, and a two-bin feature, under
L1/L2, ``max_delta_step``, ``min_data_in_leaf``, ``min_gain_to_split``,
path smoothing and a feature mask.  The winner's feature, threshold bin
and default direction must be equal; its left sums and left output
within 1e-6 relative (the port takes the bin prefix sums in f64, the
JAX package in f32, so they differ in the last places).  The right side
is the difference of two nearly equal sums (total minus left), which
amplifies that noise: the gain, which adds the right side's term, is
held to 1e-5 relative (1.5e-6 seen), the right output to 1e-4.  ``selection_key`` and the
elementwise leaf math must match bit for bit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops.histogram import build_histogram

B = 256
NUM_BINS = np.array([50, 30, 4, 200, 2, 120], np.int32)
HAS_NAN = np.array([True, False, False, True, False, False])
IS_CAT = np.array([False, False, True, False, False, False])

HP_CASES = {
    "default": {},
    "l1_l2": {"lambda_l1": 0.5, "lambda_l2": 2.0},
    "max_delta_step": {"max_delta_step": 0.05, "lambda_l2": 1.0},
    "min_data_gain": {"min_data_in_leaf": 300, "min_gain_to_split": 0.5,
                      "min_sum_hessian_in_leaf": 5.0},
    "path_smooth": {"path_smooth": 1.5},
}


def _hist(n, seed):
    rng = np.random.default_rng(seed)
    bins = np.stack([rng.integers(0, nb, n) for nb in NUM_BINS], 1)
    g = rng.normal(size=n).astype(np.float32) + 0.3 * (bins[:, 0] < 20)
    h = rng.uniform(0.05, 0.25, n).astype(np.float32)
    vals = np.stack([g.astype(np.float32), h], 1)
    hist = build_histogram(torch.tensor(bins.astype(np.uint8)),
                           torch.tensor(vals), padded_bins=B).numpy()
    return hist, np.float32(vals[:, 0].sum()), np.float32(vals[:, 1].sum()), \
        np.float32(n)


def _close(a, b, rtol=1e-6):
    a, b = float(a), float(b)
    return abs(a - b) <= rtol * max(abs(a), abs(b), 1e-30)


@pytest.mark.parametrize("case", list(HP_CASES))
@pytest.mark.parametrize("masked", [False, True])
def test_find_best_split_matches_jax(case, masked):
    kw = HP_CASES[case]
    hist, sg, sh, cnt = _hist(3000, 7)
    fmask = np.ones(len(NUM_BINS), np.float32)
    if masked:
        fmask[0] = 0.0
    parent = np.float32(-0.12)
    jhp = jsplit.SplitHyperParams(
        use_smoothing="path_smooth" in kw, **kw)
    thp = tsplit.SplitHyperParams(
        use_smoothing="path_smooth" in kw, **kw)
    js = jsplit.find_best_split(
        jnp.asarray(hist), jnp.float32(sg), jnp.float32(sh),
        jnp.float32(cnt), jnp.asarray(NUM_BINS), jnp.asarray(HAS_NAN),
        jnp.asarray(IS_CAT), jnp.asarray(fmask), jnp.asarray(True), jhp,
        parent_output=jnp.float32(parent))
    ts = tsplit.find_best_split(
        torch.tensor(hist)[None], torch.tensor([sg]), torch.tensor([sh]),
        torch.tensor([cnt]), torch.tensor(NUM_BINS), torch.tensor(HAS_NAN),
        torch.tensor(IS_CAT), torch.tensor(fmask), torch.tensor([True]),
        thp, parent_output=torch.tensor([parent]))
    assert int(ts.feature[0]) == int(js.feature)
    assert int(ts.threshold_bin[0]) == int(js.threshold_bin)
    assert bool(ts.default_left[0]) == bool(js.default_left)
    assert bool(ts.is_categorical[0]) == bool(js.is_categorical)
    for name in ("left_sum_g", "left_sum_h", "left_count", "left_output"):
        assert _close(getattr(ts, name)[0], getattr(js, name)), name
    assert _close(ts.gain[0], js.gain, rtol=1e-5)
    assert _close(ts.right_output[0], js.right_output, rtol=1e-4)
    if masked:
        assert int(ts.feature[0]) != 0


def test_two_leaves_in_one_pass_match_one_by_one():
    """The batched search of two children equals two single searches."""
    h1, sg1, sh1, c1 = _hist(2000, 1)
    h2, sg2, sh2, c2 = _hist(1500, 2)
    hp = tsplit.SplitHyperParams()
    common = (torch.tensor(NUM_BINS), torch.tensor(HAS_NAN),
              torch.tensor(IS_CAT), torch.ones(len(NUM_BINS)))
    both = tsplit.find_best_split(
        torch.tensor(np.stack([h1, h2])), torch.tensor([sg1, sg2]),
        torch.tensor([sh1, sh2]), torch.tensor([c1, c2]), *common,
        torch.tensor([True, True]), hp)
    for k, (h, sg, sh, c) in enumerate([(h1, sg1, sh1, c1),
                                        (h2, sg2, sh2, c2)]):
        one = tsplit.find_best_split(
            torch.tensor(h)[None], torch.tensor([sg]), torch.tensor([sh]),
            torch.tensor([c]), *common, torch.tensor([True]), hp)
        for a, b in zip(both, one):
            assert torch.equal(a[k], b[0])


def test_no_valid_split_gives_nonpositive_gain():
    hist, sg, sh, cnt = _hist(100, 3)
    ts = tsplit.find_best_split(
        torch.tensor(hist)[None], torch.tensor([sg]), torch.tensor([sh]),
        torch.tensor([cnt]), torch.tensor(NUM_BINS), torch.tensor(HAS_NAN),
        torch.tensor(IS_CAT), torch.ones(len(NUM_BINS)),
        torch.tensor([True]), tsplit.SplitHyperParams(min_data_in_leaf=80))
    assert float(ts.gain[0]) == float("-inf")


def test_selection_key_bitwise():
    rng = np.random.default_rng(5)
    g = np.concatenate([rng.normal(size=2000) * 10.0 ** rng.integers(
        -8, 8, 2000), [0.0, -0.0, np.inf, -np.inf, 1e-40, -3e38]]).astype(
        np.float32)
    want = np.asarray(jsplit.selection_key(jnp.asarray(g)))
    got = tsplit.selection_key(torch.tensor(g)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_leaf_math_matches_jax():
    rng = np.random.default_rng(6)
    sg = rng.normal(size=500).astype(np.float32) * 50
    sh = rng.uniform(0.0, 40, 500).astype(np.float32)
    sh[:5] = 0.0                      # empty leaves: the 1e-38 guard
    cnt = np.floor(sh * 7).astype(np.float32)
    for kw in ({}, {"lambda_l1": 0.3, "lambda_l2": 1.0},
               {"max_delta_step": 0.2}):
        jhp, thp = jsplit.SplitHyperParams(**kw), tsplit.SplitHyperParams(
            **kw)
        for jf, tf in ((jsplit.calculate_leaf_output,
                        tsplit.calculate_leaf_output),
                       (jsplit.leaf_split_gain, tsplit.leaf_split_gain)):
            want = np.asarray(jf(jnp.asarray(sg), jnp.asarray(sh), jhp))
            got = tf(torch.tensor(sg), torch.tensor(sh), thp).numpy()
            np.testing.assert_array_equal(got, want)
    want = np.asarray(jsplit.derived_counts(jnp.asarray(sh), jnp.float32(
        1000.0), jnp.float32(sh.sum())))
    got = tsplit.derived_counts(torch.tensor(sh), torch.tensor(1000.0),
                                torch.tensor(sh.sum())).numpy()
    np.testing.assert_array_equal(got, want)
