"""The port's fused split (``ops/fused_split.py``) against the JAX
package's fused partition + dual histogram, on the CPU.

The JAX side runs ``make_fused_split(..., interpret=True,
interpret_kernel=True)``, as tests/test_fused.py does: the REAL scan and
copyback kernel bodies through the Pallas interpreter (the compiled
TPU kernel's row order) and the comb-direct histogram of each child
range.  Rows are made from a seed with numpy and handed to both: the
five row arrays on the port's side, the same values in the 128-lane comb
on the JAX side (bins, g*w, h*w, w, row-id bytes, score, constants).
g*w and h*w are bf16-exact, as the JAX histogram's matmul operands are.

Tolerances: the permuted rows are byte-identical and ``nleft`` equal;
each side's histogram is bitwise the port's ``build_histogram_comb_ref``
of that child's range with ``max_rows = cnt // 2 + 1`` and within
``4 * n * eps_f32 * max|v|`` of the JAX side's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from chip_smoke import hist_tolerance, random_row_matrix, rows_on
from lightgbm_tpu.ops.pallas.fused_split import make_fused_split
from lightgbm_tpu_torch.ops.device_data import empty_rows_like
from lightgbm_tpu_torch.ops.fused_split import (child_ranges, fused_split,
                                                fused_split_ref,
                                                fused_supported)
from lightgbm_tpu_torch.ops.hist_kernel2 import build_histogram_comb_ref
from lightgbm_tpu_torch.ops.partition_kernel import copyback, partition_ref

torch.set_num_threads(1)

R, C, F, B = 128, 128, 8, 256
SIZE = 1024
N = SIZE + 3 * R + 4096
NAN_BIN = 200

# (s0, cnt, feat, sbin, default_left, is_cat, nan_bin)
CASES = {
    "numerical_nan_left": (70, 950, 0, 90, 1, 0, NAN_BIN),
    "numerical_nan_right": (513, 701, 0, 120, 0, 0, NAN_BIN),
    "numerical_no_nan": (0, 1024, 3, 33, 0, 0, -1),
    "onehot_categorical": (301, 599, 4, 17, 0, 1, -1),
    "all_left": (9, 333, 5, 250, 0, 0, -1),
    "dead_split": (100, 0, 1, 10, 0, 0, -1),
}


def _comb(bins, vals, rid, score, consts):
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
    arrays = list(random_row_matrix(N, F, 31, n_bins=NAN_BIN + 1,
                                    nan_bin=NAN_BIN))
    arrays[1] = torch.tensor(arrays[1]).bfloat16().float().numpy()
    return tuple(arrays)


@pytest.fixture(scope="module")
def jax_fused():
    return make_fused_split(N, C, f_pad=F, padded_bins=B, R=R, size=SIZE,
                            interpret=True, interpret_kernel=True)


@pytest.mark.parametrize("case", list(CASES))
def test_fused_split_ref_matches_jax(case, rows_np, jax_fused):
    sel = CASES[case]
    s0, cnt = sel[:2]
    sel_j = np.zeros(8, np.int32)
    sel_j[:7] = sel
    comb = jnp.asarray(_comb(*rows_np))
    out_j, _, nl_j, hl_j, hr_j = jax_fused(jnp.asarray(sel_j), comb,
                                           jnp.zeros_like(comb))
    out_j = np.asarray(out_j)

    rows = rows_on(rows_np, "cpu")
    scratch = empty_rows_like(rows)
    nleft = torch.full((1,), -1, dtype=torch.int32)
    hists = fused_split(rows, scratch, sel, nleft, padded_bins=B)
    copyback(rows, scratch, s0, cnt)
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
    for a, b in zip(rows, rows_np):
        np.testing.assert_array_equal(a.numpy()[:s0], b[:s0])
        np.testing.assert_array_equal(a.numpy()[s0 + cnt:], b[s0 + cnt:])
    for side, (rng, h_j) in enumerate(zip(
            child_ranges(s0, cnt, int(nleft)), (hl_j, hr_j))):
        want = build_histogram_comb_ref(
            rows, torch.tensor(rng, dtype=torch.int32), padded_bins=B,
            max_rows=cnt // 2 + 1)
        assert torch.equal(hists[side], want)
        assert np.abs(hists[side].numpy() - np.asarray(h_j)).max() <= \
            hist_tolerance(rows, rng)


def test_fused_split_is_partition_plus_child_histograms(rows_np):
    """The plain version composes slice 2's pieces: the same rows as
    partition_ref, and the two sides together hold every row of the
    segment once."""
    sel = CASES["numerical_nan_left"]
    s0, cnt = sel[:2]
    a, b = rows_on(rows_np, "cpu"), rows_on(rows_np, "cpu")
    scratch = empty_rows_like(a)
    nl_a = torch.zeros(1, dtype=torch.int32)
    h = fused_split_ref(a, scratch, sel, nl_a, padded_bins=B)
    partition_ref(b, empty_rows_like(b), sel, torch.zeros(1, dtype=torch.int32))
    for x, y in zip(scratch, b):
        assert torch.equal(x[s0:s0 + cnt], y[s0:s0 + cnt])
    whole = build_histogram_comb_ref(
        b, torch.tensor([s0, 0, cnt], dtype=torch.int32), padded_bins=B,
        max_rows=cnt)
    assert (h.sum(0) - whole).abs().max() <= hist_tolerance(b, (s0, 0, cnt))


def test_fused_supported_gate():
    """The route's shape gate: the port's kernel at F=28, B=256 fits one
    block's shared memory; a far wider histogram does not."""
    assert fused_supported(28, 256)
    assert not fused_supported(200, 256)
