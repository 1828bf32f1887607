"""The port's partition (scan + copyback) against the JAX package's
single-scan kernel, on the CPU.

The JAX side runs the REAL scan and copyback kernel bodies through the
Pallas interpreter (``make_partition_perm(..., interpret=True,
interpret_kernel=True)``, as tests/test_partition_perm.py runs them), so
its row order is the compiled TPU kernel's: left rows in order, right
rows reversed.  The port's plain version (``partition_ref``) must leave
the same bytes in the segment, the same ``nleft``, and every row outside
the segment untouched.  Rows are made from a seed with numpy and handed
to both: bins, values, row-id bytes, score and constants in the
128-lane comb on the JAX side, the five row arrays on the port's.
Tolerance: none, the bytes are equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from chip_smoke import random_row_matrix, rows_on
from lightgbm_tpu.ops.pallas.partition_kernel3 import make_partition_perm
from lightgbm_tpu_torch.ops.device_data import Rows, empty_rows_like
from lightgbm_tpu_torch.ops.partition_kernel import (copyback_ref,
                                                     partition_ref,
                                                     partition_scan_ref)

R, C, F = 128, 128, 6
SIZE = 1024
N = SIZE + 3 * R + 4096
NAN_BIN = 200

# (s0, cnt, feat, sbin, default_left, is_cat, nan_bin)
CASES = {
    "numerical_nan_left": (70, 950, 0, 90, 1, 0, NAN_BIN),
    "numerical_nan_right": (513, 701, 0, 120, 0, 0, NAN_BIN),
    "numerical_no_nan": (0, 1024, 3, 33, 0, 0, -1),
    "onehot_categorical": (301, 599, 4, 17, 0, 1, -1),
    "dead_split": (100, 0, 1, 10, 0, 0, -1),
}


def _comb(bins, vals, rid, score, consts):
    """The JAX package's comb rows: bins, (g*w, h*w, w), row-id bytes,
    then the score and the two constants in f32 (the stream layout's
    columns, unsplit)."""
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
    return random_row_matrix(N, F, 21, n_bins=NAN_BIN + 1, nan_bin=NAN_BIN)


@pytest.fixture(scope="module")
def jax_partition():
    return make_partition_perm(N, C, R=R, size=SIZE, interpret=True,
                               interpret_kernel=True)


@pytest.mark.parametrize("case", list(CASES))
def test_partition_ref_matches_jax_kernel(case, rows_np, jax_partition):
    s0, cnt = CASES[case][:2]
    sel = np.zeros(8, np.int32)
    sel[:7] = CASES[case]
    comb = jnp.asarray(_comb(*rows_np))
    out_j, _, nl_j = jax_partition(jnp.asarray(sel), comb,
                                   jnp.zeros_like(comb))
    out_j = np.asarray(out_j)

    rows = rows_on(rows_np, "cpu")
    nleft = torch.full((1,), -1, dtype=torch.int32)
    partition_ref(rows, empty_rows_like(rows), CASES[case], nleft)
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


def test_scan_then_copyback_is_the_partition(rows_np):
    """The scan writes exactly the final segment into scratch, and the
    copyback moves it, every column, and nothing else."""
    sel = CASES["numerical_nan_left"]
    s0, cnt = sel[:2]
    rows = rows_on(rows_np, "cpu")
    scratch = Rows(*(torch.zeros_like(a) for a in rows))
    nleft = torch.zeros(1, dtype=torch.int32)
    partition_scan_ref(rows, scratch, sel, nleft)
    for a, b in zip(rows, rows_np):          # the scan leaves rows alone
        np.testing.assert_array_equal(a.numpy(), b)
    whole = rows_on(rows_np, "cpu")
    partition_ref(whole, empty_rows_like(whole), sel,
                  torch.zeros(1, dtype=torch.int32))
    copyback_ref(rows, scratch, s0, cnt)
    for a, b in zip(rows, whole):
        assert torch.equal(a, b)
    col = rows_np[0][s0:s0 + cnt, 0].astype(np.int64)
    gl = np.where(col == NAN_BIN, True, col <= sel[3])
    assert int(nleft) == int(gl.sum())
    # left rows keep their order, right rows come reversed
    np.testing.assert_array_equal(rows.rid.numpy()[s0:s0 + int(nleft)],
                                  rows_np[2][s0:s0 + cnt][gl])
    np.testing.assert_array_equal(rows.rid.numpy()[s0 + int(nleft):s0 + cnt],
                                  rows_np[2][s0:s0 + cnt][~gl][::-1])
