"""The port's comb-direct histogram against the JAX package's, on the
CPU.

The JAX side runs ``build_histogram_comb`` with its Pallas kernel in
interpret mode over the 128-lane comb; the port runs its plain version
(``build_histogram_comb_ref``, which adds in the CUDA kernel's order)
over the same rows.  Inputs are made from a seed with numpy and handed
to both; the values are rounded to bf16 first, as the JAX package's
physical path rounds them before its kernel (whose MXU operands are
bf16), so both sides sum the same f32 values.  Tolerance: the two
sum them in different orders, so every bin must agree within
``4 * n * eps_f32 * max|v|``, n the rows of the range and max|v| the
largest value among them.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from chip_smoke import hist_tolerance, random_row_matrix, rows_on
from lightgbm_tpu.ops.histogram import build_histogram as jax_histogram
from lightgbm_tpu.ops.pallas.hist_kernel2 import build_histogram_comb as \
    jax_comb_histogram
from lightgbm_tpu_torch.ops.hist_kernel2 import (block_ranges,
                                                 build_histogram_comb,
                                                 build_histogram_comb_ref)
from lightgbm_tpu_torch.ops.histogram import (build_histogram,
                                              subtract_histogram)

C, F, B = 128, 8, 256
N = 5000
N_ALLOC = N + 2 * 2048


@pytest.fixture(scope="module")
def data():
    arrays = list(random_row_matrix(N_ALLOC, F, 4))
    vals = torch.tensor(arrays[1]).bfloat16().float().numpy()
    vals[N:] = 0.0             # slack rows, as the JAX comb keeps them
    arrays[1] = vals
    comb = np.zeros((N_ALLOC, C), np.float32)
    comb[:, :F] = arrays[0]
    comb[:, F:F + 3] = vals
    return tuple(arrays), jnp.asarray(comb)


@pytest.mark.parametrize("start,off,count", [(0, 0, N), (1237, 3, 2011),
                                             (4000, 17, 999)])
def test_comb_histogram_matches_jax(data, start, off, count):
    arrays, comb = data
    want = np.asarray(jax_comb_histogram(
        comb, jnp.int32(start), jnp.int32(off), jnp.int32(count), f_pad=F,
        size=off + count, padded_bins=B, rows_per_block=512,
        interpret=True))
    rows = rows_on(arrays, "cpu")
    rng = torch.tensor([start, off, count], dtype=torch.int32)
    got = build_histogram_comb(rows, rng, padded_bins=B,
                               max_rows=count).numpy()
    assert got.shape == want.shape == (F, B, 2)
    tol = hist_tolerance(rows, (start, off, count))
    assert np.abs(got - want).max() <= tol


def test_ref_adds_in_kernel_order(data):
    """Blocked, in the kernel's order: bitwise repeatable, equal to the
    one-pass sum within the tolerance, and the blocks tile the range."""
    rows = rows_on(data[0], "cpu")
    rng = torch.tensor([11, 2, 4321], dtype=torch.int32)
    a = build_histogram_comb_ref(rows, rng, padded_bins=B, max_rows=9000)
    b = build_histogram_comb_ref(rows, rng, padded_bins=B, max_rows=9000)
    assert torch.equal(a, b)
    one = build_histogram(rows.bins[13:13 + 4321], rows.vals[13:13 + 4321, :2],
                          padded_bins=B)
    assert (a - one).abs().max() <= hist_tolerance(rows, (11, 2, 4321))
    blocks = block_ranges(13, 13 + 4321, 3)
    assert blocks[0][0] == 13 and blocks[-1][1] == 13 + 4321
    assert all(x[1] == y[0] for x, y in zip(blocks, blocks[1:]))


def test_out_of_range_rows_contribute_nothing(data):
    """A window reaching past either end of the matrix sums only the
    rows inside it."""
    rows = rows_on(data[0], "cpu")
    lo_cut = build_histogram_comb(
        rows, torch.tensor([-40, 10, 100], dtype=torch.int32),
        padded_bins=B, max_rows=100)
    want = build_histogram(rows.bins[:70], rows.vals[:70, :2],
                           padded_bins=B)
    assert torch.equal(lo_cut, want)
    hi_cut = build_histogram_comb(
        rows, torch.tensor([N_ALLOC - 5, 0, 100], dtype=torch.int32),
        padded_bins=B, max_rows=100)
    want = build_histogram(rows.bins[-5:], rows.vals[-5:, :2],
                           padded_bins=B)
    assert torch.equal(hi_cut, want)


def test_build_histogram_and_subtraction_match_jax(data):
    bins, vals = data[0][:2]
    want = np.asarray(jax_histogram(jnp.asarray(bins[:N]),
                                    jnp.asarray(vals[:N, :2]),
                                    padded_bins=B))
    got = build_histogram(torch.tensor(bins[:N]), torch.tensor(vals[:N, :2]),
                          padded_bins=B)
    rows = rows_on(data[0], "cpu")
    assert np.abs(got.numpy() - want).max() <= hist_tolerance(
        rows, (0, 0, N))
    child = build_histogram(torch.tensor(bins[:N // 3]),
                            torch.tensor(vals[:N // 3, :2]), padded_bins=B)
    sib = subtract_histogram(got, child)
    assert torch.equal(sib, got - child)
