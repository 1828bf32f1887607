"""The port's row-indexed histogram (``build_histogram_rows``, the
kernel ``csrc/hist_rows.cu``) against the JAX package's, on the CPU.

The JAX side runs ``build_histogram_pallas2`` and
``build_histogram_pallas`` with their Pallas kernels in interpret mode,
and ``build_histogram(impl="scatter")``; the port runs its plain version
(``build_histogram_rows_ref``, which adds in the CUDA kernel's order).
Inputs are made from a seed with numpy and handed to both.

Tolerances: against the Pallas kernels the values are small dyadics
(k / 8, |k| <= 16) that bf16 holds exactly and whose every partial sum
f32 holds exactly, so the histograms are equal (``==``) whatever the
order of the sums or the kernel's operand precision.  Against the
scatter form on random f32 values every cell agrees within 1e-6 of the
largest cell (f32 sums in another order).  An indexed range equals the
histogram of the gathered rows bitwise (the same rows in the same
slices).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lightgbm_tpu.ops.histogram import build_histogram as jax_histogram
from lightgbm_tpu.ops.histogram import feature_group_size
from lightgbm_tpu.ops.pallas.hist_kernel import build_histogram_pallas
from lightgbm_tpu.ops.pallas.hist_kernel2 import build_histogram_pallas2
from lightgbm_tpu_torch.ops.hist_kernel2 import (MAX_SMEM, ROWS_RANGE,
                                                 ROWS_WARPS, block_ranges,
                                                 hist_blocks,
                                                 build_histogram_rows,
                                                 build_histogram_rows_ref,
                                                 rows_blocks,
                                                 rows_direct_smem_bytes,
                                                 rows_geometry,
                                                 rows_smem_bytes)
from lightgbm_tpu_torch.ops.histogram import build_histogram
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)
N = 3000


def _bins(n, f, b, seed):
    """Seeded bins below b (u8 at b <= 256, else u16), some rows in the
    last real bins."""
    rng = np.random.default_rng(seed)
    dt = np.uint8 if b <= 256 else np.uint16
    bins = rng.integers(0, b, size=(n, f)).astype(dt)
    bins[rng.random(n) < 0.05, 0] = b - 1
    return bins


def _rng(start, count):
    return torch.tensor([start, count], dtype=torch.int32)


@pytest.mark.parametrize("b", [256, 1024])
@pytest.mark.parametrize("kernel", ["pallas2", "pallas"])
def test_rows_ref_equals_pallas_kernels(kernel, b):
    """Exact-sum inputs: the plain version equals both TPU kernels in
    interpret mode, u8 bins at B = 256 and u16 at B = 1024, F a multiple
    of the kernels' feature group."""
    f = 2 * feature_group_size(b)
    bins = _bins(N, f, b, 1)
    vals = (np.random.default_rng(2).integers(-16, 17, size=(N, 2)) / 8
            ).astype(np.float32)
    fn = build_histogram_pallas2 if kernel == "pallas2" else \
        build_histogram_pallas
    want = np.asarray(fn(jnp.asarray(bins), jnp.asarray(vals), padded_bins=b,
                         interpret=True))
    got = build_histogram_rows_ref(torch.from_numpy(bins),
                                   torch.from_numpy(vals), _rng(0, N),
                                   padded_bins=b, max_rows=N).numpy()
    assert got.shape == want.shape == (f, b, 2)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("b,f", [(256, 7), (1024, 5), (1040, 3)])
def test_rows_ref_matches_jax_scatter(b, f):
    """Random f32 values: the plain version against the JAX package's
    scatter histogram (what it runs off the TPU) within 1e-6 of the
    largest cell."""
    bins = _bins(N, f, b, 3)
    vals = np.random.default_rng(4).normal(size=(N, 2)).astype(np.float32)
    want = np.asarray(jax_histogram(jnp.asarray(bins.astype(np.int32)),
                                    jnp.asarray(vals), padded_bins=b,
                                    impl="scatter"))
    got = build_histogram_rows(torch.from_numpy(bins),
                               torch.from_numpy(vals), _rng(0, N),
                               padded_bins=b, max_rows=N).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("b,start,count,max_rows", [
    (256, 0, N, N), (1024, 1237, 1500, 2000), (1040, 7, 999, 999),
    (256, 2900, 500, 500), (1024, 10, 0, 100)])
def test_indexed_range_equals_gathered_rows(b, start, count, max_rows):
    """Through a seeded permutation index, positions [start, start +
    count) (cut at the index's end) give the histogram of the gathered
    rows bitwise, and the one-pass sum within 4 * n * eps * max|v|."""
    f = 6
    bins = torch.from_numpy(_bins(N, f, b, 5))
    vals = torch.from_numpy(
        np.random.default_rng(6).normal(size=(N, 2)).astype(np.float32))
    index = torch.from_numpy(
        np.random.default_rng(7).permutation(N).astype(np.int32))
    got = build_histogram_rows(bins, vals, _rng(start, count), index=index,
                               padded_bins=b, max_rows=max_rows)
    rows = index[start:start + count].long()
    m = rows.numel()
    gathered = build_histogram_rows(bins[rows], vals[rows], _rng(0, m),
                                    padded_bins=b, max_rows=max_rows)
    assert torch.equal(got, gathered)
    one = build_histogram(bins[rows].to(torch.int32), vals[rows],
                          padded_bins=b)
    vmax = float(vals[rows].abs().max()) if m else 0.0
    assert (got - one).abs().max() <= 4 * m * 1.2e-7 * vmax


def test_windows_cut_at_the_ends():
    """A range reaching past either end of the positions sums only the
    positions inside it; a negative count sums nothing."""
    bins = torch.from_numpy(_bins(500, 3, 256, 8))
    vals = torch.from_numpy(
        np.random.default_rng(9).normal(size=(500, 2)).astype(np.float32))
    lo_cut = build_histogram_rows(bins, vals, _rng(-40, 100), padded_bins=256,
                                  max_rows=100)
    assert torch.equal(lo_cut, build_histogram(bins[:60], vals[:60],
                                               padded_bins=256))
    hi_cut = build_histogram_rows(bins, vals, _rng(495, 100), padded_bins=256,
                                  max_rows=100)
    assert torch.equal(hi_cut, build_histogram(bins[495:], vals[495:],
                                               padded_bins=256))
    none = build_histogram_rows(bins, vals, _rng(3, -5), padded_bins=256,
                                max_rows=10)
    assert not none.any()


def test_rows_blocks_geometry():
    """At B <= 256 the slices are hist_comb's; wider bins take fewer,
    longer slices, so the 1M-row root's partials at F = 28, B = 1024
    stay under a quarter of its input bytes; the slices tile the range."""
    for m in (1, 3000, 250_000, 1_000_000, 5_000_000):
        assert rows_blocks(m, 256) == hist_blocks(m)
        assert rows_blocks(m, 1024) <= rows_blocks(m, 256)
    s = rows_blocks(1_000_000, 1024)
    partials = s * 28 * 1024 * 8
    assert partials < 0.25 * 1_000_000 * (28 * 2 + 8)
    sl = block_ranges(13, 13 + 987_654, s)
    assert sl[0][0] == 13 and sl[-1][1] == 13 + 987_654
    assert all(a[1] == c[0] for a, c in zip(sl, sl[1:]))


def test_wrapper_refuses_other_devices():
    """Only CPU tensors take the plain version; any device but the card
    raises."""
    bins = torch.zeros((4, 2), dtype=torch.uint8, device="meta")
    vals = torch.zeros((4, 2), dtype=torch.float32, device="meta")
    with pytest.raises(LightGBMError, match="cuda or cpu"):
        build_histogram_rows(bins, vals, _rng(0, 4), padded_bins=16,
                             max_rows=4)


def _cell_writers(geo, f, b):
    """[slices, F, B] writers of each cell under ``geo``, counted the way
    the kernels map blocks and warps to cells: in one launch warp ``w``
    of block ``x`` owns unit ``x * ROWS_WARPS + w`` (below ``f *
    bin_parts``), feature ``u // bin_parts`` and bins ``[(u % bin_parts)
    * 32, ... + 32)`` cut at ``b``, in every slice; with partials block
    ``(x, y)`` owns slice ``x`` of features ``[y * feats, (y + 1) *
    feats)`` cut at ``f``, every bin."""
    writers = np.zeros((geo.slices, f, b), dtype=np.int64)
    if geo.direct:
        for x in range(geo.grid[0]):
            for w in range(ROWS_WARPS):
                u = x * ROWS_WARPS + w
                if u >= f * geo.bin_parts:
                    continue
                lo = (u % geo.bin_parts) * ROWS_RANGE
                writers[:, u // geo.bin_parts, lo:lo + ROWS_RANGE] += 1
    else:
        for x in range(geo.grid[0]):
            for y in range(geo.grid[1]):
                writers[x, y * geo.feats:(y + 1) * geo.feats, :] += 1
    return writers


@pytest.mark.parametrize("f", [1, 28, 136])
@pytest.mark.parametrize("b,edge,bin_bytes", [
    (256, 4096, 1), (256, 4096, 2), (1024, 16_384, 2), (1040, 16_384, 2)])
def test_rows_geometry_one_writer_a_cell(f, b, edge, bin_bytes):
    """The geometry of a hist_rows call around the one-slice edge and the
    direct kernel's two-slice edge (``max_rows`` = edge: one slice;
    edge + 1 and 2 * edge: two, still one launch of the direct kernel,
    ceil(B / 32) bin parts a feature; 2 * edge + 1: three, the partial
    kernel and the reduction, eight features a block or fewer): every
    cell of every slice has exactly one writer, and a block's shared
    memory fits the card."""
    for max_rows, slices in ((1, 1), (edge, 1), (edge + 1, 2),
                             (2 * edge, 2), (2 * edge + 1, 3),
                             (1_000_000, rows_blocks(1_000_000, b))):
        assert rows_blocks(max_rows, b) == slices
        geo = rows_geometry(f, b, bin_bytes, slices)
        assert geo.slices == slices
        assert geo.direct == (slices <= 2)
        if geo.direct:
            assert geo.bin_parts == -(-b // ROWS_RANGE)
            assert geo.grid == (-(-f * geo.bin_parts // ROWS_WARPS), 1)
            assert 1 <= geo.feats <= min(f, ROWS_WARPS)
            assert geo.smem == rows_direct_smem_bytes(geo.feats, bin_bytes)
        else:
            assert geo.bin_parts == 1
            assert geo.grid == (slices, -(-f // geo.feats))
            assert geo.smem == rows_smem_bytes(geo.feats, b, bin_bytes)
        assert geo.smem <= MAX_SMEM
        assert (_cell_writers(geo, f, b) == 1).all()


def test_rows_geometry_direct_block_counts():
    """In one launch a child of the row-order route (F = 28, B = 1024)
    runs on 112 blocks, each staging one feature; at B = 1040 a block's
    eight 32-bin ranges may span two features; at B = 256 a block is one
    whole feature."""
    assert rows_geometry(28, 1024, 2, rows_blocks(3000, 1024))[:5] == (
        1, True, (112, 1), 1, 32)
    assert rows_geometry(28, 1024, 2, rows_blocks(23_854, 1024))[:5] == (
        2, True, (112, 1), 1, 32)
    assert rows_geometry(28, 1040, 2, 1).feats == 2
    assert rows_geometry(28, 256, 1, 1)[:5] == (1, True, (28, 1), 1, 8)
