"""The comb-direct histogram's launch geometry and its two modes'
arithmetic on the CPU (``ops/hist_kernel2.comb_geometry``,
``csrc/hist_comb.cu``, ``csrc/hist_walk.cuh``).

- The geometry: range mode (one launch, a warp a 32-bin range of one
  feature, every slice) up to ``COMB_RANGE_SLICES`` slices where a
  feature has more than one 32-bin range, feature mode (per-slice
  partials over feature chunks, then the reduction) above; every cell
  has one writer, the shared memory is the library's formula and fits.
- A plain model of the range walk (steps of ``COMB_STAGE_RANGE`` rows,
  each slice's sums moved to running totals where the slice ends, any
  number of times in one step) is bitwise the plain version
  ``build_histogram_comb_ref`` (per-slice histograms added in slice
  order): empty ranges, odd offsets, ranges past the matrix, F not a
  multiple of 4, bins all in one 32-bin range, 1 to 7 slices.
- A model of the word staging (``histwalk::WordRows``: the aligned
  32-bit words that cover a row's staged bins, funnel-shifted into
  place) reproduces the bins at every row alignment, for rows and
  records, and reads no word without a byte of the span.
- pack=2 against pack=1 through ``PackedRows.fields()``.

No GPU is needed; the kernels themselves are held against these on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from chip_smoke import random_row_matrix, rows_on
from lightgbm_tpu_torch.analysis import entries
from lightgbm_tpu_torch.analysis.registry import collect
from lightgbm_tpu_torch.ops import hist_kernel2 as hk
from lightgbm_tpu_torch.ops.device_data import Rows, pack_rows

WORDS = {"feature": 8, "range": 2}   # kFeatureWords, kRangeWords


def _cells_owned(geo, f, b):
    """{(feature, bin): writers} of one slice."""
    owned = {}
    if geo.ranged:
        for x in range(geo.grid[0]):
            for w in range(hk.COMB_WARPS):
                u = x * hk.COMB_WARPS + w
                if u >= f * geo.bin_parts:
                    continue
                lo = (u % geo.bin_parts) * hk.COMB_RANGE_BINS
                for bb in range(lo, min(b, lo + hk.COMB_RANGE_BINS)):
                    key = (u // geo.bin_parts, bb)
                    owned[key] = owned.get(key, 0) + 1
    else:
        for y in range(geo.grid[1]):
            for ff in range(y * geo.feats, min(f, (y + 1) * geo.feats)):
                for bb in range(b):
                    owned[(ff, bb)] = owned.get((ff, bb), 0) + 1
    return owned


@pytest.mark.parametrize("f", [28, 136])
@pytest.mark.parametrize("b", [16, 64, 256, 1024])
@pytest.mark.parametrize("slices", range(1, 10))
def test_mode_grid_and_shared_memory(f, b, slices):
    max_rows = slices * hk.ROWS_PER_BLOCK
    geo = hk.comb_geometry(f, b, max_rows)
    assert geo.slices == slices == hk.hist_blocks(max_rows)
    parts = -(-b // hk.COMB_RANGE_BINS)
    assert geo.ranged == (parts > 1 and slices <= hk.COMB_RANGE_SLICES)
    if geo.ranged:
        assert geo.bin_parts == parts
        assert geo.grid == (-(-f * parts // hk.COMB_WARPS), 1)
        assert geo.feats == hk.rows_direct_feats(f, b)
        assert geo.feats <= hk.COMB_RANGE_FEATS
        assert geo.smem == hk.comb_range_smem(geo.feats)
        # every block's units span at most the staged features
        for x in range(geo.grid[0]):
            u0 = x * hk.COMB_WARPS
            u1 = min(u0 + hk.COMB_WARPS, f * parts) - 1
            assert u1 // parts - u0 // parts + 1 <= geo.feats
    else:
        assert geo.bin_parts == 1 and geo.grid[0] == slices
        assert geo.feats == hk.comb_chunk(f, b, slices) <= hk.COMB_MAX_CHUNK
        assert geo.grid[1] == -(-f // geo.feats)
        # no empty block: the library refuses a geometry with one
        assert (geo.grid[1] - 1) * geo.feats < f
        assert geo.smem == hk.comb_feature_smem(geo.feats, b)
    assert geo.smem <= hk.MAX_SMEM
    owned = _cells_owned(geo, f, b)
    assert set(owned) == {(ff, bb) for ff in range(f) for bb in range(b)}
    assert set(owned.values()) == {1}


@pytest.mark.parametrize("f,b", [(28, 256), (136, 256), (27, 1024),
                                 (28, 64)])
def test_range_mode_boundary(f, b):
    """Range mode up to ``COMB_RANGE_SLICES`` slices (the bound's last
    row), feature mode from the next row on; the switch follows the
    limit ``mode_geometry`` is given."""
    edge = hk.COMB_RANGE_SLICES * hk.ROWS_PER_BLOCK
    assert hk.comb_geometry(f, b, edge).ranged
    assert not hk.comb_geometry(f, b, edge + 1).ranged
    slices = hk.COMB_RANGE_SLICES + 1
    fc = hk.comb_chunk(f, b, slices)
    assert hk.mode_geometry(f, b, slices, fc, slices).ranged
    assert not hk.mode_geometry(f, b, 1, fc, 0).ranged


def test_one_32_bin_range_is_feature_mode():
    """B <= 32: a feature has one range, so the launch is feature mode
    at every size (the fused split's rule)."""
    for max_rows in (1, 5000, 10 ** 6):
        assert not hk.comb_geometry(28, 32, max_rows).ranged


def test_grid_at_the_main_shapes():
    """The median smaller child (the default route's median split
    segment, 13,128 rows) and the 1M-row root at 28 and 136 features."""
    child = hk.comb_geometry(28, 256, 13_128 // 2 + 1)
    assert (child.ranged, child.slices, child.grid) == (True, 2, (28, 1))
    assert hk.comb_geometry(136, 256, 6565).grid == (136, 1)
    root = hk.comb_geometry(28, 256, 10 ** 6)
    assert (root.ranged, root.grid, root.feats) == (False, (245, 2), 14)
    # a child of 97 slices: one feature a warp, 4 blocks of 7 a slice
    big = hk.comb_geometry(28, 256, 394_384)
    assert (big.ranged, big.grid, big.feats) == (False, (97, 4), 7)
    four = hk.comb_geometry(28, 256, 4 * hk.ROWS_PER_BLOCK)
    assert (four.ranged, four.grid, four.feats) == (False, (4, 4), 7)
    wide = hk.comb_geometry(136, 256, 10 ** 6)
    assert (wide.grid, wide.feats, wide.smem) == ((245, 17), 8, 24_576)


@pytest.mark.parametrize("f,slices,fc", [(28, 245, 14), (28, 131, 7),
                                         (28, 132, 14), (27, 200, 14),
                                         (7, 264, 7), (136, 264, 8),
                                         (64, 264, 8), (63, 264, 16),
                                         (63, 60, 8)])
def test_feature_chunk_by_slices(f, slices, fc):
    """One feature a warp (balanced over the chunks) unless the chunk
    rule's blocks reach ``COMB_FILL_BLOCKS`` below
    ``COMB_WIDE_FEATURES`` features."""
    assert hk.comb_chunk(f, 256, slices) == fc


def test_chunks_stay_within_the_staged_words(monkeypatch):
    """Where the chunk rule is kept, a chunk above ``COMB_MAX_CHUNK``
    features is rebalanced over more chunks, and at or below it the
    rule's chunk is kept; from ``COMB_WIDE_FEATURES`` on, one feature a
    warp."""
    monkeypatch.setattr(hk, "comb_feature_chunk", lambda f, b: 60)
    geo = hk.comb_geometry(60, 64, 10 ** 7)
    assert (geo.slices, geo.feats, geo.grid[1]) == (264, 30, 2)
    monkeypatch.setattr(hk, "comb_feature_chunk", lambda f, b: 13)
    assert hk.comb_geometry(60, 64, 10 ** 7).feats == 13
    for f in (hk.COMB_WIDE_FEATURES, 136, 2000):
        assert hk.comb_geometry(f, 256, 10 ** 6).feats == hk.COMB_WARPS


def test_registered_entries_cover_both_modes():
    """The analyzer registers each mode at the routes' shapes: the root
    (feature mode) and the median smaller child (range mode), 28 and
    136 features, both packs, each on the wrapper's geometry."""
    table = collect()
    for f, width in ((28, ""), (136, "_wide")):
        for pack, sfx in ((1, ""), (2, "_p2")):
            root = table[f"hist_comb{width}{sfx}"]
            child = table[f"hist_comb{width}_range{sfx}"]
            assert root.symbol.startswith("hist_comb_partial<")
            assert child.symbol.startswith("hist_comb_range<")
            g_root = hk.comb_geometry(f, 256, entries.N)
            g_child = hk.comb_geometry(f, 256,
                                       entries.MEDIAN_SEGMENT // 2 + 1)
            assert root.dyn_smem == g_root.smem
            assert child.dyn_smem == g_child.smem
            assert child.export == ("hist_comb_smem_bytes",
                                    (g_child.feats, 256, 1))


# -- a plain model of the range walk ------------------------------------------
def range_walk_model(rows: Rows, rng, padded_bins: int, max_rows: int,
                     stage: int = hk.COMB_STAGE_RANGE) -> torch.Tensor:
    """``histwalk::range_hist``'s order of f32 additions over every
    cell at once: the range walked in steps of ``stage`` rows; the rows
    of a step added one by one in row order to the cells; where a slice
    ends (``histblock::slice``'s cut, any number of times in a step) the
    cells are added to the totals and restart at +0; the output is the
    totals plus the last slice's cells."""
    bins = rows.bins.numpy()
    vals = rows.vals.numpy()[:, :2]
    n, f = bins.shape
    lo, hi = hk._window(list(rng), n)
    s = hk.hist_blocks(max_rows)
    per = -(-(hi - lo) // s)
    per = -(-per // 32) * 32
    cuts = [lo + per * k for k in range(1, s)]
    cells = np.zeros((f * padded_bins, 2), np.float32)
    tot = np.zeros_like(cells)
    offsets = np.arange(f) * padded_bins

    def add(a, b):
        if b > a:
            idx = (bins[a:b].astype(np.int64) + offsets).ravel()
            np.add.at(cells, idx, np.repeat(vals[a:b], f, axis=0))
    ci = 0
    for p0 in range(lo, hi, stage):
        end = min(hi, p0 + stage)
        done = p0
        while ci < len(cuts) and cuts[ci] < end:
            add(done, cuts[ci])
            tot = tot + cells
            cells[:] = 0.0
            done = cuts[ci]
            ci += 1
        add(done, end)
    return torch.from_numpy((tot + cells).reshape(f, padded_bins, 2))


def _rows(n, f, seed, n_bins=255):
    return rows_on(random_row_matrix(n, f, seed, n_bins=n_bins), "cpu")


@pytest.mark.parametrize("f,n,rng,max_rows", [
    (28, 9000, (0, 0, 9000), 9000),            # 3 slices, from row 0
    (28, 9000, (101, 0, 4096), 4096),          # 1 slice, odd start
    (27, 12000, (33, 3, 8191), 8192),          # F % 4, 2 slices
    (7, 30000, (5, 0, 28672), 28672),          # 7 slices: the mode's edge
    (7, 30000, (0, 17, 900), 28672),           # 7 slices of 32 rows
    (13, 5000, (4990, 0, 100), 8000),          # past the matrix's end
    (13, 5000, (-40, 10, 100), 100),           # before its start
    (28, 5000, (77, 0, 0), 6000),              # empty
    (28, 5000, (77, 0, -5), 6000),             # negative count
    (29, 20000, (3, 1, 17_000), 20_480),       # 5 slices, cuts mid-step
    (28, 40000, (1, 0, 33_000), 33_000),       # 9 slices (feature mode's)
])
def test_range_walk_is_the_plain_version(f, n, rng, max_rows):
    rows = _rows(n, f, 2 + f)
    want = hk.build_histogram_comb_ref(
        rows, torch.tensor(rng, dtype=torch.int32), padded_bins=256,
        max_rows=max_rows)
    got = range_walk_model(rows, rng, 256, max_rows)
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,stage", [(64, hk.COMB_STAGE_RANGE), (256, 96),
                                     (1024, 32)])
def test_range_walk_bins_in_one_range(b, stage):
    """Every bin in one 32-bin range (the owning warps list every row,
    the others none), at steps that put several cuts in one step."""
    n, f = 6000, 6
    rows = _rows(n, f, 9, n_bins=32)
    rows = Rows(rows.bins + 32, *rows[1:])      # bins 32..63
    rng, max_rows = (11, 0, 5900), 6 * hk.ROWS_PER_BLOCK
    want = hk.build_histogram_comb_ref(
        rows, torch.tensor(rng, dtype=torch.int32), padded_bins=b,
        max_rows=max_rows)
    assert torch.equal(range_walk_model(rows, rng, b, max_rows, stage), want)
    assert want[:, :32].abs().sum() == 0 and want[:, 64:].abs().sum() == 0


# -- the word staging -----------------------------------------------------------
def stage_words(buf: np.ndarray, a: int, nf: int, words: int):
    """``WordRows::load`` and ``store`` for the row whose staged bins
    start at byte ``a`` of ``buf``: the (indices of the) words read and
    the staged bytes."""
    off = a & 3
    w0 = a - off
    n_in = (off + nf + 3) >> 2
    assert n_in <= words + 1

    def word(j):
        return int.from_bytes(bytes(buf[w0 + 4 * j:w0 + 4 * j + 4]),
                              "little") if j < n_in else 0
    w = [word(j) for j in range(words + 1)]
    out = b"".join((((w[k + 1] << 32 | w[k]) >> (8 * off)) & 0xFFFFFFFF)
                   .to_bytes(4, "little") for k in range((nf + 3) >> 2))
    return range(w0 // 4, w0 // 4 + n_in), out


@pytest.mark.parametrize("f,base", [(7, 0), (27, 1), (28, 2), (29, 3),
                                    (136, 0)])
def test_word_staging_reproduces_the_bins(f, base):
    """pack=1 rows of F bytes from a base at any alignment: every row,
    every chunk of the feature-mode rule and every range-mode block's
    features staged as the bins themselves; no word read that holds no
    byte of the span."""
    n = 37
    g = np.random.default_rng(f + base)
    buf = g.integers(0, 256, size=base + n * f + 8, dtype=np.uint8)
    spans = []
    for fc in {hk.comb_chunk(f, 256, s) for s in (1, 245)}:
        spans += [(y * fc, min(fc, f - y * fc), "feature")
                  for y in range(-(-f // fc))]
    for x in range(-(-f * 8 // hk.COMB_WARPS)):
        lo = x * hk.COMB_WARPS // 8
        hi = (min(x * hk.COMB_WARPS + hk.COMB_WARPS, f * 8) - 1) // 8
        spans.append((lo, hi - lo + 1, "range"))
    for r in range(n):
        for f_lo, nf, mode in spans:
            a = base + r * f + f_lo
            read, out = stage_words(buf, a, nf, WORDS[mode])
            assert out[:nf] == bytes(buf[a:a + nf])
            assert read.start * 4 <= a and (read.stop - 1) * 4 < a + nf


def test_word_staging_of_records():
    """pack=2 records (stride S, bins at byte 0): the same staged bytes
    as the pack=1 rows, and the values at byte Fb."""
    f = 28
    rows = _rows(50, f, 3)
    packed = pack_rows(rows)
    buf = packed.buf.numpy().reshape(-1)
    s, fb = packed.layout.stride, packed.layout.fb
    fc = hk.comb_chunk(f, 256, 245)
    for r in range(50):
        for f_lo in range(0, f, fc):
            nf = min(fc, f - f_lo)
            _, out = stage_words(buf, r * s + f_lo, nf, WORDS["feature"])
            assert out[:nf] == rows.bins[r, f_lo:f_lo + nf].numpy().tobytes()
        v = buf[r * s + fb:r * s + fb + 8].view(np.float32)
        assert np.array_equal(v, rows.vals[r, :2].numpy())


@pytest.mark.parametrize("f,rng,max_rows", [(28, (0, 0, 3000), 3000),
                                            (27, (7, 1, 2000), 9000),
                                            (28, (100, 0, 2900), 40_000)])
def test_pack2_equals_pack1(f, rng, max_rows):
    rows = _rows(3000, f, 12)
    packed = pack_rows(rows)
    t = torch.tensor(rng, dtype=torch.int32)
    one = hk.build_histogram_comb(rows, t, padded_bins=256,
                                  max_rows=max_rows)
    two = hk.build_histogram_comb_p2(packed, t, padded_bins=256,
                                     max_rows=max_rows)
    assert torch.equal(one, two)
    assert torch.equal(
        two, hk.build_histogram_comb_ref(packed.fields(), t, padded_bins=256,
                                         max_rows=max_rows))
