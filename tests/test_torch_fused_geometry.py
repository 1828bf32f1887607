"""The fused split's launch geometry (``ops/fused_split.fused_geometry``)
on the CPU: the cells, rows and grid the kernels of
``csrc/fused_split.cu`` are given.

Each histogram cell has one writer (range mode: warp ``w`` of block
``z`` owns feature ``u // parts``'s bins ``[(u % parts) * 32, ... +
32)``, ``u = z * 8 + w``; feature mode: block ``z`` owns features
``[z * feats, z * feats + feats)``), every destination row lies in
exactly one slice, and the slices are ``hist_kernel2.block_ranges`` of
``hist_blocks(cnt // 2 + 1)``, the cut the plain version adds in.  No
GPU is needed.
"""
import pytest

from lightgbm_tpu_torch.ops.fused_split import (HIST_WARPS, RANGE_BINS,
                                                RANGE_SLICES, fused_geometry,
                                                fused_supported,
                                                hist_smem_bytes,
                                                staged_features)
from lightgbm_tpu_torch.ops.hist_kernel2 import (MAX_SMEM, block_ranges,
                                                 hist_blocks)
from lightgbm_tpu_torch.ops.partition_kernel import SCAN_TILE

# the default route's median split segment and the 1M-row root
MEDIAN, ROOT = 13_128, 1_000_000
SHAPES = [(28, 256), (27, 256), (71, 256), (28, 64), (8, 128), (1, 256),
          (43, 512)]
COUNTS = [1, 2, 3000, 8190, 8192, 8194, MEDIAN, 50_000, 132_000,
          200_000, ROOT]


def _owners(geo, f, b):
    """{(feature, bin): writers} of one slice and side."""
    owned = {}
    for z in range(geo.groups):
        if geo.parts == 1:
            cells = [(ff, bb) for ff in range(z * geo.feats,
                                               min(f, (z + 1) * geo.feats))
                     for bb in range(b)]
        else:
            cells = []
            for w in range(HIST_WARPS):
                u = z * HIST_WARPS + w
                if u >= f * geo.parts:
                    continue
                lo = (u % geo.parts) * RANGE_BINS
                cells += [(u // geo.parts, bb)
                          for bb in range(lo, min(b, lo + RANGE_BINS))]
        for c in cells:
            owned[c] = owned.get(c, 0) + 1
    return owned


@pytest.mark.parametrize("f,b", SHAPES)
@pytest.mark.parametrize("cnt", COUNTS)
def test_one_writer_a_cell(f, b, cnt):
    if not fused_supported(f, b):
        pytest.skip("shape outside the fused route")
    geo = fused_geometry(f, b, cnt)
    owned = _owners(geo, f, b)
    assert set(owned) == {(ff, bb) for ff in range(f) for bb in range(b)}
    assert set(owned.values()) == {1}
    # no empty block: the library refuses a geometry with one
    if geo.parts == 1:
        assert (geo.groups - 1) * geo.feats < f <= geo.groups * geo.feats
    else:
        assert geo.parts == -(-b // RANGE_BINS)
        assert ((geo.groups - 1) * HIST_WARPS < f * geo.parts
                <= geo.groups * HIST_WARPS)


@pytest.mark.parametrize("cnt", COUNTS)
def test_slices_cover_every_destination_row_once(cnt):
    geo = fused_geometry(28, 256, cnt)
    assert geo.slices == hist_blocks(cnt // 2 + 1)
    assert geo.tiles == -(-cnt // SCAN_TILE)
    assert (geo.tiles - 1) * SCAN_TILE < cnt <= geo.tiles * SCAN_TILE
    # each side's destination ranks, for sides of every size the split
    # can give
    for side in sorted({0, 1, cnt // 3, cnt // 2, cnt - 1, cnt}):
        if side < 0:
            continue
        seen = []
        for lo, hi in block_ranges(0, side, geo.slices):
            assert lo <= hi
            seen += range(lo, hi)
        assert seen == list(range(side))


@pytest.mark.parametrize("f,b", SHAPES)
def test_shared_memory_fits(f, b):
    if not fused_supported(f, b):
        pytest.skip("shape outside the fused route")
    for cnt in COUNTS:
        geo = fused_geometry(f, b, cnt)
        assert geo.smem == hist_smem_bytes(geo.feats, geo.parts, b)
        assert geo.smem <= MAX_SMEM


@pytest.mark.parametrize("f,b", SHAPES)
def test_range_blocks_stage_every_feature_they_span(f, b):
    """A range-mode block stages the columns of the features its units
    span: never more than the shared memory holds."""
    if not fused_supported(f, b):
        pytest.skip("shape outside the fused route")
    geo = fused_geometry(f, b, MEDIAN)
    if geo.parts == 1:
        pytest.skip("feature mode")
    for z in range(geo.groups):
        u0 = z * HIST_WARPS
        u1 = min(u0 + HIST_WARPS, f * geo.parts) - 1
        assert u1 // geo.parts - u0 // geo.parts + 1 <= staged_features(
            0, geo.parts)


def test_grid_at_the_median_and_the_root():
    med = fused_geometry(28, 256, MEDIAN)
    # range mode: 28 features x 8 ranges of 32 bins, 8 warps a block
    assert (med.grid, med.parts) == ((2, 2, 28), 8)
    assert med.slices * 2 * med.groups == 112
    root = fused_geometry(28, 256, ROOT)
    # feature mode: two blocks of 14 features a slice and side
    assert (root.grid, root.feats, root.parts) == ((123, 2, 2), 14, 1)


@pytest.mark.parametrize("cnt,slices,parts", [(57_342, 7, 8),
                                               (57_344, 8, 1)])
def test_mode_edge(cnt, slices, parts):
    """Range mode up to ``RANGE_SLICES`` slices, feature mode above."""
    geo = fused_geometry(28, 256, cnt)
    assert (geo.slices, geo.parts) == (slices, parts)
    assert geo.slices <= RANGE_SLICES or geo.parts == 1


def test_geometry_depends_on_the_count_through_its_slices():
    """Counts of one slice count share the cached histogram geometry;
    only the count tiles differ."""
    from lightgbm_tpu_torch.ops.fused_split import _hist_geometry
    fused_geometry(28, 256, MEDIAN)
    hits = _hist_geometry.cache_info().hits
    a, b = fused_geometry(28, 256, MEDIAN), fused_geometry(28, 256, 16_000)
    assert _hist_geometry.cache_info().hits == hits + 2
    assert a[1:] == b[1:] and (a.tiles, b.tiles) == (13, 16)
