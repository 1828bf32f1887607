"""The partition scans' geometry and a plain model of their kernel, on
the CPU (no GPU, nvcc or triton needed).

``ops/partition_kernel.scan_geometry`` sizes the one-launch scan of
``csrc/partition_scan.cuh`` (``scan_tiles``), which ``partition_scan``,
``partition_scan_p2`` and the first launch of ``partition_3ph`` run:

- the geometry: every row of a segment in one tile, the staging inside
  the 227 KB a block may use beside the kernel's static part, the
  largest tile within the budget, staged up to about 740 features and
  unstaged past them (any width, 20,000 features included);
- a numpy model of the kernel, tile by tile: the cp.async staging of
  each array's contiguous byte range (a head of up to 15 bytes), or the
  bins / records read in place when unstaged, the ballot ranks, the
  decoupled look-back under a seeded random interleaving of the blocks,
  the left run and the reversed right run written word by word (16-byte
  words at pack=2, bytes for bins of F % 4 != 0),
  each destination word written once, and the 3-phase copyback that
  reverses the right run back: bitwise ``partition_scan_ref`` /
  ``partition_3ph_ref`` on adversarial segments (every row left, every
  row right, one row, one row past a tile boundary, an odd ``s0`` with
  the NaN bin routed either way, one-hot categorical, 8 membership
  words) at F = 27, 28 and 136 and pack=2, at several tile sizes;
- the plain versions against the JAX package's kernels on the same
  segments: ``make_partition_perm`` (the ``make_partition_ss`` scan and
  copyback through the Pallas interpreter, as tests/test_partition_perm.py
  runs them), ``make_partition_p2`` likewise, and ``make_partition``
  (its interpret emulation, as tests/test_torch_part3ph.py runs it).

Tolerance: none, the bytes are equal.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from chip_smoke import partition_edge_cases, random_row_matrix, rows_on
from lightgbm_tpu.ops.pallas.partition_kernel import make_partition
from lightgbm_tpu.ops.pallas.partition_kernel3 import (make_partition_p2,
                                                       make_partition_perm)
from lightgbm_tpu_torch.ops import partition_kernel as pk
from lightgbm_tpu_torch.ops.device_data import (PackedRows, RecordLayout,
                                                empty_packed_like,
                                                empty_rows_like, pack_rows)
from lightgbm_tpu_torch.utils.log import LightGBMError

THREADS = pk.SCAN_THREADS
# csrc/partition_3ph.cu: rows a copyback block moves
BACK_ROWS = 128
NAN_BIN = 200
# the tile the JAX comparisons' segments are cut for (their sizes only)
JAX_TILE = 256


def _stride(f: int, pack: int):
    return RecordLayout(f).stride if pack == 2 else None


# -- the geometry -------------------------------------------------------------
@pytest.mark.parametrize("cnt", [1, 31, 1024, 1025, 13_128, 1_000_000])
@pytest.mark.parametrize("pack", [1, 2])
@pytest.mark.parametrize("f", [1, 6, 27, 28, 71, 136, 500, 2000, 8000,
                               20_000])
def test_geometry_covers_every_row_once_and_fits(f, pack, cnt):
    stride = _stride(f, pack)
    geo = pk.scan_geometry(cnt, f, stride)
    assert geo.tile in pk.SCAN_TILES and geo.tile % 32 == 0
    assert geo.tile <= 1024                   # 32 ballot groups at most
    assert geo.smem == pk.scan_smem(geo.tile, f, stride, geo.staged)
    assert geo.smem + pk.SCAN_STATIC_SMEM <= pk.MAX_SMEM
    assert geo.smem <= pk.SCAN_SMEM_BUDGET
    # the tiles cover [0, cnt) once: each row has one block, one writer
    assert (geo.tiles - 1) * geo.tile < cnt <= geo.tiles * geo.tile
    # staged where some tile fits the budget with the bins, and then the
    # largest such tile; else the largest unstaged tile within it
    staged_fits = [t for t in pk.SCAN_TILES
                   if pk.scan_smem(t, f, stride) <= pk.SCAN_SMEM_BUDGET]
    assert geo.staged == bool(staged_fits)
    assert all(pk.scan_smem(t, f, stride, geo.staged) > pk.SCAN_SMEM_BUDGET
               for t in pk.SCAN_TILES if t > geo.tile)
    assert geo.staged == (f < 738 if pack == 1 else stride <= 736)
    # each staged array's region holds its tile from any 4-byte-aligned
    # start
    widths = [stride] if pack == 2 else [f, 12, 4, 4, 8]
    if not geo.staged:
        widths = widths[1:]
    assert sum(pk.stage_bytes(geo.tile * w) for w in widths) == geo.smem
    for w in widths:
        for head in range(0, 16, 4 if pack == 1 and w % 4 == 0 else 1):
            chunks = -(-(head + geo.tile * w) // 16)
            assert 16 * chunks <= pk.stage_bytes(geo.tile * w)


@pytest.mark.parametrize("tile", [32, 64, 128, 256, 512, 1024])
def test_geometry_takes_any_kernel_tile(tile):
    geo = pk.scan_geometry(5_000, 28, tile=tile)
    assert geo == (tile, -(-5_000 // tile), pk.scan_smem(tile, 28), True)
    # a tile a block cannot stage is read unstaged; staging it is refused
    wide = pk.scan_geometry(5_000, 20_000, tile=tile)
    assert not wide.staged
    assert wide.smem == pk.scan_smem(tile, 20_000, staged=False)
    with pytest.raises(LightGBMError):
        pk.scan_geometry(5_000, 20_000, tile=tile, staged=True)


@pytest.mark.parametrize("kw", [dict(tile=100), dict(tile=2048),
                                dict(tile=0),
                                dict(record_stride=16 * 500, tile=512,
                                     staged=True)])
def test_geometry_refuses_what_the_kernel_cannot_take(kw):
    kw = dict(dict(num_features=28), **kw)
    with pytest.raises(LightGBMError):
        pk.scan_geometry(10_000, **kw)


def test_static_smem_is_the_kernels():
    """SCAN_STATIC_SMEM, which the geometry adds to the dynamic bytes, is
    every scan_tiles instantiation's static shared memory in the card's
    resource report."""
    text = (Path(pk.__file__).parents[1] / "analysis"
            / "resources_sm90a.txt").read_text()
    found = re.findall(r"part::scan_tiles<[^>]*>\s.*?smem=(\d+)", text)
    assert len(found) == 6
    assert {int(x) for x in found} == {pk.SCAN_STATIC_SMEM}


# -- the kernel's index walks -------------------------------------------------
@pytest.mark.parametrize("wpr", [1, 2, 3, 4, 7, 27, 34, 64, 136, 255, 256,
                                 257, 600])
def test_word_walks_equal_division(wpr):
    """write_runs' walk (p, k) += (256 // wpr, 256 % wpr) with a carry,
    and move_back's four steps a round, visit i // wpr, i % wpr."""
    total = 40 * 256 + 17
    for tid in (0, 1, 31, 255):
        p, k = divmod(tid, wpr)
        dq, dr = divmod(THREADS, wpr)
        for i in range(tid, total, THREADS):
            assert (p, k) == divmod(i, wpr)
            k += dr
            p += dq
            if k >= wpr:
                k -= wpr
                p += 1


# -- a plain model of the kernel ----------------------------------------------
AGG, PREFIX = 1, 2


def lookback_prefixes(counts, seed: int):
    """Each tile's left rows before it, from a model of scan_tiles'
    decoupled look-back: tickets in order, the blocks' steps (take a
    ticket, publish the count, read a window of 32 status words, publish
    the prefix) interleaved at random; a block whose window holds an
    unpublished word waits.  Returns the prefixes and the final status
    words."""
    rng = np.random.default_rng(seed)
    n = len(counts)
    flag = np.zeros(n, np.int64)
    val = np.zeros(n, np.int64)
    started, state, before = 0, {}, {}
    for _ in range(100 * n + 1000):
        if len(before) == n:
            break
        live = [t for t in range(started) if t not in before]
        pick = live + ([started] if started < n else [])
        t = pick[rng.integers(len(pick))]
        if t == started:
            started += 1
            continue
        if t not in state:
            flag[t], val[t] = (PREFIX if t == 0 else AGG), counts[t]
            state[t] = (t - 1, 0)
            continue
        j, acc = state[t]
        if j < 0:
            before[t] = acc
            continue
        win = np.arange(j, j - 32, -1)
        ok = win >= 0
        fl = np.where(ok, flag[np.maximum(win, 0)], PREFIX)
        if (fl == 0).any():
            continue                        # spins on an unpublished word
        v = np.where(ok, val[np.maximum(win, 0)], 0)
        hit = np.nonzero(fl == PREFIX)[0]
        acc += int(v[:(hit[0] if len(hit) else 31) + 1].sum())
        if len(hit):
            before[t] = acc
            flag[t], val[t] = PREFIX, acc + counts[t]
        else:
            state[t] = (j - 32, acc)
    assert len(before) == n, "the look-back model did not finish"
    return np.array([before[t] for t in range(n)], np.int64), flag, val


def _stage(flat: np.ndarray, byte0: int, n: int, cap: int) -> np.ndarray:
    """stage_span: bytes [byte0, byte0 + n) of a 16-byte-aligned buffer
    into a region of ``cap`` bytes as 16-byte chunks from the boundary
    at or below byte0, the last chunk zero past the end; the staged
    bytes from the head on."""
    head = byte0 % 16
    total = n + head
    chunks = -(-total // 16)
    assert 16 * chunks <= cap
    smem = np.full(cap, 0xEE, np.uint8)
    smem[:16 * chunks] = 0
    smem[:total] = flat[byte0 - head:byte0 + n]
    return smem[head:head + n]


def _arrays(rows):
    """[(flat bytes, row bytes, word bytes)] of each array the kernel
    moves: the five arrays (bins in 4-byte words when F % 4 == 0, else
    bytes), or the records in 16-byte words."""
    if isinstance(rows, PackedRows):
        s = rows.layout.stride
        return [(rows.buf.numpy().reshape(-1), s, 16)]
    out = []
    for a in rows:
        row = a.numpy().reshape(a.shape[0], -1).view(np.uint8)
        width = row.shape[1]
        word = 4 if width % 4 == 0 else 1
        out.append((np.ascontiguousarray(row).reshape(-1), width, word))
    return out


def _words(flat: np.ndarray, word: int) -> np.ndarray:
    return flat.view(np.dtype((np.void, word)))


def model_scan(rows, scratch, sel, tile: int, seed: int = 0,
               staged: bool = True) -> int:
    """scan_tiles on CPU arrays, tile by tile, into ``scratch`` (numpy
    views of its tensors), the bins (records) staged or read in place;
    returns nleft.  Asserts that each word of the segment is written
    once and no other."""
    s0, cnt = int(sel[0]), int(sel[1])
    fields = rows.fields() if isinstance(rows, PackedRows) else rows
    col = fields.bins[s0:s0 + cnt, int(sel[2])].to(torch.int32)
    left = pk.go_left(col, sel).numpy()
    tiles = -(-cnt // tile)
    padded = np.zeros(tiles * tile, bool)
    padded[:cnt] = left
    groups = padded.reshape(tiles, tile // 32, 32)
    mask = (groups.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        -1).astype(np.uint32)                               # the ballots
    counts = groups.sum((1, 2))
    before, _, _ = lookback_prefixes(counts, seed)
    nleft = int(before[-1] + counts[-1])
    srcs, dsts = _arrays(rows), _arrays(scratch)
    hits = [np.zeros(len(d) // w, np.int64) for d, _, w in dsts]
    cap_rows = tile
    for t in range(tiles):
        first = t * tile
        m = min(tile, cnt - first)
        r0 = s0 + first
        nl = int(counts[t])
        nr = m - nl
        # ranks from the group masks and their exclusive prefix
        pops = np.array([bin(int(x)).count("1") for x in mask[t]])
        gpre = np.concatenate([[0], np.cumsum(pops)[:-1]])
        i = np.arange(m)
        b = mask[t][i // 32].astype(np.int64)
        below = b & ((1 << (i % 32)) - 1)
        lr = gpre[i // 32] + np.array([bin(int(x)).count("1")
                                       for x in below], np.int64)
        is_left = (b >> (i % 32)) & 1
        pos = np.where(is_left == 1, lr, nl + nr - 1 - (i - lr))
        assert sorted(pos) == list(range(m))
        perm = np.empty(m, np.int64)
        perm[pos] = i
        l0 = s0 + int(before[t])
        r_0 = s0 + cnt - (first - int(before[t])) - nr
        for a, ((src, width, word), (dst, _, _), hit) in enumerate(
                zip(srcs, dsts, hits)):
            if staged or a > 0:
                sm = _stage(src, r0 * width, m * width,
                            pk.stage_bytes(cap_rows * width))
            else:                       # the first array read in place
                sm = src[r0 * width:(r0 + m) * width]
            wpr = width // word
            k = np.arange(m * wpr)
            p, kk = k // wpr, k % wpr
            d = np.where(p < nl, l0 + p, r_0 + p - nl)
            at = d * wpr + kk
            _words(dst, word)[at] = _words(sm, word)[perm[p] * wpr + kk]
            np.add.at(hit, at, 1)
    for (_, width, word), hit in zip(dsts, hits):
        wpr = width // word
        want = np.zeros_like(hit)
        want[s0 * wpr:(s0 + cnt) * wpr] = 1
        np.testing.assert_array_equal(hit, want)
    return nleft


def model_copyback_3ph(rows, scratch, s0: int, cnt: int, nl: int) -> None:
    """copyback_3ph: blocks of BACK_ROWS rows, each word of the span
    once, the right run reversed back into ascending order."""
    for (dst, width, word), (src, _, _) in zip(_arrays(rows),
                                               _arrays(scratch)):
        wpr = width // word
        hit = np.zeros(len(dst) // word, np.int64)
        for p0 in range(0, cnt, BACK_ROWS):
            m = min(BACK_ROWS, cnt - p0)
            i = np.arange(m * wpr)
            q, k = p0 + i // wpr, i % wpr
            frm = np.where(q < nl, q, cnt - 1 - q + nl)
            at = (s0 + q) * wpr + k
            _words(dst, word)[at] = _words(src, word)[(s0 + frm) * wpr + k]
            np.add.at(hit, at, 1)
        assert hit.sum() == cnt * wpr and hit.max() == 1


def _rows(n: int, f: int, seed: int):
    """Seeded rows: feature 0 with 5% in the NaN bin, feature 5 over the
    whole u8 range (the bitset's), the rest below NAN_BIN."""
    r = random_row_matrix(n, f, seed, n_bins=NAN_BIN + 1, nan_bin=NAN_BIN)
    r[0][:, 5] = np.random.default_rng(seed + 1).integers(0, 256, n)
    return rows_on(r, "cpu")


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.uint8)


def _same(a, b) -> bool:
    """Every array of ``a`` bitwise ``b``'s."""
    return all(torch.equal(_bytes(x), _bytes(y)) for x, y in zip(a, b))


MODEL_CASES = [(f, pack, tile) for f, pack, tile in
               [(27, 1, 64), (28, 1, 32), (28, 1, 1024), (136, 1, 256),
                (136, 1, 512), (27, 2, 128), (28, 2, 1024), (136, 2, 256)]]


@pytest.mark.parametrize("f,pack,tile", MODEL_CASES)
@pytest.mark.parametrize("staged", [True, False])
def test_model_scan_equals_the_plain_scan(f, pack, tile, staged):
    """The model of scan_tiles, staged and unstaged, leaves scratch
    bitwise what partition_scan_ref (partition_scan_p2_ref: the records'
    fields) leaves, nleft included, on every adversarial segment, under
    a random block interleaving."""
    cases = partition_edge_cases(tile, NAN_BIN, 0, bitset=False)
    n = max(s[0] + s[1] for _, s in cases) + 37
    base = _rows(n, f, 40 + f)
    if pack == 2:
        base = pack_rows(base)
    for k, (label, sel) in enumerate(cases):
        if pack == 2:
            ref, got = empty_packed_like(base), empty_packed_like(base)
            ref.buf.fill_(0x5A)
            got.buf.fill_(0x5A)
        else:
            ref = pk.Rows(*(torch.full_like(a, 7) for a in base))
            got = pk.Rows(*(torch.full_like(a, 7) for a in base))
        nl_ref = torch.full((1,), -1, dtype=torch.int32)
        if pack == 2:
            pk.partition_scan_p2_ref(base, ref, sel, nl_ref)
        else:
            pk.partition_scan_ref(base, ref, sel, nl_ref)
        nl = model_scan(base, got, sel, tile, seed=k, staged=staged)
        assert nl == int(nl_ref), label
        if pack == 2:          # the plain version moves fields, not pads
            got, ref = got.fields(), ref.fields()
        assert _same(got, ref), label


@pytest.mark.parametrize("f,tile", [(27, 64), (28, 1024), (136, 256)])
@pytest.mark.parametrize("staged", [True, False])
def test_model_3ph_equals_the_plain_3ph(f, tile, staged):
    """The model of partition_3ph (scan_tiles with the membership words,
    staged and unstaged, then copyback_3ph) leaves the row matrix
    bitwise what partition_3ph_ref leaves, nleft included, nothing
    outside the segment touched."""
    cases = partition_edge_cases(tile, NAN_BIN, 0, bitset=True)
    n = max(s[0] + s[1] for _, s in cases) + 41
    base = _rows(n, f, 60 + f)
    for k, (label, sel) in enumerate(cases):
        ref = pk.Rows(*(a.clone() for a in base))
        got = pk.Rows(*(a.clone() for a in base))
        nl_ref = torch.full((1,), -1, dtype=torch.int32)
        pk.partition_3ph_ref(ref, empty_rows_like(ref), sel, nl_ref)
        scratch = pk.Rows(*(torch.full_like(a, 3) for a in base))
        nl = model_scan(got, scratch, sel, tile, seed=100 + k,
                        staged=staged)
        model_copyback_3ph(got, scratch, sel[0], sel[1], nl)
        assert nl == int(nl_ref), label
        assert _same(got, ref), label


# -- the plain versions against the JAX package's kernels ---------------------
C_LANES = 128


def _comb(rows, c: int) -> np.ndarray:
    """The JAX package's comb rows: bins, (g*w, h*w, w), row-id bytes,
    score and the two constants, f32 [n, c]."""
    bins, vals, rid, score, consts = (a.numpy() for a in rows)
    f = bins.shape[1]
    comb = np.zeros((bins.shape[0], c), np.float32)
    comb[:, :f] = bins
    comb[:, f:f + 3] = vals
    comb[:, f + 3] = rid // 65536
    comb[:, f + 4] = (rid // 256) % 256
    comb[:, f + 5] = rid % 256
    comb[:, f + 6] = score
    comb[:, f + 7:f + 9] = consts
    return comb


def _check_comb(rows, out_j: np.ndarray, s0: int, cnt: int) -> None:
    """The segment of the port's rows equals the JAX comb output's."""
    f = rows.bins.shape[1]
    seg = slice(s0, s0 + cnt)
    np.testing.assert_array_equal(rows.bins.numpy()[seg], out_j[seg, :f])
    np.testing.assert_array_equal(rows.vals.numpy()[seg],
                                  out_j[seg, f:f + 3])
    rid_j = (out_j[seg, f + 3] * 65536 + out_j[seg, f + 4] * 256
             + out_j[seg, f + 5]).astype(np.int32)
    np.testing.assert_array_equal(rows.rid.numpy()[seg], rid_j)
    np.testing.assert_array_equal(rows.score.numpy()[seg], out_j[seg, f + 6])
    np.testing.assert_array_equal(rows.consts.numpy()[seg],
                                  out_j[seg, f + 7:f + 9])


def _sel_array(sel) -> np.ndarray:
    out = np.zeros(max(8, len(sel)), np.int32)
    out[:len(sel)] = sel
    return out


def _jax_sizes(cases, r: int):
    size = max(s[1] for _, s in cases)
    n = max(s[0] for _, s in cases) + size + 4 * r + 256
    return -(-n // (2 * r)) * 2 * r, -(-size // r) * r


SCAN_CASES = partition_edge_cases(JAX_TILE, NAN_BIN, 2_000)


@pytest.fixture(scope="module", params=[27, 28, 136], ids=lambda f: f"F{f}")
def jax_scan(request):
    f = request.param
    r = 128
    n, size = _jax_sizes(SCAN_CASES, r)
    c = C_LANES if f + 9 <= C_LANES else 2 * C_LANES
    part = make_partition_perm(n, c, R=r, size=size, interpret=True,
                               interpret_kernel=True, cb_block=r)
    return f, n, c, part


@pytest.mark.parametrize("case", [c for c, _ in SCAN_CASES])
def test_plain_scan_matches_jax_make_partition_ss(case, jax_scan):
    f, n, c, part = jax_scan
    sel = dict(SCAN_CASES)[case]
    s0, cnt = sel[:2]
    rows = _rows(n, f, 70 + f)
    out_j, _, nl_j = part(jnp.asarray(_sel_array(sel)),
                          jnp.asarray(_comb(rows, c)),
                          jnp.zeros((n, c), jnp.float32))
    before = [a.clone() for a in rows]
    nleft = torch.full((1,), -1, dtype=torch.int32)
    pk.partition_ref(rows, empty_rows_like(rows), sel, nleft)
    assert int(nleft) == int(nl_j)
    _check_comb(rows, np.asarray(out_j), s0, cnt)
    for a, b in zip(rows, before):
        assert torch.equal(a[:s0], b[:s0])
        assert torch.equal(a[s0 + cnt:], b[s0 + cnt:])


P2_CASES = [(c, s) for c, s in partition_edge_cases(JAX_TILE, NAN_BIN, 2_000)]


@pytest.fixture(scope="module")
def jax_scan_p2():
    r = 64
    n, size = _jax_sizes(P2_CASES, r)
    part = make_partition_p2(n, R=r, size=size, interpret=True,
                             interpret_kernel=True, cb_block=64)
    return n, part


@pytest.mark.parametrize("case", [c for c, _ in P2_CASES])
def test_plain_scan_p2_matches_jax_make_partition_p2(case, jax_scan_p2):
    """pack=2 at F = 27 (F % 4 != 0): the records after
    partition_scan_p2_ref + copyback_p2_ref hold the rows the JAX
    package's pack=2 kernel leaves, field by field."""
    n, part = jax_scan_p2
    f = 27
    sel = dict(P2_CASES)[case]
    s0, cnt = sel[:2]
    rows = _rows(n, f, 90)
    comb = _comb(rows, C_LANES // 2)
    packed_j = jnp.asarray(comb.reshape(n // 2, C_LANES))
    out_j, _, nl_j = part(jnp.asarray(_sel_array(sel)), packed_j,
                          jnp.zeros_like(packed_j))
    out_j = np.asarray(out_j).reshape(n, C_LANES // 2)
    packed = pack_rows(rows)
    before = packed.buf.clone()
    nleft = torch.full((1,), -1, dtype=torch.int32)
    pk.partition_p2(packed, empty_packed_like(packed), sel, nleft)
    assert int(nleft) == int(nl_j)
    _check_comb(packed.fields(), out_j, s0, cnt)
    assert torch.equal(packed.buf[:s0], before[:s0])
    assert torch.equal(packed.buf[s0 + cnt:], before[s0 + cnt:])


P3_CASES = partition_edge_cases(JAX_TILE, NAN_BIN, 2_000, bitset=True)


@pytest.mark.parametrize("f", [27, 28, 136])
@pytest.mark.parametrize("case", [c for c, _ in P3_CASES])
def test_plain_3ph_matches_jax_make_partition(case, f):
    sel = dict(P3_CASES)[case]
    s0, cnt = sel[:2]
    r = 128
    n, _ = _jax_sizes(P3_CASES, r)
    c = C_LANES if f + 9 <= C_LANES else 2 * C_LANES
    rows = _rows(n, f, 110 + f)
    part = make_partition(n, c, R=r, size=max(cnt, 1), interpret=True)
    out_j, _, nl_j = part(jnp.asarray(_sel_array(sel)),
                          jnp.asarray(_comb(rows, c)),
                          jnp.zeros((n, c), jnp.float32))
    before = [a.clone() for a in rows]
    nleft = torch.full((1,), -1, dtype=torch.int32)
    pk.partition_3ph_ref(rows, empty_rows_like(rows), sel, nleft)
    assert int(nleft) == int(nl_j)
    _check_comb(rows, np.asarray(out_j), s0, cnt)
    for a, b in zip(rows, before):
        assert torch.equal(a[:s0], b[:s0])
        assert torch.equal(a[s0 + cnt:], b[s0 + cnt:])
