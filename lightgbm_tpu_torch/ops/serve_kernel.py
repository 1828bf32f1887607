"""Forest traversal kernel for serving: the wrappers of
``csrc/serve_traverse.cu``, their launch count, the packed forest the
kernel reads, and the plain PyTorch versions.

Counterpart of ``lightgbm_tpu/ops/pallas/serve_kernel.py``
(``make_serve_traverse``).  Two entries of one kernel:

- :func:`serve_traverse` keeps the JAX kernel's operand contract:
  ``forest_kernel_args`` gives the forest operands in the same order,
  the input is the single ``[n, F]`` i32 matrix of
  ``ops.predict.quantize_rows_kernel``, and the scores form writes the
  per-class sums into the caller's ``[n, K]`` f32 buffer in place;
- :func:`serve_traverse_raw` reads the padded raw f32 rows ``[n,
  Forig]`` and quantizes each row's used features inside the kernel,
  exactly as ``quantize_rows_kernel`` does, before it walks; it can
  also write the bins it computed.  The serving engine runs this one.

Both walk the forest as :func:`pack_forest` lays it out once a
``ServingModel`` (:class:`PackedForest`): one 16-byte record a node
(32 bytes in a wide forest), each tree's leaf values right after its
nodes, the trees cut into tiles of :func:`tile_trees` trees that one
block stages in shared memory.

The order of additions (scores form), the same at every batch size,
bucket and launch geometry: for each tile in tree order, the tile's
trees of class ``kk`` are added in tree order into an f32 sum that
starts at +0; the tile sums are then added in tile order into a total
that starts at +0.  The tiles depend on the forest's padded geometry
only (:func:`tile_trees`), so a row's scores are the same bits whatever
rows share its launch.  :func:`ordered_class_sums` is that order in
PyTorch, and the plain versions use it.

The wrappers take the plain versions only for tensors on the CPU.  For
CUDA tensors they launch the kernel or raise; nothing falls back.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.log import LightGBMError
from . import _build
from .predict import ServingForest, quantize_rows_kernel

# one block's shared memory on the H100 (opt-in limit), and the most a
# geometry takes (the analyzer flags more than 80 % of it)
MAX_SMEM = 232448
SMEM_TARGET = MAX_SMEM * 8 // 10
THREADS = 1024
# bytes of trees a block stages (a tile); tiles of larger trees are
# walked from global memory
TILE_BYTES = 48 * 1024
# bytes of staged rows (R rows of F i32 bins) and of the raw entry's
# quantizer tables; tables past it are read from global memory
ROWS_BYTES = 64 * 1024
QUANT_BYTES = 32 * 1024
# split geometry (few rows): rows a block holds at most and at least,
# and the blocks it aims at (two waves of two blocks an SM)
MAX_TILE_ROWS = 128
MIN_TILE_ROWS = 8
TARGET_BLOCKS = 4 * 132
# resident geometry (many rows): rows a block holds, and the row blocks
# from which a launch takes it
RESIDENT_ROWS = 512
RESIDENT_BLOCKS = 64
# node record: tb-or-nbits, meta, feature, children (i16 pair); a wide
# forest's record takes two 16-byte units (children as i32)
NARROW_UNITS, WIDE_UNITS = 1, 2
# |v| <= 1e-35 is the zero bin under missing ZERO, compared in f32 as
# quantize_rows compares it
KZERO_F32 = float(np.float32(1e-35))


def forest_kernel_args(forest: ServingForest, *, leaves: bool = False
                       ) -> Tuple[torch.Tensor, ...]:
    """The forest operands of the traversal, in ``make_serve_traverse``
    order: ``sf, tb, lc, rc, nm[, cw, nb][, lv]`` (``cw, nb`` only when
    the forest has categorical bitsets, ``lv`` only for scores)."""
    t, ni = forest.split_feature.shape
    w = forest.cat_words.shape[1] // max(int(ni), 1)
    args = [forest.split_feature, forest.threshold_bin,
            forest.left_child, forest.right_child, forest.node_meta]
    if w > 0:
        args += [forest.cat_words, forest.cat_nbits]
    if not leaves:
        args += [forest.leaf_value]
    return tuple(args)


def _unpack(args, leaves: bool):
    sf, tb, lc, rc, nm = args[:5]
    rest = list(args[5:])
    lv = None if leaves else rest.pop()
    cw, nb = rest if rest else (None, None)
    return sf, tb, lc, rc, nm, cw, nb, lv


# -- the packed layout ------------------------------------------------------
def forest_is_wide(ni_pad: int, nl_pad: int) -> bool:
    """Whether a forest needs the wide record: a narrow record holds a
    child as i16 (node index <= 32767, ~leaf >= -32768)."""
    return int(ni_pad) > 32767 or int(nl_pad) > 32768


def tree_bound_bytes(ni_pad: int, nl_pad: int) -> int:
    """The most bytes one packed tree takes: every padded node and leaf."""
    units = WIDE_UNITS if forest_is_wide(ni_pad, nl_pad) else NARROW_UNITS
    return 16 * units * int(ni_pad) + 16 * -(-int(nl_pad) // 4)


def tile_trees(t_cnt: int, ni_pad: int, nl_pad: int) -> int:
    """Trees a tile holds: as many padded trees as fit ``TILE_BYTES``,
    at least one.  A function of the padded geometry only, so the order
    of additions is the forest's."""
    per = TILE_BYTES // tree_bound_bytes(ni_pad, nl_pad)
    return max(1, min(int(t_cnt), per))


@dataclasses.dataclass
class PackedForest:
    """The forest as the kernel reads it, on one device, derived from a
    :class:`ServingForest` by :func:`pack_forest`.

    ``blob`` i32 holds 16-byte units: tree t's node records from unit
    ``tree_rec[t]`` (node i at ``tree_rec[t] + i * rec_units``), each
    ``(x, meta, feature, children)`` with ``x`` the threshold bin, or
    the valid bit count on a categorical node when the forest has
    bitsets, and ``children`` the i16 pair ``left | right << 16``
    (narrow) or a second unit ``(left, right, 0, 0)`` (wide); then its
    leaf values as f32 (bf16 upcast) from word ``tree_leaf[t]``.  Only
    the nodes and leaves a walk of ``n_steps`` levels from node 0 can
    reach are packed (``tree_nodes`` / ``tree_leaves``).  Tile j holds
    trees ``[j * tile_trees, ...)``, units ``[tile_unit[j],
    tile_unit[j + 1])``.  ``qmeta`` [F, 4] i32 is the quantizer's
    per-feature word (used column, bin of 0.0, NaN bin, flags: 1
    has_nan, 2 missing_zero, 4 categorical) beside ``ub``."""
    forest: ServingForest
    n_steps: int
    wide: bool
    blob: torch.Tensor
    tree_rec: torch.Tensor
    tree_leaf: torch.Tensor
    tile_unit: torch.Tensor
    qmeta: torch.Tensor
    tree_nodes: np.ndarray
    tree_leaves: np.ndarray
    tile_units: np.ndarray      # host copy of tile_unit

    @property
    def trees(self) -> int:
        return int(self.forest.split_feature.shape[0])

    @property
    def ni_pad(self) -> int:
        return int(self.forest.split_feature.shape[1])

    @property
    def nl_pad(self) -> int:
        return int(self.forest.leaf_value.shape[1])

    @property
    def cat_words_w(self) -> int:
        return int(self.forest.cat_words.shape[1]) // max(self.ni_pad, 1)

    @property
    def tile_trees(self) -> int:
        return tile_trees(self.trees, self.ni_pad, self.nl_pad)

    @property
    def n_tiles(self) -> int:
        return len(self.tile_units) - 1

    @property
    def rec_units(self) -> int:
        return WIDE_UNITS if self.wide else NARROW_UNITS

    @property
    def device(self) -> torch.device:
        return self.blob.device

    @functools.cached_property
    def stage_units(self) -> int:
        """Units of the shared tile region: the largest tile up to
        ``TILE_BYTES`` (twice that with the wide record forced on a
        forest the narrow one fits); a larger tile is walked from global
        memory."""
        sizes = np.diff(self.tile_units)
        fit = sizes[sizes * 16 <= TILE_BYTES * self.rec_units]
        return int(fit.max()) if len(fit) else 0

    def unpack(self) -> dict:
        """The ServingForest fields the packed arrays hold, [T, ni_pad]
        node arrays and the [T, nl_pad] f32 leaf table, for the packed
        nodes and leaves (zeros elsewhere): the inverse of
        :func:`pack_forest` on what a walk reads."""
        t_cnt, ni, nl = self.trees, self.ni_pad, self.nl_pad
        blob = self.blob.cpu().numpy().reshape(-1, 4)
        words = self.blob.cpu().numpy()
        has_bits = self.cat_words_w > 0
        out = {k: np.zeros((t_cnt, ni), np.int32)
               for k in ("split_feature", "threshold_bin", "left_child",
                         "right_child", "node_meta", "cat_nbits")}
        out["leaf_value"] = np.zeros((t_cnt, nl), np.float32)
        for t in range(t_cnt):
            k = int(self.tree_nodes[t])
            u = int(self.tree_rec[t]) + self.rec_units * np.arange(k)
            rec = blob[u]
            cat = has_bits & ((rec[:, 1] & 4) > 0)
            out["threshold_bin"][t, :k] = np.where(cat, 0, rec[:, 0])
            out["cat_nbits"][t, :k] = np.where(cat, rec[:, 0], 0)
            out["node_meta"][t, :k] = rec[:, 1]
            out["split_feature"][t, :k] = rec[:, 2]
            if self.wide:
                kids = blob[u + 1]
                out["left_child"][t, :k] = kids[:, 0]
                out["right_child"][t, :k] = kids[:, 1]
            else:
                out["left_child"][t, :k] = (rec[:, 3] << 16) >> 16
                out["right_child"][t, :k] = rec[:, 3] >> 16
            nlt = int(self.tree_leaves[t])
            lo = int(self.tree_leaf[t])
            out["leaf_value"][t, :nlt] = words[lo:lo + nlt].view(np.float32)
        return out


def _reach(lc: np.ndarray, rc: np.ndarray, n_steps: int):
    """Per tree, the largest node index and leaf index a walk of
    ``n_steps`` levels from node 0 can reach (a walk still on a node
    after its last level reads leaf 0)."""
    t_cnt, ni = lc.shape
    node_max = np.zeros(t_cnt, np.int64)
    leaf_max = np.zeros(t_cnt, np.int64)
    ts = np.arange(t_cnt)
    ns = np.zeros(t_cnt, np.int64)
    for _ in range(int(n_steps)):
        if not len(ts):
            break
        np.maximum.at(node_max, ts, ns)
        nxt_t, nxt_n = [], []
        for child in (lc[ts, ns], rc[ts, ns]):
            leaf = child < 0
            np.maximum.at(leaf_max, ts[leaf], ~child[leaf].astype(np.int64))
            nxt_t.append(ts[~leaf])
            nxt_n.append(child[~leaf].astype(np.int64))
        key = np.unique(np.concatenate(nxt_t) * ni + np.concatenate(nxt_n))
        ts, ns = key // ni, key % ni
    return node_max, leaf_max


def pack_forest(forest: ServingForest, n_steps: int, *,
                wide: Optional[bool] = None) -> PackedForest:
    """Lay a :class:`ServingForest` out as the kernel reads it (the
    carry function, once a ``ServingModel``): host-side numpy, then the
    arrays on the forest's device.  ``wide=True`` forces the wide
    record on a forest that would fit the narrow one."""
    f = forest.numpy()
    sf, tb, lc, rc, nm = (f[k] for k in ("split_feature", "threshold_bin",
                                         "left_child", "right_child",
                                         "node_meta"))
    nb = f["cat_nbits"]
    t_cnt, ni_pad = sf.shape
    nl_pad = f["leaf_value"].shape[1]
    has_bits = f["cat_words"].shape[1] // max(ni_pad, 1) > 0
    need_wide = forest_is_wide(ni_pad, nl_pad)
    if wide is None:
        wide = need_wide
    elif not wide and need_wide:
        raise LightGBMError("forest too large for the narrow node record")
    ru = WIDE_UNITS if wide else NARROW_UNITS
    node_max, leaf_max = _reach(lc, rc, n_steps)
    k_nodes = node_max + 1
    k_leaves = leaf_max + 1
    tree_units = ru * k_nodes + -(-k_leaves // 4)
    tree_rec = np.zeros(t_cnt, np.int64)
    tree_rec[1:] = np.cumsum(tree_units)[:-1]
    blob = np.zeros((int(tree_units.sum()), 4), np.int32)
    lv = f["leaf_value"].astype(np.float32)
    for t in range(t_cnt):
        k = int(k_nodes[t])
        u = int(tree_rec[t]) + ru * np.arange(k)
        cat = has_bits & ((nm[t, :k] & 4) > 0)
        blob[u, 0] = np.where(cat, nb[t, :k], tb[t, :k])
        blob[u, 1] = nm[t, :k]
        blob[u, 2] = sf[t, :k]
        if wide:
            blob[u + 1, 0] = lc[t, :k]
            blob[u + 1, 1] = rc[t, :k]
        else:
            blob[u, 3] = ((lc[t, :k].astype(np.int64) & 0xFFFF)
                          | (rc[t, :k].astype(np.int64) << 16)
                          ).astype(np.int32)
        leaf_u = int(tree_rec[t]) + ru * k
        nlt = int(k_leaves[t])
        words = blob[leaf_u:leaf_u + -(-nlt // 4)].reshape(-1)
        vals = lv[t, :nlt]          # fewer when only leaf indices are read
        words[:len(vals)] = vals.view(np.int32)
    tree_leaf = 4 * (tree_rec + ru * k_nodes)
    tt = tile_trees(t_cnt, ni_pad, nl_pad)
    starts = np.arange(0, t_cnt, tt)
    tile_unit = np.append(tree_rec[starts], len(blob)) if t_cnt \
        else np.zeros(1, np.int64)
    if len(blob) >= 2 ** 31 // 4:
        raise LightGBMError("packed forest above 2**31 words")
    # the quantizer's per-feature word
    flags = (f["has_nan"].astype(np.int32)
             | (f["missing_zero"].astype(np.int32) << 1)
             | (f["cat_col"].astype(np.int32) << 2))
    qmeta = np.stack([f["used_cols"].astype(np.int32),
                      f["default_bin"].astype(np.int32),
                      (f["num_bins"] - 1).astype(np.int32), flags], axis=1)
    dev = forest.device

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
    return PackedForest(
        forest=forest, n_steps=int(n_steps), wide=bool(wide),
        blob=on(blob.reshape(-1)), tree_rec=on(tree_rec),
        tree_leaf=on(tree_leaf), tile_unit=on(tile_unit), qmeta=on(qmeta),
        tree_nodes=k_nodes, tree_leaves=k_leaves,
        tile_units=np.asarray(tile_unit, np.int64))


# -- the plain versions -----------------------------------------------------
def ordered_class_sums(vals: torch.Tensor, num_class: int,
                       per_tile: int) -> torch.Tensor:
    """[n, T] f32 leaf values -> [n, K] f32 per-class sums in the
    kernel's order: tree order within each tile of ``per_tile`` trees
    from +0, then the tile sums in tile order from +0."""
    n, t_cnt = vals.shape
    k = max(int(num_class), 1)
    total = torch.zeros((n, k), dtype=torch.float32, device=vals.device)
    for t0 in range(0, t_cnt, per_tile):
        part = torch.zeros_like(total)
        for t in range(t0, min(t0 + per_tile, t_cnt)):
            part[:, t % k] += vals[:, t]
        total = total + part
    return total


def serve_traverse_ref(args, bins: torch.Tensor, n_real: int,
                       out: torch.Tensor, *, n_steps: int,
                       leaves: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same inputs and outputs:
    a lock-step walk of every (row, tree) from node 0 for ``n_steps``
    levels, then leaf indices into ``out`` ([n, T] i32) or per-class
    leaf sums into ``out`` ([n, K] f32), in place.  The sums are taken
    in the kernel's order (:func:`ordered_class_sums` over tiles of
    :func:`tile_trees` of the forest's geometry); rows >= ``n_real``
    come back 0."""
    sf, tb, lc, rc, nm, cw, nb, lv = _unpack(args, leaves)
    n = bins.shape[0]
    t_cnt, ni = sf.shape
    w = cw.shape[1] // ni if cw is not None else 0
    tri = torch.arange(t_cnt, device=bins.device)[None, :]
    sf_f, tb_f, lc_f, rc_f, nm_f = (a.reshape(-1) for a in (sf, tb, lc, rc,
                                                           nm))
    node = torch.zeros((n, t_cnt), dtype=torch.int32, device=bins.device)
    for _ in range(n_steps):
        active = node >= 0
        gidx = tri * ni + node.clamp(min=0).long()           # [n, T]
        b = torch.gather(bins, 1, sf_f[gidx].long())
        meta = nm_f[gidx]
        at_nan = ((meta & 2) > 0) & (b == (meta >> 3))
        go_left = ((b <= tb_f[gidx]) & ~at_nan) | (at_nan & ((meta & 1) > 0))
        if w > 0:
            ok = (b >= 0) & (b < nb.reshape(-1)[gidx])
            ivc = b.clamp(0, w * 32 - 1)
            word = cw.reshape(-1)[gidx * w + (ivc // 32).long()]
            go_cat = ok & (((word >> (ivc % 32)) & 1) > 0)
            go_left = torch.where((meta & 4) > 0, go_cat, go_left)
        nxt = torch.where(go_left, lc_f[gidx], rc_f[gidx])
        node = torch.where(active, nxt, node)
    leaf = ~node.clamp(max=-1)
    live = torch.arange(n, device=bins.device)[:, None] < n_real
    if leaves:
        out.copy_(torch.where(live, leaf, torch.zeros_like(leaf)))
        return out
    nl = lv.shape[1]
    vals = lv.reshape(-1)[tri * nl + leaf.long()].float()
    sums = ordered_class_sums(vals, out.shape[1], tile_trees(t_cnt, ni, nl))
    out.copy_(torch.where(live, sums, torch.zeros_like(sums)))
    return out


def serve_traverse_raw_ref(pf: PackedForest, raw: torch.Tensor,
                           n_real: int, out: torch.Tensor, *,
                           leaves: bool = False,
                           bins_out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain version of the raw entry: ``quantize_rows_kernel`` of the
    used columns, then :func:`serve_traverse_ref`; ``bins_out`` [n, F]
    i32, when given, receives the bins."""
    forest = pf.forest
    bins = quantize_rows_kernel(forest,
                                raw[:, forest.used_cols.long()]).contiguous()
    if bins_out is not None:
        bins_out.copy_(bins)
    return serve_traverse_ref(forest_kernel_args(forest, leaves=leaves),
                              bins, n_real, out, n_steps=pf.n_steps,
                              leaves=leaves)


# -- the launch geometry ----------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ServeGeometry:
    """One launch: ``grid_x`` blocks of ``rows`` rows (row stride
    ``row_stride`` words in shared memory, 0 where the rows are read
    from global memory) times ``grid_y`` blocks of ``tiles_per_block``
    tree tiles, staged ``nbuf`` at a time (two: the next tile's copies
    run during a walk); ``totals``: one block sees every tile and keeps
    the rows' running sums (no partials, no second launch); the
    quantizer tables staged or not, and the dynamic shared memory in
    bytes."""
    rows: int
    grid_x: int
    grid_y: int
    tiles_per_block: int
    nbuf: int
    n_tiles: int
    row_stride: int
    stage_units: int
    quant_staged: bool
    totals: bool
    smem: int


def serve_smem_bytes(stage_units: int, nbuf: int, rows: int,
                     row_stride: int, per_tile: int, n_feat: int, bq: int,
                     k: int, raw: bool, quant_staged: bool, leaves: bool,
                     totals: bool) -> int:
    """Dynamic shared memory of one block: the staged tiles, the
    quantizer tables (raw entry, when staged and not in the second
    buffer), the rows, the tile's leaf values a row and the running
    totals (scores form)."""
    b = 16 * nbuf * stage_units
    quant = 16 * n_feat + 4 * n_feat * bq
    # with two staged buffers the tables lie in the second while the rows
    # are quantized, when they fit it
    if raw and quant_staged and not (nbuf == 2 and quant <= 16 * stage_units):
        b += quant
    b += 4 * rows * row_stride
    if not leaves:
        b += 4 * rows * per_tile
        if totals:
            b += 4 * rows * k
    return b


def serve_geometry(pf: PackedForest, n: int, n_feat: int, *, raw: bool,
                   leaves: bool, k: int = 1) -> ServeGeometry:
    """The launch geometry of ``pf`` for ``n`` rows of ``n_feat``
    features (:func:`geometry_for`)."""
    return geometry_for(n, n_feat, n_tiles=pf.n_tiles,
                        per_tile=pf.tile_trees,
                        stage_units=pf.stage_units,
                        bq=int(pf.forest.ub.shape[1]), k=k, raw=raw,
                        leaves=leaves)


@functools.lru_cache(maxsize=256)
def geometry_for(n: int, n_feat: int, *, n_tiles: int, per_tile: int,
                 stage_units: int, bq: int, k: int, raw: bool,
                 leaves: bool) -> ServeGeometry:
    """The launch geometry for ``n`` rows of ``n_feat`` features over
    ``n_tiles`` tiles of ``per_tile`` trees.  Many rows (at least
    ``RESIDENT_BLOCKS`` blocks of ``RESIDENT_ROWS``): resident, a block
    stages (quantizes) its rows once and walks every tile in turn.  Few
    rows: split, a block a (row tile, tree tile), the row tiles small
    (down to ``MIN_TILE_ROWS``) so that the blocks fill the card, the
    tile sums added by a second launch."""
    stride = n_feat | 1              # odd: a warp's rows in distinct banks
    rows_cap = ROWS_BYTES // (4 * stride)
    if rows_cap < 1:
        stride = 0                   # rows read from global memory
        rows_cap = RESIDENT_ROWS
    quant_staged = raw and (16 * n_feat + 4 * n_feat * bq) <= QUANT_BYTES
    rows = min(RESIDENT_ROWS, rows_cap)
    if -(-n // rows) >= RESIDENT_BLOCKS:
        grid_y, per_block = 1, n_tiles
    else:
        rows = min(MAX_TILE_ROWS, rows_cap)
        while rows > MIN_TILE_ROWS and \
                -(-n // rows) * n_tiles < TARGET_BLOCKS // 2:
            rows //= 2
        grid_y, per_block = n_tiles, 1
    nbuf = 2 if per_block > 1 and stage_units else 1
    totals = grid_y == 1 and n_tiles > 1 and not leaves

    def smem_of(r):
        return serve_smem_bytes(stage_units, nbuf, r, stride, per_tile,
                                n_feat, bq, k, raw, quant_staged, leaves,
                                totals)
    while rows > 1 and smem_of(rows) > SMEM_TARGET:
        rows //= 2
    return ServeGeometry(rows=rows, grid_x=-(-n // rows), grid_y=grid_y,
                         tiles_per_block=per_block, nbuf=nbuf,
                         n_tiles=n_tiles, row_stride=stride,
                         stage_units=stage_units, quant_staged=quant_staged,
                         totals=totals, smem=smem_of(rows))


# -- the wrappers -----------------------------------------------------------
def _check(args, bins, out, leaves: bool) -> None:
    dev = bins.device
    for a in (*args, bins, out):
        if a.device != dev:
            raise LightGBMError("serve_traverse operands must share one "
                                f"device (got {a.device} and {dev})")
        if not a.is_contiguous():
            raise LightGBMError("serve_traverse operands must be "
                                "contiguous")
    sf, tb, lc, rc, nm, cw, nb, lv = _unpack(args, leaves)
    for a in (sf, tb, lc, rc, nm, cw, nb, bins):
        if a is not None and a.dtype != torch.int32:
            raise LightGBMError(f"serve_traverse wants i32 node arrays "
                                f"and bins, got {a.dtype}")
    t_cnt, ni = sf.shape
    for a in (tb, lc, rc, nm) + ((nb,) if nb is not None else ()):
        if tuple(a.shape) != (t_cnt, ni):
            raise LightGBMError("serve_traverse node arrays must all be "
                                f"[T, ni_pad] = {(t_cnt, ni)}")
    if cw is not None and (cw.shape[0] != t_cnt or cw.shape[1] % ni):
        raise LightGBMError("cat_words must be [T, ni_pad * W]")
    if bins.dim() != 2:
        raise LightGBMError("bins must be [n, F]")
    _check_out(out, bins.shape[0], t_cnt, leaves)
    if not leaves and (lv.dtype not in (torch.float32, torch.bfloat16)
                       or lv.shape[0] != t_cnt):
        raise LightGBMError("leaf table must be [T, nl_pad] f32 or bf16")


def _check_out(out, n: int, t_cnt: int, leaves: bool) -> None:
    if leaves:
        if out.dtype != torch.int32 or tuple(out.shape) != (n, t_cnt):
            raise LightGBMError("leaves output must be [n, T] i32")
    else:
        k = out.shape[1] if out.dim() == 2 else 0
        if out.dtype != torch.float32 or out.dim() != 2 \
                or out.shape[0] != n or k < 1 or t_cnt % k:
            raise LightGBMError("scores output must be [n, K] f32 with K "
                                "dividing the tree count")


@functools.lru_cache(maxsize=1)
def _lib():
    """The built library with its argument types declared."""
    lib = _build.load("serve_traverse")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # blob, tree_rec, tree_leaf, tile_unit, cw; w, ni_pad, wide, trees,
    # per_tile, n_tiles, stage_units, n_steps, k; bins, raw, forig,
    # qmeta, ub, bq, quant_staged, bins_out; n, n_real, f, row_stride,
    # rows, tiles_per_block, nbuf, grid_x, grid_y, leaves, smem; out,
    # partials, kzero, stream
    lib.serve_traverse_run.argtypes = (
        [p] * 5 + [i] * 9 + [p, p, i, p, p, i, i, p] + [i] * 11
        + [p, p, f, p])
    lib.serve_traverse_run.restype = i
    return lib


def _launch(pf: PackedForest, geo: ServeGeometry, *, bins, raw, bins_out,
            n: int, n_real: int, n_feat: int, out: torch.Tensor,
            leaves: bool) -> None:
    """One call of the library: the traversal kernel, then (scores
    form, several tiles) the tile sums in tile order."""
    dev = out.device
    k = 1 if leaves else out.shape[1]
    partials = None
    if not leaves and geo.n_tiles > 1 and geo.grid_y > 1:
        partials = torch.empty((geo.n_tiles, n, k), dtype=torch.float32,
                               device=dev)
    if geo.smem > MAX_SMEM:
        raise LightGBMError(f"serve_traverse needs {geo.smem} bytes of "
                            "shared memory a block")
    ptr = (lambda a: a.data_ptr() if a is not None else None)
    forest = pf.forest
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc_ = _lib().serve_traverse_run(
            ptr(pf.blob), ptr(pf.tree_rec), ptr(pf.tree_leaf),
            ptr(pf.tile_unit),
            ptr(forest.cat_words) if pf.cat_words_w else None,
            pf.cat_words_w, pf.ni_pad, int(pf.wide), pf.trees,
            pf.tile_trees, geo.n_tiles, geo.stage_units, pf.n_steps, k,
            ptr(bins), ptr(raw), raw.shape[1] if raw is not None else 0,
            ptr(pf.qmeta), ptr(forest.ub), int(forest.ub.shape[1]),
            int(geo.quant_staged), ptr(bins_out),
            n, int(n_real), n_feat, geo.row_stride, geo.rows,
            geo.tiles_per_block, geo.nbuf, geo.grid_x, geo.grid_y,
            int(leaves), geo.smem,
            ptr(out), ptr(partials), KZERO_F32, stream)
    if rc_ != 0:
        raise LightGBMError(f"serve_traverse kernel launch failed with "
                            f"CUDA error {rc_}")


def serve_traverse(args, bins: torch.Tensor, n_real: int,
                   out: torch.Tensor, *, n_steps: int,
                   leaves: bool = False,
                   packed: Optional[PackedForest] = None) -> torch.Tensor:
    """Walk the stacked forest for ``bins`` and write the result into
    ``out`` in place: ``[n, T]`` i32 leaf indices (``leaves=True``) or
    ``[n, K]`` f32 per-class leaf sums.  ``args`` is
    :func:`forest_kernel_args` of the same form; ``packed`` is the
    forest's :class:`PackedForest` (built here when not given).  Rows
    >= ``n_real`` come back 0.  CPU tensors take
    :func:`serve_traverse_ref`; CUDA tensors launch the kernel on the
    current stream."""
    if bins.device.type == "cpu":
        return serve_traverse_ref(args, bins, n_real, out, n_steps=n_steps,
                                  leaves=leaves)
    if bins.device.type != "cuda":
        raise LightGBMError(f"serve_traverse runs on cuda or cpu, not "
                            f"{bins.device}")
    _check(args, bins, out, leaves)
    n, n_feat = bins.shape
    if n == 0:
        return out
    if packed is None:
        packed = pack_forest(_forest_of(args, leaves), n_steps)
    if packed.n_steps != int(n_steps):
        raise LightGBMError("packed forest built for another n_steps")
    geo = serve_geometry(packed, n, n_feat, raw=False, leaves=leaves,
                         k=1 if leaves else out.shape[1])
    _launch(packed, geo, bins=bins, raw=None, bins_out=None, n=n,
            n_real=n_real, n_feat=n_feat, out=out, leaves=leaves)
    serve_traverse.launches += 1
    return out


def serve_traverse_raw(pf: PackedForest, raw: torch.Tensor, n_real: int,
                       out: torch.Tensor, *, leaves: bool = False,
                       bins_out: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The raw entry: quantize the used columns of ``raw`` [n, Forig]
    f32 inside the kernel (``quantize_rows_kernel``'s bins, written to
    ``bins_out`` [n, F] i32 when given) and walk them; ``out`` as in
    :func:`serve_traverse`.  CPU tensors take
    :func:`serve_traverse_raw_ref`; CUDA tensors launch the kernel on
    the current stream."""
    if raw.device.type == "cpu":
        return serve_traverse_raw_ref(pf, raw, n_real, out, leaves=leaves,
                                      bins_out=bins_out)
    if raw.device.type != "cuda":
        raise LightGBMError(f"serve_traverse runs on cuda or cpu, not "
                            f"{raw.device}")
    n_feat = int(pf.qmeta.shape[0])
    n = raw.shape[0]
    for a in (raw, out, pf.blob) + ((bins_out,) if bins_out is not None
                                    else ()):
        if a.device != raw.device or not a.is_contiguous():
            raise LightGBMError("serve_traverse operands must be contiguous "
                                "on one device")
    if raw.dtype != torch.float32 or raw.dim() != 2:
        raise LightGBMError("raw rows must be [n, Forig] f32")
    if bins_out is not None and (bins_out.dtype != torch.int32 or tuple(
            bins_out.shape) != (n, n_feat)):
        raise LightGBMError("bins output must be [n, F] i32")
    _check_out(out, n, pf.trees, leaves)
    if n == 0:
        return out
    geo = serve_geometry(pf, n, n_feat, raw=True, leaves=leaves,
                         k=1 if leaves else out.shape[1])
    if geo.row_stride == 0 and bins_out is None:
        # rows too wide to stage: the kernel walks the bins it writes
        bins_out = torch.empty((n, n_feat), dtype=torch.int32,
                               device=raw.device)
    _launch(pf, geo, bins=None, raw=raw, bins_out=bins_out, n=n,
            n_real=n_real, n_feat=n_feat, out=out, leaves=leaves)
    serve_traverse.launches += 1
    return out


def _forest_of(args, leaves: bool) -> ServingForest:
    """A ServingForest holding the kernel operands ``args`` (the fields
    the walk does not read are empty): what :func:`pack_forest` reads."""
    sf, tb, lc, rc, nm, cw, nb, lv = _unpack(args, leaves)
    dev = sf.device
    t_cnt, ni = sf.shape
    empty_i = torch.zeros(0, dtype=torch.int32, device=dev)
    if lv is None:
        lv = torch.zeros((t_cnt, 1), dtype=torch.float32, device=dev)
    if cw is None:
        cw = torch.zeros((t_cnt, 0), dtype=torch.int32, device=dev)
        nb = torch.zeros_like(sf)
    return ServingForest(
        split_feature=sf, threshold_bin=tb,
        default_left=torch.zeros_like(sf, dtype=torch.bool),
        is_categorical=(nm & 4) > 0, left_child=lc, right_child=rc,
        leaf_value=lv, init_node=torch.zeros(t_cnt, dtype=torch.int32,
                                             device=dev),
        cat_words=cw, cat_nbits=nb, used_cols=empty_i,
        ub=torch.zeros((0, 1), dtype=torch.float32, device=dev),
        default_bin=empty_i, num_bins=empty_i,
        has_nan=torch.zeros(0, dtype=torch.bool, device=dev),
        missing_zero=torch.zeros(0, dtype=torch.bool, device=dev),
        node_meta=nm,
        cat_col=torch.zeros(0, dtype=torch.bool, device=dev))


serve_traverse.launches = 0
