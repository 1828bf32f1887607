"""Every kernel of the port, registered at the main paths' shapes.

The counterpart of ``lightgbm_tpu/analysis/entries.py``.  One entry per
``__global__`` symbol and launch shape, the shared memory from the
wrappers' own Python (``ops/*.py``), the tensors as the kernels
address them: 1,000,000 rows x 28 features, u8 bins at B = 256 (the
default, slice 2, 3ph and pack=2 routes) and u16 bins at B = 1024 (the
row-order route), pack 1 (five arrays) and pack 2 (64-byte records), the
split kernels on the 1M-row segment (the fused split's histogram pass
also on the median segment's geometry), the tails at B = 256 (the pool
entry also at the row-order route's B = 1024 and the wide route's 136
features, each one cluster of its geometry's blocks), serving 100
trees x 255 leaves over a 65,536-row bucket, ``hist_comb`` in both
modes (feature mode at the 1M-row root, range mode at the median
smaller child) at 28 and 136 features and both packs, the
membership-word modes of the partitions and the fused split at the
categorical cell's 2^20 rows x 36 features, the fixture kernels at
their legal geometries, the launch-cost probes at their tools'
shapes and the partition-bisection probes at ``profile_legacy``'s
(2^20 rows, the ``hbm_alias`` comb).  Nothing is allocated and
nothing is launched.
"""
from __future__ import annotations

import dataclasses
import itertools

from ..ops import apply_find as af
from ..ops import fused_split as fs
from ..ops import hist_kernel2 as hk
from ..ops import legacy_probes as lp
from ..ops import linear_kernel as lk
from ..ops import probes as pr
from ..ops import serve_kernel as sk
from ..ops import shap_kernel as shk
from ..ops import stream_grad as sg
from ..ops.device_data import RecordLayout
from ..ops import partition_kernel as pk
from ..ops.partition_kernel import SCAN_TILE
from .registry import (KernelEntry, register_kernel, register_purity_pin,
                       vec_arg)

N, F, B, B_WIDE = 1_000_000, 28, 256, 1024
# the wide dataset's features (MSLR-WEB30K's 136): hist_comb in chunks
F_WIDE = 136
# rows too wide for the partition scan to stage (its unstaged kernels)
F_MANY, N_MANY = 8_000, 100_000
TREES, LEAVES, BUCKET, QUEUE = 100, 255, 65_536, 64
REC = RecordLayout(F)
S = REC.stride
THREADS = 256
PALLAS = "lightgbm_tpu/ops/pallas"
FUSED = {1: f"{PALLAS}/fused_split.py:346", 2: f"{PALLAS}/fused_split.py:417"}
# the default route's median split segment (the pack=2 route's trees are
# its trees bit for bit)
MEDIAN_SEGMENT = 13_128
# the categorical workload (bench.py --categorical 1024,8): 28 dense and
# 8 categorical features, 2^20 rows; its splits run the kernels in the
# membership-word mode (the sorted-subset search's descriptor)
N_CAT, F_CAT = 1_048_576, 36
CAT = {"fused_split": f"{PALLAS}/fused_split.py:483",
       "fused_split_p2": f"{PALLAS}/fused_split.py:505",
       "partition_scan": f"{PALLAS}/partition_kernel3.py:689",
       "partition_scan_p2": f"{PALLAS}/partition_kernel3.py:710",
       "partition_3ph": f"{PALLAS}/partition_kernel.py:372"}


def _grid(x):
    return (int(x), 1, 1)


def _block(x):
    return (int(x), 1, 1)


def _rows_args(prefix: str = "", f: int = F, n: int = N, bins_vec: int = 4):
    """The five arrays of the pack=1 row matrix."""
    return (vec_arg(f"{prefix}bins", "uint8", (n, f), bins_vec),
            vec_arg(f"{prefix}vals", "float32", (n, 3), 4),
            vec_arg(f"{prefix}rid", "int32", (n, 1), 4),
            vec_arg(f"{prefix}score", "float32", (n, 1), 4),
            vec_arg(f"{prefix}consts", "float32", (n, 2), 4))


def _records(name: str = "base", n: int = N, vec: int = 16):
    return vec_arg(name, "uint8", (n, S), vec)


def _hist_out(partials: int, b: int = B):
    return (vec_arg("partials", "float32", (partials, F, b, 2), 4),
            vec_arg("out", "float32", (F, b, 2), 4))


def _reduce(source: str, wrapper: str, replaces: str, partials: int,
            sets: int = 1, b: int = B) -> KernelEntry:
    """``histblock::reduce_partials`` of one library."""
    cells = F * b * 2
    return register_kernel(KernelEntry(
        name=f"{source}_reduce", source=source,
        symbol="histblock::reduce_partials",
        block=_block(256),
        dyn_smem=0,
        args=(vec_arg("partials", "float32", (sets * partials, cells), 4),
              vec_arg("out", "float32", (sets, cells), 4)),
        wrapper=wrapper, replaces=replaces))


# -- serving ----------------------------------------------------------------
def _serve():
    """The traversal at the main path's forest (100 trees x 255 leaves,
    ni_pad = nl_pad = 256: 12 tiles of 9 trees, a tile at most 9 padded
    trees), both entries and both forms over a 65,536-row bucket
    (resident geometry), the raw entry's scores also at the queue's 64
    rows (split geometry), the wide record (forced) beside the narrow
    one, and the tile sums of the split geometry."""
    ni = nl = 256
    per = sk.tile_trees(TREES, ni, nl)
    tiles = -(-TREES // per)
    blob = vec_arg("blob", "int32", (tiles * per * (2 * ni + nl // 4), 4), 16)
    tree_tabs = tuple(vec_arg(a, "int32", (TREES, 1), 4)
                      for a in ("tree_rec", "tree_leaf"))
    for wide in (False, True):
        units = per * ((2 if wide else 1) * ni + nl // 4)
        for raw in (False, True):
            for leaves in (False, True):
                sizes = [BUCKET] + ([QUEUE] if raw and not leaves else [])
                for n in sizes:
                    geo = sk.geometry_for(n, F, n_tiles=tiles, per_tile=per,
                                          stage_units=units, bq=255, k=1,
                                          raw=raw, leaves=leaves)
                    rows = (vec_arg("raw", "float32", (n, F), 4),
                            vec_arg("qmeta", "int32", (F, 4), 16),
                            vec_arg("ub", "float32", (F, 255), 4)) if raw \
                        else (vec_arg("bins", "int32", (n, F), 4),)
                    out = vec_arg("out", "int32", (n, TREES), 4) if leaves \
                        else vec_arg("out", "float32", (n, 1), 4)
                    name = ("serve_traverse" + ("_raw" if raw else "")
                            + ("_leaves" if leaves else "_scores")
                            + ("_wide" if wide else "")
                            + ("" if n == BUCKET else f"_{n}"))
                    flags = ", ".join("true" if v else "false"
                                      for v in (wide, leaves, raw))
                    register_kernel(KernelEntry(
                        name=name, source="serve_traverse",
                        symbol=f"traverse_kernel<{flags}>",
                        grid=(geo.grid_x, geo.grid_y, 1),
                        block=_block(sk.THREADS), dyn_smem=geo.smem,
                        args=(blob,) + tree_tabs + rows + (out,),
                        wrapper=("serve_kernel.serve_traverse_raw" if raw
                                 else "serve_kernel.serve_traverse"),
                        replaces=f"{PALLAS}/serve_kernel.py:219"))
    register_kernel(KernelEntry(
        name="serve_traverse_tile_sums", source="serve_traverse",
        symbol="sum_tiles", block=_block(256), dyn_smem=0,
        args=(vec_arg("partials", "float32", (tiles, QUEUE, 1), 4),
              vec_arg("out", "float32", (QUEUE, 1), 4)),
        wrapper="serve_kernel.serve_traverse_raw",
        replaces=f"{PALLAS}/serve_kernel.py:219"))


def _comb_rows(pack: int, f: int):
    """The row arguments of ``hist_comb`` (pack 1: bins and vals; pack
    2: the records) at ``f`` features."""
    if pack == 1:
        return (vec_arg("bins", "uint8", (N, f), 4),
                vec_arg("vals", "float32", (N, 3), 4))
    return (vec_arg("base", "uint8", (N, RecordLayout(f).stride), 4),)


def comb_entry(f: int, max_rows: int, pack: int = 1,
               fc: int = None) -> KernelEntry:
    """``hist_comb`` (``_p2`` at pack 2) at ``f`` features, B = 256, on
    the geometry ``hist_kernel2.comb_geometry`` gives a range of up to
    ``max_rows`` rows: feature mode (``hist_comb_partial``, the
    partials) at the root, range mode (``hist_comb_range``, one launch)
    at a smaller child.  ``fc`` replaces the feature chunk."""
    geo = hk.comb_geometry(f, B, max_rows)
    if fc is not None:
        geo = geo._replace(grid=(geo.grid[0], -(-f // fc)), feats=fc,
                           smem=hk.comb_feature_smem(fc, B))
    layout = "CombRows" if pack == 1 else "CombRecords"
    kernel = "hist_comb_range" if geo.ranged else "hist_comb_partial"
    width = "_wide" if f == F_WIDE else ""
    mode = "_range" if geo.ranged else ""
    sfx = "_p2" if pack == 2 else ""
    out = vec_arg("out", "float32", (f, B, 2), 8 if geo.ranged else 4)
    partials = () if geo.ranged else (
        vec_arg("partials", "float32", (geo.slices, f, B, 2), 4),)
    return KernelEntry(
        name=f"hist_comb{width}{mode}{sfx}", source="hist_comb",
        symbol=f"{kernel}<{layout}>", block=_block(THREADS),
        dyn_smem=geo.smem, args=_comb_rows(pack, f) + partials + (out,),
        wrapper=f"hist_kernel2.build_histogram_comb{sfx}",
        replaces=(f"{PALLAS}/hist_kernel2.py:225" if pack == 1
                  else f"{PALLAS}/hist_kernel2.py:144, :225"),
        export=("hist_comb_smem_bytes", (geo.feats, B, int(geo.ranged))))


# -- histograms ---------------------------------------------------------------
def _hist():
    # both modes at the shapes the routes give: the 1M-row root and the
    # median smaller child (the default route's median split segment;
    # the grower's bound cnt // 2 + 1), 28 and 136 features, both packs
    for f in (F, F_WIDE):
        for max_rows in (N, MEDIAN_SEGMENT // 2 + 1):
            for pack in (1, 2):
                register_kernel(comb_entry(f, max_rows, pack))
    _reduce("hist_comb", "hist_kernel2.build_histogram_comb",
            f"{PALLAS}/hist_kernel2.py:225", hk.hist_blocks(N))
    rows_src = (f"{PALLAS}/hist_kernel2.py:339, "
                f"{PALLAS}/hist_kernel.py:122")
    # the gpu_use_dp mode replaces no Pallas kernel: the JAX package's
    # f64 histogram is the XLA scatter-add of ops/histogram.py:178
    dp_src = "lightgbm_tpu/ops/histogram.py:178 (XLA scatter-add, no kernel)"
    for (bin_t, dtype, b), (acc, acc_bytes) in itertools.product(
            (("unsigned char", "uint8", B),
             ("unsigned short", "uint16", B_WIDE)),
            (("float", 4), ("double", 8))):
        width = 2 if dtype == "uint16" else 1
        tag = ("u16" if width == 2 else "u8") + (
            "_f64" if acc_bytes == 8 else "")
        wrapper = ("hist_kernel2.build_histogram_rows_dp" if acc_bytes == 8
                   else "hist_kernel2.build_histogram_rows")
        src = dp_src if acc_bytes == 8 else rows_src
        ins = (vec_arg("bins", dtype, (N, F), width),
               vec_arg("vals", "float32", (N, 2), 8),
               vec_arg("index", "int32", (N, 1), 4))
        # the root: several slices, then the reduction
        root = hk.rows_geometry(F, b, width, hk.rows_blocks(N, b), acc_bytes)
        register_kernel(KernelEntry(
            name=f"hist_rows_{tag}", source="hist_rows",
            symbol=f"hist_rows_partial<{bin_t}, {acc}>",
            block=_block(THREADS), dyn_smem=root.smem,
            args=ins + (vec_arg("partials", f"float{8 * acc_bytes}",
                                (root.slices, F, b, 2), acc_bytes),
                        vec_arg("out", "float32", (F, b, 2), 4)),
            wrapper=wrapper, replaces=src,
            export=("hist_rows_smem_bytes",
                    (root.feats, b, width, acc_bytes))))
        # a child of one slice: one launch writes out
        child = hk.rows_geometry(F, b, width, 1, acc_bytes)
        register_kernel(KernelEntry(
            name=f"hist_rows_direct_{tag}", source="hist_rows",
            symbol=f"hist_rows_direct<{bin_t}, {acc}>",
            block=_block(THREADS), dyn_smem=child.smem,
            args=ins + (vec_arg("out", "float32", (F, b, 2), 8),),
            wrapper=wrapper, replaces=src,
            export=("hist_rows_direct_smem_bytes",
                    (child.feats, width, acc_bytes))))
    _reduce("hist_rows", "hist_kernel2.build_histogram_rows",
            f"{PALLAS}/hist_kernel2.py:339", hk.rows_blocks(N, B_WIDE),
            b=B_WIDE)
    cells = F * B_WIDE * 2
    register_kernel(KernelEntry(
        name="hist_rows_reduce_f64", source="hist_rows",
        symbol="reduce_partials_f64", block=_block(256), dyn_smem=0,
        args=(vec_arg("partials", "float64",
                      (hk.rows_blocks(N, B_WIDE), cells), 8),
              vec_arg("out", "float32", (1, cells), 4)),
        wrapper="hist_kernel2.build_histogram_rows_dp", replaces=dp_src))


# -- the linear-leaf fit --------------------------------------------------------
# the path features of a leaf's model at which the sums take each kernel:
# chunk_sums_warp at its entries a lane (NS) 3 (kmax 9, E = 66: the linear
# main path's tree 0), 4 (12, 105), 8 (19, 231) and 16 (28, 465: every
# feature), chunk_sums at 136 (the wide data's, passes of 4,096)
LINEAR_KMAX = (9, 12, 19, 28, 136)


def _linear():
    """``linear_moments``' kernels at the linear main path's shapes: 1M
    rows x 28 features (136 for the widest), 255 leaves, ``CHUNK`` rows a
    chunk, the scratch ``[batch, pass]`` f64; the sums at each of their
    instantiations' kmax (``chunk_sums`` in its first pass, every column
    staged), ``chunk_chain`` once (its block does not depend on kmax)."""
    src = "lightgbm_tpu/models/linear.py:101 (XLA einsum, no kernel)"
    cmax = lk.scratch_chunks(N, LEAVES)
    for kmax in LINEAR_KMAX:
        f = F_WIDE if kmax > F else F
        e = lk.moment_layout(kmax)[1]
        ep = lk.pass_entries(kmax)
        warp = e <= 32 * lk.MAX_SLOTS
        register_kernel(KernelEntry(
            name=f"linear_moments_sums_k{kmax}", source="linear_fit",
            symbol=(f"chunk_sums_warp<(int){lk.lane_slots(e)}>" if warp
                    else "chunk_sums"),
            block=_block((lk.WARPS_W if warp else lk.WARPS) * 32),
            dyn_smem=lk.smem_bytes(kmax),
            args=(vec_arg("raw", "float32", (N, f), 4),
                  vec_arg("order", "int32", (N, 1), 4),
                  vec_arg("seg", "int32", (LEAVES, 2), 4),
                  vec_arg("cfirst", "int32", (LEAVES + 1, 1), 4),
                  vec_arg("g", "float32", (N, 1), 4),
                  vec_arg("h", "float32", (N, 1), 4),
                  vec_arg("w", "float32", (N, 1), 4),
                  vec_arg("feat_idx", "int32", (LEAVES, kmax), 4))
            + (() if warp else (vec_arg("ghw", "float32", (3, N), 4),))
            + (vec_arg("scratch", "float64",
                       (lk.chunk_batch(kmax, cmax, N), ep), 8),),
            wrapper="linear_kernel.linear_moments", replaces=src,
            export=("linear_moments_smem_bytes", (kmax, lk.CHUNK))))
    e = lk.moment_layout(F)[1]
    register_kernel(KernelEntry(
        name="linear_moments_chain", source="linear_fit",
        symbol="chunk_chain", block=_block(lk.CHAIN_THREADS),
        dyn_smem=lk.chain_smem_bytes(),
        args=(vec_arg("cfirst", "int32", (LEAVES + 1, 1), 4),
              vec_arg("scratch", "float64", (cmax, e), 8),
              vec_arg("out", "float64", (LEAVES, e), 8)),
        wrapper="linear_kernel.linear_moments", replaces=src,
        export=("linear_moments_chain_smem_bytes", ())))


# -- TreeSHAP (pred_contrib) -----------------------------------------------------
def _shap():
    """``tree_shap`` at ``pred_contrib``'s main path: a 65,536-row bucket
    of f64 rows x 28 features, one thread a row, the contributions [n,
    F + 1] f64; the path scratch is global memory the wrapper sizes from
    the forest's depth."""
    register_kernel(KernelEntry(
        name="tree_shap", source="tree_shap", symbol="tree_shap_kernel",
        block=_block(shk.THREADS), dyn_smem=0,
        args=(vec_arg("x", "float64", (BUCKET, F), 8),
              vec_arg("out", "float64", (BUCKET, F + 1), 8)),
        wrapper="shap_kernel.tree_shap",
        replaces="lightgbm_tpu/models/shap.py:97 (host recursion, no "
                 "kernel)"))


def hist_comb_wide_entry(fc: int = None) -> KernelEntry:
    """``hist_comb`` at the wide edge's root, F = 136, B = 256, in
    feature mode: blocks of ``fc`` features (the wrapper's chunk, 8,
    unless given)."""
    return comb_entry(F_WIDE, N, 1, fc)


# -- partitions ---------------------------------------------------------------
def _cat_modes():
    """The membership-word modes at the categorical workload's shapes
    (2^20 rows x 36 features, 64-byte records): the scans of both packs
    and of the 3-phase partition, the fused split's count and scatter
    passes of both packs and its histogram pass at the root."""
    rec = RecordLayout(F_CAT).stride
    for name, pack, source, rows in (
            ("partition_scan", 1, "partition", "part::RowPtrs"),
            ("partition_scan_p2", 2, "partition", "part::RecPtr"),
            ("partition_3ph", 1, "partition_3ph", "part::RowPtrs")):
        geo = (pk.scan_geometry(N_CAT, record_stride=rec) if pack == 2
               else pk.scan_geometry(N_CAT, F_CAT))
        args = (_rows_args(f=F_CAT, n=N_CAT) + _rows_args("s", f=F_CAT,
                                                          n=N_CAT)
                if pack == 1 else
                tuple(vec_arg(a, "uint8", (N_CAT, rec), 16)
                      for a in ("base", "sbase")))
        register_kernel(KernelEntry(
            name=f"{name}_cat", source=source,
            symbol=f"part::scan_tiles<{rows}, "
                   f"{'true' if geo.staged else 'false'}>",
            block=_block(pk.SCAN_THREADS), dyn_smem=geo.smem,
            args=args + (vec_arg("state", "int64", (1 + geo.tiles, 1), 8),),
            wrapper=f"partition_kernel.{name}", replaces=CAT[name],
            export=(f"{name}_smem_bytes",
                    (geo.tile, rec if pack == 2 else F_CAT,
                     int(geo.staged)))))
    tiles = -(-N_CAT // SCAN_TILE)
    copy = (vec_arg("cols", "uint8", (F_CAT, N_CAT), 1),
            vec_arg("gv", "float32", (N_CAT, 2), 8))
    for pack, rows in ((1, "part::RowPtrs"), (2, "part::RecPtr")):
        name = "fused_split" + ("_p2" if pack == 2 else "")
        recs = tuple(vec_arg(a, "uint8", (N_CAT, rec), v)
                     for a, v in (("base", 1), ("sbase", 16)))
        register_kernel(KernelEntry(
            name=f"{name}_cat_count", source="fused_split",
            symbol="part::count_tiles", block=_block(THREADS), dyn_smem=0,
            args=((recs[0] if pack == 2
                   else vec_arg("bins", "uint8", (N_CAT, F_CAT), 1)),
                  vec_arg("tile_left", "int32", (tiles, 1), 4)),
            wrapper=f"fused_split.{name}", replaces=CAT[name]))
        register_kernel(KernelEntry(
            name=f"{name}_cat_scatter", source="fused_split",
            symbol=f"fused_scatter<{rows}>", block=_block(THREADS),
            dyn_smem=0,
            args=(_rows_args(f=F_CAT, n=N_CAT)
                  + _rows_args("s", f=F_CAT, n=N_CAT) if pack == 1
                  else (vec_arg("base", "uint8", (N_CAT, rec), 16),
                        recs[1])) + copy,
            wrapper=f"fused_split.{name}", replaces=CAT[name]))
    geo = fs.fused_geometry(F_CAT, B, N_CAT)
    register_kernel(KernelEntry(
        name="fused_split_cat_hist_root", source="fused_split",
        symbol="fused_hist", block=_block(THREADS), dyn_smem=geo.smem,
        args=copy + (vec_arg("partials", "float32",
                             (2 * geo.slices, F_CAT, B, 2), 4),
                     vec_arg("out", "float32", (2, F_CAT, B, 2), 4)),
        wrapper="fused_split.fused_split", replaces=CAT["fused_split"],
        export=("fused_hist_smem_bytes", (geo.feats, geo.parts, B))))


def _partition():
    """The scan (``part::scan_tiles``) at the wrapper's geometry on the
    1M-row segment (staged) and on rows of ``F_MANY`` features
    (unstaged), both packs and the 3-phase partition's instantiation;
    the copybacks; the fused split's count pass."""
    tiles = -(-N // SCAN_TILE)
    scan = {1: f"{PALLAS}/partition_kernel2.py:377",
            2: f"{PALLAS}/partition_kernel3.py:633"}
    for pack in (1, 2):
        sfx = "_p2" if pack == 2 else ""
        bins = (_records(vec=1) if pack == 2
                else vec_arg("bins", "uint8", (N, F), 1))
        register_kernel(KernelEntry(
            name=f"fused_split_count{sfx}", source="fused_split",
            symbol="part::count_tiles", block=_block(THREADS), dyn_smem=0,
            args=(bins, vec_arg("tile_left", "int32", (tiles, 1), 4)),
            wrapper=f"fused_split.fused_split{sfx}", replaces=FUSED[pack]))
    p3 = f"{PALLAS}/partition_kernel.py:329"
    many = RecordLayout(F_MANY).stride
    for source, pack, rows in (("partition", 1, "part::RowPtrs"),
                               ("partition", 2, "part::RecPtr"),
                               ("partition_3ph", 1, "part::RowPtrs")):
        sfx = "_p2" if pack == 2 else ""
        name = "partition_3ph" if source == "partition_3ph" else \
            f"partition_scan{sfx}"
        replaces = p3 if source == "partition_3ph" else scan[pack]
        # staged at F, unstaged at F_MANY features (rows too wide to stage)
        for n, f, stride in ((N, F, S), (N_MANY, F_MANY, many)):
            geo = (pk.scan_geometry(n, record_stride=stride) if pack == 2
                   else pk.scan_geometry(n, f))
            args = (_rows_args(f=f, n=n) + _rows_args("s", f=f, n=n)
                    if pack == 1 else
                    tuple(vec_arg(a, "uint8", (n, stride), 16)
                          for a in ("base", "sbase")))
            state = vec_arg("state", "int64", (1 + geo.tiles, 1), 8)
            tag = "" if geo.staged else "_unstaged"
            register_kernel(KernelEntry(
                name=(f"{name}_scan{tag}" if source == "partition_3ph"
                      else f"{name}{tag}"),
                source=source,
                symbol=f"part::scan_tiles<{rows}, "
                       f"{'true' if geo.staged else 'false'}>",
                block=_block(pk.SCAN_THREADS), dyn_smem=geo.smem,
                args=args + (state,), wrapper=f"partition_kernel.{name}",
                replaces=replaces,
                export=(f"{name}_smem_bytes",
                        (geo.tile, stride if pack == 2 else f,
                         int(geo.staged)))))
    register_kernel(KernelEntry(
        name="copyback", source="partition", symbol="part::copy_span",
        block=_block(256), dyn_smem=0,
        args=_rows_args() + _rows_args("s"),
        wrapper="partition_kernel.copyback",
        replaces=f"{PALLAS}/partition_kernel2.py:325"))
    register_kernel(KernelEntry(
        name="copyback_p2", source="partition", symbol="copy_records",
        block=_block(256),
        dyn_smem=0, args=(_records(), _records("sbase")),
        wrapper="partition_kernel.copyback_p2",
        replaces=f"{PALLAS}/partition_kernel3.py:562"))
    register_kernel(KernelEntry(
        name="partition_3ph_copyback", source="partition_3ph",
        symbol="copyback_3ph", block=_block(256), dyn_smem=0,
        args=_rows_args() + _rows_args("s"),
        wrapper="partition_kernel.partition_3ph", replaces=p3))


def _fused():
    """The partition pass on the 1M-row segment (scratch and the
    feature-major copy, either pack), the histogram pass over the copy at
    the root's geometry and the median segment's, the reduction at the
    root's slices."""
    copy = (vec_arg("cols", "uint8", (F, N), 1),
            vec_arg("gv", "float32", (N, 2), 8))
    for pack, rows in ((1, "part::RowPtrs"), (2, "part::RecPtr")):
        sfx = "_p2" if pack == 2 else ""
        register_kernel(KernelEntry(
            name=f"fused_scatter{sfx}", source="fused_split",
            symbol=f"fused_scatter<{rows}>", block=_block(THREADS),
            dyn_smem=0,
            args=(_rows_args() + _rows_args("s") if pack == 1
                  else (_records(), _records("sbase"))) + copy,
            wrapper=f"fused_split.fused_split{sfx}", replaces=FUSED[pack]))
    for where, cnt in (("root", N), ("median", MEDIAN_SEGMENT)):
        geo = fs.fused_geometry(F, B, cnt)
        register_kernel(KernelEntry(
            name=f"fused_hist_{where}", source="fused_split",
            symbol="fused_hist", block=_block(THREADS), dyn_smem=geo.smem,
            args=copy + (vec_arg("partials", "float32",
                                 (2 * geo.slices, F, B, 2), 4),
                         vec_arg("out", "float32", (2, F, B, 2), 4)),
            wrapper="fused_split.fused_split", replaces=FUSED[1],
            export=("fused_hist_smem_bytes", (geo.feats, geo.parts, B))))
    _reduce("fused_split", "fused_split.fused_split", FUSED[1],
            fs.fused_geometry(F, B, N).slices, sets=2)


def _apply_find():
    """Both entries at the default route's 28 x 256, and the pool entry
    at the row-order route's 28 x 1024 and the wide route's 136 x 256:
    one cluster of ``tail_geometry``'s blocks; each in the unconstrained
    and the monotone instantiation (``apply_find_mono_kernel``)."""
    shapes = ((True, F, B, ""), (False, F, B, ""),
              (True, F, B_WIDE, "_b1024"), (True, F_WIDE, B, "_wide"))
    for (pool, f, b, tag), mono in itertools.product(shapes, (False, True)):
        base = "apply_find_pool" if pool else "apply_find"
        geo = af.tail_geometry(f, b)
        hists = ((vec_arg("pool", "float32", (LEAVES, f, b, 2), 8),)
                 if pool else ())
        kernel = "apply_find_mono_kernel" if mono else "apply_find_kernel"
        register_kernel(KernelEntry(
            name=base + ("_mono" if mono else "") + tag, source="apply_find",
            symbol=f"{kernel}<{'true' if pool else 'false'}>",
            grid=_grid(geo.blocks), block=_block(af.TAIL_THREADS),
            cluster=geo.blocks, dyn_smem=geo.smem,
            args=hists + (vec_arg("h_a", "float32", (f, b, 2), 8),
                          vec_arg("h_b", "float32", (f, b, 2), 8),
                          vec_arg("best", "float32", (LEAVES, 10), 4),
                          vec_arg("lstate", "float32", (LEAVES, 8), 4)),
            wrapper=f"apply_find.{base}",
            replaces=f"{PALLAS}/apply_find.py:{571 if pool else 529}",
            export=("apply_find_smem_bytes", (geo.feats, b))))


def _stream():
    rep = f"{PALLAS}/stream_grad.py"
    aux = (vec_arg("score", "float32", (N, 1), 4),
           vec_arg("valid", "float32", (N, 1), 4),
           vec_arg("consts", "float32", (N, 2), 4))
    src_bins = vec_arg("src_bins", "uint8", (N, F), 4)
    register_kernel(KernelEntry(
        name="stream_init", source="stream_grad",
        symbol="stream_init_kernel",
        block=_block(256), dyn_smem=0,
        args=(src_bins,) + aux + _rows_args(),
        wrapper="stream_grad.stream_init", replaces=f"{rep}:784"))
    register_kernel(KernelEntry(
        name="stream_init_p2", source="stream_grad",
        symbol="stream_init_p2_kernel",
        block=_block(THREADS), dyn_smem=sg.init_p2_smem_bytes(S),
        args=(src_bins,) + aux + (_records(),),
        wrapper="stream_grad.stream_init_p2",
        replaces=f"{rep}:754"))
    for pack in (1, 2):
        sfx = "_p2" if pack == 2 else ""
        plain = KernelEntry(
            name=f"stream_refresh_plain{sfx}", source="stream_grad",
            symbol=f"stream_refresh_plain{sfx}_kernel",
            block=_block(256), dyn_smem=0,
            args=(((_records(vec=4),) if pack == 2
                   else (_rows_args()[1], _rows_args()[3], _rows_args()[4]))
                  + (vec_arg("lv", "float32", (N, 1), 4),)),
            wrapper=f"stream_grad.stream_refresh_plain{sfx}",
            replaces=f"{rep}:{652 if pack == 2 else 557}")
        register_kernel(plain)
        # the root-histogram refresh: the plain refresh's kernel, then
        # hist_comb's root over [0, n)
        hist_rep = f"{rep}:{610 if pack == 2 else 515}"
        register_kernel(dataclasses.replace(
            plain, name=f"stream_refresh{sfx}",
            wrapper=f"stream_grad.stream_refresh{sfx}", replaces=hist_rep))
        register_kernel(dataclasses.replace(
            comb_entry(F, N, pack), name=f"stream_refresh{sfx}_root_hist",
            wrapper=f"stream_grad.stream_refresh{sfx}", replaces=hist_rep))


# -- the launch-cost probes at their tools' shapes ----------------------------
PROBE_ROWS = 1 << 20           # tools/profile_step_cost.py PN = 20
TOOLS = "tools"


def _probes():
    register_kernel(KernelEntry(
        name="select_update", source="probes", symbol="select_update_kernel",
        grid=_grid(1), block=_block(256), dyn_smem=0,
        args=(vec_arg("leafs", "float32", (pr.LEAVES, pr.COLS), 4),
              vec_arg("sel", "float32", (pr.SEL,), 4)),
        wrapper="probes.select_update",
        replaces=f"{TOOLS}/profile_pallas_ov.py:40"))
    nb = PROBE_ROWS // pr.TILE_ROWS
    rows = vec_arg("rows", "float32", (PROBE_ROWS, pr.TILE_COLS), 16)
    out = vec_arg("out", "int32", (1,), 4)
    for code, var in enumerate(pr.VARIANTS):
        register_kernel(KernelEntry(
            name=f"step_cost_{var}", source="probes",
            symbol=f"step_cost_kernel<(int){code}>", grid=_grid(nb),
            block=_block(32), dyn_smem=pr.smem_bytes(var),
            args=(vec_arg("sel", "int32", (2,), 4), rows, out),
            wrapper="probes.step_cost",
            replaces=f"{TOOLS}/profile_step_cost.py:86",
            export=("probes_smem_bytes", (code,))))
    register_kernel(KernelEntry(
        name="stream_tiles", source="probes", symbol="stream_tiles_kernel",
        grid=_grid(nb), block=_block(32),
        dyn_smem=pr.smem_bytes("stream_tiles"), args=(rows, out),
        wrapper="probes.stream_tiles",
        replaces=f"{TOOLS}/profile_step_cost.py:52",
        export=("probes_smem_bytes", (len(pr.VARIANTS),))))


# -- the partition-bisection probes at their tool's shapes --------------------
LEGACY_N = 1 << 20             # tools/profile_legacy.py PN = 20 (part3-5)
LEGACY_ALLOC = LEGACY_N + 2 * lp.R


def _legacy_rows(*names, n: int = LEGACY_ALLOC):
    return tuple(vec_arg(a, "float32", (n, lp.C), 16) for a in names)


def _legacy_probes():
    nb = LEGACY_N // lp.R
    tiles = LEGACY_N // lp.TILE
    ints = lambda name, k: vec_arg(name, "int32", (k,), 4)  # noqa: E731
    legacy = "legacy_probes"
    src = f"{TOOLS}/profile_legacy.py"
    for phases in (1, 3):
        register_kernel(KernelEntry(
            name=f"legacy_block_copy{'3' if phases == 3 else ''}",
            source=legacy, symbol=f"block_copy<(int){phases}>",
            grid=(nb, phases, 1), block=_block(32),
            dyn_smem=lp.smem_bytes("block_copy"),
            args=_legacy_rows("rows", "scratch"),
            wrapper="legacy_probes.block_copy", replaces=f"{src}:150",
            export=("legacy_smem_bytes", (0,))))
    dense = "legacy_probes.partition_dense"
    register_kernel(KernelEntry(
        name="legacy_dense_left_count", source=legacy,
        symbol="dense_left_count", grid=_grid(tiles), block=_block(lp.TILE),
        dyn_smem=0, args=_legacy_rows("rows") + (ints("tile_cnt", tiles),),
        wrapper=dense, replaces=f"{src}:172"))
    register_kernel(KernelEntry(
        name="legacy_tile_scan", source=legacy, symbol="tile_scan",
        grid=_grid(1), block=_block(1024), dyn_smem=0,
        args=(ints("cnt", tiles), ints("pre", tiles), ints("total", 1)),
        wrapper=dense, replaces=f"{src}:172"))
    for phases in (1, 2):
        register_kernel(KernelEntry(
            name=f"legacy_dense_scatter{phases}", source=legacy,
            symbol=f"dense_scatter<(int){phases}>", grid=_grid(tiles),
            block=_block(lp.TILE), dyn_smem=0,
            args=_legacy_rows("rows", "scratch"), wrapper=dense,
            replaces=f"{src}:172"))
    register_kernel(KernelEntry(
        name="legacy_dense_copy_span", source=legacy,
        symbol="dense_copy_span", block=_block(256), dyn_smem=0,
        args=_legacy_rows("rows", "scratch"), wrapper=dense,
        replaces=f"{src}:172"))
    # part4 :369, part5 :467, part6 :562 (prefetch) / :577, part7 :686
    line = dict.fromkeys(("nosmem", "grid2", "smem_full", "alias2",
                          "nsplit"), 369)
    line.update(dict.fromkeys(("selread", "when", "dynoff", "pred"), 467))
    line.update(smemuse=577, prefetch=562)
    line.update(dict.fromkeys(("deadsel", "scratchthr", "smem_thr",
                               "noalias", "hbmsel"), 686))
    for code, mech in enumerate(lp.MECHS):
        grid = (1, tiles, 1) if 1 <= code <= 4 else _grid(tiles)
        in_place = mech not in lp.TO_SCRATCH and mech != "noalias"
        args = _legacy_rows("rows", "out") + (
            vec_arg("sel", "int32", (8,), 16),)
        for step in ("count", "move"):
            smem = lp.smem_bytes("compact_move") if (
                step == "move" and in_place) else 0
            register_kernel(KernelEntry(
                name=f"legacy_compact_{step}_{mech}", source=legacy,
                symbol=f"compact_carry<(int){code}>", grid=grid,
                block=_block(lp.TILE), dyn_smem=smem, args=args,
                wrapper="legacy_probes.compact",
                replaces=f"{src}:{line[mech]}",
                export=("legacy_smem_bytes", (1,)) if smem else None))
    register_kernel(KernelEntry(
        name="legacy_hbm_alias_step", source=legacy,
        symbol="hbm_alias_step", grid=_grid(8), block=_block(512),
        cluster=8,
        dyn_smem=0, args=_legacy_rows("comb", n=lp.ALIAS_N),
        wrapper="legacy_probes.hbm_alias_step", replaces=f"{src}:898"))


# -- the analyzer's fixture kernels at their legal geometries ---------------
# (name, dtype, classes, rows, cols, copied rows, JAX fixture)
FIXTURE_STAGE_LEGAL = (
    ("fixture_lane", "float32", 1, 256, 64, 8, "__init__.py:77"),
    ("fixture_cat", "int32", 1, 256, 16, 8, "__init__.py:280"),
    ("fixture_serve", "int32", 1, 64, 64, 64, "__init__.py:326"),
    ("fixture_mc_batch", "float32", 4, 16, 64, 16, "__init__.py:393"),
)
FIXTURES_DIR = "lightgbm_tpu/analysis/fixtures"
SMEM_ACC_LEGAL = 8192        # bytes of the legal accumulator


def stage_copy_entry(name, dtype, classes, rows, cols, copied, replaces,
                     fixture=False, base_offset=0) -> KernelEntry:
    """One ``fixture_stage_copy`` launch: ``copied`` rows of each of
    ``classes`` slices ``[rows, cols]``."""
    shape = (classes, rows, cols) if classes > 1 else (rows, cols)
    row_bytes = cols * 4
    return KernelEntry(
        name=name, source="analysis_fixtures",
        symbol=f"fixture_stage_copy<{'int' if dtype == 'int32' else 'float'}>",
        grid=_grid(classes), block=_block(128),
        dyn_smem=copied * row_bytes,
        args=(vec_arg("src", dtype, shape, 16, base_offset),
              vec_arg("dst", dtype, shape, 16, base_offset)),
        wrapper="analysis_fixtures.stage_copy",
        replaces=f"{FIXTURES_DIR}/{replaces}",
        export=("analysis_stage_copy_smem_bytes", (copied, row_bytes)),
        fixture=fixture)


def smem_acc_entry(name: str, acc_bytes: int,
                   fixture: bool = False) -> KernelEntry:
    """One ``fixture_smem_acc`` launch: 4 blocks of (8, 128) f32."""
    return KernelEntry(
        name=name, source="analysis_fixtures", symbol="fixture_smem_acc",
        grid=_grid(4), block=_block(128), dyn_smem=acc_bytes,
        args=(vec_arg("x", "float32", (32, 128), 4),
              vec_arg("o", "float32", (32, 128), 4)),
        wrapper="analysis_fixtures.smem_acc",
        replaces=f"{FIXTURES_DIR}/__init__.py:107", fixture=fixture)


def _fixture_kernels():
    for row in FIXTURE_STAGE_LEGAL:
        register_kernel(stage_copy_entry(*row))
    register_kernel(smem_acc_entry("fixture_vmem", SMEM_ACC_LEGAL))
    register_kernel(KernelEntry(
        name="fixture_host", source="analysis_fixtures",
        symbol="fixture_scale_bias", block=_block(256),
        dyn_smem=0,
        args=(vec_arg("x", "float32", (8, 128), 4),
              vec_arg("o", "float32", (8, 128), 4)),
        wrapper="analysis_fixtures.scale_bias",
        replaces=f"{FIXTURES_DIR}/bad_host_ast.py:21"))


for _register in (_serve, _hist, _linear, _shap, _partition, _fused, _cat_modes,
                  _apply_find, _stream,
                  _probes, _legacy_probes, _fixture_kernels):
    _register()


# -- purity pins: "knob off => the same program" ------------------------------
def train_variant(env: dict, *, n_features: int, seed: int = 0):
    """A function that trains 2 iterations of a 7-leaf binary model on
    300 seeded rows on the CPU with ``env`` set (``None`` unsets)."""
    def fn():
        import os

        import numpy as np

        import lightgbm_tpu_torch as lgt
        from ..utils import log
        rng = np.random.default_rng(seed)
        x = rng.normal(size=(300, n_features)).astype(np.float32)
        y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float32)
        saved = {k: os.environ.get(k) for k in env}
        verbosity = log.get_verbosity()
        log.set_verbosity(-1)
        try:
            for k, v in env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            lgt.train({"objective": "binary", "num_leaves": 7,
                       "min_data_in_leaf": 5},
                      lgt.Dataset(x, label=y), 2, device="cpu")
        finally:
            log.set_verbosity(verbosity)
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return fn


@register_purity_pin("pool-tail-explicit")
def _pin_pool_tail():
    """``LGBM_TPU_POOL_TAIL=1`` set is the default."""
    return [("default", train_variant({"LGBM_TPU_POOL_TAIL": None},
                                      n_features=4)),
            ("LGBM_TPU_POOL_TAIL=1", train_variant(
                {"LGBM_TPU_POOL_TAIL": "1"}, n_features=4))]


@register_purity_pin("pack2-too-wide")
def _pin_pack2_wide():
    """``LGBM_TPU_COMB_PACK=2`` on a layout too wide for it (56 features:
    56 + 13 stream columns over the 64-lane half line) is the pack=1
    program (``ops/routing.resolve_layout``'s fall back)."""
    return [("pack=1", train_variant({"LGBM_TPU_COMB_PACK": "1"},
                                     n_features=56)),
            ("pack=2 requested", train_variant({"LGBM_TPU_COMB_PACK": "2"},
                                               n_features=56))]
