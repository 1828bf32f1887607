"""The split tail in one kernel: the wrappers of ``csrc/apply_find.cu``,
their launch counts and their plain PyTorch versions.

Counterpart of ``lightgbm_tpu/ops/pallas/apply_find.py``
(``make_apply_find_pool`` and ``make_apply_find``).  After a split's
partition, the tail derives both children's histograms (the smaller
child's given, the sibling by the subtraction trick from the parent's
pool row), writes them to the pool, searches both children's best
splits and writes the per-leaf state rows: ``best`` and ``lstate`` of
the left child (which keeps the parent's slot ``leaf``) and of the new
``right`` leaf, the ``node`` row, and the ``seg`` rows.  Nothing is
written when ``done`` is set.  Under ``LGBM_TPU_POOL_TAIL=0`` the pool
ops (sibling = parent - child, the pool writes) run in PyTorch and the
tail is the plain-pool kernel (:func:`apply_find_torch_pool`), as the
JAX package runs ``make_apply_find`` with ``tail_pool=False``
(``grow.py:1253-1262``).

The plain versions are slice 2's tail: ``ops/split.py``
``find_best_split`` plus the state writes and the subtraction trick, in
the order the grower ran them; the kernel repeats that arithmetic
operation by operation (f64 bin prefix sums rounded once, no fused
multiply-adds), so on the CPU both routes grow the same trees and on
the card the kernel equals its plain version bit for bit.

The kernel runs as one thread-block cluster over the features
(:func:`tail_geometry`: up to ``MAX_CLUSTER`` blocks, each holding its
features' two child histograms in shared memory), so the tail fits
wherever one cluster's shared memory holds both children: 28 x 1024
(the row-order route at ``max_bin=1023``) and 136 x 256 (the wide route)
included.  :func:`cluster_winner_ref` models its search (each block's
winner over its feature range, then the merge) for the tests.

Monotone constraints, the basic method (``make_apply_find``'s
``mono_s`` mode): the children's output bounds come from the parent's
bounds and the midpoint of its winner's outputs on a monotone feature
(``BasicLeafConstraints::Update``, :func:`child_bounds`), both children
search with them (clipped outputs, the violation mask, the depth
penalty read from ``FinderConsts.penalty``), and their ``lstate`` rows
hold them.  On the card this is the kernel's second instantiation
(``apply_find_mono_kernel``), chosen under ``hp.use_monotone``; the
unconstrained one is unchanged.

Under a parallel learner (``parallel/``) the pool entry takes the
split's global side: ``side`` (i32 [2] on the device, ``(nl_g, cnt_g)``,
the left child's and the leaf's rows summed over the ranks) picks the
smaller child by ``nl_g * 2 <= cnt_g`` while the segments still move by
the rank's own ``nleft`` and ``cnt``; without it the test is the local
``nleft * 2 <= cnt``, bit for bit the serial tail.  Under the
reduce-scatter merge the pool, the finder's constants and the mask hold
the rank's feature chunk only, so the kernel runs at ``F_r`` features
and its winners' feature indices are the chunk's (the grower shifts and
elects them).

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.  The kernel has no
sorted-subset categorical search, no intermediate monotone method and
no per-child search inputs (:class:`ChildSearch`: interaction
constraints, by-node feature sampling, CEGB penalties, the extra
trees' draws): under ``hp.use_cat_subset``, ``hp.mono_intermediate``,
``hp.use_cegb`` or ``hp.use_extra_trees``, or with a ``ChildSearch``,
the route takes the PyTorch tail (:func:`apply_find_pool_ref`), and a
kernel launch raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ..utils.log import LightGBMError
from . import _build
from .hist_kernel2 import MAX_SMEM
from .histogram import subtract_histogram
from .split import (SplitHyperParams, calculate_leaf_output, find_best_split,
                    pack_split_info)

# best-row columns (the JAX grower's _GrowState.best layout)
BG, BF, BB, BDL, BCAT, BLG, BLH, BLC, BLO, BRO = range(10)
# per-leaf state columns (_GrowState.lstate)
SG, SH, SC, SDEP, SPAR, SMN, SMX, SOUT = range(8)


class FinderConsts(NamedTuple):
    """The dataset's bin metadata for the split search: ``masks`` [4, F,
    B] f32 (``build_finder_consts``) for the kernel, the [F] vectors for
    the plain version, and the monotone constants for both."""
    masks: torch.Tensor
    num_bins: torch.Tensor   # i32 [F], the NaN bin included
    has_nan: torch.Tensor    # bool [F]
    is_cat: torch.Tensor     # bool [F]
    mono: torch.Tensor       # i32 [F] monotone sign; zeros when off
    penalty: torch.Tensor    # f32 [D] split.monotone_penalty_table by depth


class TreeState(NamedTuple):
    """The grower's per-tree device state, updated in place."""
    pool: torch.Tensor     # f32 [L, F, B, 2] histograms of the leaves
    best: torch.Tensor     # f32 [L, 10] best split of each leaf
    lstate: torch.Tensor   # f32 [L, 8] sums, depth, parent, bounds, output
    nodes: torch.Tensor    # f32 [L - 1, 4] gain, output, weight, count
    seg: torch.Tensor      # i32 [L, 2] segment (start, count) of each leaf


class ChildSearch(NamedTuple):
    """The two children's own search inputs, built once a split by the
    grower (``ops/grow._SearchPlan.children``): each ``[2, F]`` f32
    (left, right); None where the option is off."""
    mask: torch.Tensor                     # feature mask of each child
    cegb: Optional[torch.Tensor] = None    # CEGB per-feature penalty
    rand: Optional[torch.Tensor] = None    # extra trees: thresholds' draws
    rand_subset: Optional[torch.Tensor] = None   # extra trees: subsets'


class SplitAt(NamedTuple):
    """Where a split writes: its leaf, the new right leaf, the node, the
    parent segment and the drop guard."""
    leaf: int
    right: int
    node: int
    s0: int
    cnt: int
    done: int = 0


def build_finder_consts(num_bins: torch.Tensor, has_nan: torch.Tensor,
                        is_cat: torch.Tensor, padded_bins: int,
                        monotone: Optional[torch.Tensor] = None,
                        penalty: Optional[torch.Tensor] = None
                        ) -> FinderConsts:
    """``apply_find.build_finder_consts``'s masks: 0 valid0 (numerical
    forward merged with one-hot categorical, bin 0 of a categorical
    feature left out as in ``split.py``), 1 valid1 (numerical, missing
    left), 2 the NaN bin's one-hot (zero without a NaN bin), 3 is_cat
    broadcast over bins.  Its fifth row, the monotone sign, is the [F]
    vector ``monotone`` (zeros when None), which the kernel stages per
    feature; ``penalty`` the depth penalty table (one 1.0 when None)."""
    bins_r = torch.arange(padded_bins, dtype=torch.int32,
                          device=num_bins.device)[None, :]
    max_t = num_bins[:, None] - 2 - has_nan[:, None].to(torch.int32)
    num_valid = (bins_r <= max_t) & ~is_cat[:, None]
    cat_valid = ((bins_r >= 1) & (bins_r < num_bins[:, None])
                 & is_cat[:, None])
    nan_oh = ((bins_r == torch.clamp(num_bins - 1, min=0)[:, None])
              & has_nan[:, None])
    masks = torch.stack([num_valid | cat_valid, num_valid & has_nan[:, None],
                         nan_oh, is_cat[:, None].expand_as(num_valid)])
    dev = num_bins.device
    mono = (torch.zeros(num_bins.shape, dtype=torch.int32, device=dev)
            if monotone is None
            else monotone.to(device=dev, dtype=torch.int32).contiguous())
    pen = (torch.ones(1, dtype=torch.float32, device=dev) if penalty is None
           else penalty.to(device=dev, dtype=torch.float32).contiguous())
    return FinderConsts(masks.to(torch.float32).contiguous(), num_bins,
                        has_nan, is_cat, mono, pen)


def allow_split(depth: torch.Tensor, max_depth: int) -> torch.Tensor:
    if max_depth <= 0:
        return torch.ones(depth.shape, dtype=torch.bool, device=depth.device)
    return depth < max_depth


def child_bounds(brow: torch.Tensor, lrow: torch.Tensor, fc: FinderConsts,
                 hp: SplitHyperParams) -> tuple:
    """``(l_mn, l_mx, r_mn, r_mx)``: the children's output bounds of the
    split ``brow`` of the leaf ``lrow`` (0-d tensors).  Under the basic
    method a numerical split on a monotone feature pins the children to
    either side of the midpoint of its outputs
    (``BasicLeafConstraints::Update``, monotone_constraints.hpp:485-501;
    ``apply_find.py:384-389``); otherwise, and under the intermediate
    method (whose adjacency pass tightens them after the split), they
    inherit the parent's."""
    mn, mx = lrow[SMN], lrow[SMX]
    if not hp.use_monotone or hp.mono_intermediate:
        return mn, mx, mn, mx
    feat = torch.clamp(brow[BF].long(), min=0)
    sign = torch.where(brow[BCAT] > 0.5, torch.zeros_like(fc.mono[feat]),
                       fc.mono[feat])
    mid = (brow[BLO] + brow[BRO]) * 0.5
    return (torch.where(sign < 0, torch.maximum(mn, mid), mn),
            torch.where(sign > 0, torch.minimum(mx, mid), mx),
            torch.where(sign > 0, torch.maximum(mn, mid), mn),
            torch.where(sign < 0, torch.minimum(mx, mid), mx))


def apply_find_ref(h2: torch.Tensor, nleft: torch.Tensor, st: TreeState,
                   fc: FinderConsts, feature_mask: torch.Tensor,
                   hp: SplitHyperParams, max_depth: int, at: SplitAt,
                   child: Optional[ChildSearch] = None) -> None:
    """Plain version of the plain-pool entry: ``h2`` [2, F, B, 2] holds
    the left and right child's histograms.  With ``child`` the children
    search with its masks (instead of ``feature_mask``), penalties and
    draws."""
    if at.done:
        return
    leaf, right = at.leaf, at.right
    nl = nleft[0]
    st.seg[leaf, 1] = nl
    st.seg[right, 0] = at.s0 + nl
    st.seg[right, 1] = at.cnt - nl
    lrow = st.lstate[leaf]
    brow = st.best[leaf]
    pg, ph, pc = lrow[SG], lrow[SH], lrow[SC]
    lg, lh, lc = brow[BLG], brow[BLH], brow[BLC]
    lo, ro = brow[BLO], brow[BRO]
    rg, rh, rc = pg - lg, ph - lh, pc - lc
    st.nodes[at.node] = torch.stack(
        [brow[BG], calculate_leaf_output(pg, ph, hp), ph, pc])
    d_child = lrow[SDEP] + 1.0
    fnode = d_child.new_tensor(float(at.node))
    l_mn, l_mx, r_mn, r_mx = child_bounds(brow, lrow, fc, hp)
    st.lstate[[leaf, right]] = torch.stack([
        torch.stack([lg, lh, lc, d_child, fnode, l_mn, l_mx, lo]),
        torch.stack([rg, rh, rc, d_child, fnode, r_mn, r_mx, ro])])
    depth = torch.stack([d_child, d_child])
    cs = child or ChildSearch(feature_mask)
    si = find_best_split(
        h2, torch.stack([lg, rg]), torch.stack([lh, rh]),
        torch.stack([lc, rc]), fc.num_bins, fc.has_nan, fc.is_cat,
        cs.mask, allow_split(depth, max_depth), hp,
        parent_output=torch.stack([lo, ro]), monotone=fc.mono,
        mn=torch.stack([l_mn, r_mn]), mx=torch.stack([l_mx, r_mx]),
        depth=depth, penalty=fc.penalty, cegb_penalty=cs.cegb,
        rand=cs.rand, rand_subset=cs.rand_subset)
    st.best[[leaf, right]] = pack_split_info(si)


def small_is_left(nleft: torch.Tensor, cnt: int,
                  side: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Whether the left child is the smaller, bool [1]: ``nleft * 2 <=
    cnt``, or with ``side`` (``(nl_g, cnt_g)``, i32 [2]) the same test on
    the counts summed over the ranks."""
    if side is None:
        return nleft * 2 <= cnt
    return side[:1] * 2 <= side[1:]


def pool_children(h_a: torch.Tensor, h_b: torch.Tensor, nleft: torch.Tensor,
                  st: TreeState, at: SplitAt,
                  side: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The pool ops of a split: the smaller child's histogram is ``h_a``
    when ``nleft * 2 <= cnt`` (the left child is the smaller; with
    ``side``, by the global counts) and ``h_b`` otherwise, the sibling is
    parent minus child; both go to the pool (the left child in the
    parent's slot) and are returned as [2, F, B, 2] (left, right)."""
    small_left = small_is_left(nleft, at.cnt, side)
    h_small = torch.where(small_left, h_a, h_b)
    h_parent = st.pool[at.leaf]
    h_left = torch.where(small_left, h_small,
                         subtract_histogram(h_parent, h_small))
    h_right = subtract_histogram(h_parent, h_left)
    st.pool[at.leaf] = h_left
    st.pool[at.right] = h_right
    return torch.stack([h_left, h_right])


def apply_find_pool_ref(h_a: torch.Tensor, h_b: torch.Tensor,
                        nleft: torch.Tensor, st: TreeState, fc: FinderConsts,
                        feature_mask: torch.Tensor, hp: SplitHyperParams,
                        max_depth: int, at: SplitAt,
                        child: Optional[ChildSearch] = None,
                        side: Optional[torch.Tensor] = None) -> None:
    """Plain version of the pool entry: :func:`pool_children`, then
    :func:`apply_find_ref`.  The PyTorch tail of the routes whose
    search the kernel has no mode for (``ChildSearch`` and the options
    named in the module docstring)."""
    if at.done:
        return
    apply_find_ref(pool_children(h_a, h_b, nleft, st, at, side), nleft, st,
                   fc, feature_mask, hp, max_depth, at, child)


def apply_find_torch_pool(h_a: torch.Tensor, h_b: torch.Tensor,
                          nleft: torch.Tensor, st: TreeState,
                          fc: FinderConsts, feature_mask: torch.Tensor,
                          hp: SplitHyperParams, max_depth: int,
                          at: SplitAt,
                          child: Optional[ChildSearch] = None,
                          side: Optional[torch.Tensor] = None) -> None:
    """The split tail under ``LGBM_TPU_POOL_TAIL=0``: the pool ops in
    PyTorch (:func:`pool_children`), then the plain-pool entry
    :func:`apply_find` (the kernel on CUDA tensors)."""
    if at.done:
        return
    apply_find(pool_children(h_a, h_b, nleft, st, at, side), nleft, st, fc,
               feature_mask, hp, max_depth, at, child)


# the kernel's launch (csrc/apply_find.cu): one thread-block cluster of
# up to MAX_CLUSTER blocks of TAIL_THREADS threads over the features
# (the most blocks were the fastest at every shape timed, PERF.md);
# above PORTABLE_CLUSTER blocks the cluster is non-portable
TAIL_THREADS = 512
MAX_CLUSTER = 16
PORTABLE_CLUSTER = 8
# bytes of one block's shared memory kept for the kernel's static arrays
STATIC_RESERVE = 1024


class TailGeometry(NamedTuple):
    """The split tail's launch: one cluster of ``blocks`` blocks, block
    ``k`` owning features ``[k * feats, min(F, (k + 1) * feats))``;
    ``smem`` the dynamic shared bytes a block (the library's
    ``apply_find_smem_bytes``).  The wrapper passes it to the library as
    it is; the library refuses one that misses a feature or does not
    fit."""
    blocks: int
    feats: int
    smem: int

    def ranges(self, num_features: int) -> list:
        """Each block's feature range ``(start, stop)``."""
        return [(k * self.feats, min(num_features, (k + 1) * self.feats))
                for k in range(self.blocks)]


def tail_smem_bytes(feats: int, padded_bins: int) -> int:
    """Dynamic shared memory of a block of ``feats`` features: both
    children's ``[feats, B, 2]`` f32 histograms, the NaN bins' values
    (16 bytes a feature), the NaN bin and the categorical flag (8), one
    validity byte a bin."""
    return feats * (17 * padded_bins + 24)


@functools.lru_cache(maxsize=None)
def tail_geometry(num_features: int, padded_bins: int,
                  max_blocks: int = MAX_CLUSTER) -> Optional[TailGeometry]:
    """The geometry of the tail of ``num_features`` x ``padded_bins``:
    ``min(F, max_blocks)`` blocks of balanced feature ranges (fewer where
    the ranges round up); ``None`` where a block's share does not fit its
    shared memory.  ``max_blocks`` below ``MAX_CLUSTER`` is for timing
    other cluster sizes."""
    f, b = int(num_features), int(padded_bins)
    if f < 1 or b < 8 or b % 8 or not 1 <= max_blocks <= MAX_CLUSTER:
        return None
    feats = -(-f // min(f, int(max_blocks)))
    smem = tail_smem_bytes(feats, b)
    if smem > MAX_SMEM - STATIC_RESERVE:
        return None
    return TailGeometry(-(-f // feats), feats, smem)


def apply_find_supported(num_features: int, padded_bins: int) -> bool:
    """Whether the tail's features fit one cluster's shared memory
    (:func:`tail_geometry`; the counterpart of the reference's
    ``tail_supported``: a route decision, taken up front)."""
    return tail_geometry(num_features, padded_bins) is not None


# the rank of no candidate (every key NaN), as the kernel's kNone
NO_RANK = 0x7FFFFFFF


def block_winners_ref(keys: torch.Tensor, geo: TailGeometry,
                      padded_bins: int) -> tuple:
    """Each block's winner, as the kernel's blocks find it: ``keys``
    [K, F * 2B] are the candidates' selection keys in rank order (rank r
    = f * 2B + d * B + b); block k searches its features' ranks and keeps
    the largest key, ties to the smallest rank (a NaN key never wins; a
    block of NaN keys keeps ``(-inf, NO_RANK)``).  Returns (keys f32 [K,
    blocks], ranks i64 [K, blocks])."""
    k, n = keys.shape
    f = n // (2 * padded_bins)
    bq = torch.full((k, geo.blocks), float("-inf"), dtype=torch.float32)
    br = torch.full((k, geo.blocks), NO_RANK, dtype=torch.int64)
    ranks = torch.arange(n, dtype=torch.int64)
    for blk, (lo, hi) in enumerate(geo.ranges(f)):
        sl = slice(lo * 2 * padded_bins, hi * 2 * padded_bins)
        for i in range(k):
            q, r = keys[i, sl], ranks[sl]
            ok = ~torch.isnan(q)
            if bool(ok.any()):
                bq[i, blk] = q[ok].max()
                br[i, blk] = r[ok & (q == bq[i, blk])].min()
    return bq, br


def cluster_winner_ref(keys: torch.Tensor, geo: TailGeometry,
                       padded_bins: int) -> torch.Tensor:
    """Plain model of the kernel's search: :func:`block_winners_ref`,
    then block 0's merge of the blocks' winners with the same
    ``better()`` (a larger key, or an equal key of a smaller rank).
    Returns the winning rank of each of the K rows, i64 [K]."""
    bq, br = block_winners_ref(keys, geo, padded_bins)
    out = torch.empty(keys.shape[0], dtype=torch.int64)
    for i in range(keys.shape[0]):
        wq, wr = float("-inf"), NO_RANK
        for q, r in zip(bq[i].tolist(), br[i].tolist()):
            if q > wq or (q == wq and r < wr):
                wq, wr = q, r
        out[i] = wr
    return out


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("apply_find")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # the sign vector and the penalty table, then the scalars
    tail = [p, p] + [i] * 12 + [f] * 7 + [i] * 2 + [p]
    lib.apply_find_pool.argtypes = [p] * 11 + tail
    lib.apply_find_pool.restype = i
    lib.apply_find.argtypes = [p] * 9 + tail
    lib.apply_find.restype = i
    lib.apply_find_smem_bytes.argtypes = [i, i]
    lib.apply_find_smem_bytes.restype = i
    lib.apply_find_max_clusters.argtypes = [i] * 6
    lib.apply_find_max_clusters.restype = i
    return lib


def max_clusters(geo: TailGeometry, num_features: int, padded_bins: int,
                 pool: bool = True, mono: bool = False) -> int:
    """Clusters of ``geo`` the card holds at once
    (``cudaOccupancyMaxActiveClusters``; 0: the launch cannot run), of
    the unconstrained instantiation or, with ``mono``, the constrained
    one."""
    n = _lib().apply_find_max_clusters(int(pool), int(num_features),
                                       int(padded_bins), geo.blocks,
                                       geo.feats, int(mono))
    if n < 0:
        raise LightGBMError(f"apply_find occupancy query of {geo} failed "
                            f"with CUDA error {-n}")
    return n


def _check(h_a, h_b, nleft, st: TreeState, fc: FinderConsts,
           feature_mask, side=None) -> TailGeometry:
    L, f, b, _ = st.pool.shape
    dev = st.pool.device
    want = ((st.pool, torch.float32, (L, f, b, 2)),
            (h_a, torch.float32, (f, b, 2)), (h_b, torch.float32, (f, b, 2)),
            (nleft, torch.int32, (1,)),
            (st.best, torch.float32, (L, 10)),
            (st.lstate, torch.float32, (L, 8)),
            (st.nodes, torch.float32, (max(L - 1, 1), 4)),
            (st.seg, torch.int32, (L, 2)),
            (fc.masks, torch.float32, (4, f, b)),
            (fc.mono, torch.int32, (f,)),
            (fc.penalty, torch.float32, (fc.penalty.numel(),)),
            (feature_mask, torch.float32, (f,)))
    if side is not None:
        want += ((side, torch.int32, (2,)),)
    for t, dt, shape in want:
        if (t.dtype != dt or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous()):
            raise LightGBMError(f"apply_find wants contiguous {dt} "
                                f"{list(shape)} tensors on {dev}")
    if any(t.data_ptr() % 8 for t in (st.pool, h_a, h_b)):
        raise LightGBMError("apply_find reads histograms in 8-byte (g, h) "
                            "pairs: pool and histograms must be 8-byte "
                            "aligned")
    geo = tail_geometry(f, b)
    if geo is None:
        raise LightGBMError(f"apply_find of {f} features x {b} bins does "
                            f"not fit a cluster of {MAX_CLUSTER} blocks' "
                            "shared memory")
    return geo


def _scalars(at: SplitAt, max_depth: int, hp: SplitHyperParams,
             fc: FinderConsts, f: int, b: int, geo: TailGeometry) -> list:
    """The library's arguments after the state pointers: the monotone
    constants, then the scalars; the mode (``hp.use_monotone``) picks
    the instantiation."""
    if hp.use_cat_subset:
        # the kernel searches no sorted subsets: the route sends such
        # models to the PyTorch tail (routing rule tail_cat_subset)
        raise LightGBMError("the kernel split tail has no sorted-subset "
                            "categorical search; the PyTorch tail "
                            "(apply_find_pool_ref) runs it")
    if hp.use_monotone and hp.mono_intermediate:
        # routing rule tail_mono_intermediate
        raise LightGBMError("the kernel split tail has no intermediate "
                            "monotone method; the PyTorch tail "
                            "(apply_find_pool_ref) and the grower's "
                            "adjacency pass run it")
    if hp.use_cegb or hp.use_extra_trees:
        # routing rules tail_cegb, tail_extra_trees
        raise LightGBMError("the kernel split tail has no CEGB penalty and "
                            "no extra trees' draws; the PyTorch tail "
                            "(apply_find_pool_ref) runs them")
    return [fc.mono.data_ptr(), fc.penalty.data_ptr(), f, b, at.leaf,
            at.right, at.node, at.s0, at.cnt, int(at.done), geo.blocks,
            geo.feats, int(max_depth), fc.penalty.numel(), hp.lambda_l1,
            hp.lambda_l2, float(hp.min_data_in_leaf),
            hp.min_sum_hessian_in_leaf, hp.min_gain_to_split,
            hp.max_delta_step, hp.path_smooth, int(hp.use_smoothing),
            int(hp.use_monotone)]


def _state_ptrs(st: TreeState) -> list:
    return [st.best.data_ptr(), st.lstate.data_ptr(), st.nodes.data_ptr(),
            st.seg.data_ptr()]


def launch_pool(h_a: torch.Tensor, h_b: torch.Tensor, nleft: torch.Tensor,
                st: TreeState, fc: FinderConsts, feature_mask: torch.Tensor,
                hp: SplitHyperParams, max_depth: int, at: SplitAt,
                geo: TailGeometry, side: Optional[torch.Tensor] = None
                ) -> None:
    """The pool entry's launch on ``geo`` (CUDA tensors already checked;
    ``side`` the global counts or None); raises on a launch error.
    Counts nothing: :func:`apply_find_pool` counts its launches."""
    dev = st.pool.device
    _, f, b, _ = st.pool.shape
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().apply_find_pool(
            st.pool.data_ptr(), h_a.data_ptr(), h_b.data_ptr(),
            nleft.data_ptr(), None if side is None else side.data_ptr(),
            *_state_ptrs(st), fc.masks.data_ptr(),
            feature_mask.data_ptr(),
            *_scalars(at, max_depth, hp, fc, f, b, geo), stream)
    if rc != 0:
        raise LightGBMError(f"apply_find_pool kernel launch failed with "
                            f"CUDA error {rc}")


def launch_plain(h2: torch.Tensor, nleft: torch.Tensor, st: TreeState,
                 fc: FinderConsts, feature_mask: torch.Tensor,
                 hp: SplitHyperParams, max_depth: int, at: SplitAt,
                 geo: TailGeometry) -> None:
    """The plain-pool entry's launch on ``geo``, as :func:`launch_pool`."""
    dev = st.pool.device
    _, f, b, _ = st.pool.shape
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().apply_find(
            h2[0].data_ptr(), h2[1].data_ptr(), nleft.data_ptr(),
            *_state_ptrs(st), fc.masks.data_ptr(), feature_mask.data_ptr(),
            *_scalars(at, max_depth, hp, fc, f, b, geo), stream)
    if rc != 0:
        raise LightGBMError(f"apply_find kernel launch failed with CUDA "
                            f"error {rc}")


def _no_child(child: Optional[ChildSearch]) -> None:
    if child is not None:
        # routing rules tail_interaction, tail_bynode (and the others
        # that build per-child inputs)
        raise LightGBMError("the kernel split tail takes one feature mask "
                            "for both children; per-child masks, penalties "
                            "and draws run on the PyTorch tail "
                            "(apply_find_pool_ref)")


def apply_find_pool(h_a: torch.Tensor, h_b: torch.Tensor,
                    nleft: torch.Tensor, st: TreeState, fc: FinderConsts,
                    feature_mask: torch.Tensor, hp: SplitHyperParams,
                    max_depth: int, at: SplitAt,
                    child: Optional[ChildSearch] = None,
                    side: Optional[torch.Tensor] = None) -> None:
    """The split tail with the histogram pool (the main path's entry;
    ``side``: the global counts of a parallel learner's split, see the
    module docstring).  CPU tensors take :func:`apply_find_pool_ref`;
    CUDA tensors launch the kernel on :func:`tail_geometry` (and raise
    with ``child``)."""
    dev = st.pool.device
    if dev.type == "cpu":
        return apply_find_pool_ref(h_a, h_b, nleft, st, fc, feature_mask, hp,
                                   max_depth, at, child, side)
    if dev.type != "cuda":
        raise LightGBMError(f"apply_find runs on cuda or cpu, not {dev}")
    _no_child(child)
    geo = _check(h_a, h_b, nleft, st, fc, feature_mask, side)
    launch_pool(h_a, h_b, nleft, st, fc, feature_mask, hp, max_depth, at, geo,
                side)
    apply_find_pool.launches += 1
    return None


def apply_find(h2: torch.Tensor, nleft: torch.Tensor, st: TreeState,
               fc: FinderConsts, feature_mask: torch.Tensor,
               hp: SplitHyperParams, max_depth: int, at: SplitAt,
               child: Optional[ChildSearch] = None) -> None:
    """The split tail with both children's histograms given (``h2``
    [2, F, B, 2]); the pool is not touched.  CPU tensors take
    :func:`apply_find_ref`; CUDA tensors launch the kernel on
    :func:`tail_geometry` (and raise with ``child``)."""
    dev = st.pool.device
    if dev.type == "cpu":
        return apply_find_ref(h2, nleft, st, fc, feature_mask, hp, max_depth,
                              at, child)
    if dev.type != "cuda":
        raise LightGBMError(f"apply_find runs on cuda or cpu, not {dev}")
    _no_child(child)
    if not h2.is_contiguous() or h2.dim() != 4 or h2.shape[0] != 2:
        raise LightGBMError("h2 must be a contiguous [2, F, B, 2] tensor")
    geo = _check(h2[0], h2[1], nleft, st, fc, feature_mask)
    launch_plain(h2, nleft, st, fc, feature_mask, hp, max_depth, at, geo)
    apply_find.launches += 1
    return None


apply_find_pool.launches = 0
apply_find.launches = 0
