"""Leaf-wise tree growth: on the physically partitioned row matrix
(:class:`SerialGrower`) or on a row-order index (:class:`RowOrderGrower`).

Counterpart of the serial, physical branch of ``lightgbm_tpu/ops/grow.py``
(``make_grow_fn`` with ``physical_bins`` set, and the ``_PhysicalGrow``
wrapper that carries the row matrix across trees), on the route
``ops/routing.py`` decides.  The default route is the reference's:

- score-resident gradients: the rows carry their scores and objective
  constants; the first tree's rows come from ``stream_init``, and each
  tree ends with ``stream_refresh``, which adds the tree's shrunk leaf
  outputs to the scores by position, recomputes g/h in place and builds
  the next tree's root histogram (carried; tree 0's root comes from
  ``hist_comb``);
- per split, in the reference's order: the best leaf (argmax of the
  selection key) and one host read of its descriptor, then
  ``fused_split`` (partition + both children's histograms), the
  ``copyback``, and ``apply_find_pool`` (smaller child by
  ``nl * 2 <= cnt``, sibling = parent - child, both children's best
  splits, the state rows).

Slice 2's route (``LGBM_TPU_STREAM=0 LGBM_TPU_FUSED=0
LGBM_TPU_APPLY_IMPL=xla``) rewrites the rows' values from the
objective's gradients by row id and builds the root histogram per tree,
and per split runs the partition scan + copyback, the smaller child's
histogram and the PyTorch tail; each knob switches its part alone.  The
routes grow the same trees: each kernel's plain version composes slice
2's plain arithmetic in slice 2's order.  On the stream route without
the fused split (``LGBM_TPU_FUSED=0``, and the 3-phase route) each tree
ends with ``stream_refresh_plain`` and the next tree's root histogram
comes from ``hist_comb`` over ``[0, n)`` at its start (``grow.py:782``),
bitwise the histogram ``stream_refresh`` would have carried.

The 3-phase route (``LGBM_TPU_PART=3ph``, scheme ``3ph``) partitions
each split with ``partition_3ph`` instead of the scan + copyback: the
right rows keep their ascending order, so its trees equal the other
routes' only up to f32 noise (the histograms add the right child's rows
in another order).  Under ``LGBM_TPU_POOL_TAIL=0`` the kernel tail is
``apply_find_torch_pool`` (the pool ops in PyTorch, then the plain-pool
kernel), the same arithmetic as ``apply_find_pool``.

At ``LGBM_TPU_COMB_PACK=2`` (``route.pack == 2``; never with the 3ph
scheme) the rows are records (``device_data.PackedRows``) and the
record-layout kernels run in the pack=1 kernels' places (``ROW_OPS``):
``stream_init_p2`` (``init_packed_rows`` under ``LGBM_TPU_STREAM=0``),
``hist_comb_p2`` for every root the refresh does not carry and, without
the fused split, every smaller child; per split ``fused_split_p2`` and
``copyback_p2``, or without the fused split ``partition_scan_p2`` and
``copyback_p2`` (``partition_p2``, ``make_partition_p2``'s two
launches); per tree ``stream_refresh_p2``, or without the fused split
``stream_refresh_plain_p2``.  Every other reader takes
``rows.fields()``.  Each record kernel writes its pack=1 counterpart's
bits, so both packs grow the same trees bit for bit.

The loop runs on the host; the state (histogram pool, per-leaf best
splits and sums, segments) stays on the device, and each split reads
one small descriptor back (leaf, best split, segment), which the host
needs to launch the partition.  The tree's structure (child pointers,
split features and bins) is kept on the host; its float fields on the
device until the tree is finished.  A device-side loop over splits is
later work (``ROADMAP.md`` A4).

The ``row_order`` path (u16 bins at ``max_bin > 255``, or
``LGBM_TPU_PHYS=0``) keeps the bins in place and partitions an index
instead: per split a stable compaction of the leaf's segment in PyTorch
ops and the smaller child's histogram through the index
(``hist_rows``), then the route's tail.  Both growers share the host
loop, the tree state and the tree's structure.

Monotone constraints: the tail gives the children their output bounds
(the basic method, ``apply_find.child_bounds``).  Under the intermediate
method (``hp.mono_intermediate``, the PyTorch tail) the children inherit
the parent's bounds, and after each split :meth:`_Grower._mono_adjacent`
keeps every leaf's box in bin space, tightens the bounds of the leaves
face-adjacent to a new child across a monotone feature with its output
and searches the tightened leaves again from the pool
(``grow.py:2075-2150``); it reads nothing back.

The split options the kernel tail has no mode for (``GrowOptions``;
the route sends them to the PyTorch tail, ``tail=xla``) live in a
tree's :class:`_SearchPlan`, on the device (JAX ``grow.py:1266-1281``,
``:1371-1402``, ``:1464-1507``, ``:1876-1891``, ``:2009-2071``):

- interaction constraints: the features used on each leaf's path
  (``used_feat [L, F]``), a child searching the union of the sets that
  hold all of them;
- ``feature_fraction_bynode``: each node keeps the ``k`` features of
  largest uniform among those allowed;
- ``extra_trees``: one random threshold (and subset size) a feature and
  node;
- CEGB: the coupled penalty of the features no split of the tree used
  yet (``model_used [F]``) and, on the row-order path, the lazy penalty
  of each child's in-bag rows not yet paid for a feature (the booster's
  paid mask ``[F, n]``, marked at every split);
- forced splits: the schedule's first splits of every tree, computed
  on the device from the leaf's pooled histogram; where both children
  are non-empty the forced split is written into the leaf's best row
  and chosen, its flag riding the split's one descriptor read.

Under a parallel learner (``parallel/``) the grower takes a merge
object (``merge=``; None is the serial grower, its bits unchanged): the
root's sums are added over the ranks in f64 and rounded once, the root's
and each split's smaller-child histograms are merged (the data learner's
reduce-scatter leaves the rank its feature chunk: the pool is ``[L, F_r,
B, 2]``, the finder's constants and mask the chunk's), the side is the
global ``nl_g * 2 <= cnt_g`` from one allreduce of ``(nleft, cnt)`` while
the segments move by the local counts, and where the search covers a
chunk its winners (the root's, then both children's after each tail)
are shifted to global features and elected, so every rank holds the same
best rows, reads the same descriptor but its own segment, and stops at
the same split.  The unfused routes' smaller-child histogram is bounded
by the local ``cnt`` then, not ``cnt // 2 + 1``: the globally smaller
child can be the locally larger one.

The draws depend only on ``(seed, tree, node)``: node ``i``'s children
take salts ``2i + 1`` and ``2i + 2``, the root 0, so a tree's ``[2L - 1,
F]`` uniforms are drawn in one batched threefry when it starts (JAX's
``fold_in`` keys, bit for bit).
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..objective.regression import blocked_cumsum
from ..resilience import numerics
from ..utils.random import fold_in, prng_key, uniform_rows
from .apply_find import (BB, BCAT, BF, BG, SC, SDEP, SG, SH, SMN, SMX,
                         SOUT, SPAR, ChildSearch, SplitAt, TreeState,
                         allow_split, apply_find_pool, apply_find_pool_ref,
                         apply_find_torch_pool, build_finder_consts,
                         small_is_left)
from .device_data import (DeviceDataset, PackedRows, Rows, bins_i32,
                          empty_packed_like, empty_rows_like,
                          init_packed_rows, init_rows)
from .fused_split import fused_split, fused_split_p2
from .hist_kernel2 import (build_histogram_comb, build_histogram_comb_p2,
                           build_histogram_rows, build_histogram_rows_dp)
from .descriptor import members_to_words, words_to_members
from .partition_kernel import (copyback, copyback_p2, go_left, partition,
                               partition_3ph, partition_p2)
from .routing import RouteDecision, cat_bitset_fit
from .split import (SplitHyperParams, calculate_leaf_output,
                    cat_subset_member, derived_counts, find_best_split,
                    leaf_split_gain, monotone_penalty_table, pack_split_info,
                    selection_key)
from .stream_grad import (stream_init, stream_init_p2, stream_refresh,
                          stream_refresh_p2, stream_refresh_plain,
                          stream_refresh_plain_p2)


class TreeArrays(NamedTuple):
    """One grown tree in array-of-nodes form (reference tree.h:25), host
    numpy.  Child pointers use the ``~leaf`` encoding; the left child
    keeps the parent's leaf slot and the new right leaf takes index
    ``num_leaves``."""
    split_feature: np.ndarray    # i32 [L-1], inner feature index
    threshold_bin: np.ndarray    # i32
    split_gain: np.ndarray       # f32
    default_left: np.ndarray     # bool
    is_categorical: np.ndarray   # bool
    left_child: np.ndarray       # i32
    right_child: np.ndarray      # i32
    internal_value: np.ndarray   # f32
    internal_weight: np.ndarray  # f32
    internal_count: np.ndarray   # f32
    leaf_value: np.ndarray       # f32 [L], raw (shrinkage comes later)
    leaf_weight: np.ndarray      # f32
    leaf_count: np.ndarray       # f32
    num_leaves: int
    # bool [L-1, B]: the bins each categorical node sends left, under the
    # sorted-subset search (a one-hot node's is its one bin); None when
    # every categorical split is one-hot (threshold_bin is the bin)
    cat_members: Optional[np.ndarray] = None


class StageTimer:
    """Per-stage device time of a training run, off unless enabled.
    On a CUDA device each stage is bracketed by CUDA events (so it
    includes the host's enqueue gaps inside it); on the CPU by the host
    clock.  An enabled stage is also a ``stage:<name>`` range for
    ``torch.profiler``, so a profile can count the kernels each stage
    launches."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._spans: List = []

    @contextlib.contextmanager
    def stage(self, name: str, device: torch.device):
        if not self.enabled:
            yield
            return
        with torch.profiler.record_function(f"stage:{name}"):
            if device.type == "cuda":
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
                yield
                ev1.record()
                self._spans.append((name, ev0, ev1))
            else:
                t0 = time.perf_counter()
                yield
                self._spans.append((name, t0, time.perf_counter()))

    def calls_ms(self) -> Dict[str, List[float]]:
        """Milliseconds of each call of each stage, in call order."""
        out: Dict[str, List[float]] = {}
        if self._spans and isinstance(self._spans[0][1], torch.cuda.Event):
            torch.cuda.synchronize()
        for name, a, b in self._spans:
            ms = (a.elapsed_time(b) if isinstance(a, torch.cuda.Event)
                  else (b - a) * 1e3)
            out.setdefault(name, []).append(ms)
        return out

    def totals_ms(self) -> Dict[str, float]:
        """Milliseconds per stage summed over the run so far."""
        return {name: sum(v) for name, v in self.calls_ms().items()}


class _RowOps(NamedTuple):
    """The row-matrix operations of one pack: pack=1's arrays or
    pack=2's records."""
    stream_init: Callable
    init: Callable        # bins -> rows, values zero
    empty_like: Callable
    histogram: Callable   # build_histogram_comb's signature
    fused_split: Callable
    copyback: Callable
    stream_refresh: Callable
    partition: Callable       # the unfused split's scan + copyback
    refresh_plain: Callable   # the unfused stream route's refresh


ROW_OPS = {
    1: _RowOps(stream_init, init_rows, empty_rows_like, build_histogram_comb,
               fused_split, copyback, stream_refresh, partition,
               stream_refresh_plain),
    2: _RowOps(stream_init_p2, init_packed_rows, empty_packed_like,
               build_histogram_comb_p2, fused_split_p2, copyback_p2,
               stream_refresh_p2, partition_p2, stream_refresh_plain_p2),
}


class StreamSpec(NamedTuple):
    """The objective's stream-route gradient formula."""
    kind: str        # binary | l2
    sigmoid: float


class GrowOptions(NamedTuple):
    """The split options of a training that the kernel tail has no mode
    for (``models/constraints.build_grow_constraints``; the booster's
    by-node count and seeds).  Each per-feature array has one entry an
    inner feature; None or 0 where the option is off."""
    interaction_sets: Optional[np.ndarray] = None   # bool [S, F]
    cegb_coupled: Optional[np.ndarray] = None       # f32 [F]
    cegb_lazy: Optional[np.ndarray] = None          # f32 [F]
    # the forced splits' schedule: "leaf", "feature", "bin",
    # "default_left" arrays, one entry a step
    forced: Optional[dict] = None
    bynode_count: int = 0        # features a node keeps (0: no sampling)
    bynode_seed: int = 0         # feature_fraction_seed
    extra_seed: int = 6

    def per_child(self, hp: SplitHyperParams) -> bool:
        """Whether the children search with inputs of their own."""
        return (self.interaction_sets is not None
                or self.cegb_coupled is not None
                or self.cegb_lazy is not None or self.bynode_count > 0
                or hp.use_extra_trees)


class _SearchPlan:
    """One tree's per-node search inputs on the device (see the module
    docstring).  ``children`` builds a split's :class:`ChildSearch`
    with no host read: the leaf, the feature and the split's index are
    the host's already."""

    def __init__(self, g: "_Grower", feature_mask: torch.Tensor,
                 tree_seed: int, lazy_u0: Optional[torch.Tensor] = None):
        opt, hp, dev = g.opts, g.hp, g.dd.device
        f32 = torch.float32
        self.fmask = feature_mask
        self.ic = g._ic
        self.coupled, self.lazy = g._coupled, g._lazy
        f, L = g.dd.num_features, g.L
        self.k_node = min(opt.bynode_count, f)
        # the root may use only features some interaction set holds
        self.mask0 = (feature_mask * self.ic.amax(dim=0)
                      if self.ic is not None else feature_mask)
        self.used_feat = (torch.zeros((L, f), dtype=f32, device=dev)
                          if self.ic is not None else None)
        self.model_used = (torch.zeros(f, dtype=f32, device=dev)
                           if self.coupled is not None else None)
        self.cegb = self.coupled         # the coupled penalty of the tree
        salts = torch.arange(2 * L - 1, dtype=torch.int64, device=dev)

        def draws(seed):
            keys = fold_in(fold_in(prng_key(seed), tree_seed, dev), salts)
            return keys, uniform_rows(keys, f, dev)
        self.u_node = (draws(opt.bynode_seed)[1] if opt.bynode_count > 0
                       else None)
        self.u_rand = self.u_sub = None
        if hp.use_extra_trees:
            keys, self.u_rand = draws(opt.extra_seed)
            if hp.use_cat_subset:
                self.u_sub = uniform_rows(fold_in(keys, 1), f, dev)
        pen0 = self.coupled
        if lazy_u0 is not None:
            lz = self.lazy * lazy_u0
            pen0 = lz if pen0 is None else pen0 + lz
        self.root = ChildSearch(self.node_mask(self.mask0[None], [0]),
                                pen0, self._u(self.u_rand, [0]),
                                self._u(self.u_sub, [0]))
        # the intermediate monotone method searches leaves again: each
        # leaf's mask and salt
        self.leaf_mask = self.leaf_salt = None
        if hp.use_monotone and hp.mono_intermediate:
            self.leaf_mask = self.root.mask.expand(L, f).clone()
            self.leaf_salt = torch.zeros(L, dtype=torch.int64, device=dev)

    @staticmethod
    def _u(u: Optional[torch.Tensor], salts) -> Optional[torch.Tensor]:
        return None if u is None else u[salts]

    def node_mask(self, base: torch.Tensor, salts) -> torch.Tensor:
        """By-node sampling (ColSampler feature_fraction_bynode,
        col_sampler.hpp) of the ``[R, F]`` allowed masks ``base`` at the
        nodes ``salts``: each keeps the ``k`` allowed features of largest
        uniform, ties to the smaller feature (``lax.top_k``'s order)."""
        if self.u_node is None:
            return base
        r = torch.where(base > 0, self.u_node[salts],
                        torch.full_like(base, float("-inf")))
        top = torch.sort(r, dim=1, descending=True, stable=True).indices
        keep = torch.zeros_like(base).scatter_(
            1, top[:, :self.k_node], torch.ones_like(base))
        return base * keep

    def children(self, leaf: int, right: int, i: int, feat: int,
                 u2: Optional[torch.Tensor] = None) -> ChildSearch:
        """The children's inputs of split ``i`` of ``leaf`` on ``feat``
        (``u2`` f32 [F, 2]: each child's unpaid in-bag rows under lazy
        CEGB), and the tree state they carry forward."""
        base = self.fmask
        if self.ic is not None:
            used = self.used_feat[leaf].clone()
            used[feat] = 1.0
            self.used_feat[[leaf, right]] = used
            holds = (self.ic >= used[None]).all(dim=1)
            allowed = (self.ic * holds[:, None].to(self.ic.dtype)).amax(dim=0)
            base = base * allowed
        if self.model_used is not None:
            self.model_used[feat] = 1.0
            self.cegb = self.coupled * (1.0 - self.model_used)
        pen = self.cegb
        if u2 is not None:
            lz = torch.stack([self.lazy * u2[:, 0], self.lazy * u2[:, 1]])
            pen = lz if pen is None else pen[None] + lz
        salts = [2 * i + 1, 2 * i + 2]
        mask = self.node_mask(base[None].expand(2, -1), salts)
        if self.leaf_mask is not None:
            self.leaf_mask[[leaf, right]] = mask
            self.leaf_salt[[leaf, right]] = torch.tensor(
                salts, device=self.leaf_salt.device)
        return ChildSearch(mask, pen, self._u(self.u_rand, salts),
                           self._u(self.u_sub, salts))


class _TreeBuilder:
    """The host side of a growing tree's structure (reference
    Tree::Split, tree.h:541): child pointers, split features and bins."""

    def __init__(self, L: int):
        ni = L - 1
        # each node's membership words as read (i32), where the
        # descriptor carried them
        self.words: Dict[int, List[int]] = {}
        self.split_feature = np.zeros(ni, np.int32)
        self.threshold_bin = np.zeros(ni, np.int32)
        self.default_left = np.zeros(ni, bool)
        self.is_cat = np.zeros(ni, bool)
        self.left_child = np.zeros(ni, np.int32)
        self.right_child = np.zeros(ni, np.int32)
        self.leaf_parent = {0: (-1, 0)}
        self.num_leaves = 1

    def split(self, leaf: int, right: int, node: int, feat: int, sbin: int,
              dl: int, cat: int, words=()) -> None:
        if words:
            self.words[node] = list(words)
        p, side = self.leaf_parent[leaf]
        if p >= 0:
            (self.left_child if side == 0 else self.right_child)[p] = node
        self.left_child[node], self.right_child[node] = ~leaf, ~right
        self.split_feature[node], self.threshold_bin[node] = feat, sbin
        self.default_left[node], self.is_cat[node] = bool(dl), bool(cat)
        self.leaf_parent[leaf] = (node, 0)
        self.leaf_parent[right] = (node, 1)
        self.num_leaves += 1

    def members(self, padded_bins: int) -> np.ndarray:
        """bool [L-1, B]: bit ``b % 32`` of node word ``b // 32``, the
        bins each node sends left (all false for numerical nodes)."""
        out = np.zeros((len(self.split_feature), padded_bins), bool)
        for node, words in self.words.items():
            out[node] = words_to_members(words, padded_bins)
        return out


class _Grower:
    """What both growers share: the tree state of a one-leaf tree, the
    host loop over splits (best leaf, one descriptor read, the route's
    partition + histogram step, the split tail, the tree's structure)
    and every row's leaf at the end."""

    def __init__(self, hp: SplitHyperParams, *, num_leaves: int,
                 max_depth: int, dd: DeviceDataset, route: RouteDecision,
                 timer: Optional[StageTimer] = None,
                 monotone: Optional[np.ndarray] = None,
                 options: Optional[GrowOptions] = None, merge=None):
        self.hp = hp
        self.L = int(num_leaves)
        self.max_depth = int(max_depth)
        self.dd = dd
        self.route = route
        self.timer = timer or StageTimer()
        self.opts = options or GrowOptions()
        opt = self.opts
        if route.tail == "kernel" and opt.per_child(hp):
            raise ValueError("per-child search inputs (interaction "
                             "constraints, CEGB penalties, by-node sampling, "
                             "extra trees) run on the PyTorch tail")
        # monotone: the features' signs and the depth penalty by depth
        # (depths 0 .. L - 1), both on the device
        mono = pen = None
        if hp.use_monotone:
            if monotone is None or len(monotone) != dd.num_features:
                raise ValueError("hp.use_monotone needs one monotone sign "
                                 "a feature")
            mono = torch.as_tensor(np.asarray(monotone, np.int32),
                                   device=dd.device)
            pen = torch.as_tensor(monotone_penalty_table(
                hp.monotone_penalty, self.L + 1), device=dd.device)
        # a parallel learner's merge points (None: serial); the search
        # covers its chunk [f0, f1) of the features, every one without
        self.merge = merge
        chunk = None if merge is None else merge.chunk
        self._chunk = (0, dd.num_features) if chunk is None else chunk
        f0, f1 = self._chunk
        self._meta = tuple(a[f0:f1].contiguous()
                           for a in (dd.num_bins, dd.has_nan, dd.is_cat))
        if mono is not None and chunk is not None:
            mono = mono[f0:f1].contiguous()
        self.finder = build_finder_consts(*self._meta, dd.padded_bins,
                                          monotone=mono, penalty=pen)
        self._num_bins = dd.num_bins.cpu().numpy()
        self._has_nan = dd.has_nan.cpu().numpy()
        self._bins = torch.arange(dd.padded_bins, device=dd.device)
        dev_f32 = lambda a: (None if a is None else  # noqa: E731
                             torch.as_tensor(np.asarray(a, np.float32),
                                             device=dd.device))
        self._ic = dev_f32(opt.interaction_sets)
        self._coupled = dev_f32(opt.cegb_coupled)
        self._lazy = dev_f32(opt.cegb_lazy)
        fs = opt.forced
        self._forced = ([] if fs is None else list(zip(
            (int(v) for v in fs["leaf"]), (int(v) for v in fs["feature"]),
            (int(v) for v in fs["bin"]),
            (bool(v) for v in fs["default_left"]))))
        # lazy CEGB: each child's unpaid in-bag rows of the split under
        # way, f32 [F, 2] (set by the row-order grower's split step)
        self._u2: Optional[torch.Tensor] = None
        # host reads of the split descriptor over the run
        self.host_reads = 0
        # set to a list to record every split descriptor read
        # (leaf, gain, feature, bin, default_left, is_cat, s0, cnt, then
        # the forced flag on a forced step, then the membership words)
        self.trace: Optional[list] = None

    def plan(self, feature_mask: torch.Tensor, tree_seed: int = 0,
             lazy_u0: Optional[torch.Tensor] = None) -> _SearchPlan:
        """The tree's per-node search inputs (``tree_seed``: the salt of
        its draws, ``iteration * K + class``; ``lazy_u0`` f32 [F]: the
        root's unpaid in-bag rows under lazy CEGB)."""
        return _SearchPlan(self, feature_mask, tree_seed, lazy_u0)

    def _fmask(self, fmask: torch.Tensor) -> torch.Tensor:
        """A feature mask as the search reads it: the chunk's part."""
        f0, f1 = self._chunk
        return fmask if self.merge is None else fmask[..., f0:f1].contiguous()

    def _elect(self, rows: torch.Tensor) -> torch.Tensor:
        """Best-split rows of the chunk's search made global: the
        feature shifted by the chunk's start, then elected over the
        ranks (as they are where the search covers every feature)."""
        if self.merge is None or self.merge.chunk is None:
            return rows
        rows = rows.clone()
        rows[:, BF] += float(self._chunk[0])
        return self.merge.elect(rows)

    def _init_state(self, sums: torch.Tensor, root_hist: torch.Tensor,
                    plan: _SearchPlan) -> TreeState:
        """The device state of a tree that is one leaf: the root's sums
        ``(g, h, count)`` (f64 [3], rounded once here: the CPU's and the
        card's reduction orders then give the same f32; a merge adds the
        ranks' f64 sums first), its histogram in the pool and its best
        split."""
        dd, hp, L = self.dd, self.hp, self.L
        dev, f32 = dd.device, torch.float32
        sums = sums.to(f32) if self.merge is None else self.merge.sums(sums)
        sg0, sh0, c0 = sums.unbind()
        root_out = calculate_leaf_output(sg0, sh0, hp)
        depth0 = torch.zeros(1, dtype=f32, device=dev)
        fc, rs = self.finder, plan.root
        search_hist, mask = root_hist, self._fmask(rs.mask)
        if self.merge is not None:
            search_hist, mask = self.merge.root_search(root_hist, mask, c0)
        si0 = find_best_split(
            search_hist[None], sg0[None], sh0[None], c0[None], *self._meta,
            mask, allow_split(depth0, self.max_depth), hp,
            parent_output=root_out[None], monotone=fc.mono,
            mn=torch.full_like(depth0, float("-inf")),
            mx=torch.full_like(depth0, float("inf")), depth=depth0,
            penalty=fc.penalty, cegb_penalty=rs.cegb, rand=rs.rand,
            rand_subset=rs.rand_subset)
        pool = torch.zeros((L,) + tuple(root_hist.shape), dtype=f32,
                           device=dev)
        pool[0] = root_hist
        best = torch.full((L, 10), float("-inf"), dtype=f32, device=dev)
        best[:, BG + 1:] = 0.0
        best[0] = self._elect(pack_split_info(si0))[0]
        lstate = torch.zeros((L, 8), dtype=f32, device=dev)
        lstate[0] = torch.stack([
            sg0, sh0, c0, sg0.new_tensor(0.0), sg0.new_tensor(-1.0),
            sg0.new_tensor(float("-inf")), sg0.new_tensor(float("inf")),
            root_out])
        lstate[1:, SPAR] = -1.0
        lstate[1:, SMN] = float("-inf")
        lstate[1:, SMX] = float("inf")
        nodes = torch.zeros((max(L - 1, 1), 4), dtype=f32, device=dev)
        seg = torch.zeros((L, 2), dtype=torch.int32, device=dev)
        seg[0, 1] = dd.num_data
        return TreeState(pool, best, lstate, nodes, seg)

    def _split_step(self, sel: tuple, nleft: torch.Tensor):
        """Partition the leaf's segment ``sel = (s0, cnt, feature, bin,
        default_left, is_cat, nan_bin)`` (then a spare slot and the
        membership words under the sorted-subset search), set ``nleft``,
        and return the children's histograms ``(h_a, h_b)`` as the tail
        takes them, and the split's global side (None without a merge,
        or where every rank holds every row)."""
        raise NotImplementedError

    def _max_rows(self, cnt: int) -> int:
        """The bound on the smaller child's rows in a segment of ``cnt``
        (a merge's bound where the child is the globally smaller one)."""
        return cnt // 2 + 1 if self.merge is None else self.merge.max_rows(cnt)

    def _winner_words(self, st: TreeState, leaf_t: torch.Tensor
                      ) -> torch.Tensor:
        """The membership words of leaf ``leaf_t``'s best split, i32
        ``[ceil(B / 32)]`` on the device (``grow.py:1511-1546``): a subset
        winner (``threshold_bin = B * (1 + dir) + k - 1``) takes the
        finder's own ranking of the leaf's pooled histogram row, with the
        row counts derived from the leaf's ``(count, sum_h)``; a one-hot
        winner its one bin; a numerical winner none."""
        b, hp = self.dd.padded_bins, self.hp
        brow, lrow = st.best[leaf_t], st.lstate[leaf_t]
        feat, sbin = brow[BF].long(), brow[BB].long()
        hrow = st.pool[leaf_t, feat]                           # [B, 2]
        hc = derived_counts(hrow[:, 1], lrow[SC], lrow[SH])
        subset = cat_subset_member(
            hrow[:, 0], hrow[:, 1], hc, self.dd.num_bins[feat], sbin % b + 1,
            torch.clamp(sbin // b - 1, 0, 1), hp)
        member = (torch.where(sbin >= b, subset, self._bins == sbin)
                  & (brow[BCAT] > 0.5))
        return members_to_words(member[None])[0]

    def _forced_step(self, st: TreeState, i: int) -> torch.Tensor:
        """Step ``i`` of the forced splits' schedule
        (serial_tree_learner.cpp:459 ForceSplits; JAX ``grow.py:1464-1484``,
        ``:1876-1891``): the split of its leaf at its feature and bin, from
        the leaf's pooled histogram (the bin's prefix sums in XLA:CPU's
        order, the NaN bin's added where it goes left), with counts
        derived from the leaf's.  Where both children are non-empty it
        overwrites the leaf's best row (numerical, its outputs, and the
        unconstrained gain the node records).  Returns that validity, bool
        [1], on the device."""
        hp = self.hp
        leaf, feat, sbin, dl = self._forced[i]
        row = st.pool[leaf, feat]                              # [B, 2]
        cum = torch.stack([blocked_cumsum(row[:, 0]),
                           blocked_cumsum(row[:, 1])])         # [2, B]
        nanb = max(int(self._num_bins[feat]) - 1, 0)
        nan_gh = (row[nanb] if self._has_nan[feat]
                  else torch.zeros_like(row[nanb]))
        sums = cum[:, sbin] + (nan_gh if dl else torch.zeros_like(nan_gh))
        lg, lh = sums[0], sums[1]
        lrow = st.lstate[leaf]
        pg, ph, pc = lrow[SG], lrow[SH], lrow[SC]
        lc = derived_counts(lh, pc, ph)
        valid = (lc > 0) & (pc - lc > 0)
        p_out, mn, mx = lrow[SOUT], lrow[SMN], lrow[SMX]
        lo = calculate_leaf_output(lg, lh, hp, lc, p_out, mn, mx)
        ro = calculate_leaf_output(pg - lg, ph - lh, hp, pc - lc, p_out, mn,
                                   mx)
        gain = (leaf_split_gain(lg, lh, hp)
                + leaf_split_gain(pg - lg, ph - lh, hp)
                - leaf_split_gain(pg, ph, hp))
        c = lambda v: lg.new_tensor(float(v))  # noqa: E731
        frow = torch.stack([gain, c(feat), c(sbin), c(dl), c(0.0), lg, lh,
                            lc, lo, ro])
        st.best[leaf] = torch.where(valid, frow, st.best[leaf])
        return valid[None]

    def _grow(self, st: TreeState, plan: _SearchPlan) -> _TreeBuilder:
        """The host loop over splits, until the tree has L leaves or no
        leaf has a positive gain (a valid forced split is taken
        whatever its gain)."""
        dev, stage = self.dd.device, self.timer.stage
        route = self.route
        tail = ((apply_find_pool if route.pool_tail else apply_find_torch_pool)
                if route.tail == "kernel" else apply_find_pool_ref)
        if self.merge is not None and self.merge.tail is not None:
            tail = self.merge.tail
        fmask = self._fmask(plan.fmask)
        tb = _TreeBuilder(self.L)
        nleft = torch.zeros(1, dtype=torch.int32, device=dev)
        subset = self.hp.use_cat_subset
        per_child = self.opts.per_child(self.hp)
        boxes = (self._root_boxes()
                 if self.hp.use_monotone and self.hp.mono_intermediate
                 else None)
        n_forced = len(self._forced)
        for i in range(self.L - 1):
            with stage("split_tail", dev):
                leaf_t = torch.argmax(selection_key(st.best[:, BG]))
                if i < n_forced:
                    forced_t = self._forced_step(st, i)
                    leaf_t = torch.where(forced_t[0], self._forced[i][0],
                                         leaf_t)
                parts = [leaf_t[None].double(),
                         st.best[leaf_t, :BCAT + 1].double(),
                         st.seg[leaf_t].double()]
                if i < n_forced:
                    parts.append(forced_t.double())
                if subset:
                    # the words ride the same read, as integers (an f32
                    # word above 2^24 would lose bits)
                    parts.append(self._winner_words(st, leaf_t).double())
                desc = torch.cat(parts).tolist()
            self.host_reads += 1
            if self.trace is not None:
                self.trace.append(desc)
            leaf, gain, feat, sbin, dl, cat, s0, cnt = (
                int(desc[0]), desc[1], int(desc[2]), int(desc[3]),
                int(desc[4] > 0.5), int(desc[5] > 0.5), int(desc[6]),
                int(desc[7]))
            forced = i < n_forced and desc[8] > 0.5
            words = tuple(int(w) for w in desc[8 + (i < n_forced):])
            if gain <= 0.0 and not forced:
                break
            node, right = i, tb.num_leaves
            nanb = (int(self._num_bins[feat]) - 1 if self._has_nan[feat]
                    else -1)
            sel = (s0, cnt, feat, sbin, dl, cat, nanb) + (
                (0,) + words if subset else ())
            h_a, h_b, side = self._split_step(sel, nleft)
            with stage("split_tail", dev):
                child = (plan.children(leaf, right, i, feat, self._u2)
                         if per_child else None)
                kw = {} if side is None else {"side": side}
                tail(h_a, h_b, nleft, st, self.finder, fmask, self.hp,
                     self.max_depth, SplitAt(leaf, right, node, s0, cnt),
                     child, **kw)
                if self.merge is not None and self.merge.chunk is not None:
                    two = [leaf, right]
                    st.best[two] = self._elect(st.best[two])
                if boxes is not None:
                    self._mono_adjacent(st, boxes, leaf, right, feat, sbin,
                                        cat, plan)
            tb.split(leaf, right, node, feat, sbin, dl, cat, words)
        return tb

    def _root_boxes(self) -> torch.Tensor:
        """Every leaf's box in bin space, f32 [L, 2, F] (low, high
        bins): the whole range, ``[0, num_bins - 1]``, for each."""
        dd = self.dd
        hi = torch.clamp(dd.num_bins - 1, min=0).to(torch.float32)
        return torch.stack([torch.zeros_like(hi), hi])[None].repeat(
            self.L, 1, 1)

    def _mono_adjacent(self, st: TreeState, boxes: torch.Tensor, leaf: int,
                       right: int, feat: int, sbin: int, cat: int,
                       plan: _SearchPlan) -> None:
        """The intermediate method after a split of ``leaf`` into
        ``leaf`` and ``right`` (``IntermediateLeafConstraints``,
        monotone_constraints.hpp:514, as the JAX package re-expresses it
        in boxes, ``grow.py:2075-2150``): the children's boxes (a
        numerical split cuts ``feat`` at ``sbin``); each live leaf whose
        box is disjoint from a child's in exactly one feature, touches it
        there, and that feature is monotone takes the child's output as
        its lower or upper bound, by the sign and the side; the leaves
        whose bounds tightened search their best split again from the
        pool, in one batched search, each with its own mask and draws and
        the tree's current coupled penalty."""
        live = right + 1
        blo, bhi = boxes[:live, 0], boxes[:live, 1]           # [live, F]
        blo[right] = blo[leaf]
        bhi[right] = bhi[leaf]
        if not cat:
            bhi[leaf, feat] = torch.clamp(bhi[leaf, feat], max=float(sbin))
            blo[right, feat] = torch.clamp(blo[right, feat],
                                           min=float(sbin) + 1.0)
        sign = self.finder.mono.to(torch.float32)[None]        # [1, F]
        ls = st.lstate[:live]
        mn0, mx0 = ls[:, SMN].clone(), ls[:, SMX].clone()

        def update(x, mn_c, mx_c):
            xlo, xhi, out = blo[x], bhi[x], ls[x, SOUT]
            disj = (blo > xhi + 0.5) | (bhi < xlo - 0.5)
            above = torch.abs(blo - (xhi + 1.0)) < 0.5
            below = torch.abs(bhi - (xlo - 1.0)) < 0.5
            contact = (above | below) & disj & (sign != 0.0)
            one = ((disj.sum(dim=1) == 1) & (contact.sum(dim=1) == 1))
            m_at = torch.where(contact, sign, 0.0).sum(dim=1)
            is_ab = torch.where(contact, above.to(torch.float32),
                                0.0).sum(dim=1) > 0.5
            upd_min = one & (((m_at > 0) & is_ab) | ((m_at < 0) & ~is_ab))
            upd_max = one & (((m_at > 0) & ~is_ab) | ((m_at < 0) & is_ab))
            return (torch.where(upd_min, torch.maximum(mn_c, out), mn_c),
                    torch.where(upd_max, torch.minimum(mx_c, out), mx_c))

        mn_c, mx_c = update(leaf, mn0, mx0)
        mn_c, mx_c = update(right, mn_c, mx_c)
        changed = (mn_c > mn0) | (mx_c < mx0)
        ls[:, SMN] = torch.where(changed, mn_c, mn0)
        ls[:, SMX] = torch.where(changed, mx_c, mx0)
        dd, fc = self.dd, self.finder
        salts = plan.leaf_salt[:live]
        si = find_best_split(
            st.pool[:live], ls[:, SG], ls[:, SH], ls[:, SC], dd.num_bins,
            dd.has_nan, dd.is_cat, plan.leaf_mask[:live],
            allow_split(ls[:, SDEP], self.max_depth), self.hp,
            parent_output=ls[:, SOUT], monotone=fc.mono, mn=ls[:, SMN],
            mx=ls[:, SMX], depth=ls[:, SDEP], penalty=fc.penalty,
            cegb_penalty=plan.cegb, rand=plan._u(plan.u_rand, salts),
            rand_subset=plan._u(plan.u_sub, salts))
        st.best[:live] = torch.where(changed[:, None], pack_split_info(si),
                                     st.best[:live])

    def _finish(self, st: TreeState, tb: _TreeBuilder, rid: torch.Tensor):
        """``(TreeArrays, leaf_id, leaf_value, leaf_of_pos)``: every
        position's leaf from the final segments (positions tile [0, n)),
        every row's through ``rid`` (the row at each position)."""
        dd, L, n = self.dd, self.L, self.dd.num_data
        dev = dd.device
        ni = L - 1
        with self.timer.stage("split_tail", dev):
            order = torch.argsort(st.seg[:, 0], stable=True)
            leaf_of_pos = torch.repeat_interleave(
                order, st.seg[order, 1].long(), output_size=n)
            leaf_id = torch.empty(n, dtype=torch.int64, device=dev)
            leaf_id[rid.long()] = leaf_of_pos
            live = torch.arange(L, device=dev) < tb.num_leaves
            leaf_value = torch.where(live, st.lstate[:, SOUT],
                                     torch.zeros((), dtype=torch.float32,
                                                 device=dev))
            host = torch.cat([st.nodes.reshape(-1), st.lstate[:, SH],
                              st.lstate[:, SC], leaf_value]).cpu().numpy()
        nf = st.nodes.numel()
        nodes_h = host[:nf].reshape(-1, 4)[:ni]
        ta = TreeArrays(
            split_feature=tb.split_feature, threshold_bin=tb.threshold_bin,
            split_gain=nodes_h[:, 0].copy(), default_left=tb.default_left,
            is_categorical=tb.is_cat, left_child=tb.left_child,
            right_child=tb.right_child, internal_value=nodes_h[:, 1].copy(),
            internal_weight=nodes_h[:, 2].copy(),
            internal_count=nodes_h[:, 3].copy(),
            leaf_value=host[nf + 2 * L:nf + 3 * L].copy(),
            leaf_weight=host[nf:nf + L].copy(),
            leaf_count=host[nf + L:nf + 2 * L].copy(),
            num_leaves=tb.num_leaves,
            cat_members=(tb.members(dd.padded_bins)
                         if self.hp.use_cat_subset else None))
        return ta, leaf_id, leaf_value, leaf_of_pos


class SerialGrower(_Grower):
    """Grows one tree per call from the row matrix it carries across
    calls (``_PhysicalGrow``): the rows stay in the previous tree's
    permutation.  On the stream route they carry their scores, and with
    the fused split the root histogram is carried too."""

    def __init__(self, hp: SplitHyperParams, *, num_leaves: int,
                 max_depth: int, dd: DeviceDataset, route: RouteDecision,
                 stream: Optional[StreamSpec] = None,
                 timer: Optional[StageTimer] = None,
                 monotone: Optional[np.ndarray] = None,
                 options: Optional[GrowOptions] = None, merge=None):
        super().__init__(hp, num_leaves=num_leaves, max_depth=max_depth,
                         dd=dd, route=route, timer=timer, monotone=monotone,
                         options=options, merge=merge)
        if not route.physical:
            raise ValueError("the row_order path grows with RowOrderGrower")
        if merge is not None and (route.stream or merge.hist_chunk):
            raise ValueError("a parallel learner grows the physical path "
                             "without the stream, over every feature's "
                             "histogram")
        if self.opts.cegb_lazy is not None:
            raise ValueError("cegb_lazy: the per-(feature, row) paid mask "
                             "is not plumbed through the partition kernels; "
                             "lazy CEGB grows on the row_order path")
        if hp.use_cat_subset and not cat_bitset_fit(dd.padded_bins):
            raise ValueError(
                f"cat_overwide: the membership words of {dd.padded_bins} "
                "bins exceed the split descriptor's 8; such models grow on "
                "the row_order path")
        if route.stream and stream is None:
            raise ValueError("the stream route needs the objective's "
                             "StreamSpec")
        self.stream = stream
        self.ops = ROW_OPS[route.pack]
        # Rows at pack=1, PackedRows at pack=2; rows.fields() is Rows
        self.rows: Optional[Rows | PackedRows] = None
        self.scratch: Optional[Rows | PackedRows] = None
        # stream route: () -> (score, validity, consts) of every row,
        # read when the row matrix is (re)built; the carried root
        self._stream_aux: Optional[Callable] = None
        self._root_hist: Optional[torch.Tensor] = None

    def set_stream_aux(self, fn: Callable) -> None:
        """Stream route: ``fn() -> (score [n], validity [n], consts [n,
        2])`` on the device, read once when the row matrix is built."""
        self._stream_aux = fn

    def reset_stream(self) -> None:
        """Drop the carried rows and root histogram; the next call
        rebuilds them from fresh scores (after anything that changes the
        booster's scores behind the rows' back)."""
        self.rows = self.scratch = self._root_hist = None

    def reanchor_inplace(self) -> bool:
        """Stream route, ``LGBM_TPU_CKPT_AT_REFRESH=1`` (JAX
        ``reanchor_inplace``, ``grow.py:2536-2560``): put the carried rows
        back in original row order without dropping them: their bins
        scattered back by their row ids (plain PyTorch), then the stream
        init over them and the booster's scores, the same bits a process
        resuming from the snapshot builds.  The carried root histogram
        goes (its sums follow the row order).  False off the stream route
        or before the first tree, where the caller resets instead."""
        if not self.route.stream or self.rows is None:
            return False
        fields = self.rows.fields()
        bins = torch.empty_like(self.dd.bins)
        bins[fields.rid.long()] = fields.bins
        score, valid, consts = self._stream_aux()
        self.rows = self.ops.stream_init(
            bins, score.contiguous(), valid.contiguous(), consts.contiguous(),
            kind=self.stream.kind, sigmoid=self.stream.sigmoid)
        self.scratch = self.ops.empty_like(self.rows)
        self._root_hist = None
        return True

    def _init_rows(self) -> None:
        dd = self.dd
        if self.route.stream:
            if self._stream_aux is None:
                raise RuntimeError("the stream route needs set_stream_aux "
                                   "before training")
            score, valid, consts = self._stream_aux()
            self.rows = self.ops.stream_init(
                dd.bins, score.contiguous(), valid.contiguous(),
                consts.contiguous(), kind=self.stream.kind,
                sigmoid=self.stream.sigmoid)
        else:
            self.rows = self.ops.init(dd.bins)
        self.scratch = self.ops.empty_like(self.rows)

    def _root_histogram(self, rows) -> torch.Tensor:
        n = self.dd.num_data
        rng = torch.tensor([0, 0, n], dtype=torch.int32,
                           device=self.dd.device)
        return self.ops.histogram(rows, rng, padded_bins=self.dd.padded_bins,
                                  max_rows=n)

    def init_tree_state(self, rows: Rows, root_hist: torch.Tensor,
                        feature_mask: torch.Tensor,
                        plan: Optional[_SearchPlan] = None) -> TreeState:
        """The one-leaf tree state of ``rows``: the root's sums from the
        rows' (g*w, h*w, w) values; the root searches ``plan``'s inputs
        (tree 0's plan of ``feature_mask`` when None)."""
        return self._init_state(rows.vals.double().sum(dim=0), root_hist,
                                plan or self.plan(feature_mask))

    def _split_step(self, sel: tuple, nleft: torch.Tensor):
        rows, B = self.rows, self.dd.padded_bins
        dev, stage = self.dd.device, self.timer.stage
        s0, cnt = sel[0], sel[1]
        m = self.merge
        if self.route.fused:
            with stage("fused_split", dev):
                h_pair = self.ops.fused_split(rows, self.scratch, sel, nleft,
                                              padded_bins=B)
                self.ops.copyback(rows, self.scratch, s0, cnt)
            if m is None:
                return h_pair[0], h_pair[1], None
            side = m.counts(nleft, cnt)
            h = m.hist(torch.where(small_is_left(nleft, cnt, side),
                                   h_pair[0], h_pair[1]))
            return h, h, side
        with stage("partition", dev):
            part = (partition_3ph if self.route.scheme == "3ph"
                    else self.ops.partition)
            part(rows, self.scratch, sel, nleft)
        side = None if m is None else m.counts(nleft, cnt)
        with stage("histogram", dev):
            small_left = small_is_left(nleft, cnt, side)
            child_start = torch.where(small_left, s0, s0 + nleft)
            child_cnt = torch.where(small_left, nleft, cnt - nleft)
            rng = torch.cat([child_start, torch.zeros_like(nleft),
                             child_cnt])
            h = self.ops.histogram(rows, rng, padded_bins=B,
                                   max_rows=self._max_rows(cnt))
        if m is not None:
            h = m.hist(h)
        return h, h, side

    def __call__(self, grad: Optional[torch.Tensor],
                 hess: Optional[torch.Tensor],
                 inbag: Optional[torch.Tensor], feature_mask: torch.Tensor,
                 rate: float = 0.0, tree_seed: int = 0,
                 paid: Optional[torch.Tensor] = None):
        """Grow one tree.  ``grad``, ``hess`` and ``inbag`` are the
        objective's [n] values on slice 2's route (unused, may be None,
        on the stream route, where ``rate`` is the shrinkage the tree's
        outputs enter the scores with); ``tree_seed`` salts the tree's
        draws; ``paid`` is lazy CEGB's, which this path does not grow.
        Returns ``(TreeArrays, leaf_id, leaf_value)``: host arrays of the
        tree, the [n] leaf of every row in original order and the [L]
        leaf outputs, both on the device."""
        dd, route = self.dd, self.route
        dev, B = dd.device, dd.padded_bins
        stage = self.timer.stage
        if self.rows is None:
            with stage("stream_init" if route.stream else "gradients", dev):
                self._init_rows()
        rows = self.rows
        fields = rows.fields()
        if route.stream and route.fused:
            if self._root_hist is None:
                with stage("histogram", dev):
                    self._root_hist = self._root_histogram(rows)
            root_hist = self._root_hist
        elif route.stream:
            with stage("histogram", dev):
                root_hist = self._root_histogram(rows)
        else:
            with stage("gradients", dev):
                gv = torch.stack([grad * inbag, hess * inbag, inbag], dim=1)
                fields.vals.copy_(gv[fields.rid.long()])
            with stage("histogram", dev):
                root_hist = self._root_histogram(rows)
        if self.merge is not None:
            root_hist = self.merge.hist(root_hist)
        with stage("split_tail", dev):
            plan = self.plan(feature_mask, tree_seed)
            st = self.init_tree_state(fields, root_hist, feature_mask, plan)
        tb = self._grow(st, plan)
        ta, leaf_id, leaf_value, leaf_of_pos = self._finish(st, tb,
                                                            fields.rid)
        if route.stream and tb.num_leaves > 1:
            # the next tree's rows: every position's score gains this
            # tree's shrunk output of the leaf owning it (the booster's
            # score update, rate * leaf_value, in the same f32 ops), g/h
            # follow, and with the fused split the pass builds the next
            # root histogram
            with stage("stream_refresh", dev):
                rate_t = torch.tensor(rate, dtype=torch.float32, device=dev)
                lv = (rate_t * leaf_value)[leaf_of_pos]
                kw = dict(kind=self.stream.kind, sigmoid=self.stream.sigmoid)
                if route.fused:
                    self._root_hist = self.ops.stream_refresh(
                        rows, lv, padded_bins=B, **kw)
                else:
                    self.ops.refresh_plain(rows, lv, **kw)
        return ta, leaf_id, leaf_value


class NumericsGuard:
    """The opt-in NaN / Inf sentinel around a grower (JAX
    ``_NumericsGuard``, ``grow.py:2718-2775``; the policies in
    ``resilience/numerics.py``).  ``clamp`` sanitizes the grad / hess a
    route hands in before the grow (the stream route has none and is
    refused); ``raise`` / ``skip`` grow first, then keep
    ``last_numerics_bad``: the non-finite values of grad, hess and the
    tree's leaf values on the device, plus its split gains', one scalar
    that the booster reads where it decides.  ``off`` builds no guard.
    Every other attribute is the wrapped grower's."""

    def __init__(self, grow, policy: str):
        if policy not in numerics.POLICIES or policy == "off":
            raise ValueError(f"a numerics guard takes raise, skip or clamp, "
                             f"not {policy!r}")
        if policy == "clamp" and grow.route.stream:
            raise ValueError(
                "LGBM_TPU_NUMERICS=clamp cannot guard score-resident "
                "streaming (gradients refresh in the row matrix and never "
                "pass the grow entry); use raise/skip or set "
                "LGBM_TPU_STREAM=0")
        self._grow = grow
        self.numerics_policy = policy
        self.last_numerics_bad: Optional[torch.Tensor] = None

    def __call__(self, grad, hess, inbag, feature_mask, **kw):
        if self.numerics_policy == "clamp":
            grad, hess = numerics.sanitize(grad, hess)
            return self._grow(grad, hess, inbag, feature_mask, **kw)
        out = self._grow(grad, hess, inbag, feature_mask, **kw)
        ta, _, leaf_value = out
        seen = [leaf_value] if grad is None else [grad, hess, leaf_value]
        bad = numerics.count_bad(*seen)
        gains = int(np.count_nonzero(~np.isfinite(ta.split_gain)))
        self.last_numerics_bad = bad + gains if gains else bad
        return out

    def __getattr__(self, name):
        # reached only when the guard has no such attribute
        return getattr(self._grow, name)


class RowOrderGrower(_Grower):
    """The ``row_order`` path (``make_grow_fn`` without
    ``physical_bins``): the bins never move.  Per tree the values
    ``[g*w, h*w]`` are taken in original row order and ``row_order``
    restarts at ``arange(n)`` (``grow.py:1188-1223, 1421``); each split
    partitions the leaf's segment of ``row_order`` by a stable
    compaction, left rows then right rows, each in their order
    (``grow.py:1620-1670``), and histograms the smaller child through
    the index (``hist_rows``).  The JAX package pads each segment to a
    power-of-two bucket and masks the values, for XLA's static shapes;
    the port histograms exactly the child's positions, the same rows.
    The tail is the route's.

    Under ``gpu_use_dp`` (``dp``; routing rule ``gpu_use_dp``) every
    histogram, the root's and each smaller child's, is the f64-accumulating
    mode (``build_histogram_rows_dp``, JAX ``histogram.py:184-190``); its
    output is f32, so the subtraction and the tail are the f32 route's.

    Lazy CEGB grows here only (routing rule ``cegb_lazy``): each split
    marks the leaf's in-bag rows paid for its feature in the caller's
    paid mask ``[F, n]`` (bool, by original row, kept across trees) and
    counts each child's in-bag rows still unpaid for every feature
    (JAX ``grow.py:1643-1658``)."""

    def __init__(self, hp: SplitHyperParams, *, num_leaves: int,
                 max_depth: int, dd: DeviceDataset, route: RouteDecision,
                 timer: Optional[StageTimer] = None,
                 monotone: Optional[np.ndarray] = None,
                 options: Optional[GrowOptions] = None, dp: bool = False,
                 merge=None):
        super().__init__(hp, num_leaves=num_leaves, max_depth=max_depth,
                         dd=dd, route=route, timer=timer, monotone=monotone,
                         options=options, merge=merge)
        if route.physical:
            raise ValueError("RowOrderGrower grows on the row_order path")
        self._hist = build_histogram_rows_dp if dp else build_histogram_rows
        # the bins the histograms read: the chunk's columns where the
        # learner builds only its chunk's histograms (tree_learner=feature)
        f0, f1 = self._chunk
        self._hist_bins = (dd.bins[:, f0:f1].contiguous()
                           if merge is not None and merge.hist_chunk
                           else dd.bins)
        self.row_order: Optional[torch.Tensor] = None
        self.vals: Optional[torch.Tensor] = None
        # lazy CEGB: the tree's in-bag rows and the caller's paid mask
        self._bag: Optional[torch.Tensor] = None
        self._paid: Optional[torch.Tensor] = None

    def _histogram(self, rng: torch.Tensor, max_rows: int,
                   index: Optional[torch.Tensor]) -> torch.Tensor:
        return self._hist(self._hist_bins, self.vals, rng, index=index,
                          padded_bins=self.dd.padded_bins,
                          max_rows=max_rows)

    def _split_step(self, sel: tuple, nleft: torch.Tensor):
        s0, cnt, feat = sel[:3]
        dev, stage = self.dd.device, self.timer.stage
        with stage("partition", dev):
            seg = self.row_order[s0:s0 + cnt]
            col = bins_i32(self.dd.bins, seg, feat)
            # the membership test, where the descriptor carries words
            # (any number: this path's u16 bins take up to 2,048), is a
            # gather of the bin's word (grow.py:1620-1627)
            go = go_left(col, sel)
            if self._paid is not None:
                self._u2 = self._pay(seg.long(), feat, go)
            # a stable compaction with no host read: a left row goes to
            # (lefts up to it) - 1, a right row to nleft + (rights
            # before it)
            cl = torch.cumsum(go, 0, dtype=torch.int32)
            nl = cl[-1:] if cnt else torch.zeros_like(nleft)
            pos = torch.arange(cnt, dtype=torch.int32, device=dev)
            dest = torch.where(go, cl - 1, nl + pos - cl)
            seg.copy_(torch.empty_like(seg).scatter_(0, dest.long(), seg))
            nleft.copy_(nl)
        m = self.merge
        side = None if m is None else m.counts(nleft, cnt)
        with stage("histogram", dev):
            small_left = small_is_left(nleft, cnt, side)
            rng = torch.cat([torch.where(small_left, s0, s0 + nleft),
                             torch.where(small_left, nleft, cnt - nleft)])
            h = self._histogram(rng, self._max_rows(cnt), self.row_order)
        if m is not None:
            h = m.hist(h)
        return h, h, side

    def _pay(self, idx: torch.Tensor, feat: int, go: torch.Tensor
             ) -> torch.Tensor:
        """Lazy CEGB at a split of the rows ``idx`` on ``feat``
        (UpdateLeafBestSplits, cost_effective_gradient_boosting.hpp:125-134):
        the in-bag ones become paid for ``feat``; returns each child's
        in-bag rows unpaid for every feature, f32 [F, 2] (integer
        counts)."""
        bag = self._bag[idx] > 0
        self._paid[feat, idx] |= bag
        unpaid = ~self._paid[:, idx]                           # [F, cnt]
        return torch.stack([(unpaid & (go & bag)).sum(dim=1),
                            (unpaid & (~go & bag)).sum(dim=1)],
                           dim=1).to(torch.float32)

    def __call__(self, grad: torch.Tensor, hess: torch.Tensor,
                 inbag: torch.Tensor, feature_mask: torch.Tensor,
                 rate: float = 0.0, tree_seed: int = 0,
                 paid: Optional[torch.Tensor] = None):
        """Grow one tree from the objective's [n] gradients, hessians and
        in-bag weights (``rate`` is unused: this path keeps no scores;
        ``tree_seed`` salts the tree's draws; ``paid`` is lazy CEGB's
        bool [F, n] paid mask, updated in place).  Returns ``(TreeArrays,
        leaf_id, leaf_value)`` as :class:`SerialGrower` does."""
        dd = self.dd
        dev, n = dd.device, dd.num_data
        stage = self.timer.stage
        if (paid is None) != (self.opts.cegb_lazy is None):
            raise ValueError("lazy CEGB grows with the booster's paid mask, "
                             "and only then")
        self._bag, self._paid = inbag, paid
        with stage("gradients", dev):
            self.vals = torch.stack([grad * inbag, hess * inbag], dim=1)
            self.row_order = torch.arange(n, dtype=torch.int32, device=dev)
        with stage("histogram", dev):
            # the root: every row, no index
            root_hist = self._histogram(
                torch.tensor([0, n], dtype=torch.int32, device=dev), n, None)
        if self.merge is not None:
            root_hist = self.merge.hist(root_hist)
        with stage("split_tail", dev):
            sums = torch.cat([self.vals.double().sum(dim=0),
                              inbag.double().sum()[None]])
            # lazy CEGB at the root: the in-bag rows not yet paid for
            # each feature (CalculateOndemandCosts, hpp:139-163)
            u0 = (None if paid is None
                  else (~paid).to(torch.float32) @ inbag)
            plan = self.plan(feature_mask, tree_seed, u0)
            st = self._init_state(sums, root_hist, plan)
        tb = self._grow(st, plan)
        ta, leaf_id, leaf_value, _ = self._finish(st, tb, self.row_order)
        self._bag = self._paid = self._u2 = None
        return ta, leaf_id, leaf_value


def predict_leaf_bins(ta: TreeArrays, bins: torch.Tensor,
                      num_bins: torch.Tensor, has_nan: torch.Tensor,
                      depth: Optional[int] = None) -> torch.Tensor:
    """Rows -> leaf index, walking one tree in bin space (the JAX
    package's ``ops.predict.predict_leaf_bins``): a categorical node
    sends a row left where its bin is one of ``ta.cat_members``' (the
    bitset walk), or without members where it is ``threshold_bin``
    (one-hot).  ``bins`` [n, F] u8 or u16 on the device, result [n]
    i64.  ``ta``'s arrays may already be tensors on the device; then
    ``depth`` gives the tree's depth, which is otherwise read from
    ``ta``'s host arrays."""
    n = bins.shape[0]
    nl = int(ta.num_leaves)
    dev = bins.device
    if nl <= 1:
        return torch.zeros(n, dtype=torch.int64, device=dev)
    ni = nl - 1
    t = lambda a, dt: torch.as_tensor(a[:ni], dtype=dt,  # noqa: E731
                                      device=dev)
    sf, tb = t(ta.split_feature, torch.int64), t(ta.threshold_bin,
                                                 torch.int32)
    dl, cat = t(ta.default_left, torch.bool), t(ta.is_categorical,
                                                torch.bool)
    lc, rc = t(ta.left_child, torch.int64), t(ta.right_child, torch.int64)
    members = (None if ta.cat_members is None
               else torch.as_tensor(ta.cat_members[:ni], device=dev))
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    b_all = bins_i32(bins)
    for _ in range(_tree_depth(ta) if depth is None else depth):
        nd = node.clamp(min=0)
        feat = sf[nd]
        b = torch.gather(b_all, 1, feat[:, None])[:, 0]
        at_nan = has_nan[feat] & (b == num_bins[feat] - 1)
        thr = tb[nd]
        cat_go = (b == thr if members is None else
                  members[nd, b.clamp(0, members.shape[1] - 1).long()])
        go = torch.where(cat[nd], cat_go,
                         torch.where(at_nan, dl[nd], b <= thr))
        node = torch.where(node >= 0, torch.where(go, lc[nd], rc[nd]), node)
    return ~node


def _tree_depth(ta: TreeArrays) -> int:
    """Levels of internal nodes on the longest root-to-leaf path."""
    depth, stack = 0, [(0, 1)]
    while stack:
        node, d = stack.pop()
        depth = max(depth, d)
        for c in (int(ta.left_child[node]), int(ta.right_child[node])):
            if c >= 0:
                stack.append((c, d + 1))
    return depth
