"""Leaf-wise tree growth on the physically partitioned row matrix.

Counterpart of the serial, physical, unfused branch of
``lightgbm_tpu/ops/grow.py`` (``make_grow_fn`` with ``physical_bins``
set, ``LGBM_TPU_FUSED=0``, no gradient streaming, the XLA split tail,
and the ``_PhysicalGrow`` wrapper that carries the row matrix across
trees).  Per tree: the row values are refreshed from this tree's
gradients by row id, the root histogram is built, and then, split by
split, in the reference's order:

  best leaf (argmax of the selection key) -> partition of its segment
  (scan + copyback kernels) -> the smaller child by ``nl * 2 <= par``
  -> its histogram (comb-direct kernel) -> sibling = parent - child ->
  ``find_best_split`` on both children.

The loop runs on the host; the state (histogram pool, per-leaf best
splits and sums, segments) stays on the device, and each split reads
one small descriptor back (leaf, best split, segment), which the host
needs to launch the partition.  The tree's structure (child pointers,
split features and bins) is kept on the host; its float fields on the
device until the tree is finished.  A device-side loop over splits is
later work (``ROADMAP.md`` A4).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .device_data import DeviceDataset, Rows, empty_rows_like, init_rows
from .hist_kernel2 import build_histogram_comb
from .histogram import subtract_histogram
from .partition_kernel import partition
from .split import (SplitHyperParams, calculate_leaf_output,
                    find_best_split, pack_split_info, selection_key)


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


# best-row columns (the JAX grower's _GrowState.best layout)
_BG, _BF, _BB, _BDL, _BCAT, _BLG, _BLH, _BLC, _BLO, _BRO = range(10)
# per-leaf state columns (_GrowState.lstate)
_SG, _SH, _SC, _SDEP, _SPAR, _SMN, _SMX, _SOUT = range(8)


class StageTimer:
    """Per-stage device time of a training run, off unless enabled.
    On a CUDA device each stage is bracketed by CUDA events (so it
    includes the host's enqueue gaps inside it); on the CPU by the host
    clock."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._spans: List = []

    @contextlib.contextmanager
    def stage(self, name: str, device: torch.device):
        if not self.enabled:
            yield
            return
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

    def totals_ms(self) -> Dict[str, float]:
        """Milliseconds per stage summed over the run so far."""
        out: Dict[str, float] = {}
        if self._spans and isinstance(self._spans[0][1], torch.cuda.Event):
            torch.cuda.synchronize()
        for name, a, b in self._spans:
            ms = (a.elapsed_time(b) if isinstance(a, torch.cuda.Event)
                  else (b - a) * 1e3)
            out[name] = out.get(name, 0.0) + ms
        return out


class SerialGrower:
    """Grows one tree per call from the row matrix it carries across
    calls (``_PhysicalGrow``): the rows stay in the previous tree's
    permutation, and only their value columns are rewritten per tree."""

    def __init__(self, hp: SplitHyperParams, *, num_leaves: int,
                 max_depth: int, dd: DeviceDataset,
                 timer: Optional[StageTimer] = None):
        self.hp = hp
        self.L = int(num_leaves)
        self.max_depth = int(max_depth)
        self.dd = dd
        self.timer = timer or StageTimer()
        self.rows: Optional[Rows] = None
        self.scratch: Optional[Rows] = None
        self._num_bins = dd.num_bins.cpu().numpy()
        self._has_nan = dd.has_nan.cpu().numpy()
        # host reads of the split descriptor over the run
        self.host_reads = 0
        # set to a list to record every split descriptor read
        # (leaf, gain, feature, bin, default_left, is_cat, s0, cnt)
        self.trace: Optional[list] = None

    def _allow(self, depth: torch.Tensor) -> torch.Tensor:
        if self.max_depth <= 0:
            return torch.ones(depth.shape, dtype=torch.bool,
                              device=depth.device)
        return depth < self.max_depth

    def __call__(self, grad: torch.Tensor, hess: torch.Tensor,
                 inbag: torch.Tensor, feature_mask: torch.Tensor):
        """Grow one tree.  Returns ``(TreeArrays, leaf_id, leaf_value)``:
        host arrays of the tree, the [n] leaf of every row in original
        order and the [L] leaf outputs, both on the device."""
        dd, hp, L = self.dd, self.hp, self.L
        dev, n, B = dd.device, dd.num_data, dd.padded_bins
        stage = self.timer.stage
        f32 = torch.float32
        if self.rows is None:
            self.rows = init_rows(dd.bins)
            self.scratch = empty_rows_like(self.rows)
        rows = self.rows
        with stage("gradients", dev):
            gv = torch.stack([grad * inbag, hess * inbag, inbag], dim=1)
            rows.vals.copy_(gv[rows.rid.long()])
        with stage("histogram", dev):
            root_rng = torch.tensor([0, 0, n], dtype=torch.int32, device=dev)
            root_hist = build_histogram_comb(rows, root_rng, padded_bins=B,
                                             max_rows=n)
        with stage("split_tail", dev):
            # root sums in f64, rounded once: the CPU's and the card's
            # reduction orders then give the same f32
            sg0, sh0, c0 = rows.vals.double().sum(dim=0).to(f32).unbind()
            root_out = calculate_leaf_output(sg0, sh0, hp)
            depth0 = torch.zeros(1, dtype=f32, device=dev)
            si0 = find_best_split(
                root_hist[None], sg0[None], sh0[None], c0[None],
                dd.num_bins, dd.has_nan, dd.is_cat, feature_mask,
                self._allow(depth0), hp, parent_output=root_out[None])
            pool = torch.zeros((L, dd.num_features, B, 2), dtype=f32,
                               device=dev)
            pool[0] = root_hist
            best = torch.full((L, 10), float("-inf"), dtype=f32, device=dev)
            best[:, _BF:] = 0.0
            best[0] = pack_split_info(si0)[0]
            lstate = torch.zeros((L, 8), dtype=f32, device=dev)
            lstate[0] = torch.stack([
                sg0, sh0, c0, sg0.new_tensor(0.0), sg0.new_tensor(-1.0),
                sg0.new_tensor(float("-inf")), sg0.new_tensor(float("inf")),
                root_out])
            lstate[1:, _SPAR] = -1.0
            lstate[1:, _SMN] = float("-inf")
            lstate[1:, _SMX] = float("inf")
            nodes = torch.zeros((max(L - 1, 1), 4), dtype=f32, device=dev)
            seg = torch.zeros((L, 2), dtype=torch.int32, device=dev)
            seg[0, 1] = n
        ni = L - 1
        split_feature = np.zeros(ni, np.int32)
        threshold_bin = np.zeros(ni, np.int32)
        default_left = np.zeros(ni, bool)
        is_cat = np.zeros(ni, bool)
        left_child = np.zeros(ni, np.int32)
        right_child = np.zeros(ni, np.int32)
        leaf_parent = {0: (-1, 0)}
        nleft = torch.zeros(1, dtype=torch.int32, device=dev)
        num_leaves = 1
        for i in range(ni):
            with stage("split_tail", dev):
                leaf_t = torch.argmax(selection_key(best[:, _BG]))
                brow = best[leaf_t]
                desc = torch.cat([leaf_t[None].double(),
                                  brow[:_BCAT + 1].double(),
                                  seg[leaf_t].double()]).tolist()
            self.host_reads += 1
            if self.trace is not None:
                self.trace.append(desc)
            leaf, gain, feat, sbin, dl, cat, s0, cnt = (
                int(desc[0]), desc[1], int(desc[2]), int(desc[3]),
                int(desc[4] > 0.5), int(desc[5] > 0.5), int(desc[6]),
                int(desc[7]))
            if gain <= 0.0:
                break
            node, right = i, num_leaves
            nanb = (int(self._num_bins[feat]) - 1 if self._has_nan[feat]
                    else -1)
            with stage("partition", dev):
                partition(rows, self.scratch,
                          (s0, cnt, feat, sbin, dl, cat, nanb), nleft)
            with stage("histogram", dev):
                small_left = nleft * 2 <= cnt
                child_start = torch.where(small_left, s0, s0 + nleft)
                child_cnt = torch.where(small_left, nleft, cnt - nleft)
                rng = torch.cat([child_start, torch.zeros_like(nleft),
                                 child_cnt])
                h_small = build_histogram_comb(rows, rng, padded_bins=B,
                                               max_rows=cnt // 2 + 1)
            with stage("split_tail", dev):
                h_parent = pool[leaf]
                h_left = torch.where(small_left, h_small,
                                     subtract_histogram(h_parent, h_small))
                h_right = subtract_histogram(h_parent, h_left)
                pool[leaf] = h_left
                pool[right] = h_right
                seg[leaf, 1] = nleft[0]
                seg[right, 0] = s0 + nleft[0]
                seg[right, 1] = cnt - nleft[0]
                lrow = lstate[leaf]
                brow = best[leaf]
                pg, ph, pc = lrow[_SG], lrow[_SH], lrow[_SC]
                lg, lh, lc = brow[_BLG], brow[_BLH], brow[_BLC]
                lo, ro = brow[_BLO], brow[_BRO]
                rg, rh, rc = pg - lg, ph - lh, pc - lc
                nodes[node] = torch.stack(
                    [brow[_BG], calculate_leaf_output(pg, ph, hp), ph, pc])
                d_child = lrow[_SDEP] + 1.0
                fnode = d_child.new_tensor(float(node))
                mn, mx = lrow[_SMN], lrow[_SMX]
                lstate[[leaf, right]] = torch.stack([
                    torch.stack([lg, lh, lc, d_child, fnode, mn, mx, lo]),
                    torch.stack([rg, rh, rc, d_child, fnode, mn, mx, ro])])
                si = find_best_split(
                    torch.stack([h_left, h_right]), torch.stack([lg, rg]),
                    torch.stack([lh, rh]), torch.stack([lc, rc]),
                    dd.num_bins, dd.has_nan, dd.is_cat, feature_mask,
                    self._allow(torch.stack([d_child, d_child])), hp,
                    parent_output=torch.stack([lo, ro]))
                best[[leaf, right]] = pack_split_info(si)
            # tree structure (reference Tree::Split, tree.h:541)
            p, side = leaf_parent[leaf]
            if p >= 0:
                (left_child if side == 0 else right_child)[p] = node
            left_child[node], right_child[node] = ~leaf, ~right
            split_feature[node], threshold_bin[node] = feat, sbin
            default_left[node], is_cat[node] = bool(dl), bool(cat)
            leaf_parent[leaf] = (node, 0)
            leaf_parent[right] = (node, 1)
            num_leaves += 1
        with stage("split_tail", dev):
            # every row's leaf from the final segments (positions tile
            # [0, n)), undoing the permutation by the stored row ids
            order = torch.argsort(seg[:, 0], stable=True)
            leaf_of_pos = torch.repeat_interleave(
                order, seg[order, 1].long(), output_size=n)
            leaf_id = torch.empty(n, dtype=torch.int64, device=dev)
            leaf_id[rows.rid.long()] = leaf_of_pos
            live = torch.arange(L, device=dev) < num_leaves
            leaf_value = torch.where(live, lstate[:, _SOUT],
                                     torch.zeros((), dtype=f32, device=dev))
            host = torch.cat([nodes.reshape(-1), lstate[:, _SH],
                              lstate[:, _SC], leaf_value]).cpu().numpy()
        nf = nodes.numel()
        nodes_h = host[:nf].reshape(-1, 4)[:ni]
        ta = TreeArrays(
            split_feature=split_feature, threshold_bin=threshold_bin,
            split_gain=nodes_h[:, 0].copy(), default_left=default_left,
            is_categorical=is_cat, left_child=left_child,
            right_child=right_child, internal_value=nodes_h[:, 1].copy(),
            internal_weight=nodes_h[:, 2].copy(),
            internal_count=nodes_h[:, 3].copy(),
            leaf_value=host[nf + 2 * L:nf + 3 * L].copy(),
            leaf_weight=host[nf:nf + L].copy(),
            leaf_count=host[nf + L:nf + 2 * L].copy(),
            num_leaves=num_leaves)
        return ta, leaf_id, leaf_value


def predict_leaf_bins(ta: TreeArrays, bins: torch.Tensor,
                      num_bins: torch.Tensor,
                      has_nan: torch.Tensor) -> torch.Tensor:
    """Rows -> leaf index, walking one tree in bin space (the JAX
    package's ``ops.predict.predict_leaf_bins``, one-hot categorical
    splits): ``bins`` [n, F] u8 on the device, result [n] i64."""
    n = bins.shape[0]
    nl = int(ta.num_leaves)
    dev = bins.device
    if nl <= 1:
        return torch.zeros(n, dtype=torch.int64, device=dev)
    ni = nl - 1
    t = lambda a, dt: torch.as_tensor(np.asarray(a[:ni]), dtype=dt,  # noqa
                                      device=dev)
    sf, tb = t(ta.split_feature, torch.int64), t(ta.threshold_bin,
                                                 torch.int32)
    dl, cat = t(ta.default_left, torch.bool), t(ta.is_categorical,
                                                torch.bool)
    lc, rc = t(ta.left_child, torch.int64), t(ta.right_child, torch.int64)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    for _ in range(_tree_depth(ta)):
        nd = node.clamp(min=0)
        feat = sf[nd]
        b = torch.gather(bins, 1, feat[:, None])[:, 0].to(torch.int32)
        at_nan = has_nan[feat] & (b == num_bins[feat] - 1)
        thr = tb[nd]
        go = torch.where(cat[nd], b == thr,
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
