"""The voting-parallel (PV-tree) learner: rows in blocks, merges bounded
by an election.

Counterpart of ``lightgbm_tpu/parallel/voting_parallel.py`` and of
``vote_sync`` (``lightgbm_tpu/ops/grow.py:1067-1095``; reference
voting_parallel_tree_learner.cpp :151 GlobalVoting, :184
CopyLocalHistogram).  Rows are placed as for the data learner; each
rank's pool holds its **local** histograms (the subtraction trick runs on
them, in the PyTorch pool ops with the global side).  For the root and
for both children of every split:

- each rank votes its local top-``k`` features by the best gain of its
  local histogram (``ops.split.per_feature_best_gain`` at the local
  totals and the leaf's global count, as the JAX package scores them);
- the votes are summed over the ranks, and the ``2k`` features of most
  votes are elected (ties to the lower feature: ``lax.top_k``'s order,
  a stable sort);
- only the elected features' histograms are merged (added in rank
  order), the others stay zero, and the search runs with the elected
  mask.

Both children vote in one collective and merge in another, so a split
costs three (the counts, the votes, the elected histograms).  The
learner runs on the row-order route (rule ``learner_row_order``, as the
JAX package) and, since each child searches its own elected features,
on the PyTorch split tail (rule ``tail_voting``: the JAX package's
``use_kernel_tail`` requires ``not use_voting``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.apply_find import (BLC, SC, ChildSearch, apply_find_ref,
                              pool_children)
from ..ops.split import SplitHyperParams, per_feature_best_gain
from .collectives import Comm
from .data_parallel import DataParallelMerge


class VotingParallelMerge(DataParallelMerge):
    """The merge points of ``tree_learner=voting`` (module docstring)."""

    learner = "voting"

    def __init__(self, comm: Comm, num_features: int, *, top_k: int,
                 hp: SplitHyperParams, num_bins: torch.Tensor,
                 has_nan: torch.Tensor, is_cat: torch.Tensor, timer=None):
        super().__init__(comm, num_features, scatter=False, timer=timer)
        f = int(num_features)
        self.top_k = min(max(int(top_k), 1), f)
        self.elect_k = min(2 * max(int(top_k), 1), f)
        self.hp = hp
        self.meta = (num_bins, has_nan, is_cat)
        self.tail = self._tail

    @property
    def hist_merge(self) -> str:
        return "vote"

    def hist(self, h: torch.Tensor) -> torch.Tensor:
        """Histograms stay local in the pool; the election merges."""
        return h

    def vote(self, h: torch.Tensor, mask: torch.Tensor, count: torch.Tensor):
        """``(merged, elected)`` of K leaves' local histograms ``h`` [K,
        F, B, 2] with their masks ``mask`` [K, F] and global counts
        ``count`` [K]: the elected features' histograms summed over the
        ranks (zero elsewhere) and the mask times the election."""
        k, f = mask.shape
        tot = h[:, 0].sum(dim=1)                           # [K, 2] local
        gain = per_feature_best_gain(h, tot[:, 0], tot[:, 1], count,
                                     *self.meta, mask, self.hp)
        order = torch.sort(gain, dim=1, descending=True, stable=True)
        top_v = order.values[:, :self.top_k]
        top_i = order.indices[:, :self.top_k]
        votes = torch.zeros((k, f), dtype=torch.float32, device=h.device)
        votes.scatter_add_(1, top_i, torch.isfinite(top_v).to(torch.float32))
        with self._stage():
            votes = self.comm.allreduce_sum(votes)
        el = torch.sort(votes, dim=1, descending=True,
                        stable=True).indices[:, :self.elect_k]     # [K, E]
        rows = torch.arange(k, device=h.device)[:, None]
        with self._stage():
            picked = self.comm.allreduce_sum(h[rows, el])  # [K, E, B, 2]
        merged = torch.zeros_like(h)
        merged[rows, el] = picked
        chosen = torch.zeros_like(mask)
        chosen[rows, el] = 1.0
        return merged, mask * chosen

    def root_search(self, h: torch.Tensor, mask: torch.Tensor,
                    count: torch.Tensor):
        merged, m = self.vote(h[None], mask, count.reshape(1))
        return merged[0], m

    def _tail(self, h_a, h_b, nleft, st, fc, feature_mask, hp, max_depth, at,
              child: Optional[ChildSearch] = None,
              side: Optional[torch.Tensor] = None) -> None:
        """The split tail: the pool ops on the local histograms with the
        global side, both children's election, then the search
        (``apply_find_ref``) with each child's elected mask."""
        if at.done:
            return
        brow, lrow = st.best[at.leaf], st.lstate[at.leaf]
        counts = torch.stack([brow[BLC], lrow[SC] - brow[BLC]])
        local = pool_children(h_a, h_b, nleft, st, at, side)
        base = feature_mask[None].expand(2, -1)
        merged, masks = self.vote(local, base, counts)
        apply_find_ref(merged, nleft, st, fc, feature_mask, hp, max_depth, at,
                       ChildSearch(masks))
