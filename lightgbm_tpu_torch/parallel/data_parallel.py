"""The data-parallel tree learner: rows in blocks over the ranks.

Counterpart of ``lightgbm_tpu/parallel/data_parallel.py`` (reference
data_parallel_tree_learner.cpp).  The reference's communication points
are the grower's merge points (``ops/grow._Grower``, ``merge=``):

- the root's ``(g, h, count)`` allreduce (cpp:126-152): the f64 sums
  added in rank order and rounded once (:meth:`DataParallelMerge.sums`);
- the histogram ``Network::ReduceScatter`` (cpp:185): each rank's local
  histogram of the root and of every split's globally smaller child,
  reduce-scattered over contiguous feature chunks
  (``collectives.Comm.reduce_scatter``), so each rank's pool holds its
  chunk ``[L, F_r, B, 2]`` and its split tail runs at ``F_r`` features;
  or, with ``hist_merge=full`` (``LGBM_TPU_HIST_SCATTER=0``, or fewer
  features than ranks), the whole merged histogram on every rank, the
  reduce-scatter's bits gathered;
- ``SyncUpGlobalBestSplit`` (cpp:260): under the reduce-scatter merge
  the two children's best rows (and the root's) are elected
  (``Comm.elect``);
- the global leaf counts (cpp:270): one small allreduce of the split's
  ``(nleft, cnt)`` gives the side, ``nl_g * 2 <= cnt_g``, that every rank
  histograms and that the tail's pool ops take (``side=``), while each
  rank moves its own segment by its local ``nleft``.

Three collectives a split under the reduce-scatter merge (the counts,
the histogram chunks, the election), two under the full merge.  Each
rank's rows never leave it; the learner runs on the route
``ops/routing.decide`` gives it: the physical kernel-tail route without
the stream (rule ``mesh_stream_unwired``), fused or not, or the
row-order route.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from ..ops.grow import StageTimer
from .collectives import Comm


class DataParallelMerge:
    """The merge points of ``tree_learner=data`` for one rank (see the
    module docstring).  ``chunk`` is the feature range the rank's search
    covers (None: every feature), ``hist_chunk`` whether its local
    histograms are built over that chunk only, ``tail`` a split tail
    replacing the route's (None: the route's)."""

    learner = "data"
    rows_sharded = True
    hist_chunk = False
    tail = None

    def __init__(self, comm: Comm, num_features: int, *, scatter: bool,
                 timer: Optional[StageTimer] = None):
        self.comm = comm
        self.num_features = int(num_features)
        self.scatter = bool(scatter)
        self.timer = timer or StageTimer()
        self.chunk: Optional[Tuple[int, int]] = (
            comm.chunks(num_features)[comm.rank] if scatter else None)

    @property
    def hist_merge(self) -> str:
        return "scatter" if self.scatter else "full"

    @contextlib.contextmanager
    def _stage(self):
        with self.timer.stage("collective", self.comm.device):
            yield

    def sums(self, local: torch.Tensor) -> torch.Tensor:
        """The root's ``(g, h, count)``: the ranks' f64 sums added in
        rank order, rounded once to f32."""
        with self._stage():
            return self.comm.allreduce_sum(local).to(torch.float32)

    def hist(self, h: torch.Tensor) -> torch.Tensor:
        """A merged histogram from the rank's local ``[F, B, 2]``: its
        chunk under the reduce-scatter merge, else the whole."""
        with self._stage():
            return (self.comm.reduce_scatter(h) if self.scatter
                    else self.comm.full_merge(h))

    def root_search(self, h: torch.Tensor, mask: torch.Tensor,
                    count: torch.Tensor):
        """The root's histogram and mask as the search reads them (the
        merged ones; the voting learner elects)."""
        return h, mask

    def counts(self, nleft: torch.Tensor, cnt: int) -> torch.Tensor:
        """The split's side, ``(nl_g, cnt_g)`` i32 [2] on the device."""
        with self._stage():
            return self.comm.counts(nleft, cnt)

    def elect(self, rows: torch.Tensor) -> torch.Tensor:
        with self._stage():
            return self.comm.elect(rows)

    def max_rows(self, cnt: int) -> int:
        """The bound on the smaller child's local rows: the globally
        smaller child can be the locally larger one, so the whole local
        segment."""
        return int(cnt)
