"""The feature-parallel tree learner: every rank holds every row and
searches its own feature chunk.

Counterpart of ``lightgbm_tpu/parallel/feature_parallel.py``, following
LightGBM's design (feature_parallel_tree_learner.cpp): each rank builds
the histograms of its contiguous feature chunk only
(``mesh.feature_chunks``; its pool and split tail run at ``F_r``
features), finds its local best split, and the winner is elected
(``SyncUpGlobalBestSplit``, ``collectives.Comm.elect``: the largest
selection key, ties to the lowest rank, so to the lowest feature as in
the serial search).  Every rank then partitions its own copy of the rows
by the winner, with no broadcast of go-left bits, so its counts are the
global ones and no collective runs but the election (one a split, and
the root's).  Its trees equal the serial row-order trees bit for bit:
each feature's histogram, candidates and winner are computed as the
serial grower computes them.

The JAX package instead shards the bin matrix by columns, so the split's
owner broadcasts its go-left bits over the feature axis (one O(rows)
psum a split, ``grow.py:1630-1636``).  That layout saves the device
memory of the other ranks' columns; the port keeps LightGBM's, because
one process per rank already holds the whole binned dataset on the host
and the card holds a 1M x 28 bin matrix in 28 MB, while the bit-vector
broadcast would be the learner's largest message.  The learner runs on
the row-order route (rule ``learner_row_order``).
"""
from __future__ import annotations

import torch

from ..utils.log import LightGBMError
from .collectives import Comm
from .data_parallel import DataParallelMerge


class FeatureParallelMerge(DataParallelMerge):
    """The merge points of ``tree_learner=feature`` (module docstring):
    no row merge, a search over the rank's chunk and the election."""

    learner = "feature"
    rows_sharded = False
    hist_chunk = True

    def __init__(self, comm: Comm, num_features: int, timer=None):
        if num_features < comm.world:
            raise LightGBMError(
                f"tree_learner=feature needs a feature a rank: {num_features} "
                f"features over {comm.world} ranks")
        super().__init__(comm, num_features, scatter=True, timer=timer)

    @property
    def hist_merge(self) -> str:
        return "none"

    def sums(self, local: torch.Tensor) -> torch.Tensor:
        return local.to(torch.float32)

    def hist(self, h: torch.Tensor) -> torch.Tensor:
        return h

    def counts(self, nleft: torch.Tensor, cnt: int):
        return None

    def max_rows(self, cnt: int) -> int:
        return int(cnt) // 2 + 1
