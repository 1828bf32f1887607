"""The parallel tree learners (``tree_learner=data|voting|feature``) on
``torch.distributed``.

Counterpart of ``lightgbm_tpu/parallel/``.  The JAX package drives every
device from one process (a mesh, ``shard_map``); the port follows
PyTorch and LightGBM instead, **one process per rank**:

- Each rank calls ``lgt.train(params, ds)`` with the same ``params`` and
  the same whole ``Dataset``.  It bins every row, which gives the serial
  bins bit for bit, and keeps its contiguous block of rows on its device
  (``mesh.row_block``: rows ``[r * ceil(n / W), (r + 1) * ceil(n / W))``,
  as ``pad_rows_to_shards`` places them; the last block may be shorter
  and no padding rows exist).  The feature learner keeps every row.
- Whole-data quantities come from the whole ``Dataset`` each rank holds,
  with no collective and the serial bits: the ``boost_from_average``
  init score, and the labels the training metrics read (the ranks'
  training scores are gathered in rank order once an evaluation).
  Validation sets are scored whole on every rank.
- A rank's device is ``cuda:(local_rank % device_count)``
  (``network.rank_device``) unless the caller asks for the CPU.
- The process group is one that already exists (``torchrun``) or one
  ``network.Network.init`` makes from ``machines`` / ``num_machines`` /
  ``local_listen_port``; the transport is NCCL where each rank has a
  card of its own, gloo otherwise (``collectives`` stages CUDA tensors
  through pinned host buffers).
- A group of world size 1, or none, trains serially, as the JAX package
  does with one device; it is logged once as a route reason
  (``mesh_world_1``).  ``pre_partition`` keeps raising (ROADMAP A11).
- Every rank makes the same collective calls in the same order: the
  stop test reads the global gain, and a failed collective raises on
  each rank within the group's timeout.  Every rank ends with the same
  model text.

The learners are the grower's merge points (``ops/grow._Grower``,
``merge=``): :mod:`.data_parallel`, :mod:`.voting_parallel`,
:mod:`.feature_parallel`.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils import log
from .collectives import Comm
from .data_parallel import DataParallelMerge
from .feature_parallel import FeatureParallelMerge
from .mesh import check_mesh_axes, row_block
from .network import Network, rank_device
from .voting_parallel import VotingParallelMerge

MESH_LEARNERS = ("data", "voting", "feature")

__all__ = ["Comm", "DataParallelMerge", "FeatureParallelMerge",
           "MESH_LEARNERS", "Network", "VotingParallelMerge", "make_merge",
           "mesh_comm", "rank_device", "row_block"]


def mesh_comm(config, device: torch.device) -> Optional[Comm]:
    """The collectives of this rank under a parallel learner (the group
    from :meth:`Network.init`), or None where the world is one rank,
    which trains serially (logged once)."""
    world = Network.init(config, device=device)
    check_mesh_axes(config.tpu_mesh_axes, config.tree_learner, world)
    if world <= 1:
        log.info("tree_learner=%s trains serially: the process group has "
                 "one rank (route reason mesh_world_1)", config.tree_learner)
        return None
    comm = Comm(device=device)
    log.info("tree_learner=%s: rank %d of %d over %s%s", config.tree_learner,
             comm.rank, comm.world, comm.backend,
             " (CUDA tensors staged through pinned host buffers)"
             if comm.staged else "")
    return comm


def make_merge(learner: str, comm: Comm, dd, *, scatter: bool, hp, top_k: int,
               timer=None):
    """The grower's merge object of ``learner`` over ``dd`` (the rank's
    ``DeviceDataset``)."""
    if learner == "data":
        return DataParallelMerge(comm, dd.num_features, scatter=scatter,
                                 timer=timer)
    if learner == "voting":
        return VotingParallelMerge(comm, dd.num_features, top_k=top_k, hp=hp,
                                   num_bins=dd.num_bins, has_nan=dd.has_nan,
                                   is_cat=dd.is_cat, timer=timer)
    if learner == "feature":
        return FeatureParallelMerge(comm, dd.num_features, timer=timer)
    raise ValueError(f"no parallel learner {learner!r}")
