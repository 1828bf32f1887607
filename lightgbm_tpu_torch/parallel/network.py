"""The network layer of the parallel learners, on ``torch.distributed``.

Counterpart of ``lightgbm_tpu/parallel/network.py`` (reference
network.h:89, src/network/).  ``Network.init`` wires one process per
rank (the package docstring's execution model):

- a process group that already exists (``torch.distributed.
  is_initialized()``, as under ``torchrun``) is used as it is;
- otherwise LightGBM's own parameters make one: the first entry of
  ``machines`` (``"ip1:port1,ip2:port2,..."``) is the coordinator, the
  rank is the position of the local ``ip:local_listen_port`` in the list
  (the JAX package's local-address match, ``network.py:59-124``;
  ``rank=`` overrides it), the world size is ``num_machines`` and the
  timeout ``time_out`` minutes (``timeout_s=`` overrides it).

The transport is chosen up front by one rule and logged once:
NCCL where every rank of this host has a card of its own, gloo where
ranks share a card or train on the CPU (NCCL refuses two ranks on one
device).  ``collectives.Comm`` stages CUDA tensors through pinned host
buffers under gloo.

The typed helpers of the reference (``GlobalSyncUpByMin/Max/Sum/Mean``,
``GlobalSum``, ``GlobalArray``, network.h:169-275) reduce host values
over the group in f64, sums added in rank order.
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils import log
from ..utils.log import LightGBMError

__all__ = ["Network", "choose_backend", "rank_device"]


def _local_addresses() -> List[str]:
    addrs = {"127.0.0.1", "localhost"}
    try:
        hostname = socket.gethostname()
        addrs.add(hostname)
        for info in socket.getaddrinfo(hostname, None):
            addrs.add(info[4][0])
    except OSError:
        pass
    return sorted(addrs)


def _parse_machines(machines: str) -> List[str]:
    out = [m.strip() for m in str(machines).replace("\n", ",").split(",")]
    return [m for m in out if m]


def choose_backend(device: torch.device, local_world: int) -> str:
    """The transport rule: ``nccl`` where the ranks of this host each
    have a card of their own, else ``gloo``."""
    if (device.type == "cuda" and torch.cuda.is_available()
            and local_world <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def local_rank() -> int:
    """This process's rank among the ranks of its host: ``LOCAL_RANK``
    where a launcher sets it, else the rank ``Network.init`` found among
    this host's entries of ``machines``, else the global rank."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if Network._local_rank >= 0:
        return Network._local_rank
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device: torch.device) -> torch.device:
    """A rank's card: ``cuda:(local_rank % device_count)`` for a CUDA
    ``device`` without an index; any other device as given."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank() % torch.cuda.device_count())
    return device


class Network:
    """Static facade mirroring the reference ``Network`` class."""

    _owned = False        # this facade made the process group
    _rank = 0
    _num_machines = 1
    _local_rank = -1
    _local_world = 1

    @classmethod
    def init(cls, config=None, *, machines: str = "", num_machines: int = 0,
             rank: int = -1, device: torch.device = torch.device("cpu"),
             timeout_s: Optional[float] = None) -> int:
        """Reference Network::Init: the process group of this rank, made
        from the configuration where none exists.  ``device`` is the
        device the rank trains on, which the transport rule reads.
        Returns the world size (1: no group, serial training)."""
        if dist.is_initialized():
            cls._rank = dist.get_rank()
            cls._num_machines = dist.get_world_size()
            cls._local_world = int(os.environ.get(
                "LOCAL_WORLD_SIZE", cls._local_world))
            return cls._num_machines
        if config is not None:
            machines = machines or config.machines
            num_machines = num_machines or config.num_machines
        mlist = _parse_machines(machines)
        if num_machines <= 1 and len(mlist) <= 1:
            return 1
        if not mlist:
            log.fatal("num_machines > 1 but no machines list given "
                      "(set machines=ip1:port1,ip2:port2,...)")
        num_machines = num_machines or len(mlist)
        if len(mlist) < num_machines:
            log.fatal("machines list has %d entries but num_machines=%d",
                      len(mlist), num_machines)
        mlist = mlist[:num_machines]
        local = set(_local_addresses())
        here = [i for i, m in enumerate(mlist)
                if m.rsplit(":", 1)[0] in local]
        if rank < 0:
            port = str(config.local_listen_port) if config is not None else ""
            matches = [i for i in here if mlist[i].rsplit(":", 1)[-1] == port]
            if len(here) == 1:
                rank = here[0]
            elif len(matches) == 1:
                rank = matches[0]
            elif here:
                log.fatal("Multiple machines entries match this host %s; set "
                          "local_listen_port to the entry's port or pass "
                          "rank= explicitly", mlist)
            else:
                log.fatal("Could not find the local address in the machines "
                          "list %s; pass rank= explicitly", mlist)
        cls._local_world = max(len(here), 1)
        cls._local_rank = here.index(rank) if rank in here else 0
        minutes = config.time_out if config is not None else 120
        timeout = datetime.timedelta(
            seconds=timeout_s if timeout_s is not None else 60.0 * minutes)
        backend = choose_backend(rank_device(torch.device(device)),
                                 cls._local_world)
        coordinator = mlist[0]
        log.info("Connecting to coordinator %s as rank %d/%d over %s",
                 coordinator, rank, num_machines, backend)
        try:
            dist.init_process_group(backend,
                                    init_method=f"tcp://{coordinator}",
                                    rank=rank, world_size=num_machines,
                                    timeout=timeout)
        except Exception as e:   # noqa: BLE001 - re-raised with context
            raise LightGBMError(f"Network::Init of rank {rank} of "
                                f"{num_machines} at {coordinator} failed: "
                                f"{e}") from e
        cls._owned = True
        cls._rank = rank
        cls._num_machines = num_machines
        return num_machines

    @classmethod
    def dispose(cls) -> None:
        """Reference Network::Dispose: ends the group this facade made."""
        if cls._owned and dist.is_initialized():
            dist.destroy_process_group()
        cls._owned = False
        cls._rank, cls._num_machines = 0, 1
        cls._local_rank, cls._local_world = -1, 1

    @classmethod
    def is_initialized(cls) -> bool:
        return dist.is_initialized()

    @classmethod
    def rank(cls) -> int:
        return dist.get_rank() if dist.is_initialized() else cls._rank

    @classmethod
    def num_machines(cls) -> int:
        return (dist.get_world_size() if dist.is_initialized()
                else cls._num_machines)

    # -- typed helpers (network.h:169-275), f64 on the host ------------
    @staticmethod
    def _gather(values) -> np.ndarray:
        """``[W, k]`` f64: every rank's values in rank order."""
        v = np.atleast_1d(np.asarray(values, np.float64))
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return v[None]
        t = torch.as_tensor(v)
        if str(dist.get_backend()) == "nccl":
            t = t.to(rank_device(torch.device("cuda")))
        outs = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(outs, t)
        return torch.stack(outs).cpu().numpy()

    @classmethod
    def global_sync_up_by_min(cls, value: float) -> float:
        return float(cls._gather(value)[:, 0].min())

    @classmethod
    def global_sync_up_by_max(cls, value: float) -> float:
        return float(cls._gather(value)[:, 0].max())

    @classmethod
    def global_sync_up_by_sum(cls, value: float) -> float:
        return float(cls.global_sum([value])[0])

    @classmethod
    def global_sync_up_by_mean(cls, value: float) -> float:
        return cls.global_sync_up_by_sum(value) / max(cls.num_machines(), 1)

    @classmethod
    def global_sum(cls, values: Sequence[float]) -> np.ndarray:
        """Element-wise sums over ranks, added in rank order."""
        g = cls._gather(values)
        acc = g[0].copy()
        for r in range(1, g.shape[0]):
            acc = acc + g[r]
        return acc

    @classmethod
    def global_array(cls, value: float) -> np.ndarray:
        """One value per rank, in rank order (network.h GlobalArray)."""
        return cls._gather(value)[:, 0].copy()
