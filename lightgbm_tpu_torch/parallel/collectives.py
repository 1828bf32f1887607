"""The collectives of the parallel learners, over ``torch.distributed``,
in a fixed order.

Counterpart of the merge points the JAX package writes as ``lax.psum``,
``lax.psum_scatter`` and ``lax.pmax`` inside its ``shard_map``
(``lightgbm_tpu/ops/grow.py:901-902``, ``:1029-1095``, ``:1286-1315``).
XLA and NCCL add a reduction in an order of their own; here every sum is
an exchange of the addends followed by adds **in rank order** on the
receiving rank (``((x_0 + x_1) + x_2) + ...``, one f32 rounding per
add), so the bits depend on neither the backend nor the device: the
card's run and the CPU's at the same world size give the same trees.

- :meth:`Comm.reduce_scatter`: the histogram merge of the data learner.
  Each rank cuts its local ``[F, B, 2]`` histogram into the ranks'
  contiguous feature chunks (``mesh.feature_chunks``, padded to the
  widest so every piece has one size) and an all-to-all sends chunk
  ``q`` to rank ``q`` (NCCL's ``all_to_all``; under gloo a send and a
  receive a peer pair), which adds the ``W`` pieces in rank order: the
  bytes of a ring reduce-scatter, ``(W - 1) / W`` of the histogram out
  and in.
- :meth:`Comm.full_merge`: the same, then an ``all_gather`` of the
  merged chunks, so it gives the reduce-scatter merge's bits.
- :meth:`Comm.allreduce_sum`: ``all_gather`` and adds in rank order
  (small payloads: root sums, counts, the voting learner's elected
  histograms).
- :meth:`Comm.elect`: the best-split election, an ``all_gather`` of each
  rank's candidate rows; the largest ``ops.split.selection_key`` of the
  gain wins, ties to the lowest rank (JAX ``grow.py:1040-1052``).

Transport: NCCL moves CUDA tensors where each rank has a card of its own;
under gloo (ranks sharing a card, or on the CPU) CUDA tensors are staged
explicitly through pinned host buffers here, one per shape, since gloo's
CUDA support varies by collective.  A failed collective raises
``LightGBMError``; nothing carries on serially.

Every call adds one to :attr:`Comm.calls` and the bytes this rank sends
to :attr:`Comm.bytes_sent`: the ``collectives a split`` and ``bytes
merged a split`` that ``chip_smoke.py`` prints.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from ..ops.split import selection_key
from ..utils.log import LightGBMError
from .mesh import feature_chunks

# the best-row column holding the gain (ops/apply_find.BG)
_BG = 0


class Comm:
    """The collectives of one rank of ``group`` on ``device`` (the
    device of the tensors it is given and returns)."""

    def __init__(self, group=None, device: torch.device = torch.device("cpu")):
        if not dist.is_initialized():
            raise LightGBMError("collectives need a process group "
                                "(parallel.network.Network.init)")
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self.device = torch.device(device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise LightGBMError("an NCCL group moves CUDA tensors only")
        # gloo with CUDA tensors: through pinned host buffers
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self._pinned: Dict[Tuple, List[torch.Tensor]] = {}
        self.calls = 0
        self.bytes_sent = 0

    # -- transport --------------------------------------------------------
    def _host(self, key: Tuple, shape, dtype, k: int) -> List[torch.Tensor]:
        """``k`` pinned host buffers of ``shape``, kept by ``key``."""
        bufs = self._pinned.get(key)
        if bufs is None:
            bufs = [torch.empty(shape, dtype=dtype, pin_memory=True)
                    for _ in range(k)]
            self._pinned[key] = bufs
        return bufs

    def _run(self, what: str, fn) -> None:
        try:
            fn()
        except Exception as e:   # noqa: BLE001 - re-raised with context
            raise LightGBMError(
                f"collective {what} failed on rank {self.rank} of "
                f"{self.world} ({self.backend}): {e}") from e

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[W, *t.shape]``: every rank's ``t`` in rank order."""
        t = t.contiguous()
        w = self.world
        self.calls += 1
        self.bytes_sent += t.numel() * t.element_size() * (w - 1)
        if not self.staged:
            outs = [torch.empty_like(t) for _ in range(w)]
            self._run("all_gather",
                      lambda: dist.all_gather(outs, t, group=self.group))
            return torch.stack(outs)
        key = ("ag", tuple(t.shape), t.dtype)
        bufs = self._host(key, t.shape, t.dtype, w + 1)
        src, outs = bufs[0], bufs[1:]
        src.copy_(t)
        self._run("all_gather",
                  lambda: dist.all_gather(outs, src, group=self.group))
        return torch.stack(outs).to(self.device)

    def all_to_all(self, pieces: Sequence[torch.Tensor]) -> torch.Tensor:
        """Send ``pieces[q]`` (one shape) to rank ``q``; ``[W, *shape]``:
        the pieces every rank sent here, in rank order."""
        w = self.world
        pieces = [p.contiguous() for p in pieces]
        shape, dtype = pieces[0].shape, pieces[0].dtype
        self.calls += 1
        self.bytes_sent += pieces[0].numel() * pieces[0].element_size() * (
            w - 1)
        if not self.staged:
            outs = [torch.empty_like(pieces[0]) for _ in range(w)]
            self._run("all_to_all", lambda: self._exchange(outs, pieces))
            return torch.stack(outs)
        key = ("a2a", tuple(shape), dtype)
        bufs = self._host(key, shape, dtype, 2 * w)
        ins, outs = bufs[:w], bufs[w:]
        for b, p in zip(ins, pieces):
            b.copy_(p)
        self._run("all_to_all", lambda: self._exchange(outs, ins))
        return torch.stack(outs).to(self.device)

    def _exchange(self, outs, ins) -> None:
        """``outs[q]`` = what rank ``q`` sends here, ``ins[q]`` goes to
        rank ``q``: NCCL's ``all_to_all``; under gloo, which not every
        build gives ``alltoall``, one send and one receive a peer pair,
        all in flight at once (the same bytes)."""
        if self.backend == "nccl":
            dist.all_to_all(outs, ins, group=self.group)
            return
        glob = ((lambda q: q) if self.group is None
                else (lambda q: dist.get_global_rank(self.group, q)))
        reqs = []
        for q in range(self.world):
            if q == self.rank:
                outs[q].copy_(ins[q])
                continue
            reqs.append(dist.isend(ins[q], dst=glob(q), group=self.group))
            reqs.append(dist.irecv(outs[q], src=glob(q), group=self.group))
        for r in reqs:
            r.wait()

    # -- fixed-order reductions --------------------------------------------
    @staticmethod
    def sum_in_rank_order(parts: torch.Tensor) -> torch.Tensor:
        """``parts[0] + parts[1] + ...`` left to right, one rounding an
        add, whatever the device."""
        acc = parts[0].clone()
        for r in range(1, parts.shape[0]):
            acc = acc + parts[r]
        return acc

    def allreduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of ``t``, added in rank order."""
        if self.world == 1:
            return t.clone()
        return self.sum_in_rank_order(self.all_gather(t))

    def chunks(self, f: int) -> List[Tuple[int, int]]:
        return feature_chunks(f, self.world)

    def _pieces(self, h: torch.Tensor) -> List[torch.Tensor]:
        """``h`` [F, ...] cut into the ranks' feature chunks, each padded
        with zeros to the widest."""
        cs = self.chunks(h.shape[0])
        width = max(hi - lo for lo, hi in cs)
        out = []
        for lo, hi in cs:
            p = h.new_zeros((width,) + tuple(h.shape[1:]))
            p[:hi - lo] = h[lo:hi]
            out.append(p)
        return out

    def reduce_scatter(self, h: torch.Tensor) -> torch.Tensor:
        """This rank's feature chunk of the sum over ranks of ``h`` [F,
        ...], added in rank order (``all_to_all`` of the chunks)."""
        lo, hi = self.chunks(h.shape[0])[self.rank]
        if self.world == 1:
            return h[lo:hi].clone()
        got = self.all_to_all(self._pieces(h))
        return self.sum_in_rank_order(got)[:hi - lo]

    def gather_chunks(self, mine: torch.Tensor, f: int) -> torch.Tensor:
        """``[F, ...]`` from every rank's chunk ``mine`` (its rows of
        :meth:`chunks` ``(f)``)."""
        cs = self.chunks(f)
        width = max(hi - lo for lo, hi in cs)
        p = mine.new_zeros((width,) + tuple(mine.shape[1:]))
        p[:mine.shape[0]] = mine
        got = self.all_gather(p) if self.world > 1 else p[None]
        return torch.cat([got[r, :hi - lo] for r, (lo, hi) in enumerate(cs)])

    def full_merge(self, h: torch.Tensor) -> torch.Tensor:
        """The whole merged ``[F, ...]``: :meth:`reduce_scatter`, then
        :meth:`gather_chunks`, so its bits are the reduce-scatter's."""
        return self.gather_chunks(self.reduce_scatter(h), h.shape[0])

    def gather_rows(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """``[..., n]`` from every rank's row block ``local`` [..., n_r]
        (``mesh.row_block``), in rank order."""
        per = -(-int(n) // self.world)
        pad = local.new_zeros(tuple(local.shape[:-1]) + (per,))
        pad[..., :local.shape[-1]] = local
        got = self.all_gather(pad)
        return torch.cat(list(got.unbind(0)), dim=-1)[..., :n]

    def elect(self, rows: torch.Tensor) -> torch.Tensor:
        """The global best of each of the ``[k, 10]`` best-split rows
        (feature indices already global): the largest selection key of
        the gain over ranks, ties to the lowest rank."""
        if self.world == 1:
            return rows
        got = self.all_gather(rows)                 # [W, k, 10]
        best = got[0]
        key = selection_key(best[:, _BG])
        for r in range(1, self.world):
            kr = selection_key(got[r, :, _BG])
            better = kr > key
            best = torch.where(better[:, None], got[r], best)
            key = torch.where(better, kr, key)
        return best

    def counts(self, nleft: torch.Tensor, cnt: int) -> torch.Tensor:
        """``(nl_g, cnt_g)``, i32 [2] on the device: the left child's and
        the leaf's rows summed over ranks (one collective)."""
        loc = torch.cat([nleft.to(torch.int32).reshape(1),
                         nleft.new_full((1,), int(cnt), dtype=torch.int32)])
        if self.world == 1:
            return loc
        return self.all_gather(loc).sum(dim=0, dtype=torch.int32)

