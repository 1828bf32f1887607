"""Learning-to-rank objectives: LambdaRank (NDCG) and XE-NDCG.

Counterpart of ``lightgbm_tpu/objective/rank.py`` (reference
rank_objective.hpp).  Queries are padded to ``[Q, G]`` on the host once
(:func:`pad_queries`); the pairwise lambda matrix ``[G, G]`` of each
query is computed densely on the device, the queries sorted by size
and taken in batches padded to their largest (``G``) of at most
``PAIR_BUDGET`` pair elements (:func:`size_batches`), so memory stays
``batch * G**2``.

Each pair term and each sum is taken in f64 and the results rounded to
f32 once, and every sum over a query adds its terms in one fixed order
(:func:`ordered_sum`: chunks of 32 by halves, then the chunks left to
right, so zeros padded past a query add exact zeros), so the CPU and
the card
compute the same bits and a query's result does not depend on its
batch.  The per-query gradients go back to the rows with one
``index_add_`` over the valid entries (each row is one entry), the row
weights multiplied after, as in the JAX package.

Semantics kept: label gains ``2^l - 1`` (or ``label_gain``), position
discount ``1/log2(2 + rank)`` over a stable descending sort of the
scores, pair truncation at ``lambdarank_truncation_level`` (a pair
counts when its better-ranked document ranks above the level), delta
NDCG normalised by the query's max DCG at the level, and under
``lambdarank_norm`` the score-distance regularisation and the
``log2(1 + sum)`` renormalisation of the lambdas.  XE-NDCG draws its
noise from ``jax.random.uniform(PRNGKey(objective_seed + it), [Q, G])``
(``utils/random.uniform`` over ``Q * G``: the partitionable threefry
draws element ``(q, g)`` from counter ``q * G + g``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils import log
from ..utils.random import prng_key, uniform
from .base import ObjectiveFunction

# elements of one [B, G, G] pair tensor of a lambdarank batch
PAIR_BUDGET = 1 << 24
# the width a query sum adds by halving; a batch pads its queries to a
# whole number of chunks
CHUNK = 32


def pad_queries(qb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Query boundaries ``[Q + 1]`` -> (document index ``[Q, G]`` int32,
    0 in the padding, and validity ``[Q, G]`` bool), ``G`` the largest
    query (the JAX package's ``_pad_queries``)."""
    qb = np.asarray(qb, np.int64)
    sizes = np.diff(qb)
    col = np.arange(int(sizes.max()))
    valid = col[None, :] < sizes[:, None]
    idx = np.where(valid, qb[:-1, None] + col[None, :], 0)
    return idx.astype(np.int32), valid


def ordered_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The sum over ``dim`` in one order on every device: the axis in
    chunks of ``CHUNK`` (zeros padded to a whole chunk), each chunk
    summed by adding its halves pairwise, the chunks' sums added left to
    right.  Zeros past the data add exact zeros, so the sum of a query
    does not depend on how far its batch is padded."""
    dim = dim % x.dim()
    n = x.shape[dim]
    if n % CHUNK:
        x = torch.nn.functional.pad(
            x, [0, 0] * (x.dim() - 1 - dim) + [0, CHUNK - n % CHUNK])
    x = x.unflatten(dim, (x.shape[dim] // CHUNK, CHUNK))
    w = CHUNK
    while w > 1:
        w //= 2
        x = x.narrow(dim + 1, 0, w) + x.narrow(dim + 1, w, w)
    x = x.squeeze(dim + 1)
    out = x.select(dim, 0)
    for c in range(1, x.shape[dim]):
        out = out + x.select(dim, c)
    return out


def lambdarank_grads(s: torch.Tensor, lab: torch.Tensor, gain: torch.Tensor,
                     valid: torch.Tensor, *, sigmoid: float, trunc: int,
                     norm: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """LambdaRank gradients of a batch of padded queries (JAX
    ``LambdarankNDCG.get_gradients``' ``one_query``): ``s`` f32 [B, G]
    scores, ``lab`` [B, G] labels, ``gain`` f64 [B, G] label gains times
    the query's inverse max DCG at the truncation level, ``valid`` bool
    [B, G].  Returns f32 (lambda, hessian) [B, G], 0 in the padding."""
    f64 = torch.float64
    g = s.shape[1]
    order = torch.sort(torch.where(valid, -s, torch.inf), dim=1,
                       stable=True).indices                  # rank -> doc
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(g, device=s.device).expand_as(order))
    disc = torch.where(valid, 1.0 / torch.log2(2.0 + rank.to(f64)), 0.0)
    sd = torch.where(valid, s.to(f64), 0.0)
    # ordered pair (a: the higher label, b: the lower), both valid, the
    # better ranked of the two above the truncation level
    top = rank < trunc
    ok = ((torch.where(valid, lab, -torch.inf)[:, :, None]
           > torch.where(valid, lab, torch.inf)[:, None, :])
          & (top[:, :, None] | top[:, None, :]))
    ds = sd[:, :, None] - sd[:, None, :]
    delta = torch.where(ok, (gain[:, :, None] - gain[:, None, :])
                        * (disc[:, :, None] - disc[:, None, :]).abs(), 0.0)
    if norm:
        flat = (torch.where(valid, sd, -torch.inf).amax(dim=1)
                == torch.where(valid, sd, torch.inf).amin(dim=1))
        delta = torch.where(flat[:, None, None], delta,
                            delta / (0.01 + ds.abs()))
    sig = torch.reciprocal(1.0 + torch.exp(sigmoid * ds))
    lam_p = (-sigmoid) * delta * sig                 # 0 off the pairs
    hes_p = lam_p * (-sigmoid) * (1.0 - sig)
    lam = ordered_sum(lam_p) - ordered_sum(lam_p, 1)
    hes = ordered_sum(hes_p) + ordered_sum(hes_p, 1)
    if norm:
        total = -2.0 * ordered_sum(ordered_sum(lam_p))
        factor = torch.where(total > 0,
                             torch.log2(1.0 + total) / total.clamp(min=1e-20),
                             1.0)
        lam = lam * factor[:, None]
        hes = hes * factor[:, None]
    return lam.to(torch.float32), hes.to(torch.float32)


def size_batches(sizes: np.ndarray, budget: int) -> list:
    """``(lo, hi, G)`` batches of queries sorted by ascending size, ``G``
    the batch's largest rounded up to a whole ``CHUNK``: consecutive
    queries while ``(hi - lo) * G**2`` stays within ``budget``, at least
    one a batch."""
    def width(size):
        return -(-max(int(size), 1) // CHUNK) * CHUNK
    out, lo, q = [], 0, len(sizes)
    while lo < q:
        hi = lo + 1
        while hi < q and (hi + 1 - lo) * width(sizes[hi]) ** 2 <= budget:
            hi += 1
        out.append((lo, hi, width(sizes[hi - 1])))
        lo = hi
    return out


def xendcg_grads(s: torch.Tensor, lab: torch.Tensor, u: torch.Tensor,
                 valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """XE-NDCG gradients of padded queries (JAX ``RankXENDCG.
    get_gradients``; reference rank_objective.hpp:330, its third-order
    approximation): ``s`` f32 [Q, G] scores (-inf in the padding),
    ``lab`` f64 [Q, G] labels, ``u`` f32 [Q, G] uniform noise.  A query
    of one document gets zeros.  Returns f32 (lambda, hessian)."""
    sd = s.to(torch.float64)
    top = torch.where(valid, sd, -torch.inf).amax(dim=1, keepdim=True)
    e = torch.where(valid, torch.exp(sd - top), 0.0)
    rho = torch.where(valid, e / ordered_sum(e)[:, None], 0.0)
    phi = torch.where(valid, torch.exp2(lab) - u.to(torch.float64), 0.0)
    inv_den = 1.0 / ordered_sum(phi).clamp(min=1e-15)[:, None]
    one_m_rho = (1.0 - rho).clamp(min=1e-15)
    t1 = -phi * inv_den + rho
    p1 = torch.where(valid, t1 / one_m_rho, 0.0)
    t2 = rho * (ordered_sum(p1)[:, None] - p1)
    p2 = torch.where(valid, t2 / one_m_rho, 0.0)
    lam = t1 + t2 + rho * (ordered_sum(p2)[:, None] - p2)
    hes = rho * (1.0 - rho)
    keep = (valid.sum(dim=1, keepdim=True) > 1) & valid
    return (torch.where(keep, lam, 0.0).to(torch.float32),
            torch.where(keep, hes, 0.0).to(torch.float32))


class RankingObjective(ObjectiveFunction):
    """Query padding and the scatter back to rows."""

    def init(self, metadata, num_data: int, device: torch.device) -> None:
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            log.fatal("Ranking tasks require query information")
        self._qb = np.asarray(metadata.query_boundaries, np.int64)
        idx, valid = pad_queries(self._qb)
        self.num_queries = len(self._qb) - 1
        self._idx_np, self._valid_np = idx, valid
        self._doc_idx = torch.as_tensor(idx.astype(np.int64), device=device)
        self._doc_valid = torch.as_tensor(valid, device=device)
        # each valid entry's position in the flat [Q * G] and its row
        self._entries = torch.as_tensor(np.flatnonzero(valid), device=device)
        self._entry_rows = torch.as_tensor(idx[valid].astype(np.int64),
                                           device=device)

    def _padded_scores(self, score: torch.Tensor) -> torch.Tensor:
        """f32 [Q, G] scores of the queries' documents, -inf in the
        padding."""
        return torch.where(self._doc_valid, score[self._doc_idx],
                           -torch.inf)

    def _scatter_back(self, lam_q: torch.Tensor, hess_q: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[Q, G] per-query gradients -> [n] per-row, times the row
        weights."""
        n = self.num_data

        def back(v):
            return torch.zeros(n, dtype=torch.float32,
                               device=v.device).index_add_(
                0, self._entry_rows, v.reshape(-1)[self._entries])
        lam, hes = back(lam_q), back(hess_q)
        return self._apply_weight(lam, hes)


class LambdarankNDCG(RankingObjective):
    NAME = "lambdarank"

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = config.sigmoid
        if self.sigmoid <= 0:
            log.fatal("Sigmoid param %f should be greater than zero",
                      self.sigmoid)
        self.norm = config.lambdarank_norm
        self.trunc = config.lambdarank_truncation_level

    def init(self, metadata, num_data: int, device: torch.device) -> None:
        super().init(metadata, num_data, device)
        label = self.label_np
        max_label = int(label.max())
        gains = self.config.label_gain
        if not gains:
            gains = [float((1 << i) - 1) for i in range(max(max_label + 1,
                                                            2))]
        if max_label >= len(gains):
            log.fatal("Label %d exceeds label_gain size %d", max_label,
                      len(gains))
        gains = np.asarray(gains, np.float64)
        # each query's inverse max DCG at the truncation level (host, once)
        inv = np.zeros(self.num_queries, np.float64)
        for i in range(self.num_queries):
            lab = label[self._qb[i]:self._qb[i + 1]]
            top = np.sort(lab)[::-1][:self.trunc]
            dcg = np.sum(gains[top.astype(np.int64)]
                         / np.log2(np.arange(len(top)) + 2.0))
            inv[i] = 1.0 / dcg if dcg > 0 else 0.0
        # the queries by ascending size, so a batch pads to its largest
        sizes = np.diff(self._qb)
        order = np.argsort(sizes, kind="stable")
        g = self._valid_np.shape[1]
        self._width = -(-g // CHUNK) * CHUNK
        pad = ((0, 0), (0, self._width - g))
        valid = np.pad(self._valid_np[order], pad)
        lab_q = np.pad(label[self._idx_np[order]], pad)
        self._order = torch.as_tensor(order, device=device)
        self._sorted_sizes = sizes[order]
        self._label_q = torch.as_tensor(lab_q, dtype=torch.float32,
                                        device=device)
        self._gain_q = torch.as_tensor(
            np.where(valid, gains[lab_q.astype(np.int64)]
                     * inv[order][:, None], 0.0), device=device)
        self._rank_valid = torch.as_tensor(valid, device=device)
        self.plan(PAIR_BUDGET)

    def plan(self, budget: int) -> None:
        """Batch the queries so a batch's pair tensors hold at most
        ``budget`` elements (a query's result does not depend on it)."""
        self.batches = size_batches(self._sorted_sizes, budget)

    def query_gradients(self, score: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """f32 [Q, G] (lambda, hessian) at the scores ``score`` [n]."""
        s = self._padded_scores(score)
        g = s.shape[1]
        s = torch.nn.functional.pad(s[self._order], (0, self._width - g))
        lam = torch.zeros_like(s)
        hes = torch.zeros_like(s)
        for lo, hi, w in self.batches:
            lam[lo:hi, :w], hes[lo:hi, :w] = lambdarank_grads(
                s[lo:hi, :w], self._label_q[lo:hi, :w],
                self._gain_q[lo:hi, :w], self._rank_valid[lo:hi, :w],
                sigmoid=self.sigmoid, trunc=self.trunc, norm=self.norm)
        out = (torch.empty_like(lam[:, :g]), torch.empty_like(hes[:, :g]))
        out[0][self._order] = lam[:, :g]
        out[1][self._order] = hes[:, :g]
        return out

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._scatter_back(*self.query_gradients(score))


class RankXENDCG(RankingObjective):
    NAME = "rank_xendcg"

    def init(self, metadata, num_data: int, device: torch.device) -> None:
        super().init(metadata, num_data, device)
        self._label_q = torch.as_tensor(
            np.where(self._valid_np, self.label_np[self._idx_np], 0.0),
            dtype=torch.float64, device=device)
        self._iteration = 0

    def noise(self, it: int) -> torch.Tensor:
        """Iteration ``it``'s f32 [Q, G] uniform draw."""
        q, g = self._valid_np.shape
        key = prng_key(self.config.objective_seed + it)
        return uniform(key, q * g, self.device).reshape(q, g)

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        u = self.noise(self._iteration)
        self._iteration += 1
        lam, hes = xendcg_grads(self._padded_scores(score), self._label_q, u,
                                self._doc_valid)
        return self._scatter_back(lam, hes)
