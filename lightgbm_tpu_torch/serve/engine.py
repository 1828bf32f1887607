"""ServingEngine: bucketed dispatch through the traversal kernel's raw
entry (the quantizer runs inside the kernel), a per-bucket score-buffer
pool the kernel writes into in place, and an
async dispatch queue.

Batch sizes round up to power-of-two row buckets between the
``LGBM_TPU_SERVE_BUCKETS`` floor and cap, as in the JAX engine, so a
traffic mix of novel batch sizes reuses a few buffer shapes; batches
above the cap chunk.  PyTorch keeps no trace cache, so
``stats()["programs"]`` counts the buckets seen.  Each bucket keeps a
small pool of ``[bucket, K]`` f32 buffers: a dispatch takes one, the
kernel writes the scores into it, and ``collect`` copies the live rows
out and returns it to the pool, so steady-state dispatches allocate no
score buffers.  The device is chosen once, from the ``device``
argument: on CUDA every dispatch launches the kernel, on the CPU it
runs the kernel's plain version.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import env_knob
from ..ops.serve_kernel import serve_traverse_raw
from ..utils.device import resolve_device
from ..utils.log import LightGBMError
from . import flight
from .model import ServingModel


def bucket_policy() -> Tuple[int, int]:
    """(floor, cap) row buckets from ``LGBM_TPU_SERVE_BUCKETS``."""
    spec = env_knob("LGBM_TPU_SERVE_BUCKETS")
    try:
        lo_s, hi_s = spec.split(":")
        lo, hi = int(lo_s), int(hi_s)
        if lo < 1 or hi < lo:
            raise ValueError
    except ValueError:
        raise LightGBMError(
            f"LGBM_TPU_SERVE_BUCKETS must be FLOOR:CAP (got {spec!r})")
    return lo, hi


def _next_pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 0)


def bucket_for(n: int, lo: int, hi: int) -> int:
    """The power-of-two row bucket a batch of ``n`` rows pads into
    (clamped to [lo, hi]; batches above ``hi`` chunk)."""
    return min(max(_next_pow2(max(n, 1)), lo), hi)


def _queue_depth_knob() -> int:
    try:
        depth = int(env_knob("LGBM_TPU_SERVE_QUEUE"))
    except ValueError:
        raise LightGBMError("LGBM_TPU_SERVE_QUEUE must be an integer")
    return max(depth, 1)


class _Pending:
    """One in-flight bucketed dispatch: ``out`` is the pooled score
    buffer the kernel is writing; ``t_sub`` is the host submit time the
    ServingQueue stamps."""

    __slots__ = ("out", "n", "bucket", "t_sub")

    def __init__(self, out, n: int, bucket: int):
        self.out = out
        self.n = n
        self.bucket = bucket
        self.t_sub: Optional[float] = None


class ServingEngine:
    """Bulk and small-batch scoring over one ServingModel."""

    def __init__(self, model: ServingModel, *,
                 bucket_min: Optional[int] = None,
                 bucket_max: Optional[int] = None, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        lo, hi = bucket_policy()
        self.bucket_min = int(bucket_min or lo)
        self.bucket_max = int(bucket_max or hi)
        if self.bucket_max < self.bucket_min:
            raise LightGBMError("serving bucket cap below floor")
        self._packed = self.model.packed()
        self._pool: Dict[int, List[torch.Tensor]] = {}
        self._buckets: set = set()
        self.dispatches = 0
        self.rows_true = 0
        self.rows_padded = 0
        self.retraces_after_warmup = 0
        self._warm = False

    # ------------------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        return bucket_for(n, self.bucket_min, self.bucket_max)

    def mark_warm(self) -> None:
        """Declare warmup complete: a bucket first seen after this
        counts in ``stats()["retraces_after_warmup"]``."""
        self._warm = True

    def stats(self) -> dict:
        return {
            "buckets": sorted(self._buckets),
            "programs": len(self._buckets),
            "dispatches": self.dispatches,
            "rows_true": self.rows_true,
            "rows_padded": self.rows_padded,
            "retraces_after_warmup": self.retraces_after_warmup,
            "digest": self.model.digest,
            "device": str(self.device),
        }

    # ------------------------------------------------------------------
    def _pad(self, chunk: np.ndarray, bucket: int) -> np.ndarray:
        # width check up front: the column gather would index out of
        # range or score silently wrong on a wrong-width matrix
        if chunk.shape[1] != self.model.n_orig_features:
            raise LightGBMError(
                f"predict input has {chunk.shape[1]} features but the "
                f"compiled model (digest {self.model.digest}) was "
                f"trained on {self.model.n_orig_features}")
        if chunk.shape[0] == bucket:
            return np.ascontiguousarray(chunk, np.float32)
        out = np.zeros((bucket, chunk.shape[1]), np.float32)
        out[:chunk.shape[0]] = chunk
        return out

    def _raw(self, chunk: np.ndarray, bucket: int) -> torch.Tensor:
        """Pad one chunk and move it to the device: the raw entry's
        [bucket, Forig] f32 input."""
        return torch.from_numpy(self._pad(chunk, bucket)).to(self.device)

    def dispatch(self, chunk: np.ndarray) -> _Pending:
        """Submit one bucketed dispatch (rows <= bucket cap); on CUDA it
        returns once the kernel is queued."""
        if self.model.linear:
            raise LightGBMError(
                "ServingModel does not support linear trees (routing rule "
                "predict_linear_tree): a leaves_only model serves "
                "predict_leaves only")
        n = chunk.shape[0]
        bucket = self.bucket_for(n)
        if n > bucket:
            raise LightGBMError(
                f"dispatch of {n} rows exceeds the bucket cap "
                f"{self.bucket_max}; chunk through predict()")
        raw = self._raw(chunk, bucket)
        pool = self._pool.setdefault(bucket, [])
        buf = pool.pop() if pool else torch.empty(
            (bucket, self.model.num_class), dtype=torch.float32,
            device=self.device)
        serve_traverse_raw(self._packed, raw, n, buf)
        if bucket not in self._buckets:
            self._buckets.add(bucket)
            if self._warm:
                self.retraces_after_warmup += 1
        self.dispatches += 1
        self.rows_true += n
        self.rows_padded += bucket
        return _Pending(buf, n, bucket)

    def collect(self, p: _Pending) -> np.ndarray:
        """Wait for one pending dispatch and copy its live rows to the
        host; its buffer returns to the bucket's pool."""
        # a copy on either device: the buffer goes back to the pool
        host = p.out[:p.n].to("cpu", copy=True).numpy()
        self._pool.setdefault(p.bucket, []).append(p.out)
        p.out = None
        return host

    # ------------------------------------------------------------------
    def predict(self, X: np.ndarray, *,
                queue_depth: Optional[int] = None) -> np.ndarray:
        """Bulk scoring: [n, F] raw f32 rows -> [n, K] raw scores.
        Chunks of the bucket cap are kept ``queue_depth`` deep in
        flight (dispatch chunk t+1 while t runs)."""
        X = np.asarray(X, np.float32)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        n = X.shape[0]
        k = self.model.num_class
        if n == 0:
            return np.zeros((0, k), np.float32)
        depth = queue_depth or _queue_depth_knob()
        out = np.empty((n, k), np.float32)
        pending: deque = deque()
        for start in range(0, n, self.bucket_max):
            pending.append(
                (start, self.dispatch(X[start:start + self.bucket_max])))
            while len(pending) > depth:
                s, p = pending.popleft()
                out[s:s + p.n] = self.collect(p)
        while pending:
            s, p = pending.popleft()
            out[s:s + p.n] = self.collect(p)
        return out

    def predict_leaves(self, X: np.ndarray) -> np.ndarray:
        """[n, F] raw rows -> [n, T] leaf indices through the kernel's
        leaves form (the exactness side of the parity checks)."""
        X = np.asarray(X, np.float32)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        n = X.shape[0]
        if n == 0:
            return np.zeros((0, self.model.n_trees), np.int32)
        outs = []
        for start in range(0, n, self.bucket_max):
            chunk = X[start:start + self.bucket_max]
            bucket = self.bucket_for(chunk.shape[0])
            leaf = torch.empty((bucket, self.model.n_trees),
                               dtype=torch.int32, device=self.device)
            serve_traverse_raw(self._packed, self._raw(chunk, bucket),
                               chunk.shape[0], leaf, leaves=True)
            outs.append(leaf[:chunk.shape[0]].cpu().numpy())
        return np.concatenate(outs, axis=0)


class ServingQueue:
    """Async dispatch for the small-batch latency path: ``submit``
    returns once the batch is queued, until ``depth`` batches are in
    flight; ``result`` hands batches back in submission order.  The
    submit-to-completion latency is recorded per bucket in mergeable
    log-bucketed histograms."""

    def __init__(self, engine: ServingEngine,
                 depth: Optional[int] = None):
        if engine.model.linear:
            raise LightGBMError(
                "ServingModel does not support linear trees (routing rule "
                "predict_linear_tree)")
        self.engine = engine
        self.depth = int(depth or _queue_depth_knob())
        self._inflight: deque = deque()
        self._results: deque = deque()
        self._submitted = 0
        self._lat: Dict[int, flight.LatencyHistogram] = {}

    def submit(self, X: np.ndarray) -> int:
        """Queue one small batch; returns its ticket (the 0-based
        submission index).  Blocks only when ``depth`` batches are
        already in flight."""
        while len(self._inflight) >= self.depth:
            self._results.append(self._complete())
        X = np.asarray(X, np.float32)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        t0 = time.perf_counter()
        p = self.engine.dispatch(X)
        p.t_sub = t0
        self._inflight.append(p)
        ticket = self._submitted
        self._submitted += 1
        return ticket

    def _complete(self) -> np.ndarray:
        p = self._inflight.popleft()
        bucket, t0 = p.bucket, p.t_sub
        host = self.engine.collect(p)
        if t0 is not None:
            h = self._lat.get(bucket)
            if h is None:
                h = self._lat[bucket] = flight.LatencyHistogram()
            h.add(time.perf_counter() - t0)
        return host

    def latency_percentiles(self, qs=(50.0, 99.0, 99.9)) -> dict:
        """Percentiles in milliseconds derived from the merged
        per-bucket histograms, plus the drained count."""
        merged = flight.LatencyHistogram()
        for h in self._lat.values():
            merged.merge(h)
        out = {"p" + format(q, "g").replace(".", "") + "_ms":
               round(merged.percentile_s(q) * 1e3, 4) for q in qs}
        out["count"] = merged.count
        return out

    def result(self) -> np.ndarray:
        """Scores of the oldest submitted batch (FIFO)."""
        if self._results:
            return self._results.popleft()
        if not self._inflight:
            raise LightGBMError("ServingQueue.result() with nothing "
                                "in flight")
        return self._complete()

    def drain(self) -> List[np.ndarray]:
        out = []
        while self._results:
            out.append(self._results.popleft())
        while self._inflight:
            out.append(self._complete())
        return out
