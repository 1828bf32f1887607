"""Numerical guardrails: opt-in NaN / Inf sentinels on the grow path
(counterpart of ``lightgbm_tpu/resilience/numerics.py``).

A flipped bit, a diverging custom objective or an overflowing histogram
poisons every later tree silently: NaN gradients give NaN gains, the
argmax picks garbage, and the booster keeps appending trees that predict
NaN.  The sentinels are opt-in, because they either change the grower's
inputs (``clamp``) or add one host read a tree (``raise`` / ``skip``).

Policies (``LGBM_TPU_NUMERICS``):

* ``off``   — the default: no guard is built, the grower is the one a
  build without numerics has, and it launches the same kernels;
* ``raise`` — a non-finite value in grad / hess or in the grown tree's
  leaf values / split gains raises :class:`NumericalFault`, which the
  engine classifies as ``nan_gradients`` and, with checkpointing on,
  recovers from the last snapshot;
* ``skip``  — the poisoned tree is dropped (a zero stump keeps the model
  list aligned) and training goes on;
* ``clamp`` — grad / hess are sanitized (NaN -> 0, +-Inf -> +-1e30,
  magnitudes clamped) before the grow.  The stream route keeps its
  gradients in the row matrix, so ``clamp`` has nothing to sanitize
  there and the grower refuses the combination loudly.

Wiring: the serial growers are wrapped by ``ops.grow.NumericsGuard``;
the parallel learners' grads are guarded at the booster boundary
(:func:`host_guard`).
"""
from __future__ import annotations

import torch

from ..config import env_knob

NUMERICS_ENV = "LGBM_TPU_NUMERICS"
POLICIES = ("off", "raise", "skip", "clamp")

CLAMP_LIMIT = 1e30


def policy(environ=None) -> str:
    """The engaged policy; raises ValueError on an unknown value (a
    mistyped policy training unguarded is the failure this module
    exists to prevent)."""
    val = env_knob(NUMERICS_ENV, environ).strip().lower()
    if val not in POLICIES:
        raise ValueError(
            f"{NUMERICS_ENV}={val!r} is not a valid policy; expected "
            f"one of {POLICIES}")
    return val


class NumericalFault(RuntimeError):
    """Non-finite values found by a sentinel under ``raise``; carries
    where, the iteration and the count for the fault report."""

    def __init__(self, where: str, iteration: int, count: int):
        self.where = where
        self.iteration = int(iteration)
        self.count = int(count)
        super().__init__(
            f"numerics sentinel: {count} non-finite value(s) in "
            f"{where} at iteration {iteration} ({NUMERICS_ENV}=raise)")


class NumericsSkip(Exception):
    """Control flow of ``skip``: the current tree is poisoned and is
    dropped (the booster appends a zero stump)."""

    def __init__(self, where: str, iteration: int, count: int):
        self.where = where
        self.iteration = int(iteration)
        self.count = int(count)
        super().__init__(f"skip {where}@{iteration} ({count} bad)")


def sanitize(grad: torch.Tensor, hess: torch.Tensor):
    """(grad, hess) with NaN -> 0, +-Inf -> +-CLAMP_LIMIT, magnitudes
    clamped to CLAMP_LIMIT; elementwise, new tensors."""
    def f(a):
        return torch.nan_to_num(a, nan=0.0, posinf=CLAMP_LIMIT,
                                neginf=-CLAMP_LIMIT).clamp(-CLAMP_LIMIT,
                                                           CLAMP_LIMIT)
    return f(grad), f(hess)


def count_bad(*arrays: torch.Tensor) -> torch.Tensor:
    """The non-finite values of ``arrays`` (tensors on one device), as
    an i64 scalar on that device: the caller decides when to read it."""
    total = None
    for a in arrays:
        c = (~torch.isfinite(a)).sum()
        total = c if total is None else total + c
    return total


def host_guard(grad: torch.Tensor, hess: torch.Tensor, pol: str,
               iteration: int):
    """The booster-boundary guard for paths without a grower sentinel
    (the parallel learners): ``clamp`` sanitizes, ``raise`` / ``skip``
    read one scalar and raise on a non-finite input."""
    if pol == "off":
        return grad, hess
    if pol == "clamp":
        return sanitize(grad, hess)
    bad = int(count_bad(grad, hess))
    if bad:
        if pol == "raise":
            raise NumericalFault("grad/hess", iteration, bad)
        raise NumericsSkip("grad/hess", iteration, bad)
    return grad, hess
