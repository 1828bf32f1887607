"""Fault injection and the engine boundary's fault classification
(counterpart of ``lightgbm_tpu/resilience/faults.py``, schema
``lightgbm_tpu/faultreport/v1``).

* **injection** — ``LGBM_TPU_FAULT=<class>@<iteration>`` fires one
  synthetic fault a process at that boosting iteration:

  - ``death`` — ``SIGKILL`` of the process from inside
    ``Booster.update``: only the checkpoint directory survives;
  - ``nan``   — NaN in the first two rows' gradients and hessians, where
    the booster computes them (:func:`maybe_poison`); the numerics
    sentinels are the detection side.  The stream route keeps its
    gradients in the row matrix, so there the drill cannot fire and says
    so (:func:`warn_unfireable_nan`);
  - ``oom``   — a simulated allocation failure whose message reads like
    the device's out-of-memory error;
  - ``hang``  — a simulated collective timeout (a short sleep, then a
    ``DEADLINE_EXCEEDED`` error);

* **classification and recovery** — ``engine.train`` routes every
  exception through :func:`handle_training_fault`: the fault is
  classified by an ordered table (first match wins), recorded as a
  ``faultreport/v1`` report, and either recovered (resume from the last
  checkpoint after a bounded backoff, ``LGBM_TPU_FAULT_RETRIES``) or
  raised as :class:`FaultError` carrying the report.
"""
from __future__ import annotations

import collections
import os
import signal
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..config import env_knob
from ..utils import log
from . import checkpoint as _ckpt  # the cycle resolves at call time
from . import findings as F
from .numerics import NumericalFault

FAULTREPORT_SCHEMA = "lightgbm_tpu/faultreport/v1"
FAULT_ENV = "LGBM_TPU_FAULT"
RETRIES_ENV = "LGBM_TPU_FAULT_RETRIES"
FAULT_CLASSES = ("death", "nan", "oom", "hang")

# transient classes: resume from the last checkpoint and retry.
# checkpoint_corrupt and resume_refused carry their own exit-2 contract
# (checkpoint.py); death never reaches an except clause: recovery is the
# next process resuming from the checkpoint directory
RECOVERABLE = ("nan_gradients", "resource_exhausted", "collective_timeout")


class SimulatedResourceExhausted(RuntimeError):
    """Injected stand-in for an out-of-memory allocation failure."""


class SimulatedCollectiveTimeout(RuntimeError):
    """Injected stand-in for a collective timeout."""


class FaultError(Exception):
    """A classified training fault that was not recovered; carries the
    faultreport/v1 dict, and the command-line layers exit with
    ``exit_code``."""

    def __init__(self, report: Dict[str, Any], exit_code: int = 1):
        self.report = report
        self.exit_code = exit_code
        f = report.get("finding", {})
        super().__init__(f.get("message", "training fault"))


# events of the run (numerics_skip, fault_<class>, ckpt_save,
# ckpt_resume), counted for tests and the demo
EVENTS: collections.Counter = collections.Counter()


def record(name: str) -> None:
    EVENTS[name] += 1


# ---------------------------------------------------------------------
# injection
# ---------------------------------------------------------------------
_FIRED: set = set()
_cached_val: Optional[str] = None
_cached_spec: Optional[Tuple[str, int]] = None


def parse_spec(val: str) -> Optional[Tuple[str, int]]:
    """``"<class>@<iteration>"`` -> (class, iteration), None for off or
    empty; ValueError on anything malformed (a mistyped spec that never
    fires would fake a passing drill)."""
    val = (val or "").strip()
    if val.lower() in ("", "off", "0"):
        return None
    if "@" not in val:
        raise ValueError(
            f"{FAULT_ENV}={val!r}: expected <class>@<iteration> with "
            f"class in {FAULT_CLASSES}")
    cls, _, at = val.partition("@")
    cls = cls.strip().lower()
    if cls not in FAULT_CLASSES:
        raise ValueError(
            f"{FAULT_ENV}: unknown fault class {cls!r} (known: "
            f"{FAULT_CLASSES})")
    try:
        it = int(at)
    except ValueError:
        raise ValueError(f"{FAULT_ENV}: iteration {at!r} is not an integer")
    if it < 0:
        raise ValueError(f"{FAULT_ENV}: iteration must be >= 0")
    return cls, it


def _spec() -> Optional[Tuple[str, int]]:
    global _cached_val, _cached_spec
    val = env_knob(FAULT_ENV)
    if val != _cached_val:
        _cached_spec = parse_spec(val)
        _cached_val = val
    return _cached_spec


def rearm() -> None:
    """Forget which specs fired in this process (each fires once a
    process; tests and the demo arm a fresh drill with this)."""
    _FIRED.clear()


def _take(cls_wanted, iteration: int) -> bool:
    """Whether the armed spec is of a class in ``cls_wanted`` at
    ``iteration`` and has not fired yet; marks it fired."""
    sp = _spec()
    if sp is None or sp[0] not in cls_wanted or iteration != sp[1]:
        return False
    key = (_cached_val, "fire")
    if key in _FIRED:
        return False
    _FIRED.add(key)
    return True


def maybe_fire(iteration: int) -> None:
    """Fire the armed fault when ``iteration`` matches (once a process).
    Called from ``Booster.update``, the boundary every training loop
    goes through.  ``nan`` does not fire here (:func:`maybe_poison`)."""
    if not _take(("death", "oom", "hang"), iteration):
        return
    cls = _cached_spec[0]
    if cls == "death":
        log.warning("fault injection: SIGKILL at iteration %d", iteration)
        os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(30)   # the signal lands first
    if cls == "oom":
        raise SimulatedResourceExhausted(
            f"RESOURCE_EXHAUSTED: out of memory while allocating device "
            f"buffer at iteration {iteration} (injected by "
            f"{FAULT_ENV}={_cached_val})")
    time.sleep(0.05)   # the bounded stand-in for the stall
    raise SimulatedCollectiveTimeout(
        f"DEADLINE_EXCEEDED: collective all-reduce timed out waiting for "
        f"a straggler shard at iteration {iteration} (injected by "
        f"{FAULT_ENV}={_cached_val})")


def maybe_poison(grad: torch.Tensor, hess: torch.Tensor, iteration: int):
    """NaN in the first two rows of ``grad`` / ``hess`` ([K, n]) when
    the armed fault is ``nan@iteration`` (once a process); the inputs
    are not changed, new tensors come back."""
    if not _take(("nan",), iteration):
        return grad, hess
    log.warning("fault injection: NaN-poisoning gradients at iteration %d",
                iteration)
    grad, hess = grad.clone(), hess.clone()
    grad[..., :2] = float("nan")
    hess[..., :2] = float("nan")
    return grad, hess


def warn_unfireable_nan(iteration: int) -> None:
    """On the stream route an armed ``nan@iteration`` cannot fire (the
    gradients are refreshed in the row matrix and never handed in): mark
    it fired and say so, so that a drill never passes silently."""
    if not _take(("nan",), iteration):
        return
    log.warning(
        "fault injection: %s=%s is armed but CANNOT fire on the "
        "score-resident streaming path — gradients are never handed to "
        "the grower (set LGBM_TPU_STREAM=0 to drill the nan class)",
        FAULT_ENV, _cached_val)


def max_retries() -> int:
    try:
        return max(int(env_knob(RETRIES_ENV)), 0)
    except ValueError:
        raise ValueError(f"{RETRIES_ENV} must be an integer")


# ---------------------------------------------------------------------
# classification (ordered, first match wins)
# ---------------------------------------------------------------------
def classify(exc: BaseException) -> Optional[str]:
    """The fault class of ``exc``, None for an exception no class
    matches (a plain bug, which propagates untouched)."""
    if isinstance(exc, NumericalFault):
        return "nan_gradients"
    if isinstance(exc, _ckpt.CheckpointError):
        return "checkpoint_corrupt"
    if isinstance(exc, _ckpt.ResumeRefused):
        return "resume_refused"
    if isinstance(exc, (torch.cuda.OutOfMemoryError,
                        SimulatedResourceExhausted)):
        return "resource_exhausted"
    text = f"{type(exc).__name__}: {exc}".lower()
    # narrow patterns: a deterministic bug whose message merely mentions
    # a collective stays unclassified and propagates
    ordered = (
        ("resource_exhausted", ("resource_exhausted", "out of memory")),
        ("collective_timeout", ("deadline_exceeded", "collective timed out",
                                "collective operation timed out",
                                "all-reduce timed out",
                                "all-gather timed out",
                                "barrier timed out")),
    )
    for cls, patterns in ordered:
        if any(p in text for p in patterns):
            return cls
    return None


def fault_report(cls: str, *, iteration: int, error: str, recovered: bool,
                 attempt: int = 0) -> Dict[str, Any]:
    """One faultreport/v1 report, its finding in the shared shape."""
    sev = "warning" if recovered else "error"
    return {
        "schema": FAULTREPORT_SCHEMA,
        "class": cls,
        "iteration": int(iteration),
        "recovered": bool(recovered),
        "attempt": int(attempt),
        "finding": F.make_finding(
            "fault", f"FAULT_{cls.upper()}",
            f"training fault at iteration {iteration}: {cls} "
            f"({error[:200]})"
            + (" — recovered from checkpoint" if recovered
               else " — NOT recovered"),
            severity=sev, fault_class=cls, iteration=int(iteration)),
    }


RUN_REPORTS: List[Dict[str, Any]] = []


def reset_run() -> None:
    """Clear the run's reports (``engine.train`` calls it at the start;
    the fired marks survive: a retry must not fire again the fault it
    recovers from)."""
    RUN_REPORTS.clear()


def run_reports() -> List[Dict[str, Any]]:
    return list(RUN_REPORTS)


def handle_training_fault(exc: Exception, *, iteration: int,
                          ckpt_dir: Optional[str], attempt: int,
                          retries: int,
                          state_ok: bool = True) -> Dict[str, Any]:
    """The engine boundary's policy: classify ``exc``, record its report,
    and either return (the caller resumes from the last checkpoint and
    retries) or raise :class:`FaultError`.

    Recovery needs a recoverable class, a checkpoint directory, attempts
    left and ``state_ok``: the caller's word that it can roll the
    booster back (a snapshot exists, or the booster stands at a clean
    iteration boundary).  The backoff is ``0.05 s * 2^(attempt - 1)``,
    at most 2 s."""
    cls = classify(exc)
    name = cls or "unclassified"
    record(f"fault_{name}")
    recoverable = (cls in RECOVERABLE and ckpt_dir is not None
                   and attempt <= retries and state_ok)
    report = fault_report(name, iteration=iteration, error=str(exc),
                          recovered=recoverable, attempt=attempt)
    RUN_REPORTS.append(report)
    for line in F.render([report["finding"]], indent=""):
        log.warning("%s", line)
    if not recoverable:
        why = ("unknown fault class — device state cannot be trusted"
               if cls is None else
               "no checkpoint directory configured"
               if ckpt_dir is None else
               f"retry budget exhausted ({retries} retries)"
               if attempt > retries else
               "the iteration died half-applied and no snapshot has "
               "landed yet — retrying in place would duplicate the "
               "already-appended trees"
               if not state_ok else
               f"{name} is not a recoverable class")
        log.warning("fault NOT recovered: %s", why)
        raise FaultError(report, exit_code=F.EXIT_FINDINGS) from exc
    delay = min(0.05 * (2 ** (attempt - 1)), 2.0)
    log.warning("recovering: resuming from the last checkpoint under %s "
                "after %.2fs backoff (attempt %d/%d)", ckpt_dir, delay,
                attempt, retries + 1)
    time.sleep(delay)
    return report
