"""Fault-tolerant training (counterpart of ``lightgbm_tpu/resilience``):
deterministic checkpoint / resume, the fault-injection harness and the
numerical guardrails.

* :mod:`.checkpoint` — ``lightgbm_tpu/ckpt/v1`` snapshots of the whole
  boosting state, written every ``LGBM_TPU_CKPT_EVERY`` iterations into
  ``LGBM_TPU_CKPT_DIR``; a run killed at iteration i and resumed grows
  the uninterrupted run's trees byte for byte, and a resume whose config,
  data or route disagrees refuses (exit 2);
* :mod:`.faults` — ``LGBM_TPU_FAULT=<class>@<iteration>`` injection
  (death / nan / oom / hang), the engine boundary's classification into
  ``lightgbm_tpu/faultreport/v1`` reports and the bounded recovery from
  the last snapshot;
* :mod:`.numerics` — ``LGBM_TPU_NUMERICS`` NaN / Inf sentinels on the
  grow path (raise / skip / clamp; ``off`` builds none).

``python -m lightgbm_tpu_torch.resilience demo`` trains a small model
through the engine under whatever knobs are set, on the card unless
``--device cpu``.
"""
from __future__ import annotations

from .checkpoint import (CKPT_SCHEMA, Checkpoint, CheckpointError,
                         CkptPolicy, ResumeRefused, maybe_resume,
                         policy_from_env, save_booster)
from .faults import (FAULT_CLASSES, FAULTREPORT_SCHEMA, FaultError,
                     fault_report)
from .numerics import NumericalFault, NumericsSkip

__all__ = [
    "CKPT_SCHEMA", "Checkpoint", "CheckpointError", "CkptPolicy",
    "ResumeRefused", "maybe_resume", "policy_from_env", "save_booster",
    "FAULT_CLASSES", "FAULTREPORT_SCHEMA", "FaultError", "fault_report",
    "NumericalFault", "NumericsSkip",
]
