"""Objective factory (reference objective_function.cpp:20-146).

This slice ports the binary logloss and the l2 regression objectives;
every other name of the JAX package's table raises ``LightGBMError``
pointing to ``ROADMAP.md`` (A8).
"""
from __future__ import annotations

from typing import Optional

from ..config import Config
from ..utils import log
from .base import ObjectiveFunction
from .binary import BinaryLogloss
from .regression import RegressionL2

_PORTED = {
    "regression": "regression", "regression_l2": "regression",
    "l2": "regression", "mean_squared_error": "regression",
    "mse": "regression", "l2_root": "regression",
    "root_mean_squared_error": "regression", "rmse": "regression",
    "binary": "binary",
}
_NONE = ("none", "null", "custom", "na")
_REGISTRY = {"regression": RegressionL2, "binary": BinaryLogloss}


def canonical_objective(name: str) -> str:
    name = (name or "none").strip().lower()
    base = name.split(" ")[0]
    if base in _NONE:
        return "none"
    if base not in _PORTED:
        log.fatal("objective %s is not ported to lightgbm_tpu_torch yet "
                  "(binary and regression only; see ROADMAP.md A8)", name)
    return _PORTED[base]


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    canon = canonical_objective(config.objective)
    if canon == "none":
        return None
    obj = _REGISTRY[canon](config)
    if config.objective.strip().lower() in ("rmse", "l2_root",
                                            "root_mean_squared_error"):
        obj.sqrt = True   # the l2_root alias implies the sqrt transform
    return obj


__all__ = ["ObjectiveFunction", "create_objective", "canonical_objective"]
