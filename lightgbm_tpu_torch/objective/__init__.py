"""Objective factory (reference objective_function.cpp:20-146; the JAX
package's ``objective/__init__.py`` and its alias table).  Every
objective of the JAX package is ported; the ranking ones
(``objective/rank.py``) need the dataset's query groups.
"""
from __future__ import annotations

from typing import Optional

from ..config import Config
from ..utils import log
from .base import ObjectiveFunction
from .binary import BinaryLogloss
from .multiclass import MulticlassOVA, MulticlassSoftmax
from .rank import LambdarankNDCG, RankXENDCG
from .regression import (Fair, Gamma, Huber, Mape, Poisson, Quantile,
                         RegressionL1, RegressionL2, Tweedie)
from .xentropy import CrossEntropy, CrossEntropyLambda

# canonical objective aliases (reference config.cpp ParseObjectiveAlias)
_OBJECTIVE_ALIASES = {
    "regression": "regression", "regression_l2": "regression",
    "l2": "regression", "mean_squared_error": "regression",
    "mse": "regression", "l2_root": "regression",
    "root_mean_squared_error": "regression", "rmse": "regression",
    "regression_l1": "regression_l1", "l1": "regression_l1",
    "mean_absolute_error": "regression_l1", "mae": "regression_l1",
    "huber": "huber", "fair": "fair", "poisson": "poisson",
    "quantile": "quantile",
    "mape": "mape", "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary",
    "multiclass": "multiclass", "softmax": "multiclass",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "xentlambda": "cross_entropy_lambda",
    "lambdarank": "lambdarank",
    "rank_xendcg": "rank_xendcg", "xendcg": "rank_xendcg",
    "xe_ndcg": "rank_xendcg", "xe_ndcg_mart": "rank_xendcg",
    "xendcg_mart": "rank_xendcg",
    "none": "none", "null": "none", "custom": "none", "na": "none",
}
_REGISTRY = {
    "regression": RegressionL2, "regression_l1": RegressionL1,
    "huber": Huber, "fair": Fair, "poisson": Poisson,
    "quantile": Quantile, "mape": Mape, "gamma": Gamma,
    "tweedie": Tweedie, "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax, "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
    "lambdarank": LambdarankNDCG, "rank_xendcg": RankXENDCG,
}


def canonical_objective(name: str) -> str:
    name = (name or "none").strip().lower()
    # "multiclass num_class:5"-style model-file strings
    base = name.split(" ")[0]
    if base not in _OBJECTIVE_ALIASES:
        log.fatal("Unknown objective %s", name)
    return _OBJECTIVE_ALIASES[base]


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
