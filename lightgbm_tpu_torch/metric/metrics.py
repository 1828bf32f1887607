"""Evaluation metrics for the ported objectives.

The port's own copy of the l2, binary_logloss and auc metrics of
``lightgbm_tpu/metric/metrics.py`` (reference binary_metric.hpp,
regression_metric.hpp, factory metric.cpp:16): numpy on the host over
the f32 scores pulled from the device once per evaluation.  AUC is the
weighted rank sum with midrank ties.  Each result is ``(name, value,
higher_better)``.  A metric the JAX package computes and the port lacks
raises ``LightGBMError`` (it comes with ``ROADMAP.md`` A8); a name
neither package knows warns and is skipped, as in the JAX package.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..config import Config
from ..utils import log
from ..utils.log import LightGBMError

EvalResult = Tuple[str, float, bool]  # (metric name, value, higher_better)


class Metric:
    NAME = "none"
    HIGHER_BETTER = False

    def __init__(self, config: Config):
        self.config = config

    def init(self, metadata, num_data: int) -> None:
        self.label = (None if metadata.label is None
                      else np.asarray(metadata.label, np.float64))
        self.weight = (None if metadata.weight is None
                       else np.asarray(metadata.weight, np.float64))
        self.num_data = num_data
        self.sum_weight = (float(num_data) if self.weight is None
                           else float(self.weight.sum()))

    def eval(self, prob: np.ndarray, raw: np.ndarray) -> List[EvalResult]:
        """prob = objective-converted score, raw = raw score, both [n]."""
        raise NotImplementedError

    def _avg(self, pointwise: np.ndarray) -> float:
        if self.weight is None:
            return float(np.mean(pointwise))
        return float(np.sum(pointwise * self.weight) / self.sum_weight)


class L2Metric(Metric):
    NAME = "l2"

    def eval(self, prob, raw):
        d = prob - self.label
        return [(self.NAME, self._avg(d * d), False)]


class BinaryLoglossMetric(Metric):
    NAME = "binary_logloss"

    def eval(self, prob, raw):
        p = np.clip(prob, 1e-15, 1 - 1e-15)
        pt = -(self.label * np.log(p) + (1 - self.label) * np.log(1 - p))
        return [(self.NAME, self._avg(pt), False)]


def _weighted_auc(label, score, weight) -> float:
    order = np.argsort(score, kind="mergesort")
    y = label[order]
    w = np.ones_like(y) if weight is None else weight[order]
    pos_w = w * (y > 0)
    neg_w = w * (y <= 0)
    tot_pos, tot_neg = pos_w.sum(), neg_w.sum()
    if tot_pos == 0 or tot_neg == 0:
        return 1.0
    # midrank ties: sum per tie group of equal scores
    _, inv = np.unique(score[order], return_inverse=True)
    grp_pos = np.bincount(inv, weights=pos_w)
    grp_neg = np.bincount(inv, weights=neg_w)
    cum_neg = np.cumsum(grp_neg) - grp_neg
    auc_sum = np.sum(grp_pos * (cum_neg + 0.5 * grp_neg))
    return float(auc_sum / (tot_pos * tot_neg))


class AUCMetric(Metric):
    NAME = "auc"
    HIGHER_BETTER = True

    def eval(self, prob, raw):
        return [(self.NAME, _weighted_auc(
            self.label, np.asarray(raw, np.float64), self.weight), True)]


# The JAX package's alias table (its metric/metrics.py), as data: every
# name it knows, to its canonical metric, ported or not.
_METRIC_ALIASES = {
    "l2": "l2", "mean_squared_error": "l2", "mse": "l2",
    "regression_l2": "l2", "regression": "l2",
    "rmse": "rmse", "root_mean_squared_error": "rmse", "l2_root": "rmse",
    "l1": "l1", "mean_absolute_error": "l1", "mae": "l1",
    "regression_l1": "l1",
    "quantile": "quantile",
    "mape": "mape", "mean_absolute_percentage_error": "mape",
    "huber": "huber",
    "fair": "fair",
    "poisson": "poisson",
    "gamma": "gamma",
    "gamma_deviance": "gamma_deviance",
    "tweedie": "tweedie",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "binary_error": "binary_error",
    "auc": "auc",
    "average_precision": "average_precision", "mean_average_precision": "map",
    "auc_mu": "auc_mu",
    "multi_logloss": "multi_logloss", "multiclass": "multi_logloss",
    "softmax": "multi_logloss", "multiclassova": "multi_logloss",
    "multi_error": "multi_error",
    "ndcg": "ndcg", "lambdarank": "ndcg", "rank_xendcg": "ndcg",
    "xendcg": "ndcg", "xe_ndcg": "ndcg",
    "map": "map",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "xentlambda": "cross_entropy_lambda",
    "kullback_leibler": "kullback_leibler", "kldiv": "kullback_leibler",
}

_METRIC_REGISTRY = {
    "l2": L2Metric, "binary_logloss": BinaryLoglossMetric,
    "auc": AUCMetric,
}


def default_metric_for_objective(objective: str) -> Optional[str]:
    from ..objective import canonical_objective
    return {"regression": "l2", "binary": "binary_logloss"}.get(
        canonical_objective(objective))


def create_metrics(config: Config) -> List[Metric]:
    """Factory (reference metric.cpp:16)."""
    names = list(config.metric)
    if not names:
        d = default_metric_for_objective(config.objective)
        names = [d] if d else []
    out: List[Metric] = []
    seen = set()
    for raw_name in names:
        name = str(raw_name).strip().lower()
        if name in ("", "none", "null", "na", "custom"):
            continue
        if name not in _METRIC_ALIASES:
            log.warning("Unknown metric %s", name)
            continue
        canon = _METRIC_ALIASES[name]
        if canon not in _METRIC_REGISTRY:
            raise LightGBMError(
                f"metric {name} ({canon}) is not ported to "
                "lightgbm_tpu_torch yet (see ROADMAP.md, A8); the JAX "
                "package lightgbm_tpu computes it")
        if canon in seen:
            continue
        seen.add(canon)
        out.append(_METRIC_REGISTRY[canon](config))
    return out
