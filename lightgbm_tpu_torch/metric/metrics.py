"""Evaluation metrics.

The port's own copy of ``lightgbm_tpu/metric/metrics.py`` (reference
binary_metric.hpp, regression_metric.hpp, multiclass_metric.hpp,
xentropy_metric.hpp, factory metric.cpp:16): numpy on the host over the
f32 scores pulled from the device once per evaluation.  ``prob`` is the
objective-converted score and ``raw`` the raw one, ``[n]``, or ``[K,
n]`` for a multiclass model.  AUC is the weighted rank sum with midrank
ties.  ``ndcg@k`` and ``map@k`` (one result for each ``eval_at``) follow
the JAX package's host path, query by query, and need the dataset's
query groups.  Each result is ``(name, value, higher_better)``.  A name
neither package knows warns and is skipped, as in the JAX package.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..config import Config
from ..utils import log

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
        self.query_boundaries = metadata.query_boundaries
        self.num_data = num_data
        self.sum_weight = (float(num_data) if self.weight is None
                           else float(self.weight.sum()))

    def eval(self, prob: np.ndarray, raw: np.ndarray) -> List[EvalResult]:
        """prob = objective-converted score, raw = raw score, both [n]
        (or [K, n])."""
        raise NotImplementedError

    def _avg(self, pointwise: np.ndarray) -> float:
        if self.weight is None:
            return float(np.mean(pointwise))
        return float(np.sum(pointwise * self.weight) / self.sum_weight)


# -- regression (regression_metric.hpp), on the converted output ----------
class L2Metric(Metric):
    NAME = "l2"

    def eval(self, prob, raw):
        d = prob - self.label
        return [(self.NAME, self._avg(d * d), False)]


class RMSEMetric(Metric):
    NAME = "rmse"

    def eval(self, prob, raw):
        d = prob - self.label
        return [(self.NAME, float(np.sqrt(self._avg(d * d))), False)]


class L1Metric(Metric):
    NAME = "l1"

    def eval(self, prob, raw):
        return [(self.NAME, self._avg(np.abs(prob - self.label)), False)]


class QuantileMetric(Metric):
    NAME = "quantile"

    def eval(self, prob, raw):
        a = self.config.alpha
        d = self.label - prob
        pt = np.where(d >= 0, a * d, (a - 1.0) * d)
        return [(self.NAME, self._avg(pt), False)]


class MapeMetric(Metric):
    NAME = "mape"

    def eval(self, prob, raw):
        pt = np.abs((self.label - prob)
                    / np.maximum(1.0, np.abs(self.label)))
        return [(self.NAME, self._avg(pt), False)]


class HuberMetric(Metric):
    NAME = "huber"

    def eval(self, prob, raw):
        a = self.config.alpha
        d = np.abs(prob - self.label)
        pt = np.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a))
        return [(self.NAME, self._avg(pt), False)]


class FairMetric(Metric):
    NAME = "fair"

    def eval(self, prob, raw):
        c = self.config.fair_c
        x = np.abs(prob - self.label)
        pt = c * x - c * c * np.log1p(x / c)
        return [(self.NAME, self._avg(pt), False)]


class PoissonMetric(Metric):
    NAME = "poisson"

    def eval(self, prob, raw):
        p = np.maximum(prob, 1e-10)
        pt = p - self.label * np.log(p)
        return [(self.NAME, self._avg(pt), False)]


class GammaMetric(Metric):
    NAME = "gamma"

    def eval(self, prob, raw):
        p = np.maximum(prob, 1e-10)
        y = np.maximum(self.label, 1e-10)
        # the negative log-likelihood's part that depends on p (psi = 1)
        pt = y / p + np.log(p) - np.log(y) - 1.0
        return [(self.NAME, self._avg(pt), False)]


class GammaDevianceMetric(Metric):
    NAME = "gamma_deviance"

    def eval(self, prob, raw):
        p = np.maximum(prob, 1e-10)
        y = np.maximum(self.label, 1e-10)
        pt = 2.0 * (np.log(p / y) + y / p - 1.0)
        return [(self.NAME, self._avg(pt), False)]


class TweedieMetric(Metric):
    NAME = "tweedie"

    def eval(self, prob, raw):
        rho = self.config.tweedie_variance_power
        p = np.maximum(prob, 1e-10)
        a = self.label * np.power(p, 1.0 - rho) / (1.0 - rho)
        b = np.power(p, 2.0 - rho) / (2.0 - rho)
        return [(self.NAME, self._avg(-a + b), False)]


# -- binary (binary_metric.hpp) -------------------------------------------
class BinaryLoglossMetric(Metric):
    NAME = "binary_logloss"

    def eval(self, prob, raw):
        p = np.clip(prob, 1e-15, 1 - 1e-15)
        pt = -(self.label * np.log(p) + (1 - self.label) * np.log(1 - p))
        return [(self.NAME, self._avg(pt), False)]


class BinaryErrorMetric(Metric):
    NAME = "binary_error"

    def eval(self, prob, raw):
        pred = (prob > 0.5).astype(np.float64)
        return [(self.NAME, self._avg(pred != self.label), False)]


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


class AveragePrecisionMetric(Metric):
    NAME = "average_precision"
    HIGHER_BETTER = True

    def eval(self, prob, raw):
        order = np.argsort(-np.asarray(raw, np.float64), kind="mergesort")
        y = self.label[order]
        w = np.ones_like(y) if self.weight is None else self.weight[order]
        tp = np.cumsum(w * (y > 0))
        fp = np.cumsum(w * (y <= 0))
        precision = tp / np.maximum(tp + fp, 1e-20)
        if tp[-1] == 0:
            return [(self.NAME, 1.0, True)]
        ap = np.sum(precision * w * (y > 0)) / tp[-1]
        return [(self.NAME, float(ap), True)]


# -- multiclass (multiclass_metric.hpp), prob [K, n] ----------------------
class MultiLoglossMetric(Metric):
    NAME = "multi_logloss"

    def eval(self, prob, raw):
        lab = self.label.astype(np.int64)
        p = np.clip(prob[lab, np.arange(len(lab))], 1e-15, None)
        return [(self.NAME, self._avg(-np.log(p)), False)]


class MultiErrorMetric(Metric):
    NAME = "multi_error"

    def eval(self, prob, raw):
        lab = self.label.astype(np.int64)
        top_k = self.config.multi_error_top_k
        if top_k <= 1:
            err = (np.argmax(prob, axis=0) != lab).astype(np.float64)
        else:
            true_p = prob[lab, np.arange(prob.shape[1])]
            rank = np.sum(prob > true_p[None, :], axis=0)
            err = (rank >= top_k).astype(np.float64)
        name = self.NAME if top_k <= 1 else f"multi_error@{top_k}"
        return [(name, self._avg(err), False)]


class AucMuMetric(Metric):
    """The pairwise-class AUC average (Kleiman and Page's AUC-mu) with
    uniform class-pair weights, as the JAX package computes it: the
    decision score of a pair is the difference of the two classes' raw
    scores (``auc_mu_weights`` is read by neither package)."""
    NAME = "auc_mu"
    HIGHER_BETTER = True

    def eval(self, prob, raw):
        k = prob.shape[0]
        lab = self.label.astype(np.int64)
        aucs = []
        for a in range(k):
            for b in range(a + 1, k):
                mask = (lab == a) | (lab == b)
                if not mask.any():
                    continue
                s = raw[a, mask] - raw[b, mask]
                y = (lab[mask] == a).astype(np.float64)
                w = None if self.weight is None else self.weight[mask]
                aucs.append(_weighted_auc(y, s, w))
        return [(self.NAME, float(np.mean(aucs)) if aucs else 1.0, True)]


# -- cross-entropy (xentropy_metric.hpp) ----------------------------------
class CrossEntropyMetric(Metric):
    NAME = "cross_entropy"

    def eval(self, prob, raw):
        p = np.clip(prob, 1e-15, 1 - 1e-15)
        y = self.label
        pt = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        return [(self.NAME, self._avg(pt), False)]


class CrossEntropyLambdaMetric(Metric):
    NAME = "cross_entropy_lambda"

    def eval(self, prob, raw):
        # prob is the lambda parameter, log1p(exp(raw)):
        # -[y * log(1 - exp(-lam)) + (1 - y) * (-lam)]
        lam = np.maximum(prob, 1e-15)
        y = self.label
        pt = lam * (1 - y) - y * np.log(np.maximum(-np.expm1(-lam), 1e-300))
        return [(self.NAME, self._avg(pt), False)]


class KullbackLeiblerMetric(Metric):
    NAME = "kullback_leibler"

    def eval(self, prob, raw):
        p = np.clip(prob, 1e-15, 1 - 1e-15)
        y = np.clip(self.label, 0.0, 1.0)
        ce = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        with np.errstate(divide="ignore", invalid="ignore"):
            ent = np.where((y > 0) & (y < 1),
                           -(y * np.log(y) + (1 - y) * np.log(1 - y)), 0.0)
        return [(self.NAME, self._avg(ce - ent), False)]


# -- ranking (rank_metric.hpp NDCG, map_metric.hpp MAP), on raw [n] ---------
class _RankingMetric(Metric):
    HIGHER_BETTER = True

    def init(self, metadata, num_data: int) -> None:
        super().init(metadata, num_data)
        if self.query_boundaries is None:
            log.fatal("%s metric requires query information",
                      self.NAME.upper())

    def _queries(self, raw):
        """Each query's labels and the order of its documents by
        descending score (ties in document order)."""
        qb = self.query_boundaries
        for i in range(len(qb) - 1):
            lab = self.label[qb[i]:qb[i + 1]]
            yield lab, np.argsort(-raw[qb[i]:qb[i + 1]], kind="mergesort")


class NDCGMetric(_RankingMetric):
    NAME = "ndcg"

    def eval(self, prob, raw):
        ks = self.config.eval_at or [1, 2, 3, 4, 5]
        max_label = int(self.label.max())
        gains = np.asarray(self.config.label_gain or [
            float((1 << i) - 1) for i in range(max(max_label + 1, 2))])
        results = {k: [] for k in ks}
        for lab, order in self._queries(np.asarray(raw)):
            lab = lab.astype(np.int64)
            ideal = np.sort(lab)[::-1]
            disc = 1.0 / np.log2(np.arange(len(lab)) + 2.0)
            for k in ks:
                kk = min(k, len(lab))
                dcg = np.sum(gains[lab[order[:kk]]] * disc[:kk])
                idcg = np.sum(gains[ideal[:kk]] * disc[:kk])
                # a query whose labels are all 0 counts as ranked right
                results[k].append(dcg / idcg if idcg > 0 else 1.0)
        return [(f"ndcg@{k}", float(np.mean(results[k])), True) for k in ks]


class MapMetric(_RankingMetric):
    NAME = "map"

    def eval(self, prob, raw):
        ks = self.config.eval_at or [1, 2, 3, 4, 5]
        results = {k: [] for k in ks}
        for lab, order in self._queries(np.asarray(raw)):
            rel = (lab > 0).astype(np.float64)[order]
            prec = np.cumsum(rel) / np.arange(1, len(rel) + 1)
            for k in ks:
                kk = min(k, len(rel))
                npos = rel[:kk].sum()
                results[k].append(float(np.sum(prec[:kk] * rel[:kk]) / npos)
                                  if npos > 0 else 0.0)
        return [(f"map@{k}", float(np.mean(results[k])), True) for k in ks]


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
    "l2": L2Metric, "rmse": RMSEMetric, "l1": L1Metric,
    "quantile": QuantileMetric, "mape": MapeMetric, "huber": HuberMetric,
    "fair": FairMetric, "poisson": PoissonMetric, "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric, "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric, "binary_error": BinaryErrorMetric,
    "auc": AUCMetric, "average_precision": AveragePrecisionMetric,
    "auc_mu": AucMuMetric,
    "multi_logloss": MultiLoglossMetric, "multi_error": MultiErrorMetric,
    "ndcg": NDCGMetric, "map": MapMetric,
    "cross_entropy": CrossEntropyMetric,
    "cross_entropy_lambda": CrossEntropyLambdaMetric,
    "kullback_leibler": KullbackLeiblerMetric,
}

_DEFAULT_METRIC = {
    "regression": "l2", "regression_l1": "l1", "huber": "huber",
    "fair": "fair", "poisson": "poisson", "quantile": "quantile",
    "mape": "mape", "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary_logloss",
    "multiclass": "multi_logloss", "multiclassova": "multi_logloss",
    "cross_entropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "lambdarank": "ndcg", "rank_xendcg": "ndcg",
}


def default_metric_for_objective(objective: str) -> Optional[str]:
    from ..objective import canonical_objective
    return _DEFAULT_METRIC.get(canonical_objective(objective))


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
        if canon in seen:
            continue
        seen.add(canon)
        out.append(_METRIC_REGISTRY[canon](config))
    return out
