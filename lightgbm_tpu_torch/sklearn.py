"""scikit-learn estimator API.

Counterpart of ``lightgbm_tpu/sklearn.py`` (``LGBMModel`` :38,
``LGBMRegressor`` :288, ``LGBMClassifier`` :293, ``LGBMRanker`` :342;
reference python-package/lightgbm/sklearn.py): the same constructor
surface, fit / predict semantics, early stopping through callbacks,
``best_iteration_`` and ``feature_importances_``.  One argument more,
``device="cuda"``, goes to ``train``: the estimators train and predict
on the card unless it says ``"cpu"``.  Without scikit-learn installed
the estimators stand on plain bases and keep ``fit``, ``predict``,
``predict_proba``, ``get_params`` / ``set_params`` and their
attributes; ``clone`` and the meta-estimators need scikit-learn.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from . import callback as callback_mod
from .basic import Booster, Dataset
from .engine import train as _train
from .utils.log import LightGBMError

__all__ = ["LGBMModel", "LGBMClassifier", "LGBMRegressor", "LGBMRanker"]

try:
    # sklearn interop (tags protocol, clone, meta-estimators) — the
    # reference inherits the same bases (sklearn.py _LGBMModelBase)
    from sklearn.base import (BaseEstimator as _SKBase,
                              ClassifierMixin as _SKClassifier,
                              RegressorMixin as _SKRegressor)
except ImportError:  # pragma: no cover
    class _SKBase:  # minimal stand-ins
        pass

    class _SKClassifier:
        pass

    class _SKRegressor:
        pass


class LGBMModel(_SKBase):
    def __init__(
        self,
        boosting_type: str = "gbdt",
        num_leaves: int = 31,
        max_depth: int = -1,
        learning_rate: float = 0.1,
        n_estimators: int = 100,
        subsample_for_bin: int = 200000,
        objective: Optional[Union[str, Callable]] = None,
        class_weight=None,
        min_split_gain: float = 0.0,
        min_child_weight: float = 1e-3,
        min_child_samples: int = 20,
        subsample: float = 1.0,
        subsample_freq: int = 0,
        colsample_bytree: float = 1.0,
        reg_alpha: float = 0.0,
        reg_lambda: float = 0.0,
        random_state=None,
        n_jobs: int = -1,
        importance_type: str = "split",
        device: str = "cuda",
        **kwargs,
    ):
        self.boosting_type = boosting_type
        self.objective = objective
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.importance_type = importance_type
        self.class_weight = class_weight
        self.device = device
        self._other_params = dict(kwargs)
        self._Booster: Optional[Booster] = None
        self._n_features = -1
        self._classes = None
        self._n_classes = -1
        self._evals_result: Dict = {}
        self._best_iteration = -1
        self._objective = objective

    # -- sklearn plumbing ----------------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = {
            "boosting_type": self.boosting_type,
            "objective": self.objective,
            "num_leaves": self.num_leaves,
            "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "n_estimators": self.n_estimators,
            "subsample_for_bin": self.subsample_for_bin,
            "min_split_gain": self.min_split_gain,
            "min_child_weight": self.min_child_weight,
            "min_child_samples": self.min_child_samples,
            "subsample": self.subsample,
            "subsample_freq": self.subsample_freq,
            "colsample_bytree": self.colsample_bytree,
            "reg_alpha": self.reg_alpha,
            "reg_lambda": self.reg_lambda,
            "random_state": self.random_state,
            "n_jobs": self.n_jobs,
            "importance_type": self.importance_type,
            "class_weight": self.class_weight,
            "device": self.device,
        }
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        for k, v in params.items():
            if hasattr(self, k):
                setattr(self, k, v)
            else:
                self._other_params[k] = v
        return self

    def _default_objective(self) -> str:
        return "regression"

    def _build_params(self) -> Dict[str, Any]:
        p = self.get_params()
        p.pop("importance_type")
        p.pop("class_weight")
        p.pop("n_estimators")
        p.pop("n_jobs")
        p.pop("device")
        seed = p.pop("random_state")
        if seed is not None:
            p["seed"] = int(seed)
        if p["objective"] is None or callable(p["objective"]):
            p["objective"] = self._default_objective()
        p["verbosity"] = p.get("verbosity", p.pop("verbose", -1)
                               if "verbose" in p else -1)
        return p

    # -- fit ------------------------------------------------------------
    def fit(
        self,
        X,
        y,
        sample_weight=None,
        init_score=None,
        group=None,
        eval_set=None,
        eval_names=None,
        eval_sample_weight=None,
        eval_init_score=None,
        eval_group=None,
        eval_metric=None,
        feature_name="auto",
        categorical_feature="auto",
        callbacks=None,
        init_model=None,
    ) -> "LGBMModel":
        params = self._build_params()
        if eval_metric is not None and not callable(eval_metric):
            params["metric"] = eval_metric
        y_arr = np.asarray(y).reshape(-1)
        sample_weight = self._process_class_weight(y_arr, sample_weight)
        train_set = Dataset(X, label=self._process_label(y_arr),
                            weight=sample_weight, group=group,
                            init_score=init_score,
                            feature_name=feature_name,
                            categorical_feature=categorical_feature)
        valid_sets, valid_names = [], []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                vy = self._process_label(np.asarray(vy).reshape(-1))
                vw = (eval_sample_weight[i]
                      if eval_sample_weight is not None else None)
                vg = eval_group[i] if eval_group is not None else None
                vi = (eval_init_score[i]
                      if eval_init_score is not None else None)
                valid_sets.append(Dataset(vx, label=vy, weight=vw, group=vg,
                                          init_score=vi, reference=train_set))
                valid_names.append(eval_names[i] if eval_names else f"valid_{i}")
        self._evals_result = {}
        cbs = list(callbacks or [])
        cbs.append(callback_mod.record_evaluation(self._evals_result))
        feval = eval_metric if callable(eval_metric) else None
        if callable(self._objective):
            params["objective"] = _wrap_sklearn_objective(self._objective)
        self._Booster = _train(
            params, train_set,
            num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None,
            valid_names=valid_names or None,
            feval=_wrap_sklearn_feval(feval) if feval else None,
            callbacks=cbs,
            init_model=init_model,
            device=self.device,
        )
        self._n_features = train_set.num_feature()
        self._best_iteration = self._Booster.best_iteration
        return self

    def _process_label(self, y: np.ndarray) -> np.ndarray:
        return y

    def _process_class_weight(self, y, sample_weight):
        if self.class_weight is None:
            return sample_weight
        from sklearn.utils.class_weight import compute_sample_weight
        cw = compute_sample_weight(self.class_weight, y)
        if sample_weight is not None:
            cw = cw * np.asarray(sample_weight)
        return cw

    # -- predict --------------------------------------------------------
    def predict(self, X, raw_score: bool = False,
                start_iteration: int = 0, num_iteration: Optional[int] = None,
                pred_leaf: bool = False, pred_contrib: bool = False, **kw):
        self._check_fitted()
        return self._Booster.predict(
            X, raw_score=raw_score, start_iteration=start_iteration,
            num_iteration=num_iteration, pred_leaf=pred_leaf,
            pred_contrib=pred_contrib)

    def _check_fitted(self):
        if self._Booster is None:
            raise LightGBMError("Estimator not fitted, call fit before "
                                "exploiting the model.")

    # -- attributes -----------------------------------------------------
    @property
    def booster_(self) -> Booster:
        self._check_fitted()
        return self._Booster

    @property
    def best_iteration_(self) -> int:
        return self._best_iteration

    @property
    def best_score_(self):
        self._check_fitted()
        return self._Booster.best_score

    @property
    def evals_result_(self):
        return self._evals_result

    @property
    def n_features_(self) -> int:
        return self._n_features

    @property
    def n_features_in_(self) -> int:
        return self._n_features

    @property
    def feature_importances_(self) -> np.ndarray:
        self._check_fitted()
        return self._Booster.feature_importance(self.importance_type)

    @property
    def feature_name_(self) -> List[str]:
        self._check_fitted()
        return self._Booster.feature_name()


def _wrap_sklearn_objective(func):
    def inner(preds, dataset):
        label = dataset._binned.metadata.label
        res = func(label, preds)
        return res
    return inner


def _wrap_sklearn_feval(func):
    def inner(preds, eval_data):
        res = func(eval_data.get_label(), preds)
        return res
    return inner


class LGBMRegressor(_SKRegressor, LGBMModel):
    def _default_objective(self) -> str:
        return "regression"


class LGBMClassifier(_SKClassifier, LGBMModel):
    def _default_objective(self) -> str:
        return "binary" if self._n_classes <= 2 else "multiclass"

    def fit(self, X, y, **kwargs):
        y_arr = np.asarray(y).reshape(-1)
        self._classes = np.unique(y_arr)
        self._n_classes = len(self._classes)
        if self._n_classes > 2:
            self._other_params["num_class"] = self._n_classes
        else:
            self._other_params.pop("num_class", None)
        return super().fit(X, y, **kwargs)

    def _process_label(self, y: np.ndarray) -> np.ndarray:
        if self._classes is None:
            self._classes = np.unique(y)
            self._n_classes = len(self._classes)
        lookup = {c: i for i, c in enumerate(self._classes)}
        return np.asarray([lookup[v] for v in y], np.float32)

    def predict(self, X, raw_score: bool = False, **kw):
        p = self.predict_proba(X, raw_score=raw_score, **kw)
        if raw_score or kw.get("pred_leaf") or kw.get("pred_contrib"):
            return p
        if self._n_classes <= 2:
            idx = (p[:, 1] > 0.5).astype(int) if p.ndim == 2 else (p > 0.5).astype(int)
        else:
            idx = np.argmax(p, axis=1)
        return self._classes[idx]

    def predict_proba(self, X, raw_score: bool = False, **kw):
        self._check_fitted()
        p = self._Booster.predict(X, raw_score=raw_score, **kw)
        if raw_score or kw.get("pred_leaf") or kw.get("pred_contrib"):
            return p
        if self._n_classes <= 2 and p.ndim == 1:
            return np.column_stack([1.0 - p, p])
        return p

    @property
    def classes_(self):
        return self._classes

    @property
    def n_classes_(self) -> int:
        return self._n_classes


class LGBMRanker(LGBMModel):
    def _default_objective(self) -> str:
        return "lambdarank"

    def fit(self, X, y, group=None, **kwargs):
        if group is None and "eval_group" not in kwargs:
            raise ValueError("Should set group for ranking task")
        return super().fit(X, y, group=group, **kwargs)
