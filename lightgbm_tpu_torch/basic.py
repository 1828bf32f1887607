"""Booster for serving a LightGBM model file (reference basic.py:2705).

Counterpart of the loaded-model half of ``lightgbm_tpu/basic.py``:
``Booster(model_file=..., model_str=..., device=...)`` parses the model
text, ``predict`` scores raw rows through the compiled serving engine
(the CUDA traversal kernel, or its plain version with
``device="cpu"``), ``pred_leaf`` walks the trees on the host, and
``model_to_string`` / ``save_model`` write the model text back.
Training, SHAP contributions and linear trees come with later slices.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from .models.model_text import load_model_from_string, save_model_to_string
from .utils.device import resolve_device
from .utils.log import LightGBMError


def _to_numpy_2d(data) -> np.ndarray:
    if hasattr(data, "toarray") and not isinstance(data, np.ndarray):
        # scipy sparse: prediction walks raw feature values row-wise
        return np.asarray(data.toarray(), dtype=np.float64)
    arr = np.asarray(data, dtype=np.float64)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    return arr


class Booster:
    """Prediction handle over a model loaded from LightGBM model text."""

    def __init__(
        self,
        params: Optional[Dict[str, Any]] = None,
        train_set=None,
        model_file: Optional[str] = None,
        model_str: Optional[str] = None,
        device="cuda",
    ):
        if train_set is not None:
            raise LightGBMError(
                "training is not ported to lightgbm_tpu_torch yet (see "
                "ROADMAP.md); load a model with model_file= or model_str=")
        self.device = resolve_device(device)
        self.params = dict(params) if params else {}
        self.best_iteration = -1
        if model_file is not None:
            with open(model_file) as f:
                model_str = f.read()
        if model_str is None:
            raise TypeError("Need a model file or model string to create "
                            "a Booster instance")
        self._loaded = load_model_from_string(model_str)
        self._serve_engines: Dict = {}

    # ------------------------------------------------------------------
    @property
    def _models(self):
        return self._loaded.models

    @property
    def _k(self) -> int:
        return self._loaded.num_tree_per_iteration

    @property
    def _average_output(self) -> bool:
        return self._loaded.average_output

    @property
    def _objective_str(self) -> str:
        return self._loaded.objective_str

    def num_trees(self) -> int:
        return len(self._loaded.models)

    def num_feature(self) -> int:
        return self._loaded.max_feature_idx + 1

    # ------------------------------------------------------------------
    def predict(
        self,
        data,
        start_iteration: int = 0,
        num_iteration: Optional[int] = None,
        raw_score: bool = False,
        pred_leaf: bool = False,
        pred_contrib: bool = False,
        **kwargs,
    ) -> np.ndarray:
        if pred_contrib:
            raise LightGBMError(
                "pred_contrib (SHAP) is not ported to lightgbm_tpu_torch "
                "yet (see ROADMAP.md)")
        if kwargs.get("pred_early_stop", False):
            raise LightGBMError(
                "pred_early_stop is not ported to lightgbm_tpu_torch yet "
                "(see ROADMAP.md)")
        arr = _to_numpy_2d(data)
        models = self._models
        k = self._k
        total_iter = len(models) // max(k, 1)
        if num_iteration is None or num_iteration < 0:
            num_iteration = (self.best_iteration
                             if self.best_iteration > 0 else total_iter)
        end = min(start_iteration + num_iteration, total_iter)

        if pred_leaf:
            out = np.zeros((arr.shape[0], (end - start_iteration) * k),
                           np.int32)
            for it in range(start_iteration, end):
                for kk in range(k):
                    t = models[it * k + kk]
                    out[:, (it - start_iteration) * k + kk] = \
                        t.predict_leaf(arr)
            return out

        raw = self._serve_raw(arr, start_iteration, end)
        if self._average_output:
            raw /= max(end - start_iteration, 1)
        if raw_score:
            return raw[0] if k == 1 else raw.T
        conv = _convert_output_np(raw, self._objective_str)
        return conv[0] if k == 1 and conv.ndim == 2 else \
            conv.T if conv.ndim == 2 else conv

    # -- compiled serving ----------------------------------------------
    def serving_engine(self, start_iteration: int = 0,
                       end_iteration: Optional[int] = None):
        """The cached serving engine for an iteration slice (built on
        first use, on this booster's device).  The bulk path and the
        latency queue are also usable directly:
        ``ServingQueue(booster.serving_engine())``."""
        models = self._models
        total_iter = len(models) // max(self._k, 1)
        end = total_iter if end_iteration is None \
            else min(int(end_iteration), total_iter)
        key = (int(start_iteration), end)
        cache = self._serve_engines
        eng = cache.get(key)
        if eng is not None:
            cache[key] = cache.pop(key)   # LRU: mark most-recent
            return eng
        from .serve import ServingEngine, ServingModel
        sm = ServingModel.from_booster(self, start_iteration=start_iteration,
                                       end_iteration=end, device=self.device)
        eng = cache[key] = ServingEngine(sm, device=self.device)
        # bound the per-slice cache: a num_iteration sweep would
        # otherwise pin one stacked forest on the device per slice
        while len(cache) > 4:
            del cache[next(iter(cache))]
        return eng

    def _serve_raw(self, arr, start, end) -> np.ndarray:
        """Compiled-forest raw scores in [k, n] f64.  Inputs are cast
        to f32 (the serving contract): a value beyond f32 precision may
        land one bin away from the f64 host walk."""
        scores = self.serving_engine(start, end).predict(
            np.asarray(arr, np.float32))                      # [n, K]
        return np.asarray(scores, np.float64).T

    # ------------------------------------------------------------------
    def save_model(self, filename, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> "Booster":
        with open(filename, "w") as f:
            f.write(self.model_to_string(num_iteration, start_iteration,
                                         importance_type))
        return self

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0,
                        importance_type: str = "split") -> str:
        if num_iteration is None:
            num_iteration = self.best_iteration if self.best_iteration > 0 \
                else -1
        imp = 0 if importance_type == "split" else 1
        return save_model_to_string(_LoadedAdapter(self._loaded),
                                    start_iteration, num_iteration, imp)


class _LoadedAdapter:
    """The fields of a LoadedModel under the names the model-text
    writer reads."""

    def __init__(self, loaded):
        self.models = loaded.models
        self.num_class = loaded.num_class
        self.num_tree_per_iteration = loaded.num_tree_per_iteration
        self.objective = loaded.objective_str or None
        self.average_output = loaded.average_output
        self.feature_names = loaded.feature_names
        self.feature_infos = loaded.feature_infos
        self.max_feature_idx = loaded.max_feature_idx


def _convert_output_np(raw: np.ndarray, objective_str: str) -> np.ndarray:
    """Numpy analog of ObjectiveFunction::ConvertOutput keyed off the
    model's objective string."""
    obj = objective_str.split(" ")[0] if objective_str else ""
    if obj in ("binary", "cross_entropy", "multiclassova"):
        sigmoid = 1.0
        for tok in objective_str.split():
            if tok.startswith("sigmoid:"):
                sigmoid = float(tok.split(":")[1])
        return 1.0 / (1.0 + np.exp(-sigmoid * raw))
    if obj == "multiclass":
        e = np.exp(raw - raw.max(axis=0, keepdims=True))
        return e / e.sum(axis=0, keepdims=True)
    if obj in ("poisson", "gamma", "tweedie"):
        return np.exp(raw)
    if obj == "cross_entropy_lambda":
        return np.log1p(np.exp(raw))
    if "sqrt" in objective_str:
        return np.sign(raw) * raw * raw
    return raw
