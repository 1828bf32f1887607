"""User-facing Dataset and Booster (reference basic.py:1194, :2705).

Counterpart of ``lightgbm_tpu/basic.py``.  ``Dataset`` bins a dense
matrix lazily (``reference=`` for validation sets, which must share the
training bin mappers).  ``Booster(params, train_set, device=...)``
trains on one device (``update``, ``eval_train``, ``eval_valid``);
``Booster(model_file=..., model_str=...)`` loads a model.  ``predict``
scores raw rows through the compiled serving engine for both (the CUDA
traversal kernel, or its plain version with ``device="cpu"``),
``pred_leaf`` walks the trees on the host, and ``model_to_string`` /
``save_model`` write the model text.  A model with linear trees predicts
through the traversal kernel's leaf entry and adds each tree's leaf
models on the device in f64, in tree order.  ``rollback_one_iter``
drops the last iteration.  SHAP contributions come with a later slice.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .config import Config
from .io.dataset_core import BinnedDataset
from .metric import create_metrics
from .models import GBDT, create_boosting
from .models.gbdt import check_supported
from .models.model_text import (load_model_from_string, loaded_param_string,
                                save_model_to_string)
from .objective import create_objective
from .parallel import MESH_LEARNERS, Network, rank_device
from .utils import log
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


class Dataset:
    """Training data wrapper (reference basic.py:1194): dense numpy
    input, binned on :meth:`construct` (or when a Booster first uses
    it)."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params) if params else {}
        self.free_raw_data = free_raw_data
        self._binned: Optional[BinnedDataset] = None

    def _update_params(self, params: Optional[Dict[str, Any]]) -> "Dataset":
        for k, v in (params or {}).items():
            self.params.setdefault(k, v)
        return self

    @classmethod
    def from_binned(cls, binned: BinnedDataset) -> "Dataset":
        """A constructed Dataset around an already binned one."""
        d = cls(None)
        d._binned = binned
        return d

    def construct(self) -> "Dataset":
        if self._binned is not None:
            return self
        if self.data is None:
            raise LightGBMError("Dataset has no data to construct from")
        cfg = Config.from_params(self.params)
        feature_names = ([str(s) for s in self.feature_name]
                         if isinstance(self.feature_name, (list, tuple))
                         else None)
        cat_idx = None
        if isinstance(self.categorical_feature, (list, tuple)):
            cat_idx = []
            for c in self.categorical_feature:
                if isinstance(c, (int, np.integer)):
                    cat_idx.append(int(c))
                elif feature_names and c in feature_names:
                    cat_idx.append(feature_names.index(c))
                else:
                    log.warning("Unknown categorical feature %s", c)
        elif cfg.categorical_feature:
            cat_idx = [int(x) for x in str(cfg.categorical_feature).split(",")
                       if x.strip().lstrip("-").isdigit()]
        ref = (self.reference.construct()._binned
               if self.reference is not None else None)
        self._binned = BinnedDataset.construct(
            self.data, cfg, label=self.label, weight=self.weight,
            group=self.group, init_score=self.init_score,
            feature_names=feature_names,
            categorical_indices=cat_idx, reference=ref)
        if self.free_raw_data:
            self.data = None
        return self

    def set_init_score(self, init_score) -> "Dataset":
        """Per-row init scores (class-major ``K * n`` for a multiclass
        model), kept as the binned metadata's once constructed."""
        self.init_score = init_score
        if self._binned is not None:
            self._binned.metadata.set_init_score(init_score)
        return self

    def set_group(self, group) -> "Dataset":
        """Query sizes (or boundaries), kept as the binned metadata's
        boundaries once constructed."""
        self.group = group
        if self._binned is not None:
            self._binned.metadata.set_group(group)
        return self

    def get_group(self):
        """Per-query sizes: from the binned metadata once constructed,
        else as given."""
        if (self._binned is not None
                and self._binned.metadata.query_boundaries is not None):
            return np.diff(self._binned.metadata.query_boundaries)
        return self.group

    def num_data(self) -> int:
        return self.construct()._binned.num_data

    def num_feature(self) -> int:
        return self.construct()._binned.num_total_features


class Booster:
    """Training and prediction handle (reference basic.py:2705)."""

    def __init__(
        self,
        params: Optional[Dict[str, Any]] = None,
        train_set: Optional[Dataset] = None,
        model_file: Optional[str] = None,
        model_str: Optional[str] = None,
        device="cuda",
        timer=None,
    ):
        """``timer`` (an ``ops.grow.StageTimer``) records per-stage
        device time of training when enabled."""
        self.device = resolve_device(device)
        self.params = dict(params) if params else {}
        self.best_iteration = -1
        self.best_score: Dict = {}
        self._loaded = None
        self._inner: Optional[GBDT] = None
        self._name_valid_sets: List[str] = []
        self._serve_engines: Dict = {}
        self.train_set = train_set
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be Dataset instance")
            train_set._update_params(self.params).construct()
            cfg = Config.from_params(self.params)
            check_supported(cfg)
            if (cfg.tree_learner in MESH_LEARNERS
                    and self.device.type == "cuda"
                    and torch.device(device).index is None):
                # a parallel learner's rank trains on its own card
                # (parallel/network.py): the group first, then the card
                Network.init(cfg, device=self.device)
                self.device = rank_device(torch.device("cuda"))
            objective = create_objective(cfg)
            metrics = (create_metrics(cfg)
                       if cfg.is_provide_training_metric else [])
            binned = train_set._binned
            if objective is not None:
                objective.init(binned.metadata, binned.num_data, self.device)
            self._inner = create_boosting(cfg, binned, objective, metrics,
                                          device=self.device, timer=timer)
            self.config = cfg
            return
        if model_file is not None:
            with open(model_file) as f:
                model_str = f.read()
        if model_str is None:
            raise TypeError("Need at least one training dataset or model "
                            "file or model string to create Booster "
                            "instance")
        self._loaded = load_model_from_string(model_str)

    # ------------------------------------------------------------------
    @property
    def _models(self):
        if self._inner is not None:
            return self._inner.models
        return self._loaded.models

    @property
    def _k(self) -> int:
        if self._inner is not None:
            return self._inner.num_tree_per_iteration
        return self._loaded.num_tree_per_iteration

    @property
    def _average_output(self) -> bool:
        if self._inner is not None:
            return self._inner.average_output
        return self._loaded.average_output

    @property
    def _objective_str(self) -> str:
        if self._inner is not None:
            return str(self._inner.objective or "")
        return self._loaded.objective_str

    def num_trees(self) -> int:
        return len(self._models)

    def num_feature(self) -> int:
        if self._inner is not None:
            return self._inner.train_set.num_total_features
        return self._loaded.max_feature_idx + 1

    def current_iteration(self) -> int:
        if self._inner is not None:
            return self._inner.current_iteration()
        return len(self._loaded.models) // max(self._k, 1)

    # -- training --------------------------------------------------------
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        if self._inner is None:
            raise LightGBMError("Cannot add validation data to a loaded "
                                "model")
        if data.reference is None and data._binned is None:
            # validation sets must bin with the training bin mappers
            data.reference = self.train_set
        data._update_params(self.params).construct()
        self._inner.add_valid(data._binned, name, create_metrics(self.config))
        self._name_valid_sets.append(name)
        return self

    def update(self) -> bool:
        """One boosting iteration; True when training should stop
        (reference Booster.update)."""
        if self._inner is None:
            raise LightGBMError("Cannot update a loaded model")
        self._serve_engines.clear()
        return self._inner.train_one_iter()

    def rollback_one_iter(self) -> "Booster":
        """Drop the last iteration's trees and their outputs from the
        training and validation scores (reference
        Booster.rollback_one_iter)."""
        if self._inner is None:
            raise LightGBMError("Cannot roll back a loaded model")
        self._serve_engines.clear()
        self._inner.rollback_one_iter()
        return self

    def eval_train(self) -> List:
        return self._eval("training")

    def eval_valid(self) -> List:
        out = []
        for name in self._name_valid_sets:
            out.extend(self._eval(name))
        return out

    def _eval(self, dataset_name: str) -> List:
        return [r for r in self._inner.eval() if r[0] == dataset_name]

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
            if self._is_linear():
                raise LightGBMError(
                    "pred_contrib is not supported for linear trees")
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

        raw = (self._linear_raw(arr, start_iteration, end)
               if self._is_linear() else
               self._serve_raw(arr, start_iteration, end))
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

    def _is_linear(self) -> bool:
        return any(t.is_linear for t in self._models)

    def _linear_raw(self, arr, start, end) -> np.ndarray:
        """Raw scores [k, n] f64 of a model with linear trees: every
        tree's leaf from the traversal kernel's leaf entry (a serving
        model of the structure, ``leaves_only``), then each tree's output
        (``models.linear.linear_leaf_output``, its leaf models by raw
        column; a constant tree its leaf values) added on the device in
        f64, in tree order."""
        import torch

        from .models.linear import linear_leaf_output, linear_params
        from .serve import ServingEngine, ServingModel
        key = ("leaves", int(start), int(end))
        eng = self._serve_engines.get(key)
        if eng is None:
            sm = ServingModel.from_booster(
                self, start_iteration=start, end_iteration=end,
                device=self.device, leaves_only=True)
            eng = self._serve_engines[key] = ServingEngine(
                sm, device=self.device)
        k = max(self._k, 1)
        trees = self._models[start * k:end * k]
        out = torch.zeros((k, arr.shape[0]), dtype=torch.float64,
                          device=self.device)
        if not trees:
            return out.cpu().numpy()
        leaves = torch.as_tensor(eng.predict_leaves(arr), device=self.device)
        x = torch.as_tensor(arr, dtype=torch.float64, device=self.device)
        for j, t in enumerate(trees):
            leaf = leaves[:, j].long()
            if t.is_linear:
                p = linear_params(t.leaf_features, t.leaf_coeff,
                                  t.leaf_const, t.leaf_value, self.device)
                out[j % k] += linear_leaf_output(leaf, x, p)
            else:
                out[j % k] += torch.as_tensor(t.leaf_value,
                                              device=self.device)[leaf]
        return out.cpu().numpy()

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
        target = (self._inner if self._inner is not None
                  else _LoadedAdapter(self._loaded))
        return save_model_to_string(target, start_iteration, num_iteration,
                                    imp)


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
        self.param_string = loaded_param_string(loaded.num_class)


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
