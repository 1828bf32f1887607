"""User-facing Dataset and Booster (reference basic.py:1194, :2705).

Counterpart of ``lightgbm_tpu/basic.py``.  ``Dataset`` bins lazily on
:meth:`Dataset.construct` (``reference=`` for validation sets, which
must share the training bin mappers) from a dense matrix, a scipy CSR /
CSC matrix (binned column by column without densifying it), a
:class:`Sequence` or a list of them (streamed in ``batch_size``
chunks), a text file (CSV, TSV or LibSVM, ``io/loader.py``) or a binary
cache (``.bin`` / ``.npz``, the JAX package's layout); it has the JAX
package's setters, getters, ``subset``, ``save_binary``,
``add_features_from`` and ``create_valid``.

``Booster(params, train_set, device=...)`` trains on one device
(``update``, with a custom objective ``fobj``; ``eval_train``,
``eval_valid`` and ``eval`` with a custom metric ``feval``);
``Booster(model_file=..., model_str=...)`` loads a model.  ``predict``
scores raw rows through the compiled serving engine for both (the CUDA
traversal kernel, or its plain version with ``device="cpu"``),
``pred_leaf`` walks the trees on the host, and ``model_to_string`` /
``save_model`` / ``dump_model`` write the model.  A model with linear
trees predicts through the traversal kernel's leaf entry and adds each
tree's leaf models on the device in f64, in tree order.
``rollback_one_iter`` drops the last iteration; ``refit`` refits the
leaf values on new rows, their leaves from the traversal kernel's leaf
entry.  ``pred_contrib`` gives the SHAP contributions (the ``tree_shap``
kernel, ``models/shap.py``); ``pred_early_stop`` stops adding a row's
trees once its margin passes the threshold, on the f64 leaves of
:func:`refit_leaves`.
"""
from __future__ import annotations

import abc
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .config import Config
from .io.dataset_core import BinnedDataset, Metadata
from .metric import create_metrics
from .models import GBDT, create_boosting
from .models.gbdt import _class_view, check_supported
from .models.model_text import (dump_model_to_json, feature_importance,
                                load_model_from_string, loaded_param_string,
                                save_model_to_string)
from .objective import create_objective
from .parallel import MESH_LEARNERS, Network, rank_device
from .resilience import faults
from .utils import log
from .utils.device import resolve_device
from .utils.log import LightGBMError


# the objectives whose predictions may stop early (LightGBM's
# ObjectiveFunction::NeedAccuratePrediction is false for them)
EARLY_STOP_OBJECTIVES = ("binary", "multiclass", "multiclassova",
                         "lambdarank", "rank_xendcg")


def _to_numpy_2d(data) -> np.ndarray:
    if isinstance(data, Dataset):
        raise TypeError("Cannot use Dataset instance for prediction, "
                        "please use raw data instead")
    if hasattr(data, "toarray") and not isinstance(data, np.ndarray):
        # scipy sparse: prediction walks raw feature values row-wise
        return np.asarray(data.toarray(), dtype=np.float64)
    arr = np.asarray(data, dtype=np.float64)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    return arr


class Sequence(abc.ABC):
    """Row access for streaming Dataset construction (reference
    ``lightgbm.Sequence``; JAX ``basic.py:38-62``): subclass with
    ``__getitem__`` (an int gives a 1-D row, a slice 2-D rows) and
    ``__len__``; ``batch_size`` sets the streaming chunk.  Pass one, or
    a list of them, as ``Dataset(data=...)``: the whole float matrix is
    never made."""

    batch_size: int = 4096

    @abc.abstractmethod
    def __getitem__(self, idx):
        raise NotImplementedError

    @abc.abstractmethod
    def __len__(self) -> int:
        raise NotImplementedError


class Dataset:
    """Training data wrapper (reference basic.py:1194), binned on
    :meth:`construct` (or when a Booster first uses it)."""

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
        self.used_indices = None

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
        data = self.data
        label, weight, group = self.label, self.weight, self.group
        seqs = None
        if isinstance(data, Sequence):
            seqs = [data]
        elif (isinstance(data, list) and data
              and all(isinstance(q, Sequence) for q in data)):
            seqs = data
        elif isinstance(data, (str, Path)):
            path = str(data)
            if path.endswith(".bin") or path.endswith(".npz"):
                self._binned = BinnedDataset.load_binary(path)
                return self
            from .io.loader import load_text_file
            data, file_label, file_weight, file_group = load_text_file(
                path, config=cfg)
            label = file_label if label is None else label
            weight = file_weight if weight is None else weight
            group = file_group if group is None else group
        feature_names = ([str(q) for q in self.feature_name]
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
        build = (BinnedDataset.construct if seqs is None else
                 BinnedDataset.construct_from_sequences)
        self._binned = build(
            data if seqs is None else seqs, cfg, label=label, weight=weight,
            group=group, init_score=self.init_score,
            feature_names=feature_names, categorical_indices=cat_idx,
            reference=ref)
        if self.free_raw_data:
            self.data = None
        return self

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """A validation Dataset binned with this one's mappers."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params)

    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._binned is not None:
            self._binned.metadata.set_label(label)
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._binned is not None:
            self._binned.metadata.set_weight(weight)
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

    def get_label(self):
        if self._binned is not None:
            return self._binned.metadata.label
        return self.label

    def get_weight(self):
        if self._binned is not None:
            return self._binned.metadata.weight
        return self.weight

    def get_group(self):
        """Per-query sizes: from the binned metadata once constructed,
        else as given."""
        if (self._binned is not None
                and self._binned.metadata.query_boundaries is not None):
            return np.diff(self._binned.metadata.query_boundaries)
        return self.group

    def get_init_score(self):
        """The init score as it was given (the JAX package's getter)."""
        return self.init_score

    def get_feature_name(self) -> List[str]:
        return self.construct()._binned.feature_names

    def num_data(self) -> int:
        return self.construct()._binned.num_data

    def num_feature(self) -> int:
        return self.construct()._binned.num_total_features

    def subset(self, used_indices, params=None) -> "Dataset":
        """The rows ``used_indices`` of this Dataset, binned with its
        mappers (``BinnedDataset.subset``)."""
        self.construct()
        d = Dataset.__new__(Dataset)
        d.__dict__.update(self.__dict__)
        d._binned = self._binned.subset(np.asarray(used_indices))
        d.used_indices = used_indices
        return d

    def save_binary(self, filename) -> "Dataset":
        """The binary cache (the JAX package's npz layout) at exactly
        ``filename``; ``Dataset(filename)`` loads it back."""
        self.construct()._binned.save_binary(str(filename))
        return self

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """Dataset::AddFeaturesFrom: ``other``'s features appended to
        this Dataset's (the same rows).  The raw values kept under
        ``linear_tree`` are appended when both kept them, else dropped."""
        self.construct()
        other.construct()
        a, b = self._binned, other._binned
        if a.num_data != b.num_data:
            log.fatal("Cannot add features from dataset with different "
                      "num_data")
        a.bin_matrix = np.concatenate([a.bin_matrix, b.bin_matrix], axis=1)
        a.raw_matrix = (np.concatenate([a.raw_matrix, b.raw_matrix], axis=1)
                        if a.raw_matrix is not None
                        and b.raw_matrix is not None else None)
        a.mappers = a.mappers + b.mappers
        a.used_feature_map = np.concatenate(
            [a.used_feature_map, b.used_feature_map + a.num_total_features])
        a.feature_names = a.feature_names + b.feature_names
        a.num_total_features += b.num_total_features
        return self


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
        self._train_data_name = "training"
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

    def num_model_per_iteration(self) -> int:
        return self._k

    def feature_name(self) -> List[str]:
        if self._inner is not None:
            return self._inner.train_set.feature_names
        return self._loaded.feature_names

    @property
    def _model_target(self):
        """The object the model writers read: the trained booster, or a
        loaded model under its names."""
        return (self._inner if self._inner is not None
                else _LoadedAdapter(self._loaded))

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

    def update(self, train_set: Optional[Dataset] = None,
               fobj=None) -> bool:
        """One boosting iteration; True when training should stop
        (reference Booster.update).  ``fobj(preds, train_set)`` is a
        custom objective: it sees the f64 training scores of the
        ``num_data`` rows (``[n]``, or ``[n, K]``) and returns the
        gradients and hessians (numpy arrays or tensors; ``[n, K]`` is
        transposed), which go to the booster's device once each."""
        if self._inner is None:
            raise LightGBMError("Cannot update a loaded model")
        if train_set is not None:
            raise LightGBMError("Resetting train set on an existing "
                                "booster is not supported yet")
        self._serve_engines.clear()
        # LGBM_TPU_FAULT=<class>@<iteration> fires here, the boundary
        # every training loop goes through (off: a cached no-op)
        faults.maybe_fire(self._inner.iter_)
        if fobj is None:
            return self._inner.train_one_iter()
        inner = self._inner
        # the host's part of the stage; the copies to the device are
        # timed in train_one_iter's
        with inner.timer.stage("gradients", inner.device):
            grad, hess = (v if isinstance(v, torch.Tensor)
                          else np.asarray(v, np.float32)
                          for v in fobj(self._predict_for_fobj(),
                                        self.train_set))
        if grad.ndim == 2:     # [n, K] -> [K, n]
            grad, hess = grad.T, hess.T
        return inner.train_one_iter(grad, hess)

    def _predict_for_fobj(self) -> np.ndarray:
        """The training scores a custom objective sees: f64, the
        ``num_data`` rows, ``[n]`` or ``[n, K]``."""
        n = self.train_set._binned.num_data
        score = self._inner.get_training_score()[:, :n].double().cpu().numpy()
        return score[0] if self._k == 1 else score.T

    def rollback_one_iter(self) -> "Booster":
        """Drop the last iteration's trees and their outputs from the
        training and validation scores (reference
        Booster.rollback_one_iter)."""
        if self._inner is None:
            raise LightGBMError("Cannot roll back a loaded model")
        self._serve_engines.clear()
        self._inner.rollback_one_iter()
        return self

    def eval_train(self, feval=None) -> List:
        return self._eval("training", feval)

    def eval_valid(self, feval=None) -> List:
        out = []
        for name in self._name_valid_sets:
            out.extend(self._eval(name, feval))
        return out

    def eval(self, data, name: str, feval=None) -> List:
        """The metrics of the set added under ``name`` (``data`` is not
        read, as in the JAX package)."""
        return self._eval(name, feval)

    def _eval(self, dataset_name: str, feval=None) -> List:
        res = [r for r in self._inner.eval() if r[0] == dataset_name]
        if feval is not None:
            res.extend(_run_feval(self, feval, dataset_name))
        return res

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
        """Predictions of the rows ``data`` (JAX ``basic.py:498-584``).
        ``pred_contrib`` gives the SHAP contributions (``[n, k (F +
        1)]``, each class's expected value last).  ``pred_early_stop``
        (with ``pred_early_stop_freq`` and ``pred_early_stop_margin``,
        the config's 10 and 10.0 unless given) stops adding trees to a
        row whose margin (``2 |score|``, or the top two classes' gap)
        reaches the margin, checked every ``freq`` iterations; it applies
        to the classification and ranking objectives only (LightGBM's
        ``NeedAccuratePrediction``) and refuses an rf model or a custom
        objective."""
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
        if pred_contrib:
            if self._is_linear():
                raise LightGBMError(
                    "pred_contrib is not supported for linear trees")
            from .models.shap import predict_contrib
            return predict_contrib(self, arr, start_iteration, end)

        if self._early_stops(kwargs):
            raw = self._early_stop_raw(
                arr, start_iteration, end,
                int(kwargs.get("pred_early_stop_freq",
                               Config.pred_early_stop_freq)),
                float(kwargs.get("pred_early_stop_margin",
                                 Config.pred_early_stop_margin)))
        elif self._is_linear():
            raw = self._linear_raw(arr, start_iteration, end)
        else:
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

    def _early_stops(self, kwargs) -> bool:
        """Whether ``pred_early_stop`` applies: asked for, and the model's
        objective one of classification or ranking (others predict in
        full, as LightGBM's predictor does); an rf model or a custom
        objective refuses, as LightGBM's documentation says."""
        if not kwargs.get("pred_early_stop", False):
            return False
        obj = self._objective_str.split(" ")[0]
        if self._average_output:
            raise LightGBMError("pred_early_stop cannot be used with rf "
                                "boosting")
        if obj in ("", "none", "custom"):
            raise LightGBMError("pred_early_stop cannot be used with a "
                                "custom objective")
        if obj not in EARLY_STOP_OBJECTIVES:
            log.warning("pred_early_stop is used only in classification "
                        "and ranking; objective %s predicts in full", obj)
            return False
        return True

    def _early_stop_raw(self, arr, start, end, freq: int,
                        margin: float) -> np.ndarray:
        """Raw scores [k, n] f64 with prediction early stopping
        (reference predictor.hpp / pred_early_stop.cpp; JAX
        ``basic.py:556-584``): every row's leaves as the f64 host walk
        finds them (:func:`refit_leaves`), each tree's outputs added on
        the device in tree order while the row is active; every ``freq``
        iterations a row whose margin (``2 |score|`` for one class, the
        top two scores' gap for several) reaches ``margin`` stops."""
        from .models.linear import linear_leaf_output, linear_params
        dev = self.device
        k = max(self._k, 1)
        trees = self._models[start * k:end * k]
        n = arr.shape[0]
        raw = torch.zeros((k, n), dtype=torch.float64, device=dev)
        if not trees:
            return raw.cpu().numpy()
        leaves = torch.as_tensor(
            refit_leaves(self, arr, start=start, end=end), device=dev).long()
        x = torch.as_tensor(arr, dtype=torch.float64, device=dev)
        active = torch.ones(n, dtype=torch.bool, device=dev)
        freq = max(freq, 1)
        for it in range(end - start):
            for c in range(k):
                j = it * k + c
                t = trees[j]
                if t.is_linear:
                    val = linear_leaf_output(
                        leaves[:, j], x,
                        linear_params(t.leaf_features, t.leaf_coeff,
                                      t.leaf_const, t.leaf_value, dev))
                else:
                    val = torch.as_tensor(t.leaf_value,
                                          device=dev)[leaves[:, j]]
                raw[c] = torch.where(active, raw[c] + val, raw[c])
            if (it + 1) % freq == 0:
                if k == 1:
                    m = 2.0 * raw[0].abs()
                else:
                    top = torch.topk(raw, 2, dim=0).values
                    m = top[0] - top[1]
                active &= m < margin
                if not bool(active.any()):
                    break
        return raw.cpu().numpy()

    def _serve_raw(self, arr, start, end) -> np.ndarray:
        """Compiled-forest raw scores in [k, n] f64.  Inputs are cast
        to f32 (the serving contract): a value beyond f32 precision may
        land one bin away from the f64 host walk."""
        scores = self.serving_engine(start, end).predict(
            np.asarray(arr, np.float32))                      # [n, K]
        return np.asarray(scores, np.float64).T

    # ------------------------------------------------------------------
    def refit(self, data, label, weight=None, decay_rate: float = 0.9,
              **kwargs) -> "Booster":
        """A copy of the model with every tree's structure kept and its
        leaf values refit on ``data`` (reference GBDT::RefitTree; JAX
        ``basic.py:670-725``).  Each row's leaf is the f64 host walk's
        (:func:`refit_leaves`: the traversal kernel's leaf entry for the
        rows equal to their f32 rounding, ``Tree.predict_leaf`` for the
        others); per iteration the
        objective's gradients are taken on the booster's device at the
        refitted scores (f64, rounded to f32), summed per leaf in f64 in
        row order on the host (``np.bincount``, as the JAX package sums,
        so the card's leaf values are the CPU run's), and the new leaf
        output, L1-thresholded, over ``h + lambda_l2``, times the tree's
        shrinkage, is blended with the old by ``decay_rate``."""
        X = _to_numpy_2d(data)
        y = np.asarray(label, np.float64).reshape(-1)
        n = X.shape[0]
        dev = self.device
        new_b = Booster(model_str=self.model_to_string(), device=dev)
        models, k = new_b._models, new_b._k
        cfg = _refit_config({**self.params, **kwargs}, self._objective_str,
                            new_b._loaded.num_class)
        objective = create_objective(cfg)
        if objective is None:
            log.fatal("refit requires a model with an objective")
        md = Metadata()
        md.set_label(y)
        if weight is not None:
            md.set_weight(np.asarray(weight, np.float64))
        md.num_data = n
        objective.init(md, n, dev)
        leaves = refit_leaves(new_b, X, f32_input=_is_f32(data))   # [n, T]
        leaves_dev = torch.as_tensor(leaves, device=dev).long()
        l1, l2 = cfg.lambda_l1, cfg.lambda_l2
        score = torch.zeros((k, n), dtype=torch.float64, device=dev)
        for it in range(len(models) // k):
            g, h = objective.get_gradients(_class_view(score.float()))
            g = g.reshape(k, n).double().cpu().numpy()
            h = h.reshape(k, n).double().cpu().numpy()
            for c in range(k):
                j = it * k + c
                tree, leaf = models[j], leaves[:, j]
                nl = tree.num_leaves
                sg = np.bincount(leaf, weights=g[c], minlength=nl)
                sh = np.bincount(leaf, weights=h[c], minlength=nl)
                sg_t = np.sign(sg) * np.maximum(np.abs(sg) - l1, 0.0)
                new_out = -sg_t / (sh + l2 + 1e-38) * tree.shrinkage
                tree.leaf_value = (decay_rate * tree.leaf_value
                                   + (1.0 - decay_rate) * new_out)
                score[c] += torch.as_tensor(tree.leaf_value,
                                            device=dev)[leaves_dev[:, j]]
        return new_b

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
        return save_model_to_string(self._model_target, start_iteration,
                                    num_iteration, imp)

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> dict:
        """The model as the JAX package's JSON dictionary
        (``model_text.dump_model_to_json``)."""
        return dump_model_to_json(self._model_target, start_iteration,
                                  num_iteration or -1)

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        """Split counts (int32) or summed gains (f64) per feature."""
        imp = 0 if importance_type == "split" else 1
        out = feature_importance(self._model_target, iteration or -1, imp)
        return out if imp else out.astype(np.int32)

    def free_dataset(self) -> "Booster":
        return self

    def free_network(self) -> "Booster":
        """Reference LGBM_BoosterFreeNetwork: end the process group
        (``parallel.network.Network.dispose``)."""
        Network.dispose()
        return self

    def set_train_data_name(self, name: str) -> "Booster":
        self._train_data_name = name
        return self


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


def _is_f32(data) -> bool:
    return getattr(data, "dtype", None) == np.float32


def refit_leaves(booster: Booster, X: np.ndarray, f32_input: bool = False,
                 start: int = 0, end: Optional[int] = None) -> np.ndarray:
    """``[n, T]`` each row's leaf in each tree of ``booster``'s
    iterations ``[start, end)`` (all by default), as the f64 host walk
    (``Tree.predict_leaf``) finds it.  The traversal kernel's leaf entry
    (a ``leaves_only`` serving model) casts the rows to f32 as serving
    does, so it takes every row equal to its f32 rounding (NaN
    included); the rows that are not, whose value and its rounding may
    lie on two sides of a threshold, take the host walk.  ``f32_input``
    (the caller's data was f32) skips the test."""
    from .serve import ServingEngine, ServingModel
    dev = booster.device
    k = max(booster._k, 1)
    end = len(booster._models) // k if end is None else end
    sm = ServingModel.from_booster(booster, start_iteration=start,
                                   end_iteration=end, device=dev,
                                   leaves_only=True)
    leaves = ServingEngine(sm, device=dev).predict_leaves(X)
    if f32_input:
        return leaves
    x32 = X.astype(np.float32).astype(np.float64)
    off = np.flatnonzero(~np.all((x32 == X) | np.isnan(X), axis=1))
    if off.size:
        xo = X[off]
        leaves[off] = np.stack([t.predict_leaf(xo) for t in
                                booster._models[start * k:end * k]], axis=1)
    return leaves


def _refit_config(params: Dict[str, Any], objective_str: str,
                  num_class: int) -> Config:
    """The refit's objective: the parameters', else the model's own
    (its objective string's name, ``sigmoid:`` and ``num_class:``)."""
    cfg = Config.from_params(params)
    named = {Config.canonical_name(key) for key in params}
    if objective_str and "objective" not in named:
        toks = objective_str.split()
        cfg.objective = toks[0]
        for tok in toks[1:]:
            key, _, v = tok.partition(":")
            if key == "sigmoid":
                cfg.sigmoid = float(v)
        cfg.num_class = num_class
    return cfg


def _run_feval(booster: Booster, feval, dataset_name: str) -> List:
    """A custom metric's results on one set (JAX ``basic.py:816-848``):
    each ``feval(preds, eval_data)`` sees the converted scores of the
    set's rows (``[n]``, or ``[n, K]``) and gives ``(name, value,
    higher_better)`` or a list of them."""
    inner = booster._inner
    datasets = {"training": (inner.training_scores(), inner.train_set)}
    for vs in inner.valid_sets:
        datasets[vs.name] = (vs.scores, vs.data)
    if dataset_name not in datasets:
        return []
    score, bds = datasets[dataset_name]
    prob, _ = inner.converted_scores(score)
    prob = prob[..., :bds.num_data]
    preds = prob if booster._k == 1 else prob.T
    md = bds.metadata

    class _EvalData:
        label = md.label

        @staticmethod
        def get_label():
            return md.label

        @staticmethod
        def get_weight():
            return md.weight

        @staticmethod
        def get_group():
            qb = md.query_boundaries
            return None if qb is None else np.diff(qb)

    out = []
    for f in (feval if isinstance(feval, (list, tuple)) else [feval]):
        res = f(preds, _EvalData())
        for name, value, hb in ([res] if isinstance(res, tuple) else res):
            out.append((dataset_name, name, value, hb))
    return out


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
