"""Training API: ``train()`` (reference python-package engine.py:28).

Counterpart of ``lightgbm_tpu/engine.py`` ``train``: the same loop of
before / after callbacks, ``booster.update()``, evaluation and
``EarlyStopException`` handling, on the device ``device`` names
(``"cuda"`` unless the caller asks for ``"cpu"``), and continued
training from ``init_model`` (JAX ``engine.py:65-85``).  Custom
objectives, ``feval``, checkpoint/resume and fault handling are not
ported (``ROADMAP.md`` A5, A11).
"""
from __future__ import annotations

import copy
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from . import callback as callback_mod
from .basic import Booster, Dataset
from .config import Config
from .metric import create_metrics
from .utils.log import LightGBMError

__all__ = ["train"]


def train(
    params: Dict[str, Any],
    train_set: Dataset,
    num_boost_round: int = 100,
    valid_sets: Optional[Union[Dataset, Sequence[Dataset]]] = None,
    valid_names: Optional[Sequence[str]] = None,
    callbacks: Optional[Sequence[Callable]] = None,
    device="cuda",
    timer=None,
    init_model: Optional[Union[str, Booster]] = None,
) -> Booster:
    """Train a booster on ``device``; ``timer`` (an enabled
    ``ops.grow.StageTimer``) records the per-stage device time.
    ``init_model`` (a ``Booster``, a model file or a model string)
    continues training: its trees are kept, its raw predictions are the
    dataset's init score where it has none, and a model with linear
    trees makes ``linear_tree`` the default."""
    params = dict(params or {})
    cfg = Config.from_params(params)
    if "num_iterations" in {Config.canonical_name(k) for k in params}:
        num_boost_round = cfg.num_iterations
    if callable(params.get("objective")):
        raise LightGBMError("custom objective functions are not ported to "
                            "lightgbm_tpu_torch yet (see ROADMAP.md A5)")

    predictor = None
    if init_model is not None:
        predictor = _init_predictor(init_model, device)
        if any(t.is_linear for t in predictor._models):
            # the dataset must keep raw values for the leaf models' replay
            # (the reference reads linear_tree from the model file)
            params.setdefault("linear_tree", True)
            train_set._update_params({"linear_tree": True})
        if train_set.init_score is None and train_set.data is not None:
            raw = predictor.predict(train_set.data, raw_score=True)
            train_set.set_init_score(np.asarray(raw, np.float64).T.reshape(-1)
                                     if raw.ndim == 2 else raw)
    booster = Booster(params=params, train_set=train_set, device=device,
                      timer=timer)
    if predictor is not None:
        booster._inner.set_init_model(
            [copy.deepcopy(t) for t in predictor._models])
    if valid_sets is not None:
        if isinstance(valid_sets, Dataset):
            valid_sets = [valid_sets]
        for i, vs in enumerate(valid_sets):
            if vs is train_set:
                # the training data as a valid set: name "training"
                ms = create_metrics(booster.config)
                for m in ms:
                    m.init(train_set._binned.metadata,
                           train_set._binned.num_data)
                booster._inner._train_metrics = ms
                continue
            name = (valid_names[i] if valid_names and i < len(valid_names)
                    else f"valid_{i}")
            booster.add_valid(vs, name)

    cbs = list(callbacks or [])
    if cfg.early_stopping_round and cfg.early_stopping_round > 0:
        cbs.append(callback_mod.early_stopping(cfg.early_stopping_round,
                                               cfg.first_metric_only))
    if cfg.verbosity >= 1 and cfg.metric_freq > 0 and not any(
            getattr(c, "order", None) == 10 for c in cbs):
        cbs.append(callback_mod.log_evaluation(cfg.metric_freq))
    cbs_before = sorted((c for c in cbs
                         if getattr(c, "before_iteration", False)),
                        key=lambda c: getattr(c, "order", 0))
    cbs_after = sorted((c for c in cbs
                        if not getattr(c, "before_iteration", False)),
                       key=lambda c: getattr(c, "order", 0))

    evaluation_result_list: List = []
    for it in range(num_boost_round):
        for cb in cbs_before:
            cb(callback_mod.CallbackEnv(booster, params, it, 0,
                                        num_boost_round, None))
        finished = booster.update()
        evaluation_result_list = []
        if ((it + 1) % max(cfg.metric_freq, 1) == 0
                or cfg.early_stopping_round):
            evaluation_result_list = (booster.eval_train()
                                      + booster.eval_valid())
        try:
            for cb in cbs_after:
                cb(callback_mod.CallbackEnv(booster, params, it, 0,
                                            num_boost_round,
                                            evaluation_result_list))
        except callback_mod.EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            _record_best(booster, e.best_score)
            break
        if finished:
            break
    if booster.best_iteration <= 0:
        booster.best_iteration = booster.current_iteration()
        _record_best(booster, evaluation_result_list)
    return booster


def _init_predictor(init_model, device) -> Booster:
    """The booster ``init_model`` names: itself, a model file's or a
    model string's."""
    if isinstance(init_model, Booster):
        return init_model
    text = str(init_model)
    if not os.path.exists(text) and text.lstrip().startswith("tree"):
        return Booster(model_str=text, device=device)
    return Booster(model_file=text, device=device)


def _record_best(booster: Booster, results) -> None:
    booster.best_score = {}
    for item in results or []:
        ds, metric, value = item[0], item[1], item[2]
        booster.best_score.setdefault(ds, {})[metric] = value
