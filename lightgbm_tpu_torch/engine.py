"""Training API: ``train()`` (reference python-package engine.py:28).

Counterpart of ``lightgbm_tpu/engine.py`` ``train``: the same loop of
before / after callbacks, ``booster.update()``, evaluation and
``EarlyStopException`` handling, on the device ``device`` names
(``"cuda"`` unless the caller asks for ``"cpu"``).  Custom objectives,
``feval``, ``init_model``, checkpoint/resume and fault handling are not
ported (``ROADMAP.md`` A5, A11).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

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
) -> Booster:
    """Train a booster on ``device``; ``timer`` (an enabled
    ``ops.grow.StageTimer``) records the per-stage device time."""
    params = dict(params or {})
    cfg = Config.from_params(params)
    if "num_iterations" in {Config.canonical_name(k) for k in params}:
        num_boost_round = cfg.num_iterations
    if callable(params.get("objective")):
        raise LightGBMError("custom objective functions are not ported to "
                            "lightgbm_tpu_torch yet (see ROADMAP.md A5)")

    booster = Booster(params=params, train_set=train_set, device=device,
                      timer=timer)
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


def _record_best(booster: Booster, results) -> None:
    booster.best_score = {}
    for item in results or []:
        ds, metric, value = item[0], item[1], item[2]
        booster.best_score.setdefault(ds, {})[metric] = value
