"""Training callbacks: ``log_evaluation``, ``record_evaluation``,
``early_stopping`` and ``reset_parameter``.

The port's own copy of these four from ``lightgbm_tpu/callback.py``
(reference python-package/lightgbm/callback.py): callables taking a
``CallbackEnv``, run before the iteration where ``before_iteration`` is
set, stopping by ``EarlyStopException``.  The tracing callback is not
ported.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List, Union

from .utils import log

__all__ = ["early_stopping", "log_evaluation", "record_evaluation",
           "reset_parameter", "CallbackEnv", "EarlyStopException"]

CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def log_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            result = "\t".join(
                _format_eval_result(x, show_stdv)
                for x in env.evaluation_result_list)
            log.info("[%d]\t%s", env.iteration + 1, result)
    _callback.order = 10
    return _callback


def _format_eval_result(value, show_stdv: bool = True) -> str:
    if len(value) == 4:
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    if len(value) == 5:  # cv: with stdv
        if show_stdv:
            return f"{value[0]}'s {value[1]}: {value[2]:g} + {value[4]:g}"
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    raise ValueError("Wrong metric value")


def record_evaluation(eval_result: Dict[str, Dict[str, List[float]]]) -> Callable:
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")

    def _init(env: CallbackEnv) -> None:
        eval_result.clear()
        for item in env.evaluation_result_list:
            data_name, eval_name = item[0], item[1]
            eval_result.setdefault(data_name, collections.OrderedDict())
            if len(item) == 4:
                eval_result[data_name].setdefault(eval_name, [])
            else:
                eval_result[data_name].setdefault(f"{eval_name}-mean", [])
                eval_result[data_name].setdefault(f"{eval_name}-stdv", [])

    def _callback(env: CallbackEnv) -> None:
        if not eval_result:
            _init(env)
        for item in env.evaluation_result_list:
            data_name, eval_name = item[0], item[1]
            if len(item) == 4:
                eval_result[data_name][eval_name].append(item[2])
            else:
                eval_result[data_name][f"{eval_name}-mean"].append(item[2])
                eval_result[data_name][f"{eval_name}-stdv"].append(item[4])
    _callback.order = 20
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True, min_delta: Union[float, List[float]] = 0.0
                   ) -> Callable:
    """Reference callback.py:367 semantics: track every (dataset, metric)
    pair, stop when none improves for ``stopping_rounds`` iterations."""
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List = []
    cmp_op: List[Callable] = []
    enabled = [True]
    first_metric = [""]

    def _init(env: CallbackEnv) -> None:
        from .config import Config
        booster_type = "gbdt"
        for key, v in (env.params or {}).items():
            if Config.canonical_name(key) == "boosting":
                booster_type = str(v)
        if booster_type == "dart":
            # dart rescales earlier trees after the fact, so a truncated
            # prefix does not reproduce the best-iteration score
            enabled[0] = False
            log.warning("Early stopping is not available in dart mode")
            return
        enabled[0] = bool(env.evaluation_result_list)
        if not enabled[0]:
            log.warning("For early stopping, at least one dataset and "
                        "eval metric is required for evaluation")
            return
        if verbose:
            log.info("Training until validation scores don't improve for %d rounds",
                     stopping_rounds)
        n_metrics = len({m[1] for m in env.evaluation_result_list})
        n_datasets = len({m[0] for m in env.evaluation_result_list})
        deltas = (min_delta if isinstance(min_delta, list)
                  else [min_delta] * n_datasets * n_metrics)
        first_metric[0] = env.evaluation_result_list[0][1].split(" ")[-1]
        for eval_ret, delta in zip(env.evaluation_result_list, deltas):
            best_iter.append(0)
            best_score_list.append(None)
            if eval_ret[3]:  # higher better
                best_score.append(float("-inf"))
                cmp_op.append(lambda x, y, d=delta: x > y + d)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda x, y, d=delta: x < y - d)

    def _callback(env: CallbackEnv) -> None:
        if not best_score:
            _init(env)
        if not enabled[0]:
            return
        for i in range(len(env.evaluation_result_list)):
            score = env.evaluation_result_list[i][2]
            if best_score_list[i] is None or cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            eval_name_splitted = env.evaluation_result_list[i][1].split(" ")
            if first_metric_only and first_metric[0] != eval_name_splitted[-1]:
                continue
            if ((env.evaluation_result_list[i][0] == "training"
                 and len({m[0] for m in env.evaluation_result_list}) > 1)
                    or (env.evaluation_result_list[i][0] == "cv_agg"
                        and eval_name_splitted[0] == "train")):
                continue  # train metric never triggers stopping
            if env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    log.info("Early stopping, best iteration is:\n[%d]\t%s",
                             best_iter[i] + 1, "\t".join(
                                 _format_eval_result(x)
                                 for x in best_score_list[i]))
                raise EarlyStopException(best_iter[i], best_score_list[i])
            if env.iteration == env.end_iteration - 1:
                if verbose:
                    log.info("Did not meet early stopping. Best iteration is:"
                             "\n[%d]\t%s", best_iter[i] + 1, "\t".join(
                                 _format_eval_result(x)
                                 for x in best_score_list[i]))
                raise EarlyStopException(best_iter[i], best_score_list[i])
    _callback.order = 30
    return _callback


def reset_parameter(**kwargs) -> Callable:
    """Reset parameters before each iteration (JAX ``callback.py:88-109``):
    each value is a list with one entry an iteration (its length must be
    ``num_boost_round``) or a function of the iteration.  A new
    ``learning_rate`` becomes the booster's shrinkage rate and its
    config's ``learning_rate``, which the grower reads on every call (in
    ``cv``, every fold's booster's)."""

    def _callback(env: CallbackEnv) -> None:
        new_parameters = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(f"Length of list {key!r} has to equal "
                                     f"to 'num_boost_round'.")
                new_param = value[env.iteration - env.begin_iteration]
            else:
                new_param = value(env.iteration - env.begin_iteration)
            new_parameters[key] = new_param
        if new_parameters:
            if "learning_rate" in new_parameters:
                # cv's model is a CVBooster: every fold's booster
                for model in getattr(env.model, "boosters", [env.model]):
                    inner = getattr(model, "_inner", None)
                    if inner is None:
                        continue
                    inner.shrinkage_rate = new_parameters["learning_rate"]
                    inner.config.learning_rate = \
                        new_parameters["learning_rate"]
            env.params.update(new_parameters)
    _callback.before_iteration = True
    _callback.order = 10
    return _callback
