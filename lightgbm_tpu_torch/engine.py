"""Training API: ``train()`` and ``cv()`` (reference python-package
engine.py:28, :404).

Counterpart of ``lightgbm_tpu/engine.py``: the same loop of before /
after callbacks, ``booster.update()``, evaluation with the custom
metrics ``feval`` and ``EarlyStopException`` handling, on the device
``device`` names (``"cuda"`` unless the caller asks for ``"cpu"``).  A
callable ``objective`` is a custom objective: the booster trains with
``objective="none"`` and takes its gradients each iteration.
``init_model`` continues training (JAX ``engine.py:65-85``).  ``cv``
trains one booster a fold on the JAX package's folds (numpy
``default_rng(seed)``, stratified for the classification objectives),
each fold a ``Dataset.subset`` of the constructed dataset sharing its
mappers; unlike the JAX ``cv``, it runs its callbacks and starts every
fold from ``init_model``.

Fault tolerance (``resilience/``, JAX ``engine.py:118-175``): with
``LGBM_TPU_CKPT_DIR`` set, ``train`` resumes from the newest valid
ckpt/v1 snapshot there (the trees byte-identical to the uninterrupted
run's) and writes one every ``LGBM_TPU_CKPT_EVERY`` iterations; a
snapshot of another config, route or dataset refuses
(``ResumeRefused``), a torn one raises ``CheckpointError``.  Every
exception of the loop goes through ``faults.handle_training_fault``: a
known transient class is recovered from the last snapshot within
``LGBM_TPU_FAULT_RETRIES`` attempts, anything else raises (``FaultError``
for a classified fault, the exception itself otherwise).  A booster the
snapshot cannot hold (``checkpoint.supports``) trains unprotected, with
a warning.  ``cv`` trains without checkpoints.
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
from .resilience import checkpoint as ckpt_mod
from .resilience import faults as faults_mod
from .utils import log
from .utils.log import LightGBMError

__all__ = ["train", "cv", "CVBooster"]


def train(
    params: Dict[str, Any],
    train_set: Dataset,
    num_boost_round: int = 100,
    valid_sets: Optional[Union[Dataset, Sequence[Dataset]]] = None,
    valid_names: Optional[Sequence[str]] = None,
    feval=None,
    init_model: Optional[Union[str, Booster]] = None,
    keep_training_booster: bool = False,
    callbacks: Optional[Sequence[Callable]] = None,
    device="cuda",
    timer=None,
) -> Booster:
    """Train a booster on ``device``; ``timer`` (an enabled
    ``ops.grow.StageTimer``) records the per-stage device time.  A
    callable ``params["objective"]`` is ``fobj(preds, train_set) ->
    (grad, hess)``; ``feval`` (one or a list) adds custom metrics.
    ``init_model`` (a ``Booster``, a model file or a model string)
    continues training: its trees are kept, its raw predictions from all
    of them (not only to its best iteration) are the dataset's init
    score where it has none, and a model with linear
    trees makes ``linear_tree`` the default.  ``keep_training_booster``
    is accepted and, as in the JAX package, changes nothing."""
    params, fobj = _split_fobj(params)
    cfg = Config.from_params(params)
    if "num_iterations" in {Config.canonical_name(k) for k in params}:
        num_boost_round = cfg.num_iterations

    predictor = _init_predictor(init_model, train_set, params, device)
    if (predictor is not None and train_set.init_score is None
            and train_set.data is not None):
        train_set.set_init_score(_init_scores(predictor.predict(
            train_set.data, raw_score=True,
            num_iteration=predictor.current_iteration())))
    booster = Booster(params=params, train_set=train_set, device=device,
                      timer=timer)
    _keep_trees(booster, predictor)
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
            getattr(c, "order", None) == 10
            and not getattr(c, "before_iteration", False) for c in cbs):
        cbs.append(callback_mod.log_evaluation(cfg.metric_freq))
    cbs_before, cbs_after = _split_callbacks(cbs)

    faults_mod.reset_run()
    ckpt = _Checkpointing(booster, cfg)
    retries = faults_mod.max_retries()
    attempt = 0
    evaluation_result_list: List = []
    it = ckpt.resumed
    if it >= num_boost_round and it:
        log.warning("checkpoint already holds %d iteration(s) >= "
                    "num_boost_round=%d: no further training, returning the "
                    "checkpointed model unchanged", it, num_boost_round)
    while it < num_boost_round:
        rng_snap = booster._inner._rng_feature.bit_generator.state
        try:
            for cb in cbs_before:
                cb(callback_mod.CallbackEnv(booster, params, it, 0,
                                            num_boost_round, None))
            finished = booster.update(fobj=fobj)
            evaluation_result_list = []
            if ((it + 1) % max(cfg.metric_freq, 1) == 0
                    or cfg.early_stopping_round):
                evaluation_result_list = (booster.eval_train(feval)
                                          + booster.eval_valid(feval))
            try:
                for cb in cbs_after:
                    cb(callback_mod.CallbackEnv(booster, params, it, 0,
                                                num_boost_round,
                                                evaluation_result_list))
            except callback_mod.EarlyStopException as e:
                booster.best_iteration = e.best_iteration + 1
                _record_best(booster, e.best_score)
                break
            ckpt.after_iteration(it + 1)
            if finished:
                break
        except (ckpt_mod.CheckpointError, ckpt_mod.ResumeRefused,
                faults_mod.FaultError):
            # their own exit contracts: classifying them again would
            # wrap the wrapper
            raise
        except Exception as e:   # noqa: BLE001 - classified below
            # a class the table does not know is a plain bug (a
            # callback's, a custom objective's): it propagates untouched
            if faults_mod.classify(e) is None:
                raise
            attempt += 1
            it = ckpt.recover(e, it, attempt, retries, rng_snap)
            continue
        it += 1
        # a completed iteration closes the incident: the budget bounds
        # consecutive attempts, not a long run's transient faults
        attempt = 0
    if booster.best_iteration <= 0:
        # best_iteration stays unset unless early stopping set it, as in
        # LightGBM: predict and model_to_string then take every
        # iteration, those grown later by update() included (the JAX
        # package pins it to the last iteration here; ROADMAP C)
        _record_best(booster, evaluation_result_list)
    return booster


class _Checkpointing:
    """``train``'s checkpoint policy (JAX ``engine.py:118-175`` and the
    loop's fault handler): resume at the start, a snapshot every
    ``every`` iterations, recovery from the last one."""

    def __init__(self, booster: Booster, cfg: Config):
        self.booster = booster
        self.policy = ckpt_mod.policy_from_env()
        self.dir: Optional[str] = None
        self.fingerprint: Optional[str] = None
        self.resumed = booster.resumed_from = 0
        if self.policy.dir is None:
            return
        unsupported = ckpt_mod.supports(booster._inner)
        if unsupported is not None:
            log.warning("checkpointing disabled for this run: %s",
                        unsupported)
            return
        self.dir = self.policy.dir
        # the config as it is now: reset_parameter changes it in place
        # every iteration, and a fingerprint of that would refuse every
        # legitimate resume
        self.fingerprint = ckpt_mod.config_fingerprint(booster.config)
        os.makedirs(self.dir, exist_ok=True)
        self.resumed = self._resume()
        if self.resumed and cfg.early_stopping_round:
            log.warning("resumed with early_stopping_round=%d: callback "
                        "state is not part of the ckpt/v1 snapshot, so "
                        "early stopping restarts its best-metric search at "
                        "iteration %d", cfg.early_stopping_round,
                        self.resumed)
        booster.resumed_from = self.resumed

    def _resume(self) -> int:
        return ckpt_mod.maybe_resume(self.booster, self.dir,
                                     fingerprint=self.fingerprint,
                                     every=self.policy.every)

    def _save(self) -> None:
        ckpt_mod.save_booster(self.booster, self.dir, keep=self.policy.keep,
                              every=self.policy.every,
                              fingerprint=self.fingerprint)

    def after_iteration(self, done: int) -> None:
        """A snapshot when ``done`` iterations end a cadence."""
        if (self.dir is not None and self.policy.every > 0
                and done % self.policy.every == 0):
            self._save()

    def recover(self, exc: Exception, it: int, attempt: int, retries: int,
                rng_snap) -> int:
        """The loop's fault at iteration ``it``: classified, recorded and
        recovered (or raised by ``handle_training_fault``); returns the
        iteration to go on from.  Without a snapshot the booster is
        retried in place only at a clean iteration boundary, and only
        where the dead attempt changed nothing but the feature-fraction
        RNG (no carried rows, no lazy CEGB mask): a retry on anything
        else would fork the run."""
        inner = self.booster._inner
        has_ckpt = (self.dir is not None
                    and ckpt_mod.latest(self.dir) is not None)
        boundary = (len(inner.models)
                    == inner.current_iteration()
                    * inner.num_tree_per_iteration)
        inplace_ok = (boundary and inner._cegb_paid is None
                      and getattr(inner.grow, "reset_stream", None) is None)
        faults_mod.handle_training_fault(
            exc, iteration=it, ckpt_dir=self.dir, attempt=attempt,
            retries=retries, state_ok=has_ckpt or inplace_ok)
        if has_ckpt:
            return self._resume()
        # a clean boundary: put back the RNG draws of an attempt that
        # landed no tree (a fault after update() keeps its tree's draws)
        if inner.current_iteration() == it:
            inner._rng_feature.bit_generator.state = rng_snap
        it = inner.current_iteration()
        if it > 0 and self.policy.every > 0 and it % self.policy.every == 0:
            # the fault cut the iteration's tail after its tree landed:
            # the save the tail skipped re-anchors the rows as the
            # uninterrupted run does
            self._save()
        return it


def _split_fobj(params):
    """A copy of ``params`` with a callable ``objective`` (a custom
    objective) replaced by ``"none"``, and the callable (or None)."""
    params = dict(params or {})
    fobj = params.get("objective")
    if not callable(fobj):
        return params, None
    params["objective"] = "none"
    return params, fobj


def _split_callbacks(cbs):
    """(before, after): the callbacks run before each iteration and
    those run after it, each in ``order``."""
    def pick(before):
        return sorted((c for c in cbs
                       if bool(getattr(c, "before_iteration", False))
                       == before), key=lambda c: getattr(c, "order", 0))
    return pick(True), pick(False)


def _init_predictor(init_model, train_set: Dataset, params,
                    device) -> Optional[Booster]:
    """The booster ``init_model`` names (itself, a model file's or a
    model string's), or None.  A model with linear trees makes
    ``linear_tree`` the default of ``params`` and ``train_set``: the
    dataset must keep raw values for the leaf models' replay (the
    reference reads linear_tree from the model file)."""
    if init_model is None:
        return None
    if isinstance(init_model, Booster):
        predictor = init_model
    else:
        text = str(init_model)
        predictor = (Booster(model_str=text, device=device)
                     if not os.path.exists(text)
                     and text.lstrip().startswith("tree")
                     else Booster(model_file=text, device=device))
    if any(t.is_linear for t in predictor._models):
        params.setdefault("linear_tree", True)
        train_set._update_params({"linear_tree": True})
    return predictor


def _init_scores(raw) -> np.ndarray:
    """A model's raw predictions (``[n]``, or ``[n, K]``) as a dataset's
    init score (class-major ``K * n``)."""
    raw = np.asarray(raw, np.float64)
    return raw.T.reshape(-1) if raw.ndim == 2 else raw


def _keep_trees(booster: Booster, predictor: Optional[Booster]) -> None:
    """Continued training: ``predictor``'s trees kept at the head of
    ``booster``'s model (the dataset's init score holds their
    predictions)."""
    if predictor is not None:
        booster._inner.set_init_model(
            [copy.deepcopy(t) for t in predictor._models])


def _record_best(booster: Booster, results) -> None:
    booster.best_score = {}
    for item in results or []:
        ds, metric, value = item[0], item[1], item[2]
        booster.best_score.setdefault(ds, {})[metric] = value


class CVBooster:
    """The folds' boosters (reference engine.py CVBooster): a method
    called on it is called on each booster, its results in a list."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def append(self, b: Booster) -> None:
        self.boosters.append(b)

    def __getattr__(self, name):
        def handler(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler


def _make_n_folds(full_data: Dataset, nfold: int, seed: int,
                  stratified: bool, shuffle: bool):
    """``(train_idx, test_idx)`` of each fold, the JAX package's folds
    index for index: numpy ``default_rng(seed)`` shuffles each class's
    rows (stratified) or all rows, ``np.array_split`` cuts them."""
    num_data = full_data.construct().num_data()
    rng = np.random.default_rng(seed)
    if stratified:
        label = np.asarray(full_data.get_label())
        folds_idx = [[] for _ in range(nfold)]
        for c in np.unique(label):
            idx_c = np.flatnonzero(label == c)
            if shuffle:
                rng.shuffle(idx_c)
            for i, part in enumerate(np.array_split(idx_c, nfold)):
                folds_idx[i].append(part)
        folds_idx = [np.concatenate(parts) for parts in folds_idx]
    else:
        idx = np.arange(num_data)
        if shuffle:
            rng.shuffle(idx)
        folds_idx = np.array_split(idx, nfold)
    for i in range(nfold):
        test_idx = np.sort(np.asarray(folds_idx[i]))
        train_idx = np.sort(np.concatenate(
            [folds_idx[j] for j in range(nfold) if j != i]))
        yield train_idx, test_idx


def cv(
    params: Dict[str, Any],
    train_set: Dataset,
    num_boost_round: int = 100,
    folds=None,
    nfold: int = 5,
    stratified: bool = True,
    shuffle: bool = True,
    metrics=None,
    feval=None,
    init_model=None,
    seed: int = 0,
    callbacks: Optional[Sequence[Callable]] = None,
    eval_train_metric: bool = False,
    return_cvbooster: bool = False,
    device="cuda",
) -> Dict[str, List[float]]:
    """Cross-validation (JAX ``engine.py:389-469``; LightGBM's
    python-package ``cv``): one booster a fold on ``device``, all updated
    each round; the result holds ``"valid <metric>-mean"`` and ``-stdv`` a
    round (``"train ..."`` too under ``eval_train_metric``), and
    ``"cvbooster"`` under ``return_cvbooster``.  ``folds`` (pairs of
    index arrays) replaces the generated folds.  ``init_model`` (as
    ``train`` takes it) starts every fold: its raw predictions are the
    fold's init score, its trees head the fold's model.  ``callbacks``
    run each round as the reference's ``cv`` runs them: the
    ``CVBooster`` as the model, the aggregated ``("cv_agg", "<set>
    <metric>", mean, higher_better, stdv)`` as the results.  Early
    stopping (on the first metric's mean under ``early_stopping_round``,
    or a callback's ``EarlyStopException``) sets every fold's best
    iteration and cuts the result there."""
    params, fobj = _split_fobj(params)
    if metrics is not None:
        params["metric"] = metrics
    cfg = Config.from_params(params)
    if "num_iterations" in {Config.canonical_name(k) for k in params}:
        num_boost_round = cfg.num_iterations
    predictor = _init_predictor(init_model, train_set, params, device)
    init_raw = None
    if predictor is not None and train_set.init_score is None:
        if train_set.data is None:
            raise LightGBMError("cv's init_model needs the raw data to "
                                "predict: construct the Dataset with "
                                "free_raw_data=False")
        init_raw = np.asarray(predictor.predict(
            train_set.data, raw_score=True,
            num_iteration=predictor.current_iteration()), np.float64)
    train_set.construct()
    if stratified and cfg.objective not in ("binary", "multiclass",
                                            "multiclassova"):
        stratified = False
    if folds is None:
        folds = _make_n_folds(train_set, nfold, seed, stratified, shuffle)
    cvbooster = CVBooster()
    for train_idx, test_idx in folds:
        dtrain = train_set.subset(train_idx)
        if init_raw is not None:
            dtrain.set_init_score(_init_scores(init_raw[train_idx]))
        b = Booster(params=params, train_set=dtrain, device=device)
        _keep_trees(b, predictor)
        b.add_valid(train_set.subset(test_idx), "valid")
        cvbooster.append(b)
    cbs_before, cbs_after = _split_callbacks(list(callbacks or []))

    def stop(best: int) -> None:
        cvbooster.best_iteration = best
        for b in cvbooster.boosters:
            b.best_iteration = best
        for key in list(results):
            results[key] = results[key][:best]

    results: Dict[str, List[float]] = {}
    es_rounds = cfg.early_stopping_round
    best_iter, no_improve, best_agg = -1, 0, None
    for it in range(num_boost_round):
        for cb in cbs_before:
            cb(callback_mod.CallbackEnv(cvbooster, params, it, 0,
                                        num_boost_round, None))
        agg: Dict[str, List[float]] = {}
        hb_map: Dict[str, bool] = {}
        for b in cvbooster.boosters:
            b.update(fobj=fobj)
            for ds, name, value, hb in b.eval_valid(feval):
                key = f"{ds} {name}"
                agg.setdefault(key, []).append(value)
                hb_map[key] = hb
            if eval_train_metric:
                for _, name, value, hb in b.eval_train(feval):
                    key = f"train {name}"
                    agg.setdefault(key, []).append(value)
                    hb_map[key] = hb
        res = [("cv_agg", key, float(np.mean(vals)), hb_map[key],
                float(np.std(vals))) for key, vals in agg.items()]
        for _, key, mean, _, stdv in res:
            results.setdefault(f"{key}-mean", []).append(mean)
            results.setdefault(f"{key}-stdv", []).append(stdv)
        try:
            for cb in cbs_after:
                cb(callback_mod.CallbackEnv(cvbooster, params, it, 0,
                                            num_boost_round, res))
        except callback_mod.EarlyStopException as e:
            stop(e.best_iteration + 1)
            break
        if es_rounds and es_rounds > 0 and res:
            mean0 = res[0][2]
            if (best_agg is None or (mean0 > best_agg if res[0][3]
                                     else mean0 < best_agg)):
                best_agg, best_iter, no_improve = mean0, it + 1, 0
            else:
                no_improve += 1
                if no_improve >= es_rounds:
                    stop(best_iter)
                    break
    if return_cvbooster:
        results["cvbooster"] = cvbooster
    return results
