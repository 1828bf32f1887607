"""Parameters and environment knobs.

``Config`` is the port's own copy of ``lightgbm_tpu.config.Config``
(reference config.h:34 ``Config``; config.cpp:230 ``Config::Set``): the
same fields, defaults, alias table and conflict checks, so one parameter
dict parses identically in both packages and a trained model's
``parameters:`` section is written the same way.  The TPU-only fields
(``device_type`` defaulting to ``"tpu"``, ``tpu_*``) are kept for that
reason; the port selects its device with the ``device=`` argument of
its entry points instead.  :func:`env_knob`, the serve knobs, the
training-route knobs (``ops/routing.py``) and the resilience knobs
(``resilience/``) keep the names, defaults and help text of
``lightgbm_tpu.config.ENV_KNOBS``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional, Sequence, Union

from .utils import log

# name -> (default, one-line effect)
ENV_KNOBS: Dict[str, tuple] = {
    "LGBM_TPU_SERVE_LEAF_BF16": ("0", "store stacked leaf values as "
                                      "bfloat16 (halves leaf-table "
                                      "bytes; scores still accumulate "
                                      "f32, and the serving digest "
                                      "carries the leaf dtype)"),
    "LGBM_TPU_SERVE_BUCKETS": ("16:65536", "FLOOR:CAP power-of-two row "
                                           "buckets for serving batch "
                                           "shapes; larger batches "
                                           "chunk at CAP"),
    "LGBM_TPU_SERVE_QUEUE": ("2", "dispatch queue depth for bulk and "
                                  "small-batch serving (submit batch "
                                  "t+1 while t is in flight)"),
    "LGBM_TPU_STREAM": ("auto", "0 disables score-resident gradient "
                                "streaming (ops/routing.py)"),
    "LGBM_TPU_FUSED": ("1", "0 disables the fused partition+histogram "
                            "split kernel (partition scan + smaller-child "
                            "histogram instead)"),
    "LGBM_TPU_APPLY_IMPL": ("kernel", "xla keeps the PyTorch split tail "
                                      "instead of the apply_find kernel"),
    "LGBM_TPU_PHYS": ("auto", "0 disables the physical row partition "
                              "(training takes the row_order path)"),
    "LGBM_TPU_HIST_IMPL": ("auto", "row_order histogram: auto / pallas2 "
                                   "/ pallas select the hist_rows "
                                   "kernel; matmul / scatter raise"),
    "LGBM_TPU_PART": ("ss", "3ph restores the 3-phase partition kernel "
                            "(implies the unfused split path); any value "
                            "but ss or 3ph raises (the JAX package reads "
                            "every other value as ss)"),
    "LGBM_TPU_POOL_TAIL": ("1", "0 disables the pool-resident "
                                "apply+find kernel (the pool ops run in "
                                "PyTorch, then the plain-pool kernel)"),
    "LGBM_TPU_HIST_SCATTER": ("1", "0 merges the data-parallel learner's "
                                   "histograms whole on every rank "
                                   "instead of reduce-scattering them by "
                                   "feature chunk (the same bits)"),
    "LGBM_TPU_COMB_PACK": ("1", "2 keeps each row as one record of its "
                                "bins and fields (64 bytes at 28 features) "
                                "and runs the route's pack=2 kernels where "
                                "the JAX package engages pack=2"),
    "LGBM_TPU_CKPT_DIR": ("off", "checkpoint directory for "
                                 "deterministic train checkpoint/"
                                 "resume (lightgbm_tpu/ckpt/v1; "
                                 "engine.train resumes from the "
                                 "latest valid checkpoint found "
                                 "here)"),
    "LGBM_TPU_CKPT_EVERY": ("10", "checkpoint cadence in boosting "
                                  "iterations (0 = resume-only, "
                                  "never write)"),
    "LGBM_TPU_CKPT_KEEP": ("2", "how many completed checkpoints to "
                                "retain (older ones are pruned "
                                "after each save)"),
    "LGBM_TPU_CKPT_AT_REFRESH": ("0", "1 re-anchors the physical row "
                                      "permutation IN PLACE at each "
                                      "checkpoint save on the stream "
                                      "path (one anchored-order "
                                      "gather at the refresh "
                                      "boundary, where the value "
                                      "columns were just rebuilt "
                                      "anyway) instead of dropping "
                                      "the comb for a full re-ingest "
                                      "— kill+resume stays "
                                      "byte-identical"),
    "LGBM_TPU_FAULT": ("off", "fault injection: <class>@<iteration> "
                              "with class in death | nan | oom | "
                              "hang (resilience/faults.py; each "
                              "spec fires once per process)"),
    "LGBM_TPU_FAULT_RETRIES": ("2", "bounded resume-from-checkpoint "
                                    "retries for recoverable "
                                    "injected/observed faults at the "
                                    "engine boundary"),
    "LGBM_TPU_NUMERICS": ("off", "NaN/Inf guardrails on grad/hess/"
                                 "histogram/gain in the grow path: "
                                 "raise | skip | clamp (off "
                                 "compiles the identical grow "
                                 "program — analyzer purity pin "
                                 "grow-numerics-off)"),
}


def env_knob(name: str, environ=None) -> str:
    """Documented read of one ``LGBM_TPU_*`` environment knob: the name
    must be registered in :data:`ENV_KNOBS`, and an unset or empty
    variable returns the table's default.  Raises ``KeyError`` for an
    unregistered name: an undocumented knob read is a bug."""
    if name not in ENV_KNOBS:
        raise KeyError(
            f"{name!r} is not a registered LGBM_TPU knob of "
            "lightgbm_tpu_torch; add it to config.ENV_KNOBS before "
            "reading it")
    val = (environ if environ is not None else os.environ).get(name, "")
    return val if val != "" else ENV_KNOBS[name][0]


# ---------------------------------------------------------------------------
# Alias table (reference: config_auto.cpp:10, ~150 entries).
# Maps alias -> canonical parameter name.
# ---------------------------------------------------------------------------
ALIASES: Dict[str, str] = {
    "config_file": "config",
    "task_type": "task",
    "objective_type": "objective",
    "app": "objective",
    "application": "objective",
    "loss": "objective",
    "boosting_type": "boosting",
    "boost": "boosting",
    "train": "data",
    "train_data": "data",
    "train_data_file": "data",
    "data_filename": "data",
    "test": "valid",
    "valid_data": "valid",
    "valid_data_file": "valid",
    "test_data": "valid",
    "test_data_file": "valid",
    "valid_filenames": "valid",
    "num_iteration": "num_iterations",
    "n_iter": "num_iterations",
    "num_tree": "num_iterations",
    "num_trees": "num_iterations",
    "num_round": "num_iterations",
    "num_rounds": "num_iterations",
    "nrounds": "num_iterations",
    "num_boost_round": "num_iterations",
    "n_estimators": "num_iterations",
    "max_iter": "num_iterations",
    "shrinkage_rate": "learning_rate",
    "eta": "learning_rate",
    "num_leaf": "num_leaves",
    "max_leaves": "num_leaves",
    "max_leaf": "num_leaves",
    "max_leaf_nodes": "num_leaves",
    "tree": "tree_learner",
    "tree_type": "tree_learner",
    "tree_learner_type": "tree_learner",
    "num_thread": "num_threads",
    "nthread": "num_threads",
    "nthreads": "num_threads",
    "n_jobs": "num_threads",
    "device": "device_type",
    "random_seed": "seed",
    "random_state": "seed",
    "hist_pool_size": "histogram_pool_size",
    "min_data_per_leaf": "min_data_in_leaf",
    "min_data": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "min_samples_leaf": "min_data_in_leaf",
    "min_sum_hessian_per_leaf": "min_sum_hessian_in_leaf",
    "min_sum_hessian": "min_sum_hessian_in_leaf",
    "min_hessian": "min_sum_hessian_in_leaf",
    "min_child_weight": "min_sum_hessian_in_leaf",
    "sub_row": "bagging_fraction",
    "subsample": "bagging_fraction",
    "bagging": "bagging_fraction",
    "pos_sub_row": "pos_bagging_fraction",
    "pos_subsample": "pos_bagging_fraction",
    "pos_bagging": "pos_bagging_fraction",
    "neg_sub_row": "neg_bagging_fraction",
    "neg_subsample": "neg_bagging_fraction",
    "neg_bagging": "neg_bagging_fraction",
    "subsample_freq": "bagging_freq",
    "bagging_fraction_seed": "bagging_seed",
    "sub_feature": "feature_fraction",
    "colsample_bytree": "feature_fraction",
    "sub_feature_bynode": "feature_fraction_bynode",
    "colsample_bynode": "feature_fraction_bynode",
    "extra_tree": "extra_trees",
    "early_stopping_rounds": "early_stopping_round",
    "early_stopping": "early_stopping_round",
    "n_iter_no_change": "early_stopping_round",
    "max_tree_output": "max_delta_step",
    "max_leaf_output": "max_delta_step",
    "reg_alpha": "lambda_l1",
    "l1_regularization": "lambda_l1",
    "reg_lambda": "lambda_l2",
    "lambda": "lambda_l2",
    "l2_regularization": "lambda_l2",
    "min_split_gain": "min_gain_to_split",
    "rate_drop": "drop_rate",
    "topk": "top_k",
    "mc": "monotone_constraints",
    "monotone_constraint": "monotone_constraints",
    "monotonic_cst": "monotone_constraints",
    "monotone_constraining_method": "monotone_constraints_method",
    "mc_method": "monotone_constraints_method",
    "monotone_splits_penalty": "monotone_penalty",
    "ms_penalty": "monotone_penalty",
    "mc_penalty": "monotone_penalty",
    "feature_contrib": "feature_contri",
    "fc": "feature_contri",
    "fp": "feature_contri",
    "feature_penalty": "feature_contri",
    "fs": "forcedsplits_filename",
    "forced_splits_filename": "forcedsplits_filename",
    "forced_splits_file": "forcedsplits_filename",
    "forced_splits": "forcedsplits_filename",
    "verbose": "verbosity",
    "model_input": "input_model",
    "model_in": "input_model",
    "model_output": "output_model",
    "model_out": "output_model",
    "save_period": "snapshot_freq",
    "linear_trees": "linear_tree",
    "max_bins": "max_bin",
    "subsample_for_bin": "bin_construct_sample_cnt",
    "data_seed": "data_random_seed",
    "is_sparse": "is_enable_sparse",
    "enable_sparse": "is_enable_sparse",
    "sparse": "is_enable_sparse",
    "is_enable_bundle": "enable_bundle",
    "bundle": "enable_bundle",
    "is_pre_partition": "pre_partition",
    "two_round_loading": "two_round",
    "use_two_round_loading": "two_round",
    "has_header": "header",
    "label": "label_column",
    "weight": "weight_column",
    "group": "group_column",
    "group_id": "group_column",
    "query_column": "group_column",
    "query": "group_column",
    "query_id": "group_column",
    "ignore_feature": "ignore_column",
    "blacklist": "ignore_column",
    "cat_feature": "categorical_feature",
    "categorical_column": "categorical_feature",
    "cat_column": "categorical_feature",
    "categorical_features": "categorical_feature",
    "is_save_binary": "save_binary",
    "is_save_binary_file": "save_binary",
    "is_predict_raw_score": "predict_raw_score",
    "predict_rawscore": "predict_raw_score",
    "raw_score": "predict_raw_score",
    "is_predict_leaf_index": "predict_leaf_index",
    "leaf_index": "predict_leaf_index",
    "is_predict_contrib": "predict_contrib",
    "contrib": "predict_contrib",
    "predict_result": "output_result",
    "prediction_result": "output_result",
    "predict_name": "output_result",
    "prediction_name": "output_result",
    "pred_name": "output_result",
    "name_pred": "output_result",
    "convert_model_file": "convert_model",
    "num_classes": "num_class",
    "unbalance": "is_unbalance",
    "unbalanced_sets": "is_unbalance",
    "metrics": "metric",
    "metric_types": "metric",
    "output_freq": "metric_freq",
    "training_metric": "is_provide_training_metric",
    "is_training_metric": "is_provide_training_metric",
    "train_metric": "is_provide_training_metric",
    "ndcg_eval_at": "eval_at",
    "ndcg_at": "eval_at",
    "map_eval_at": "eval_at",
    "map_at": "eval_at",
    "num_machine": "num_machines",
    "local_port": "local_listen_port",
    "port": "local_listen_port",
    "machine_list_file": "machine_list_filename",
    "machine_list": "machine_list_filename",
    "mlist": "machine_list_filename",
    "workers": "machines",
    "nodes": "machines",
}

_LIST_INT = List[int]
_LIST_FLOAT = List[float]
_LIST_STR = List[str]


@dataclass
class Config:
    """All parameters, canonical names and defaults matching the reference
    (include/LightGBM/config.h).  Fields are grouped as in the reference docs.
    """

    # -- core --
    config: str = ""
    task: str = "train"
    objective: str = "regression"
    boosting: str = "gbdt"
    data: str = ""
    valid: _LIST_STR = field(default_factory=list)
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    tree_learner: str = "serial"
    num_threads: int = 0
    device_type: str = "tpu"
    seed: int = 0
    deterministic: bool = False

    # -- learning control --
    force_col_wise: bool = False
    force_row_wise: bool = False
    histogram_pool_size: float = -1.0
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    bagging_fraction: float = 1.0
    pos_bagging_fraction: float = 1.0
    neg_bagging_fraction: float = 1.0
    bagging_freq: int = 0
    bagging_seed: int = 3
    feature_fraction: float = 1.0
    feature_fraction_bynode: float = 1.0
    feature_fraction_seed: int = 2
    extra_trees: bool = False
    extra_seed: int = 6
    early_stopping_round: int = 0
    first_metric_only: bool = False
    max_delta_step: float = 0.0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    linear_lambda: float = 0.0
    min_gain_to_split: float = 0.0
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    xgboost_dart_mode: bool = False
    uniform_drop: bool = False
    drop_seed: int = 4
    top_rate: float = 0.2
    other_rate: float = 0.1
    min_data_per_group: int = 100
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    top_k: int = 20
    monotone_constraints: _LIST_INT = field(default_factory=list)
    monotone_constraints_method: str = "basic"
    monotone_penalty: float = 0.0
    feature_contri: _LIST_FLOAT = field(default_factory=list)
    forcedsplits_filename: str = ""
    refit_decay_rate: float = 0.9
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    cegb_penalty_feature_lazy: _LIST_FLOAT = field(default_factory=list)
    cegb_penalty_feature_coupled: _LIST_FLOAT = field(default_factory=list)
    path_smooth: float = 0.0
    interaction_constraints: str = ""
    verbosity: int = 1

    # -- IO / dataset --
    input_model: str = ""
    output_model: str = "LightGBM_model.txt"
    saved_feature_importance_type: int = 0
    snapshot_freq: int = -1
    linear_tree: bool = False
    max_bin: int = 255
    max_bin_by_feature: _LIST_INT = field(default_factory=list)
    min_data_in_bin: int = 3
    bin_construct_sample_cnt: int = 200000
    data_random_seed: int = 1
    is_enable_sparse: bool = True
    enable_bundle: bool = True
    use_missing: bool = True
    zero_as_missing: bool = False
    feature_pre_filter: bool = True
    pre_partition: bool = False
    two_round: bool = False
    header: bool = False
    label_column: str = ""
    weight_column: str = ""
    group_column: str = ""
    ignore_column: str = ""
    categorical_feature: str = ""
    forcedbins_filename: str = ""
    save_binary: bool = False
    precise_float_parser: bool = False
    parser_config_file: str = ""

    # -- predict --
    start_iteration_predict: int = 0
    num_iteration_predict: int = -1
    predict_raw_score: bool = False
    predict_leaf_index: bool = False
    predict_contrib: bool = False
    predict_disable_shape_check: bool = False
    pred_early_stop: bool = False
    pred_early_stop_freq: int = 10
    pred_early_stop_margin: float = 10.0
    output_result: str = "LightGBM_predict_result.txt"

    # -- convert model --
    convert_model_language: str = ""
    convert_model: str = "gbdt_prediction.cpp"

    # -- objective --
    objective_seed: int = 5
    num_class: int = 1
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0
    sigmoid: float = 1.0
    boost_from_average: bool = True
    reg_sqrt: bool = False
    alpha: float = 0.9
    fair_c: float = 1.0
    poisson_max_delta_step: float = 0.7
    tweedie_variance_power: float = 1.5
    lambdarank_truncation_level: int = 30
    lambdarank_norm: bool = True
    label_gain: _LIST_FLOAT = field(default_factory=list)

    # -- metric --
    metric: _LIST_STR = field(default_factory=list)
    metric_freq: int = 1
    is_provide_training_metric: bool = False
    eval_at: _LIST_INT = field(default_factory=lambda: [1, 2, 3, 4, 5])
    multi_error_top_k: int = 1
    auc_mu_weights: _LIST_FLOAT = field(default_factory=list)

    # -- network (reference: socket/MPI machine list; here: jax mesh) --
    num_machines: int = 1
    local_listen_port: int = 12400
    time_out: int = 120
    machine_list_filename: str = ""
    machines: str = ""

    # -- device --
    gpu_platform_id: int = -1
    gpu_device_id: int = -1
    gpu_use_dp: bool = False
    num_gpu: int = 1
    # TPU-specific (no reference analog): mesh shape for distributed training
    # and histogram kernel selection.
    tpu_mesh_axes: str = ""          # e.g. "data:8" or "data:4,feature:2"
    tpu_histogram_impl: str = "auto"  # auto | xla | pallas
    tpu_rows_per_block: int = 8192    # row-block size for histogram streaming

    # ------------------------------------------------------------------
    @staticmethod
    def canonical_name(name: str) -> str:
        name = name.strip().lower()
        return ALIASES.get(name, name)

    @classmethod
    def param_names(cls) -> List[str]:
        return [f.name for f in fields(cls)]

    @classmethod
    def from_params(
        cls,
        params: Optional[Union[Dict[str, Any], str, Sequence[str]]] = None,
        **kwargs: Any,
    ) -> "Config":
        """Build a Config from a dict / ``"k=v k2=v2"`` string / kwargs.

        Reference: Config::Set (config.cpp:230) + KV2Map (config.cpp:16).
        Unknown keys warn (the reference warns about unknown parameters too).
        When the same canonical parameter is given via several aliases, the
        first occurrence wins and later ones warn (config.cpp:42 behavior).
        """
        merged: Dict[str, Any] = {}
        provenance: Dict[str, str] = {}

        def _add(key: str, value: Any) -> None:
            canon = cls.canonical_name(key)
            if canon in merged:
                if merged[canon] != value:
                    log.warning(
                        "%s is set=%r, %s=%r will be ignored. "
                        "Current value: %s=%r",
                        provenance[canon], merged[canon], key, value,
                        canon, merged[canon],
                    )
                return
            merged[canon] = value
            provenance[canon] = key

        if isinstance(params, str):
            params = params.replace("\n", " ").split()
        if isinstance(params, dict):
            for k, v in params.items():
                _add(k, v)
        elif params is not None:
            for tok in params:
                tok = tok.strip()
                if not tok or tok.startswith("#"):
                    continue
                if "=" not in tok:
                    log.warning("Unknown parameter token %r (expected key=value)", tok)
                    continue
                k, v = tok.split("=", 1)
                _add(k, v.split("#", 1)[0].strip())
        for k, v in kwargs.items():
            _add(k, v)

        cfg = cls()
        valid_names = set(cls.param_names())
        explicit = []
        for k, v in merged.items():
            if k not in valid_names:
                log.warning("Unknown parameter: %s", k)
                continue
            setattr(cfg, k, _coerce(cls, k, v))
            explicit.append(k)
        cfg._explicit = explicit
        cfg.check_conflicts()
        return cfg

    def explicit_params(self) -> Dict[str, Any]:
        """The parameters the caller set (canonical names), as the JAX
        package's ``Config.explicit_params``: what the CLI forwards to
        ``train``."""
        return {k: getattr(self, k) for k in getattr(self, "_explicit", [])}

    # ------------------------------------------------------------------
    def check_conflicts(self) -> None:
        """Mirror of Config::CheckParamConflict (config.cpp:286): normalise
        inconsistent combinations instead of failing where the reference does.
        """
        if self.num_leaves < 2:
            log.warning("num_leaves must be >= 2; set to 2")
            self.num_leaves = 2
        if self.max_depth > 0:
            # reference caps num_leaves at 2^max_depth
            cap = 1 << min(self.max_depth, 30)
            if self.num_leaves > cap:
                log.warning(
                    "Accuracy may be bad since num_leaves (%d) > 2^max_depth (%d)",
                    self.num_leaves, cap)
                self.num_leaves = cap
        if self.boosting == "rf":
            if self.bagging_freq <= 0 or self.bagging_fraction >= 1.0 or self.bagging_fraction <= 0.0:
                log.fatal("Random forest needs bagging_freq > 0 and 0 < bagging_fraction < 1")
        if self.boosting == "goss":
            # reference >=4.0 folds goss into data_sample_strategy; keep the
            # 3.x behavior: goss disables bagging.
            self.bagging_fraction = 1.0
            self.bagging_freq = 0
        if (self.pos_bagging_fraction != 1.0 or self.neg_bagging_fraction != 1.0) and (
            self.bagging_freq == 0
        ):
            log.warning("pos/neg bagging fractions need bagging_freq > 0; ignoring")
            self.pos_bagging_fraction = 1.0
            self.neg_bagging_fraction = 1.0
        if self.objective in ("lambdarank", "rank_xendcg") and not self.metric:
            self.metric = ["ndcg"]
        if self.max_bin < 2:
            log.fatal("max_bin must be >= 2")
        if self.device_type not in ("cpu", "tpu", "gpu", "cuda", "cuda_exp"):
            log.fatal("Unknown device_type %s", self.device_type)
        if self.tree_learner not in ("serial", "feature", "data", "voting"):
            log.fatal("Unknown tree_learner %s", self.tree_learner)

    # ------------------------------------------------------------------
    def to_param_string(self) -> str:
        """Serialise non-default parameters (reference: GetLoadedParam,
        saved in the model file's ``parameters:`` section)."""
        default = Config()
        parts = []
        for f in fields(self):
            v = getattr(self, f.name)
            if v != getattr(default, f.name):
                if isinstance(v, list):
                    v = ",".join(str(x) for x in v)
                parts.append(f"[{f.name}: {v}]")
        return "\n".join(parts)


def _coerce(cls, name: str, value: Any) -> Any:
    """Coerce a raw (possibly string) value to the field's declared type."""
    ftype = cls.__dataclass_fields__[name].type
    if isinstance(ftype, str):
        ftype_s = ftype
    else:  # typing object
        ftype_s = str(ftype)
    try:
        if ftype_s in ("int", "<class 'int'>"):
            return int(float(value))
        if ftype_s in ("float", "<class 'float'>"):
            return float(value)
        if ftype_s in ("bool", "<class 'bool'>"):
            if isinstance(value, str):
                return value.strip().lower() in ("true", "1", "+", "yes", "y", "on")
            return bool(value)
        if ftype_s in ("str", "<class 'str'>"):
            return str(value)
        # list types
        if "List[int]" in ftype_s or "_LIST_INT" in ftype_s:
            return _to_list(value, int)
        if "List[float]" in ftype_s or "_LIST_FLOAT" in ftype_s:
            return _to_list(value, float)
        if "List[str]" in ftype_s or "_LIST_STR" in ftype_s:
            return _to_list(value, str)
    except (TypeError, ValueError):
        log.fatal("Bad value %r for parameter %s", value, name)
    return value


def _to_list(value: Any, typ) -> list:
    if value is None:
        return []
    if isinstance(value, (list, tuple)):
        return [typ(v) for v in value]
    if isinstance(value, str):
        value = value.strip()
        if not value:
            return []
        return [typ(float(v)) if typ is int else typ(v) for v in value.split(",")]
    return [typ(value)]
