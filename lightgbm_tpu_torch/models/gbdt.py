"""GBDT boosting on one device.

Counterpart of the serial path of ``lightgbm_tpu/models/gbdt.py``
(reference gbdt.cpp: TrainOneIter :437, BoostFromAverage :412,
UpdateScore :580-607).  The route is decided up front
(``ops/routing.py``).  On the default, score-resident stream route the
gradients live in the row matrix and are refreshed there at each tree's
end, so an iteration computes no objective gradients; the grower reads
the scores (boost-from-average included) once when it builds its rows
and the shrinkage rate on every call.  On slice 2's route, and for
every objective the stream route has no formula for, the objective's
gradients are computed on the device from the training scores each
iteration, and so on the ``row_order`` path (u16 bins at
``max_bin > 255``, or ``LGBM_TPU_PHYS=0``).  One tree grows on the row
matrix (``ops.grow.SerialGrower``) or on a row-order index
(``ops.grow.RowOrderGrower``), and the training and validation scores
take the tree's shrunk leaf outputs on the device, for ``eval`` and
``predict``.  The finished tree comes to the host as a
``Tree`` (one read per tree); the boost-from-average init score is
folded into the first tree, so saved models are self-contained.

Each iteration's gradients go through the sampling hook
(:meth:`GBDT._sample`, JAX ``gbdt.py:1358``): bagging draws an in-bag
mask from the JAX package's threefry stream (``utils/random.uniform``),
GOSS (``models/goss.py``) keeps the large gradients and a sample of the
rest, RF (``models/rf.py``) bags trees grown from constant gradients.
The mask weights each row's gradient, hessian and count in the
histograms; out-of-bag rows still move through every partition and take
the tree's output in the scores.

A multiclass objective grows K trees an iteration (models at
``iter * K + k``), the scores class-major ``[K, n]``: class by class,
each through the same grower, whose row matrix carries from class to
class (the JAX package's serial-K path, which its batched scan
reproduces bit for bit).  A class whose first-round tree is a stump
trains no more and gets zero stumps (``class_need_train``).  The
percentile objectives (l1, huber, quantile, mape) refit each tree's
leaf outputs before the score update (``objective.regression.
renew_leaf_values``, on the training device).

The split options the kernel tail has no mode for (interaction
constraints, CEGB, forced splits, ``feature_fraction_bynode``,
``extra_trees``; ``models/constraints.py``) go to the grower as
``ops.grow.GrowOptions`` and take the PyTorch tail (``tail=xla``); each
tree's draws are salted by ``iteration * K + class`` (JAX
``gbdt.py:1378``), and lazy CEGB's paid mask ``[F, n]`` lives here,
across trees, on the row-order path.

Linear trees (``linear_tree``, ``models/linear.py``; routing rule
``linear_tree`` takes the stream away): after each tree is grown, its
leaves' linear models are fitted from the dataset's raw values (on the
device once) under the stage ``linear_fit``, the training scores take
``rate * pred`` and each validation set replays the tree's models.
Under ``gpu_use_dp`` the route is ``row_order`` (rule ``gpu_use_dp``)
and the grower's histograms accumulate in f64.

Continued training (:meth:`GBDT.set_init_model`, JAX ``gbdt.py:667-700``)
keeps an earlier model's trees, their bin thresholds found anew against
this dataset's bin mappers, while the dataset's init score (the caller
sets it to the earlier model's raw predictions) starts the scores.
:meth:`GBDT.rollback_one_iter` (JAX ``gbdt.py:1875-1920``) drops the
last iteration's trees: the scores from before that iteration are kept
(one copy), so rolling it back restores them bit for bit; an older
iteration's trees are subtracted, as LightGBM does.

Under a parallel learner (``tree_learner=data|voting|feature``,
``parallel/``; one process a rank) the booster opens the rank's
collectives (``parallel.mesh_comm``; a group of one rank trains
serially), keeps its block of rows on the device under the data and
voting learners (every row under the feature learner), initialises the
objective on those rows after taking the ``boost_from_average`` score
from the whole dataset, and hands the grower the learner's merge points;
the training metrics read the ranks' scores gathered in rank order
(:meth:`GBDT.eval`).  The parameter values the parallel learners do not
train yet raise ``LightGBMError`` naming ROADMAP A10
(:func:`mesh_refusals`).

Resilience (``resilience/``, JAX ``gbdt.py:119-126``, ``:725-830``,
``:1030-1090``): ``LGBM_TPU_NUMERICS`` wraps the serial grower in
``ops.grow.NumericsGuard`` (``off`` builds nothing) and guards a parallel
learner's gradients at this boundary; a poisoned tree raises
``NumericalFault`` or, under ``skip``, becomes a zero stump (on the
stream route the rows are rebuilt from the scores, which never took it).
``LGBM_TPU_FAULT=nan@i`` poisons the gradients where they are computed.
:meth:`GBDT.checkpoint_state` and :meth:`GBDT.restore_checkpoint_state`
carry the exact boosting state of a ckpt/v1 snapshot, and
:meth:`GBDT._reanchor_physical` puts the carried rows back in original
order after every save.

Unlike the JAX package, trees are finalized synchronously, so an
iteration in which no class's tree can split stops training at once
(the reference's synchronous behaviour).  Parameters the port does not
have yet raise ``LightGBMError`` (:func:`check_supported`).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

import copy

from .. import parallel
from ..config import Config, env_knob
from ..io.binning import BinType
from ..io.dataset_core import BinnedDataset
from ..metric import Metric
from ..models.constraints import build_grow_constraints
from ..models.model_text import feature_infos
from ..objective import canonical_objective
from ..objective.base import ObjectiveFunction
from ..objective.regression import renew_leaf_values
from ..ops.device_data import DeviceDataset, to_device
from ..ops.apply_find import apply_find_supported
from ..ops.fused_split import fused_supported
from ..ops.grow import (NumericsGuard, RowOrderGrower, SerialGrower,
                        StageTimer, StreamSpec, TreeArrays,
                        predict_leaf_bins)
from ..ops.histogram import histogram_impl
from ..ops.routing import (decide, inputs_from_env, loud_rules,
                           resolve_layout)
from ..ops.split import SplitHyperParams
from ..resilience import faults
from ..resilience import numerics as numerics_mod
from ..utils import log
from ..utils.log import LightGBMError
from ..utils.random import make_rng, prng_key, uniform
from .linear import (LinearParams, fit_linear_models, linear_leaf_output,
                     linear_params)
from .tree import Tree, _bitset


def _unported(what: str, where: str) -> None:
    raise LightGBMError(
        f"{what} is not ported to lightgbm_tpu_torch yet (see ROADMAP.md, "
        f"{where}); the JAX package lightgbm_tpu trains it")


def bagging_on(cfg: Config) -> bool:
    """Whether bagging draws an in-bag mask (JAX ``gbdt.py:590-593``)."""
    return cfg.bagging_freq > 0 and (cfg.bagging_fraction < 1.0
                                     or cfg.pos_bagging_fraction < 1.0
                                     or cfg.neg_bagging_fraction < 1.0)


def sample_key(cfg: Config, it: int):
    """The threefry key of iteration ``it``'s bagging or GOSS draw (JAX
    ``gbdt.py:896``, ``goss.py:47``)."""
    return prng_key((cfg.bagging_seed * 2654435761 + it) & 0x7FFFFFFF)


def check_pack_conflicts(cfg: Config) -> None:
    """The JAX package's refusals of ``LGBM_TPU_COMB_PACK=2``
    (``config.py:757-776``), with its messages (a value other than 1 or
    2 raises in ``routing.inputs_from_env``)."""
    if env_knob("LGBM_TPU_COMB_PACK") != "2":
        return
    if cfg.max_bin > 256:
        log.fatal("LGBM_TPU_COMB_PACK=2 requires max_bin <= 256: the "
                  "physical comb layout stores uint8 bins, and max_bin > "
                  "256 keeps the row_order path where the pack knob has no "
                  "effect")
    if cfg.gpu_use_dp:
        log.fatal("LGBM_TPU_COMB_PACK=2 is incompatible with gpu_use_dp "
                  "(double-precision histograms disable the physical comb "
                  "path entirely)")
    if env_knob("LGBM_TPU_PART") == "3ph":
        log.fatal("LGBM_TPU_COMB_PACK=2 requires the single-scan partition "
                  "kernel; unset LGBM_TPU_PART=3ph")


# the objectives the parallel learners train (canonical names)
MESH_OBJECTIVES = ("binary", "regression", "multiclass", "multiclassova")


def mesh_refusals(cfg: Config) -> List[str]:
    """The parameter values of ``cfg`` that a parallel learner does not
    train yet (ROADMAP A10's remainder): every one the serial port trains
    beyond the binary, l2 and multiclass objectives with ``gbdt``
    boosting.  The sorted-subset categorical search, which depends on the
    data, is refused in :class:`GBDT`."""
    out = []
    obj = canonical_objective(cfg.objective)
    if obj not in MESH_OBJECTIVES:
        out.append(f"objective={cfg.objective}")
    if cfg.boosting.strip().lower() not in ("gbdt", "gbrt"):
        out.append(f"boosting={cfg.boosting}")
    if bagging_on(cfg):
        out.append("bagging")
    flags = (("linear_tree", cfg.linear_tree), ("gpu_use_dp", cfg.gpu_use_dp),
             ("is_unbalance", cfg.is_unbalance),
             ("monotone_constraints", any(int(v) for v in
                                          cfg.monotone_constraints)),
             ("CEGB", cfg.cegb_penalty_split > 0.0
              or bool(cfg.cegb_penalty_feature_coupled)
              or bool(cfg.cegb_penalty_feature_lazy)),
             ("forced splits", bool(cfg.forcedsplits_filename)),
             ("interaction_constraints",
              bool(cfg.interaction_constraints.strip())),
             ("feature_fraction_bynode", cfg.feature_fraction_bynode < 1.0),
             ("extra_trees", cfg.extra_trees),
             ("LGBM_TPU_COMB_PACK=2", env_knob("LGBM_TPU_COMB_PACK") == "2"),
             ("LGBM_TPU_PART=3ph", env_knob("LGBM_TPU_PART") == "3ph"),
             ("the hybrid data x feature mesh",
              len(parallel.mesh.parse_mesh_axes(cfg.tpu_mesh_axes)) > 1))
    return out + [name for name, on in flags if on]


def check_supported(cfg: Config) -> None:
    """Raise for the pack conflicts and for every parameter the port does
    not have yet (under a parallel learner: :func:`mesh_refusals`).  A
    serial learner trains serially whatever ``num_machines`` says, as
    LightGBM's does."""
    check_pack_conflicts(cfg)
    if cfg.tree_learner != "serial":
        refused = mesh_refusals(cfg)
        if refused:
            _unported(f"tree_learner={cfg.tree_learner} with "
                      f"{', '.join(refused)}", "A10")
    if cfg.pre_partition:
        _unported("pre_partition (paged / distributed data)", "A11")


def bynode_count(cfg: Config, ds: BinnedDataset) -> int:
    """Features a node keeps under ``feature_fraction_bynode`` (JAX
    ``gbdt.py:964-981``; 0 without by-node sampling): the fraction of
    the by-tree sample (ColSampler samples from used_feature_indices_),
    not of every feature.  The JAX package's warning and no-op for the
    feature-parallel learner does not arise: that learner raises in
    :func:`check_supported`."""
    if cfg.feature_fraction_bynode >= 1.0:
        return 0
    k_tree = ds.num_features
    if cfg.feature_fraction < 1.0:
        k_tree = max(1, int(np.ceil(k_tree * cfg.feature_fraction)))
    return max(1, int(np.ceil(k_tree * cfg.feature_fraction_bynode)))


def uses_cat_subset(cfg: Config, ds: BinnedDataset) -> bool:
    """Whether the sorted-subset categorical search runs
    (``lightgbm_tpu/models/gbdt.py:130-158``): a categorical feature has
    more bins than ``max_cat_to_onehot``."""
    return any(m.bin_type == BinType.CATEGORICAL
               and m.num_bins > cfg.max_cat_to_onehot for m in ds.mappers)


def row_block_dataset(ds: BinnedDataset, lo: int, hi: int) -> BinnedDataset:
    """The rows ``[lo, hi)`` of ``ds``: its bins, raw values and
    metadata (labels, weights, each class's init scores) sliced, the
    mappers shared."""
    out = copy.copy(ds)
    out.bin_matrix = ds.bin_matrix[lo:hi]
    if ds.raw_matrix is not None:
        out.raw_matrix = ds.raw_matrix[lo:hi]
    md = copy.copy(ds.metadata)
    n = ds.num_data
    for name in ("label", "weight"):
        v = getattr(md, name)
        if v is not None:
            setattr(md, name, v[lo:hi])
    if md.init_score is not None:
        md.init_score = md.init_score.reshape(-1, n)[:, lo:hi].reshape(-1)
    md.num_data = hi - lo
    out.metadata = md
    return out


def _init_scores(md, k: int, n: int, device) -> torch.Tensor:
    """[K, n] f32 scores from the dataset's init scores (class-major
    ``K * n``, or ``n`` for every class), zeros without them."""
    score = torch.zeros((k, n), dtype=torch.float32, device=device)
    if md.init_score is not None:
        s = md.init_score.reshape(-1)     # host f64 (Metadata)
        s = s.reshape(k, n) if s.size == k * n else s[:n].reshape(1, n)
        score += torch.as_tensor(s, dtype=torch.float32, device=device)
    return score


def _class_view(scores: torch.Tensor) -> torch.Tensor:
    """The scores as a one-model booster reads them, [n], else [K, n]."""
    return scores[0] if scores.shape[0] == 1 else scores


class _ValidSet:
    def __init__(self, name: str, data: BinnedDataset, bins: torch.Tensor,
                 metrics: Sequence[Metric]):
        self.name = name
        self.data = data
        self.bins = bins
        self.metrics = list(metrics)
        self.scores: Optional[torch.Tensor] = None   # [K, n] f32
        self.raw: Optional[torch.Tensor] = None      # [n, F] f32, linear

    @property
    def score(self) -> torch.Tensor:
        """[n] for a one-model booster, else [K, n]."""
        return _class_view(self.scores)


class GBDT:
    """The ``gbdt`` booster (reference boosting.cpp:35 factory name)."""

    NAME = "gbdt"

    def __init__(self, config: Config, train_set: BinnedDataset,
                 objective: Optional[ObjectiveFunction],
                 metrics: Sequence[Metric] = (), *,
                 device: torch.device, timer: Optional[StageTimer] = None):
        check_supported(config)
        # read once: a mistyped policy fails here, not unguarded later
        self._numerics = numerics_mod.policy()
        self.config = config
        self.train_set = train_set
        # a parallel learner's collectives (None: serial training)
        self.comm = (parallel.mesh_comm(config, device)
                     if config.tree_learner in parallel.MESH_LEARNERS
                     else None)
        learner = "serial" if self.comm is None else config.tree_learner
        self._rows_sharded = learner in ("data", "voting")
        local = train_set
        self._boost_init = None
        if self._rows_sharded:
            lo, hi = parallel.row_block(train_set.num_data, self.comm.rank,
                                        self.comm.world)
            if hi <= lo:
                raise LightGBMError(
                    f"rank {self.comm.rank} of {self.comm.world} gets no row "
                    f"of {train_set.num_data}")
            local = row_block_dataset(train_set, lo, hi)
            if objective is not None:
                # the whole data's init score, then the rank's rows
                self._boost_init = objective.boost_from_score()
                objective.init(local.metadata, local.num_data, device)
        self.objective = objective
        self.device = device
        self.models: List[Tree] = []
        self.iter_ = 0
        self.shrinkage_rate = config.learning_rate
        self.average_output = False
        self.num_tree_per_iteration = (
            objective.num_models() if objective is not None
            else max(config.num_class, 1))
        self.valid_sets: List[_ValidSet] = []
        self._train_metrics = list(metrics)
        self._rng_feature = make_rng(config.feature_fraction_seed)
        self._fmask_const = None
        self._cached_bag: Optional[torch.Tensor] = None
        self.timer = timer or StageTimer()
        cfg = config
        subset = uses_cat_subset(cfg, train_set)
        if subset and cfg.tree_learner in parallel.MESH_LEARNERS:
            _unported(f"tree_learner={cfg.tree_learner} with sorted-subset "
                      "categorical splits", "A10")
        if subset:
            log.info("sorted-subset categorical search enabled (a "
                     "categorical feature exceeds max_cat_to_onehot=%d); "
                     "the splits' membership words ride the partition "
                     "descriptor", cfg.max_cat_to_onehot)
        self.hp = SplitHyperParams(
            lambda_l1=cfg.lambda_l1, lambda_l2=cfg.lambda_l2,
            min_data_in_leaf=cfg.min_data_in_leaf,
            min_sum_hessian_in_leaf=cfg.min_sum_hessian_in_leaf,
            min_gain_to_split=cfg.min_gain_to_split,
            max_delta_step=cfg.max_delta_step, path_smooth=cfg.path_smooth,
            use_smoothing=cfg.path_smooth > 0.0, cat_l2=cfg.cat_l2,
            cat_smooth=cfg.cat_smooth, use_cat_subset=subset,
            max_cat_to_onehot=cfg.max_cat_to_onehot,
            max_cat_threshold=cfg.max_cat_threshold,
            min_data_per_group=cfg.min_data_per_group,
            use_extra_trees=bool(cfg.extra_trees))
        hp_updates, monotone, opts = build_grow_constraints(cfg, train_set)
        self.hp = self.hp._replace(**hp_updates)
        self.grow_options = opts = opts._replace(
            bynode_count=bynode_count(cfg, train_set),
            bynode_seed=cfg.feature_fraction_seed, extra_seed=cfg.extra_seed)
        self.dd: DeviceDataset = to_device(local, device)
        dd = self.dd
        kind = getattr(objective, "STREAM_KIND", None)
        self.route = decide(resolve_layout(inputs_from_env(
            objective_kind=kind or ("none" if objective is None
                                    else "other"),
            boosting=self.NAME,
            multi_tree=self.num_tree_per_iteration > 1,
            bagging=bagging_on(cfg),
            linear_tree=bool(cfg.linear_tree),
            gpu_use_dp=bool(cfg.gpu_use_dp),
            learner=learner,
            features_per_rank=(self.comm is None
                               or dd.num_features >= self.comm.world),
            bins_u8=dd.bins.dtype == torch.uint8, cat_subset=subset,
            mono_intermediate=self.hp.use_monotone
            and self.hp.mono_intermediate,
            interaction=opts.interaction_sets is not None,
            cegb=self.hp.use_cegb, cegb_lazy=opts.cegb_lazy is not None,
            forced_splits=opts.forced is not None,
            bynode=opts.bynode_count > 0,
            extra_trees=self.hp.use_extra_trees,
            fused_ok=fused_supported(dd.num_features, dd.padded_bins),
            tail_ok=apply_find_supported(dd.num_features, dd.padded_bins)),
            num_features=dd.num_features, padded_bins=dd.padded_bins))
        merge = (None if self.comm is None else parallel.make_merge(
            learner, self.comm, dd, scatter=self.route.hist_merge == "scatter",
            hp=self.hp, top_k=cfg.top_k, timer=self.timer))
        if not self.route.physical:
            histogram_impl()     # raises for a knob value with no kernel
            self.grow = RowOrderGrower(self.hp, num_leaves=cfg.num_leaves,
                                       max_depth=cfg.max_depth, dd=dd,
                                       route=self.route, timer=self.timer,
                                       monotone=monotone, options=opts,
                                       dp=bool(cfg.gpu_use_dp), merge=merge)
        else:
            stream = (StreamSpec(kind,
                                 float(getattr(objective, "sigmoid", 1.0)))
                      if self.route.stream else None)
            self.grow = SerialGrower(self.hp, num_leaves=cfg.num_leaves,
                                     max_depth=cfg.max_depth, dd=dd,
                                     route=self.route, stream=stream,
                                     timer=self.timer, monotone=monotone,
                                     options=opts, merge=merge)
            if self.route.stream:
                self.grow.set_stream_aux(self._stream_aux)
        # the serial grower guards itself; a parallel learner's gradients
        # are guarded at this boundary (numerics.host_guard)
        self._numerics_in_grow = (self._numerics != "off"
                                  and self.comm is None)
        if self._numerics_in_grow:
            self.grow = NumericsGuard(self.grow, self._numerics)
        for rule in loud_rules(self.route):
            log.warning("routing: %s takes the %s path (%s)", rule.name,
                        self.route.path, rule.reason)
        n = local.num_data
        md = local.metadata
        # linear trees (JAX gbdt.py:514-531): the raw values on the
        # device once, and the features categorical splits leave out
        self._raw: Optional[torch.Tensor] = None
        if cfg.linear_tree:
            if objective is not None and objective.NEEDS_RENEW:
                log.fatal("linear_tree is not supported with objective %s "
                          "(per-leaf percentile refit conflicts with linear "
                          "leaf models)", cfg.objective)
            if self.NAME in ("dart", "rf"):
                log.fatal("linear_tree is not supported with boosting=%s",
                          self.NAME)
            if train_set.raw_matrix is None:
                log.fatal("linear_tree=true but the dataset kept no raw "
                          "values; pass linear_tree in the Dataset params")
            self._raw = torch.as_tensor(
                np.ascontiguousarray(train_set.raw_matrix, np.float32),
                device=device)
            self._is_cat = dd.is_cat.cpu().numpy()
        # the trees' linear models on the device, aligned with models
        # (None for a constant tree)
        self._linear: List[Optional[LinearParams]] = []
        # continued training: the iterations an init model brought
        self.num_init_iteration = 0
        # (iteration, scores, validation scores) before the latest
        # iteration, for an exact rollback_one_iter
        self._undo = None
        # lazy CEGB: the rows paid for each feature, kept across trees
        # (feature_used_in_data_, cost_effective_gradient_boosting.hpp:169)
        self._cegb_paid = (None if opts.cegb_lazy is None else torch.zeros(
            (dd.num_features, n), dtype=torch.bool, device=device))
        self._has_init_score = md.init_score is not None
        self.scores = _init_scores(md, self.num_tree_per_iteration, n, device)
        # reference class_need_train_: cleared for a class whose
        # first-round tree is a stump
        self._class_need_train = [True] * self.num_tree_per_iteration
        self._valid_rows = torch.ones(n, dtype=torch.float32, device=device)
        # the bagging draw's positive rows, where pos/neg fractions apply
        self._label_pos = (None if md.label is None
                           else torch.as_tensor(md.label > 0, device=device))
        for m in self._train_metrics:
            m.init(train_set.metadata, train_set.num_data)
        pack_note = (f"; LGBM_TPU_COMB_PACK=2 trains pack=1 "
                     f"({', '.join(self.route.pack_reasons)})"
                     if self.route.pack_reasons else "")
        log.info("Training on %s: %d rows x %d features, %d bins per "
                 "feature (%s); route %s%s", device, n, self.dd.num_features,
                 self.dd.padded_bins, str(dd.bins.dtype).replace("torch.", ""),
                 self.route.describe(), pack_note)

    @property
    def train_score(self) -> torch.Tensor:
        """The training scores, [n] for a one-model booster (a view of
        ``scores``), else [K, n]."""
        return _class_view(self.scores)

    def _stream_aux(self):
        """The stream route's per-row inputs: the current scores (boost
        from average included), the validity mask and the objective's
        constants.  Read when the grower builds its row matrix."""
        return (self.train_score, self._valid_rows,
                self.objective.stream_consts())

    # ------------------------------------------------------------------
    @property
    def feature_names(self) -> List[str]:
        return self.train_set.feature_names

    @property
    def feature_infos(self) -> List[str]:
        return feature_infos(self.train_set)

    @property
    def max_feature_idx(self) -> int:
        return self.train_set.num_total_features - 1

    @property
    def num_class(self) -> int:
        return self.config.num_class

    @property
    def param_string(self) -> str:
        return self.config.to_param_string()

    # ------------------------------------------------------------------
    def add_valid(self, data: BinnedDataset, name: str,
                  metrics: Sequence[Metric]) -> None:
        bins = torch.as_tensor(np.ascontiguousarray(data.bin_matrix),
                               device=self.device)
        vs = _ValidSet(name, data, bins, metrics)
        if self._raw is not None:
            if data.raw_matrix is None:
                log.fatal("linear_tree: validation dataset kept no raw "
                          "values (construct it with the same params)")
            vs.raw = torch.as_tensor(
                np.ascontiguousarray(data.raw_matrix, np.float32),
                device=self.device)
        self._replay_valid(vs)
        for m in vs.metrics:
            m.init(data.metadata, data.num_data)
        self.valid_sets.append(vs)
        self._undo = None

    def _replay_valid(self, vs: _ValidSet) -> None:
        """A validation set's scores from its init scores and every tree
        of the model."""
        k = self.num_tree_per_iteration
        vs.scores = _init_scores(vs.data.metadata, k, vs.data.num_data,
                                 self.device)
        for i in range(len(self.models)):
            vs.scores[i % k] += self._tree_score(i, vs.bins, vs.raw)

    def _inner_ids(self) -> dict:
        """Original -> inner feature ids of the training set."""
        return {int(o): i for i, o in
                enumerate(self.train_set.used_feature_map)}

    def _tree_score(self, i: int, bins: torch.Tensor,
                    raw: Optional[torch.Tensor]) -> torch.Tensor:
        """Finished (shrunk, biased) tree ``i``'s f32 outputs on ``bins``
        (and, for a linear tree, the same rows' raw values ``raw``)."""
        t = self.models[i]
        members = (t.bin_members(self.dd.padded_bins)
                   if self.hp.use_cat_subset and t.num_cat else None)
        leaf = predict_leaf_bins(_bin_tree(t, self._inner_ids(), members),
                                 bins, self.dd.num_bins, self.dd.has_nan)
        lin = self._linear[i] if i < len(self._linear) else None
        if lin is not None:
            return linear_leaf_output(leaf, raw, lin).to(torch.float32)
        lv = torch.as_tensor(t.leaf_value, dtype=torch.float32,
                             device=self.device)
        return lv[leaf]

    def _linear_params_of(self, t: Tree) -> Optional[LinearParams]:
        """A finished tree's leaf models on the device, by inner feature
        (JAX ``_linear_params_of``, ``gbdt.py:1722-1759``); None for a
        constant tree.  A loaded tree's features are mapped to inner ids,
        each coefficient kept with its feature; a feature this dataset
        does not use drops its term, with a warning."""
        if not t.is_linear:
            return None
        feats, coefs = t.leaf_features_inner, t.leaf_coeff
        if feats is None:
            inner = self._inner_ids()
            feats, coefs, dropped = [], [], 0
            for fl, cl in zip(t.leaf_features, t.leaf_coeff):
                keep = [(inner[int(f)], c) for f, c in zip(fl, cl)
                        if int(f) in inner]
                dropped += len(fl) - len(keep)
                feats.append(np.array([f for f, _ in keep], np.int64))
                coefs.append(np.array([c for _, c in keep], np.float64))
            if dropped:
                log.warning("linear tree replay: %d leaf-model features are "
                            "not present in this dataset; their terms are "
                            "dropped", dropped)
        return linear_params(feats, coefs, t.leaf_const, t.leaf_value,
                             self.device)

    def _feature_mask(self) -> torch.Tensor:
        f = self.dd.num_features
        if self.config.feature_fraction >= 1.0:
            if self._fmask_const is None:
                self._fmask_const = torch.ones(f, dtype=torch.float32,
                                               device=self.device)
            return self._fmask_const
        mask = np.zeros(f, np.float32)
        k = max(1, int(np.ceil(f * self.config.feature_fraction)))
        mask[self._rng_feature.choice(f, size=k, replace=False)] = 1.0
        return torch.as_tensor(mask, device=self.device)

    # ------------------------------------------------------------------
    def get_training_score(self) -> torch.Tensor:
        """[K, n] scores the gradients and the leaf refit are taken at
        (RF: the constant init scores)."""
        return self.scores

    def _bagging_mask(self, it: int) -> Optional[torch.Tensor]:
        """The in-bag mask of iteration ``it`` (f32 [n] of 0 / 1), None
        without bagging (JAX ``gbdt.py:886-905``, reference
        gbdt.cpp:230-330): a row is in the bag when its uniform draw is
        below the fraction (its class's fraction under pos/neg bagging),
        drawn anew every ``bagging_freq`` iterations."""
        cfg = self.config
        if not bagging_on(cfg):
            return None
        if it % cfg.bagging_freq != 0 and self._cached_bag is not None:
            return self._cached_bag
        f32 = torch.float32
        u = uniform(sample_key(cfg, it), self.train_set.num_data,
                    self.device)
        if cfg.pos_bagging_fraction != 1.0 or cfg.neg_bagging_fraction != 1.0:
            p = torch.where(
                self._label_pos,
                torch.tensor(cfg.pos_bagging_fraction, dtype=f32,
                             device=self.device),
                torch.tensor(cfg.neg_bagging_fraction, dtype=f32,
                             device=self.device))
        else:
            p = torch.tensor(cfg.bagging_fraction, dtype=f32,
                             device=self.device)
        self._cached_bag = (u < p).to(f32)
        return self._cached_bag

    def _sample(self, grad: torch.Tensor, hess: torch.Tensor, it: int):
        """The sampling hook, once an iteration after the gradients:
        ``(grad, hess, inbag)`` for every class's tree (GOSS overrides
        it)."""
        inbag = self._bagging_mask(it)
        return grad, hess, self._valid_rows if inbag is None else inbag

    def _gradients(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """[K, n] gradients and hessians at the training scores."""
        k = self.num_tree_per_iteration
        grad, hess = self.objective.get_gradients(
            _class_view(self.get_training_score()))
        return grad.reshape(k, -1), hess.reshape(k, -1)

    def _sampled_gradients(self, grad=None, hess=None):
        """The iteration's gradients (the objective's, or a custom
        objective's ``grad`` / ``hess``) through the fault drill, the
        boundary guard of a parallel learner and the sampling hook:
        ``(grad, hess, inbag)``."""
        if grad is None:
            with self.timer.stage("gradients", self.device):
                grad, hess = self._gradients()
        grad, hess = faults.maybe_poison(grad, hess, self.iter_)
        if self._numerics != "off" and not self._numerics_in_grow:
            grad, hess = numerics_mod.host_guard(grad, hess, self._numerics,
                                                 self.iter_)
        with self.timer.stage("sample", self.device):
            return self._sample(grad, hess, self.iter_)

    def _keep_undo(self) -> None:
        """Keep the scores from before the iteration about to train, for
        an exact :meth:`rollback_one_iter`."""
        self._undo = (self.iter_, self.scores.clone(),
                      [vs.scores.clone() for vs in self.valid_sets])

    def explicit_gradients(self, gradients, hessians):
        """A custom objective's ``[K, n]`` gradients and hessians (numpy
        arrays or tensors, ``[K * n]`` or ``[K, n]``) as f32 tensors on
        the booster's device: one copy each from the host, none for a
        tensor already there, under the stage ``gradients``."""
        k, n = self.num_tree_per_iteration, self.scores.shape[1]
        with self.timer.stage("gradients", self.device):
            g, h = (torch.as_tensor(v, dtype=torch.float32).to(
                self.device).reshape(k, n) for v in (gradients, hessians))
        return g, h

    def _check_explicit(self, explicit: bool) -> None:
        """The JAX package's refusals (``gbdt.py:1285-1288``, ``:1337``):
        no objective and no gradients; gradients on the stream route;
        and, in the port, gradients under a parallel learner (A10)."""
        if not explicit and self.objective is None:
            log.fatal("No objective function and no custom gradients "
                      "provided")
        if explicit and self.route.stream:
            log.fatal("explicit gradients are not supported with "
                      "score-resident gradient streaming; set "
                      "objective=none or LGBM_TPU_STREAM=0")
        if explicit and self.comm is not None:
            _unported(f"explicit gradients under tree_learner="
                      f"{self.config.tree_learner}", "A10")

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """One boosting iteration, one tree a class; True when training
        cannot continue (no class's tree could split), like
        GBDT::TrainOneIter.  ``gradients`` and ``hessians`` (``[K, n]``,
        a custom objective's) replace the objective's for this
        iteration and go through the sampling hook as the objective's
        do; an iteration with them has no boost from average."""
        explicit = gradients is not None and hessians is not None
        self._check_explicit(explicit)
        if explicit:
            gradients, hessians = self.explicit_gradients(gradients,
                                                          hessians)
        self._keep_undo()
        dev = self.device
        k = self.num_tree_per_iteration
        init_scores = np.zeros(k)
        if (not explicit and not self.models and not self._has_init_score
                and self.config.boost_from_average):
            init_scores = np.array(
                self.objective.boost_from_score() if self._boost_init is None
                else self._boost_init, dtype=np.float64).reshape(k)
            if np.any(np.abs(init_scores) > 1e-35):
                add = torch.as_tensor(init_scores, dtype=torch.float32,
                                      device=dev)[:, None]
                self.scores = self.scores + add
                for vs in self.valid_sets:
                    vs.scores = vs.scores + add
                log.info("Start training from score %s",
                         np.array2string(init_scores, precision=6))
        if self.route.stream:
            # the gradients live in the row matrix and were refreshed
            # there at the previous tree's end; the route takes no sample
            faults.warn_unfireable_nan(self.iter_)
            grad = hess = [None] * k
            inbag = self._valid_rows
        else:
            try:
                grad, hess, inbag = self._sampled_gradients(gradients,
                                                            hessians)
            except numerics_mod.NumericsSkip as e:
                # a parallel learner's boundary guard: every class a stump
                for _ in range(k):
                    self._skip_poisoned_tree(e)
                self.iter_ += 1
                return False
        grew = False
        for c in range(k):
            if not self._class_need_train[c]:
                # keeps models[iter * K + class] aligned
                self.models.append(Tree.single_leaf(0.0))
                self._linear.append(None)
                continue
            if self._tree_or_skip(grad[c], hess[c], inbag, c,
                                  float(init_scores[c])):
                grew = True
        self.iter_ += 1
        if not grew:
            log.warning("Stopped training because there are no more "
                        "leaves that meet the split requirements")
            return True
        return False

    def _tree_or_skip(self, grad, hess, inbag, c: int, init_score: float
                      ) -> bool:
        """:meth:`_train_one_tree`; under ``LGBM_TPU_NUMERICS=skip`` a
        poisoned tree becomes a zero stump.  True when a tree grew or was
        dropped (training goes on), False for a stump."""
        try:
            return self._train_one_tree(grad, hess, inbag, c,
                                        init_score) is not None
        except numerics_mod.NumericsSkip as e:
            self._skip_poisoned_tree(e)
            return True

    def _skip_poisoned_tree(self, exc) -> None:
        """Policy ``skip`` (JAX ``_skip_poisoned_tree``): the poisoned tree
        is dropped and a zero stump keeps the model list aligned.  On the
        stream route the rows took the tree's outputs when it was grown,
        so they are rebuilt from the scores at the next tree."""
        faults.record("numerics_skip")
        log.warning("numerics sentinel (%s=skip): dropping poisoned tree — "
                    "%s", numerics_mod.NUMERICS_ENV, exc)
        self.models.append(Tree.single_leaf(0.0))
        self._linear.append(None)
        if self.route.stream:
            self.grow.reset_stream()

    def _check_numerics(self, cegb_before: Optional[torch.Tensor]) -> None:
        """The guard's count of the tree just grown, read once: raise
        ``NumericalFault`` (``raise``) or ``NumericsSkip`` (``skip``) on
        a non-finite value, lazy CEGB's paid mask put back first."""
        bad = int(self.grow.last_numerics_bad)
        if not bad:
            return
        if cegb_before is not None:
            self._cegb_paid = cegb_before
        if self._numerics == "raise":
            raise numerics_mod.NumericalFault("grad/hess/leaf/gain",
                                              self.iter_, bad)
        raise numerics_mod.NumericsSkip("grad/hess/leaf/gain", self.iter_,
                                        bad)

    def _train_one_tree(self, grad, hess, inbag, c: int, init_score: float
                        ) -> Optional[Tree]:
        """Grow class ``c``'s tree, refit its leaves where the objective
        asks, add its shrunk outputs to the scores and finish it; None
        when it is a stump."""
        sentinel = self._numerics in ("raise", "skip")
        cegb_before = (self._cegb_paid.clone()
                       if sentinel and self._cegb_paid is not None else None)
        # the shrinkage rate is read per call: the stream route adds the
        # tree's outputs to the rows' scores with it; the tree's draws
        # take the salt iteration * K + class
        ta, leaf_id, leaf_value = self.grow(
            grad, hess, inbag, self._feature_mask(), rate=self.shrinkage_rate,
            tree_seed=self.iter_ * self.num_tree_per_iteration + c,
            paid=self._cegb_paid)
        if sentinel and self._numerics_in_grow:
            self._check_numerics(cegb_before)
        nl = int(ta.num_leaves)
        if nl <= 1:
            first_round = ((self.num_init_iteration + 1)
                           * self.num_tree_per_iteration)
            if len(self.models) < first_round:
                self._class_need_train[c] = False
            self.models.append(Tree.single_leaf(init_score))
            self._linear.append(None)
            return None
        if self.objective is not None and self.objective.NEEDS_RENEW:
            with self.timer.stage("leaf_renew", self.device):
                leaf_value, host_values = self._renew_leaves(
                    leaf_id, leaf_value, inbag, c)
            ta = ta._replace(leaf_value=host_values)
        fit = None
        if self._raw is not None:
            # the leaves' linear models (LinearTreeLearner::CalculateLinear)
            with self.timer.stage("linear_fit", self.device):
                fit = fit_linear_models(
                    ta, leaf_id, self._raw, grad, hess, inbag, self._is_cat,
                    self.config.linear_lambda, self.config.num_leaves,
                    self.timer)
        rate = self.shrinkage_rate
        with self.timer.stage("score_update", self.device):
            rate_t = torch.tensor(rate, dtype=torch.float32,
                                  device=self.device)
            out = fit.pred if fit is not None else leaf_value[leaf_id]
            self.scores[c] = self.scores[c] + rate_t * out
            for vs in self.valid_sets:
                leaf_v = predict_leaf_bins(ta, vs.bins, self.dd.num_bins,
                                           self.dd.has_nan)
                out_v = (linear_leaf_output(leaf_v, vs.raw, fit.params).to(
                    torch.float32) if fit is not None else leaf_value[leaf_v])
                vs.scores[c] = vs.scores[c] + rate_t * out_v
        tree = Tree.from_device(ta, self.train_set)
        if fit is not None:
            self._set_linear(tree, fit, nl)
        tree.apply_shrinkage(rate)
        if abs(init_score) > 1e-35:
            tree.add_bias(init_score)
        self.models.append(tree)
        self._linear.append(self._linear_params_of(tree))
        return tree

    def _set_linear(self, tree: Tree, fit, nl: int) -> None:
        """The finished tree's linear fields from its fit (JAX
        ``gbdt.py:1653-1676``): a leaf that is not ``ok`` has no
        features and its leaf value as the constant."""
        tree.is_linear = True
        tree.leaf_const = fit.const[:nl].copy()
        tree.leaf_coeff, tree.leaf_features = [], []
        tree.leaf_features_inner = []
        for leaf in range(nl):
            fl = fit.feat_idx[leaf]
            fl = fl[fl >= 0] if fit.ok[leaf] else fl[:0]
            tree.leaf_features_inner.append(fl.astype(np.int64))
            tree.leaf_features.append(
                self.train_set.used_feature_map[fl].astype(np.int32))
            tree.leaf_coeff.append(fit.coef[leaf, :len(fl)].copy())

    def _renew_leaves(self, leaf_id: torch.Tensor, leaf_value: torch.Tensor,
                      inbag: torch.Tensor, c: int
                      ) -> Tuple[torch.Tensor, np.ndarray]:
        """Class ``c``'s leaf outputs refit to the objective's percentile
        of the in-bag rows' residuals at the current (pre-tree) training
        scores (JAX ``_renew_leaf_values``): on the device, and their
        host copy for the finished tree."""
        obj = self.objective
        w = obj.renew_weight()
        out = renew_leaf_values(
            obj.leaf_residual(self.get_training_score()[c]),
            torch.ones_like(inbag) if w is None else w, leaf_id,
            inbag > 0, leaf_value, L=int(leaf_value.shape[0]),
            alpha=float(obj.renew_leaf_percentile()),
            weighted=w is not None)
        return out, out.cpu().numpy()

    # ------------------------------------------------------------------
    def set_init_model(self, trees: List[Tree]) -> None:
        """Continued training (JAX ``set_init_model``, reference
        application.cpp:94-97): keep an earlier model's ``trees`` so the
        final model is whole.  Call it before the first iteration; the
        caller sets the dataset's init score to the earlier model's raw
        predictions.  Each tree's bin thresholds are found anew against
        this dataset's bin mappers (:meth:`_rebin_tree`), for the
        validation replay and rollback."""
        if self.models:
            log.fatal("set_init_model must be called before training starts")
        if self.comm is not None:
            _unported("init_model under tree_learner="
                      f"{self.config.tree_learner}", "A10")
        if self._raw is None and any(t.is_linear for t in trees):
            log.fatal("init_model contains linear trees; pass "
                      "linear_tree=true so the dataset keeps raw values")
        k = self.num_tree_per_iteration
        if len(trees) % k:
            log.fatal("init_model has %d trees, not a multiple of the %d "
                      "trees an iteration", len(trees), k)
        for t in trees:
            if t.num_leaves > 1:
                self._rebin_tree(t)
            self.models.append(t)
            self._linear.append(self._linear_params_of(t))
        self.num_init_iteration = len(trees) // k

    def _rebin_tree(self, t: Tree) -> None:
        """``t``'s thresholds as bins of this dataset (JAX
        ``_rebin_tree``): a numerical threshold is the bin whose upper
        bound it is (a tree grown on these mappers gets its own bins
        back), a categorical node's bitset over raw values becomes the
        bitset over their bins (``cat_threshold_inner``) and its first
        bin; a feature this dataset does not use sends every row left."""
        inner = self._inner_ids()
        ni = t.num_leaves - 1
        tb = np.zeros(ni, np.int32)
        words_inner = [np.zeros(1, np.uint32)] * t.num_cat
        for i in range(ni):
            f = int(t.split_feature[i])
            if f not in inner:
                continue
            m = self.train_set.mappers[inner[f]]
            if int(t.decision_type[i]) & 1:
                slot = int(t.threshold[i])
                lo, hi = t.cat_boundaries[slot], t.cat_boundaries[slot + 1]
                words = t.cat_threshold[lo:hi]
                vals = [w * 32 + b for w in range(hi - lo) for b in range(32)
                        if (int(words[w]) >> b) & 1]
                bins = sorted({int(b) for b in m.values_to_bins(
                    np.array(vals, np.float64))} - {0}) if vals else []
                tb[i] = bins[0] if bins else 0
                words_inner[slot] = _bitset(bins)
            else:
                tb[i] = int(np.searchsorted(m.upper_bounds, t.threshold[i],
                                            side="left"))
        t.threshold_bin = tb
        t.cat_boundaries_inner = np.concatenate(
            [[0], np.cumsum([len(w) for w in words_inner])]).astype(np.int32)
        t.cat_threshold_inner = (np.concatenate(words_inner) if words_inner
                                 else np.zeros(0, np.uint32))

    def rollback_one_iter(self) -> None:
        """Drop the last iteration's K trees and take their outputs, linear
        ones included, back out of the training and validation scores
        (JAX ``rollback_one_iter``, reference GBDT::RollbackOneIter).  The
        scores from before the latest iteration were kept, so rolling it
        back restores them bit for bit; an older iteration's trees are
        subtracted.  On the stream route the rows are rebuilt from the
        scores at the next tree."""
        if self.NAME == "dart":
            raise LightGBMError("rollback_one_iter is not supported with "
                                "boosting=dart: a DART iteration rescales "
                                "the trees it dropped")
        if self.iter_ <= 0:
            return
        k = self.num_tree_per_iteration
        undo, self._undo = self._undo, None
        exact = undo is not None and undo[0] == self.iter_ - 1
        for c in reversed(range(k)):
            i = len(self.models) - 1
            if not exact:
                self.scores[c] -= self._tree_score(i, self.dd.bins, self._raw)
                for vs in self.valid_sets:
                    vs.scores[c] -= self._tree_score(i, vs.bins, vs.raw)
            self.models.pop()
            self._linear.pop()
        if exact:
            self.scores = undo[1]
            for vs, kept in zip(self.valid_sets, undo[2]):
                vs.scores = kept
        self.iter_ -= 1
        reset = getattr(self.grow, "reset_stream", None)
        if self.route.stream and reset is not None:
            reset()

    # ------------------------------------------------------------------
    # checkpoint / resume (resilience/checkpoint.py)
    def checkpoint_state(self) -> dict:
        """The boosting state a ckpt/v1 snapshot holds beside the forest
        (JAX ``checkpoint_state``): the [K, n] f32 training scores as
        they are (scores predicted again from the trees are not the same
        bits), the feature-fraction RNG's state and the small counters.
        The bagging and GOSS draws are threefry functions of seed x
        iteration and are drawn again at restore."""
        return {
            "iteration": int(self.iter_),
            "train_score": self.scores.detach().cpu().numpy().astype(
                np.float32),
            "rng_feature": self._rng_feature.bit_generator.state,
            "shrinkage_rate": float(self.shrinkage_rate),
            "class_need_train": [bool(b) for b in self._class_need_train],
            "cegb_paid": (None if self._cegb_paid is None
                          else self._cegb_paid.cpu().numpy()),
        }

    def restore_checkpoint_state(self, models: List[Tree], *, iteration: int,
                                 train_score, rng_feature=None,
                                 shrinkage_rate=None, class_need_train=None,
                                 cegb_paid=None) -> None:
        """Install a ckpt/v1 snapshot (JAX ``restore_checkpoint_state``):
        the forest and every piece of run state, so that the next
        iteration grows the tree the uninterrupted run grew.  Works on a
        fresh booster and on a live one (the current state is dropped):
        the carried rows are rebuilt in original order from the restored
        scores, the mid-cycle bagging mask is drawn again and the
        validation scores are replayed from the trees."""
        k = self.num_tree_per_iteration
        score = train_score.astype(np.float32)     # a copy, host numpy
        if score.shape != tuple(self.scores.shape):
            raise ValueError(f"checkpoint score shape {score.shape} does not "
                             f"match this run's {tuple(self.scores.shape)}")
        self._undo = None
        self._cached_bag = None
        self.models, self._linear = [], []
        for t in models:
            if t.num_leaves > 1:
                self._rebin_tree(t)
            self.models.append(t)
            self._linear.append(self._linear_params_of(t))
        self.iter_ = int(iteration)
        self.num_init_iteration = max(len(models) // k - self.iter_, 0)
        self.scores = torch.as_tensor(score, device=self.device)
        if rng_feature is not None:
            self._rng_feature.bit_generator.state = rng_feature
        if shrinkage_rate is not None:
            self.shrinkage_rate = float(shrinkage_rate)
        if class_need_train is not None:
            self._class_need_train = [bool(b) for b in class_need_train]
        if cegb_paid is not None:
            self._cegb_paid = torch.as_tensor(cegb_paid, device=self.device)
        cfg = self.config
        if bagging_on(cfg) and self.iter_ % cfg.bagging_freq != 0:
            # the mask the uninterrupted run still holds mid-cycle
            self._bagging_mask(self.iter_ - self.iter_ % cfg.bagging_freq)
        reset = getattr(self.grow, "reset_stream", None)
        if reset is not None:
            reset()
        for vs in self.valid_sets:
            self._replay_valid(vs)

    def _reanchor_physical(self) -> None:
        """Put the carried row order back to the original (JAX
        ``_reanchor_physical``, ``gbdt.py:804-830``).  The histograms add
        rows in the order the rows are carried, so after every save the
        surviving process and a process resuming from the snapshot must
        hold them in the same order: the rows are dropped and rebuilt at
        the next tree (``reset_stream``), or under
        ``LGBM_TPU_CKPT_AT_REFRESH=1`` on the stream route rebuilt at once
        from their own bins (``reanchor_inplace``).  The row-order path
        carries no order: nothing to do."""
        reset = getattr(self.grow, "reset_stream", None)
        if reset is None:
            return
        if env_knob("LGBM_TPU_CKPT_AT_REFRESH") == "1":
            inplace = getattr(self.grow, "reanchor_inplace", None)
            if inplace is not None and inplace():
                return
        reset()

    # ------------------------------------------------------------------
    def training_scores(self) -> torch.Tensor:
        """The [K, n] training scores of every row (under the data and
        voting learners every rank's rows, gathered in rank order)."""
        if self._rows_sharded:
            return self.comm.gather_rows(self.scores, self.train_set.num_data)
        return self.scores

    def converted_scores(self, score: torch.Tensor):
        """``(converted, raw)`` f64 numpy arrays of [K, n] scores, [n]
        for a one-model booster (JAX ``_converted_scores``): RF's sums
        averaged, then the objective's output transform."""
        raw = _class_view(score.detach())
        if self.average_output:
            # RF: the scores hold the sum of the trees' outputs
            raw = raw / max(self.iter_, 1)
        conv = (self.objective.convert_output(raw)
                if self.objective is not None else raw)
        return conv.double().cpu().numpy(), raw.double().cpu().numpy()

    def eval(self) -> List[Tuple[str, str, float, bool]]:
        """[(dataset_name, metric_name, value, higher_better)] like
        GBDT::OutputMetric."""
        out = []

        def run(metrics, score, ds_name):
            if not metrics:
                return
            prob, raw_np = self.converted_scores(score)
            for m in metrics:
                for name, v, hb in m.eval(prob, raw_np):
                    out.append((ds_name, name, v, hb))

        if self._train_metrics:
            run(self._train_metrics, self.training_scores(), "training")
        for vs in self.valid_sets:
            run(vs.metrics, vs.scores, vs.name)
        return out

    def current_iteration(self) -> int:
        """Iterations in the model, an init model's included (reference
        GBDT::GetCurrentIteration: iter_ + num_init_iteration_)."""
        return self.iter_ + self.num_init_iteration


def _bin_tree(t: Tree, inner: dict,
              members: Optional[np.ndarray] = None) -> TreeArrays:
    """Bin-space arrays of a finished tree (for scoring a validation set
    that joins after trees exist); ``members`` its categorical nodes'
    bins (``Tree.bin_members``) under the sorted-subset search."""
    ni = t.num_leaves - 1
    z = np.zeros(ni, np.float32)
    return TreeArrays(
        split_feature=np.array([inner[int(f)] for f in t.split_feature],
                               np.int32),
        threshold_bin=t.threshold_bin, split_gain=z,
        default_left=(t.decision_type & 2) > 0,
        is_categorical=(t.decision_type & 1) > 0,
        left_child=t.left_child, right_child=t.right_child,
        internal_value=z, internal_weight=z, internal_count=z,
        leaf_value=t.leaf_value.astype(np.float32),
        leaf_weight=z, leaf_count=z, num_leaves=t.num_leaves,
        cat_members=members)
