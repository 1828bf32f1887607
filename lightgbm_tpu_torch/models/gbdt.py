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

Unlike the JAX package, trees are finalized synchronously, so an
iteration in which no class's tree can split stops training at once
(the reference's synchronous behaviour).  Parameters the port does not
have yet raise ``LightGBMError`` (:func:`check_supported`).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config, env_knob
from ..io.binning import BinType
from ..io.dataset_core import BinnedDataset
from ..metric import Metric
from ..models.constraints import build_grow_constraints
from ..models.model_text import feature_infos
from ..objective.base import ObjectiveFunction
from ..objective.regression import renew_leaf_values
from ..ops.device_data import DeviceDataset, to_device
from ..ops.apply_find import apply_find_supported
from ..ops.fused_split import fused_supported
from ..ops.grow import (RowOrderGrower, SerialGrower, StageTimer,
                        StreamSpec, TreeArrays, predict_leaf_bins)
from ..ops.histogram import histogram_impl
from ..ops.routing import decide, inputs_from_env, resolve_layout
from ..ops.split import SplitHyperParams
from ..utils import log
from ..utils.log import LightGBMError
from ..utils.random import make_rng, prng_key, uniform
from .tree import Tree


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


def check_supported(cfg: Config) -> None:
    """Raise for the pack conflicts and for every parameter the port does
    not have yet."""
    check_pack_conflicts(cfg)
    if cfg.tree_learner != "serial" or cfg.num_machines > 1:
        _unported(f"tree_learner={cfg.tree_learner} (the mesh learners)",
                  "A10")
    if cfg.pre_partition:
        _unported("pre_partition (paged / distributed data)", "A11")
    if cfg.gpu_use_dp:
        _unported("gpu_use_dp", "A9")
    if cfg.linear_tree:
        _unported("linear_tree", "A9")


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
        self.config = config
        self.train_set = train_set
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
        self.dd: DeviceDataset = to_device(train_set, device)
        dd = self.dd
        kind = getattr(objective, "STREAM_KIND", None)
        self.route = decide(resolve_layout(inputs_from_env(
            objective_kind=kind or ("none" if objective is None
                                    else "other"),
            boosting=self.NAME,
            multi_tree=self.num_tree_per_iteration > 1,
            bagging=bagging_on(cfg),
            linear_tree=bool(cfg.linear_tree),
            learner=cfg.tree_learner,
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
        if not self.route.physical:
            histogram_impl()     # raises for a knob value with no kernel
            self.grow = RowOrderGrower(self.hp, num_leaves=cfg.num_leaves,
                                       max_depth=cfg.max_depth, dd=dd,
                                       route=self.route, timer=self.timer,
                                       monotone=monotone, options=opts)
        else:
            stream = (StreamSpec(kind,
                                 float(getattr(objective, "sigmoid", 1.0)))
                      if self.route.stream else None)
            self.grow = SerialGrower(self.hp, num_leaves=cfg.num_leaves,
                                     max_depth=cfg.max_depth, dd=dd,
                                     route=self.route, stream=stream,
                                     timer=self.timer, monotone=monotone,
                                     options=opts)
            if self.route.stream:
                self.grow.set_stream_aux(self._stream_aux)
        n = train_set.num_data
        md = train_set.metadata
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
            m.init(md, n)
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
        k = self.num_tree_per_iteration
        vs.scores = _init_scores(data.metadata, k, data.num_data,
                                 self.device)
        inner = {int(o): i for i, o in
                 enumerate(self.train_set.used_feature_map)}
        for i, t in enumerate(self.models):
            vs.scores[i % k] += self._tree_score(t, bins, inner)
        for m in vs.metrics:
            m.init(data.metadata, data.num_data)
        self.valid_sets.append(vs)

    def _tree_score(self, t: Tree, bins: torch.Tensor,
                    inner: dict) -> torch.Tensor:
        """A finished (shrunk, biased) tree's f32 outputs on ``bins``;
        ``inner`` maps original to inner feature ids."""
        lv = torch.as_tensor(t.leaf_value, dtype=torch.float32,
                             device=self.device)
        members = (t.bin_members(self.dd.padded_bins)
                   if self.hp.use_cat_subset else None)
        return lv[predict_leaf_bins(_bin_tree(t, inner, members), bins,
                                    self.dd.num_bins, self.dd.has_nan)]

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

    def _sampled_gradients(self):
        """The iteration's gradients through the sampling hook:
        ``(grad, hess, inbag)``."""
        with self.timer.stage("gradients", self.device):
            grad, hess = self._gradients()
        with self.timer.stage("sample", self.device):
            return self._sample(grad, hess, self.iter_)

    def train_one_iter(self) -> bool:
        """One boosting iteration, one tree a class; True when training
        cannot continue (no class's tree could split), like
        GBDT::TrainOneIter."""
        if self.objective is None:
            log.fatal("No objective function provided")
        dev = self.device
        k = self.num_tree_per_iteration
        init_scores = np.zeros(k)
        if (not self.models and not self._has_init_score
                and self.config.boost_from_average):
            init_scores = np.array(self.objective.boost_from_score(),
                                   dtype=np.float64).reshape(k)
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
            grad = hess = [None] * k
            inbag = self._valid_rows
        else:
            grad, hess, inbag = self._sampled_gradients()
        grew = False
        for c in range(k):
            if not self._class_need_train[c]:
                # keeps models[iter * K + class] aligned
                self.models.append(Tree.single_leaf(0.0))
                continue
            if self._train_one_tree(grad[c], hess[c], inbag, c,
                                    float(init_scores[c])) is not None:
                grew = True
        self.iter_ += 1
        if not grew:
            log.warning("Stopped training because there are no more "
                        "leaves that meet the split requirements")
            return True
        return False

    def _train_one_tree(self, grad, hess, inbag, c: int, init_score: float
                        ) -> Optional[Tree]:
        """Grow class ``c``'s tree, refit its leaves where the objective
        asks, add its shrunk outputs to the scores and finish it; None
        when it is a stump."""
        # the shrinkage rate is read per call: the stream route adds the
        # tree's outputs to the rows' scores with it; the tree's draws
        # take the salt iteration * K + class
        ta, leaf_id, leaf_value = self.grow(
            grad, hess, inbag, self._feature_mask(), rate=self.shrinkage_rate,
            tree_seed=self.iter_ * self.num_tree_per_iteration + c,
            paid=self._cegb_paid)
        nl = int(ta.num_leaves)
        if nl <= 1:
            if len(self.models) < self.num_tree_per_iteration:
                self._class_need_train[c] = False
            self.models.append(Tree.single_leaf(init_score))
            return None
        if self.objective.NEEDS_RENEW:
            with self.timer.stage("leaf_renew", self.device):
                leaf_value, host_values = self._renew_leaves(
                    leaf_id, leaf_value, inbag, c)
            ta = ta._replace(leaf_value=host_values)
        rate = self.shrinkage_rate
        with self.timer.stage("score_update", self.device):
            rate_t = torch.tensor(rate, dtype=torch.float32,
                                  device=self.device)
            self.scores[c] = self.scores[c] + rate_t * leaf_value[leaf_id]
            for vs in self.valid_sets:
                leaf_v = predict_leaf_bins(ta, vs.bins, self.dd.num_bins,
                                           self.dd.has_nan)
                vs.scores[c] = vs.scores[c] + rate_t * leaf_value[leaf_v]
        tree = Tree.from_device(ta, self.train_set)
        tree.apply_shrinkage(rate)
        if abs(init_score) > 1e-35:
            tree.add_bias(init_score)
        self.models.append(tree)
        return tree

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
    def eval(self) -> List[Tuple[str, str, float, bool]]:
        """[(dataset_name, metric_name, value, higher_better)] like
        GBDT::OutputMetric."""
        out = []

        def run(metrics, score, ds_name):
            if not metrics:
                return
            raw = _class_view(score.detach())
            if self.average_output:
                # RF: the scores hold the sum of the trees' outputs
                raw = raw / max(self.iter_, 1)
            conv = (self.objective.convert_output(raw)
                    if self.objective is not None else raw)
            prob = conv.double().cpu().numpy()
            raw_np = raw.double().cpu().numpy()
            for m in metrics:
                for name, v, hb in m.eval(prob, raw_np):
                    out.append((ds_name, name, v, hb))

        run(self._train_metrics, self.scores, "training")
        for vs in self.valid_sets:
            run(vs.metrics, vs.scores, vs.name)
        return out

    def current_iteration(self) -> int:
        return self.iter_


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
