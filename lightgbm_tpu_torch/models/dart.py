"""The DART booster: Dropouts meet Multiple Additive Regression Trees
(counterpart of ``lightgbm_tpu/models/dart.py``; reference
dart.hpp:23-211).

Each iteration draws a drop set of past iterations from host numpy
PCG64 (``drop_seed``), in the JAX package's order of draws: the
``skip_drop`` test first, then one draw a past iteration, uniform or
weighted by the tree weights, capped by ``max_drop``.  The dropped
trees are subtracted from the training scores once an iteration, so
the gradients, the leaf refit and the new tree's score update all read
the dropped basis, and the new tree is shrunk by ``learning_rate / (1 +
k)`` (or the ``xgboost_dart_mode`` rate).  :meth:`DART._normalize` then
rescales each dropped tree by ``factor`` (``k / (k + 1)``, or ``k *
rate / learning_rate``): the training scores take ``factor`` times the
tree back, every validation set's scores shift by ``factor - 1`` times
it, and the stored tree and its replica are scaled by ``factor``.

The JAX package scales the stored tree and the validation scores by
``1 / (k + 1)`` (``rate`` in xgboost mode) while its training scores
take ``k / (k + 1)`` back, so for ``k > 1`` its model no longer predicts
its own training scores; LightGBM's ``Normalize`` scales the tree once
by ``1 / (k + 1)`` for the validation update and then by ``-k`` for the
training update, leaving it at ``k / (k + 1)``.  The port follows
LightGBM (ROADMAP C).

Every finished tree has an f32 replica on the device in bin space (the
JAX ``_device_trees``): its node arrays, its depth and its leaf values
with the shrinkage and any folded-in bias, built with ``_bin_tree``
(categorical membership words kept) and walked by
``predict_leaf_bins`` over the rows in their original order.  All of
it runs under the ``dart`` stage of the booster's ``StageTimer``.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch

from ..ops.grow import TreeArrays, _tree_depth, predict_leaf_bins
from ..utils.random import make_rng
from .gbdt import GBDT, _bin_tree
from .tree import Tree

_NODE_DTYPES = {"split_feature": torch.int64, "threshold_bin": torch.int32,
                "default_left": torch.bool, "is_categorical": torch.bool,
                "left_child": torch.int64, "right_child": torch.int64}


class Replica(NamedTuple):
    """A finished tree in bin space on the device."""
    nodes: TreeArrays            # the walk's node arrays as tensors
    depth: int
    leaf_value: torch.Tensor     # f32 [L], shrunk, bias folded in


class DART(GBDT):
    NAME = "dart"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._rng_drop = make_rng(self.config.drop_seed)
        self._tree_weight: List[float] = []
        self._sum_weight = 0.0
        self.drop_index: List[int] = []
        self._drop_done_iter = -1
        self.replicas: List[Replica] = []
        self._feature_inner = {int(o): i for i, o in
                               enumerate(self.train_set.used_feature_map)}

    # -- the replicas ----------------------------------------------------
    def _replica(self, t: Tree) -> Replica:
        members = (t.bin_members(self.dd.padded_bins)
                   if self.hp.use_cat_subset and t.num_leaves > 1 else None)
        ta = _bin_tree(t, self._feature_inner, members)
        dev = self.device
        nodes = ta._replace(
            cat_members=None if members is None
            else torch.as_tensor(members, device=dev),
            **{f: torch.as_tensor(getattr(ta, f), dtype=dt, device=dev)
               for f, dt in _NODE_DTYPES.items()})
        depth = _tree_depth(ta) if t.num_leaves > 1 else 0
        return Replica(nodes, depth,
                       torch.as_tensor(t.leaf_value, dtype=torch.float32,
                                       device=dev))

    def _outputs(self, rep: Replica, bins: torch.Tensor) -> torch.Tensor:
        """The replica's f32 outputs on the rows ``bins``."""
        leaf = predict_leaf_bins(rep.nodes, bins, self.dd.num_bins,
                                 self.dd.has_nan, depth=rep.depth)
        return rep.leaf_value[leaf]

    # -- the dropped basis -----------------------------------------------
    def get_training_score(self) -> torch.Tensor:
        """The scores with this iteration's drop set subtracted, dropped
        once an iteration (reference ``is_update_score_cur_iter_``)."""
        if self._drop_done_iter == self.iter_:
            return self.scores
        self._drop_done_iter = self.iter_
        self._select_drop_trees()
        k = self.num_tree_per_iteration
        for i in self.drop_index:
            for c in range(k):
                self.scores[c] = self.scores[c] - self._outputs(
                    self.replicas[i * k + c], self.dd.bins)
        return self.scores

    def _select_drop_trees(self) -> None:
        """The drop set and the new tree's shrinkage rate (JAX
        ``dart.py:57-98``, the same ``random()`` calls in the same
        order)."""
        cfg = self.config
        self.drop_index = []
        if self._rng_drop.random() < cfg.skip_drop:
            pass
        elif cfg.uniform_drop:
            drop_rate = cfg.drop_rate
            if cfg.max_drop > 0 and self.iter_ > 0:
                drop_rate = min(drop_rate, cfg.max_drop / self.iter_)
            for i in range(self.iter_):
                if self._rng_drop.random() < drop_rate:
                    self.drop_index.append(i)
                    if len(self.drop_index) >= cfg.max_drop > 0:
                        break
        elif self._sum_weight > 0:
            inv_avg = len(self._tree_weight) / self._sum_weight
            drop_rate = cfg.drop_rate
            if cfg.max_drop > 0:
                drop_rate = min(drop_rate,
                                cfg.max_drop * inv_avg / self._sum_weight)
            for i in range(self.iter_):
                if (self._rng_drop.random()
                        < drop_rate * self._tree_weight[i] * inv_avg):
                    self.drop_index.append(i)
                    if len(self.drop_index) >= cfg.max_drop > 0:
                        break
        k = len(self.drop_index)
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = cfg.learning_rate / (1.0 + k)
        else:
            self.shrinkage_rate = (cfg.learning_rate if k == 0 else
                                   cfg.learning_rate / (cfg.learning_rate + k))

    # -- one iteration -----------------------------------------------------
    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        # the drop happens before a custom objective's gradients too
        # (Booster.update reads the dropped scores for them)
        with self.timer.stage("dart", self.device):
            self.get_training_score()
        finished = super().train_one_iter(gradients, hessians)
        with self.timer.stage("dart", self.device):
            self.replicas += [self._replica(t) for t in
                              self.models[len(self.replicas):]]
            if finished:
                return True
            # the scores are now the dropped basis plus the new trees
            self._normalize()
        if not self.config.uniform_drop:
            self._tree_weight.append(self.shrinkage_rate)
            self._sum_weight += self.shrinkage_rate
        return False

    def _normalize(self) -> None:
        """dart.hpp ``Normalize()``: each dropped tree rescaled to
        ``factor`` of itself, the training scores given ``factor`` of it
        back, the validation scores shifted by ``factor - 1`` of it, and
        the tree weights updated."""
        cfg = self.config
        k = len(self.drop_index)
        if k == 0:
            return
        if not cfg.xgboost_dart_mode:
            factor = k / (k + 1.0)
        else:
            factor = k * self.shrinkage_rate / cfg.learning_rate
        f32, dev = torch.float32, self.device
        back = torch.tensor(factor, dtype=f32, device=dev)
        shift = torch.tensor(factor - 1.0, dtype=f32, device=dev)
        kk = self.num_tree_per_iteration
        for i in self.drop_index:
            for c in range(kk):
                idx = i * kk + c
                rep = self.replicas[idx]
                self.scores[c] = (self.scores[c]
                                  + back * self._outputs(rep, self.dd.bins))
                for vs in self.valid_sets:
                    vs.scores[c] = (vs.scores[c]
                                    + shift * self._outputs(rep, vs.bins))
                self.models[idx].apply_shrinkage(factor)
                self.replicas[idx] = rep._replace(
                    leaf_value=rep.leaf_value * back)
            if not cfg.uniform_drop and i < len(self._tree_weight):
                if not cfg.xgboost_dart_mode:
                    self._sum_weight -= self._tree_weight[i] / (k + 1.0)
                    self._tree_weight[i] *= k / (k + 1.0)
                else:
                    self._sum_weight -= (self._tree_weight[i]
                                         / (k + cfg.learning_rate))
                    self._tree_weight[i] *= k / (k + cfg.learning_rate)
