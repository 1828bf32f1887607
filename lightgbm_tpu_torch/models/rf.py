"""The random-forest booster (counterpart of ``lightgbm_tpu/models/
rf.py``; reference rf.hpp:25-217): no shrinkage, bagging through the
GBDT hook, every tree grown from the gradients at the constant init
scores, and the model's output the average of its trees'
(``average_output``).

Each tree carries its class's init score as a bias, as LightGBM's
``AddBias`` does, and the training and validation scores take it with
the tree's outputs, so ``eval``'s average is ``predict``'s.  The JAX
package leaves the init score out of its trees (ROADMAP C).  The leaf
refit of the percentile objectives reads the residuals at the init
score, ``label - init``, in both packages as in LightGBM.  A dataset
``init_score`` is refused: every tree grows from the constant init
score, so a per-row one has no meaning (the JAX package trains on and
ignores it, ROADMAP C).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import log
from .gbdt import GBDT
from .tree import Tree


class RF(GBDT):
    NAME = "rf"

    def __init__(self, config, train_set, *args, **kw):
        if train_set.metadata.init_score is not None:
            log.fatal("boosting=rf cannot train from a dataset init_score: "
                      "a random forest grows every tree from the constant "
                      "init score, so a per-row init score has no meaning "
                      "there")
        super().__init__(config, train_set, *args, **kw)
        self.average_output = True
        self.shrinkage_rate = 1.0
        k = self.num_tree_per_iteration
        init = np.zeros(k)
        if self.objective is not None and self.config.boost_from_average:
            init = np.asarray(self.objective.boost_from_score(),
                              np.float64).reshape(k)
        self._rf_init = init
        self._rf_score = torch.as_tensor(init, dtype=torch.float32,
                                         device=self.device)[:, None].expand(
            k, self.train_set.num_data)
        self._rf_grad = None

    def get_training_score(self) -> torch.Tensor:
        return self._rf_score

    def _gradients(self):
        # the same scores every iteration give the same gradients
        if self._rf_grad is None:
            self._rf_grad = super()._gradients()
        return self._rf_grad

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """One tree a class on the iteration's bag (a custom objective's
        ``gradients`` and ``hessians`` in place of the objective's); True
        when no class's tree could split (the JAX package's RF stops
        then)."""
        explicit = gradients is not None and hessians is not None
        self._check_explicit(explicit)
        self._keep_undo()
        if explicit:
            gradients, hessians = self.explicit_gradients(gradients,
                                                          hessians)
        grad, hess, inbag = self._sampled_gradients(gradients, hessians)
        grew = False
        for c in range(self.num_tree_per_iteration):
            if self._tree_or_skip(grad[c], hess[c], inbag, c,
                                  float(self._rf_init[c])):
                grew = True
        self.iter_ += 1
        return not grew

    def _train_one_tree(self, grad, hess, inbag, c: int, init_score: float
                        ) -> Optional[Tree]:
        tree = super()._train_one_tree(grad, hess, inbag, c, init_score)
        if abs(init_score) > 1e-35:
            bias = torch.tensor(init_score, dtype=torch.float32,
                                device=self.device)
            self.scores[c] = self.scores[c] + bias
            for vs in self.valid_sets:
                vs.scores[c] = vs.scores[c] + bias
        return tree
