"""L2 regression (reference regression_objective.hpp; counterpart of
``RegressionL2`` in ``lightgbm_tpu/objective/regression.py``).  The
other regression objectives come with ``ROADMAP.md`` A8."""
from __future__ import annotations

import numpy as np
import torch

from .base import ObjectiveFunction


def l2_gradients(score, target, weight=None):
    """(grad, hess) of l2: ``score - target`` and 1, each times the
    weight when there is one."""
    grad = score - target
    hess = torch.ones_like(score)
    if weight is not None:
        grad = grad * weight
        hess = hess * weight
    return grad, hess


class RegressionL2(ObjectiveFunction):
    NAME = "regression"
    STREAM_KIND = "l2"

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = config.reg_sqrt
        self._trans_label = None

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if self.sqrt:
            lab = np.asarray(metadata.label, dtype=np.float64)
            self._trans_label = torch.as_tensor(
                np.sign(lab) * np.sqrt(np.abs(lab)), dtype=torch.float32,
                device=device)

    @property
    def _target(self):
        return self._trans_label if self.sqrt else self.label

    def get_gradients(self, score):
        return l2_gradients(score, self._target, self.weight)

    def stream_consts(self):
        """Per-row constants of the stream route: [n, 2] (target,
        weight), the weight 1 where there is none (``l2_consts``)."""
        w = (torch.ones_like(self._target) if self.weight is None
             else self.weight)
        return torch.stack([self._target, w], dim=1)

    def boost_from_score(self):
        if not self.config.boost_from_average:
            return np.zeros(1)
        lab = self._target.double().cpu().numpy()
        if self.weight is None:
            sl, sw = float(lab.sum()), float(len(lab))
        else:
            w = self.weight.double().cpu().numpy()
            sl, sw = float((lab * w).sum()), float(w.sum())
        return np.array([sl / max(sw, 1.0)])

    def convert_output(self, raw):
        if self.sqrt:
            return torch.sign(raw) * raw * raw
        return raw

    def __str__(self):
        return "regression" + (" sqrt" if self.sqrt else "")
