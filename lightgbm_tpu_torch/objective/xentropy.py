"""Cross-entropy objectives for probabilistic labels in [0, 1]
(reference xentropy_objective.hpp; the port's copy of
``lightgbm_tpu/objective/xentropy.py``): ``cross_entropy`` with optional
weights, and ``cross_entropy_lambda``, whose weights enter through a
log1p link.  ``exp`` and ``log1p`` are taken in f64 and rounded once
(``base.exp32``, ``base.log1p32``)."""
from __future__ import annotations

import numpy as np
import torch

from ..utils import log
from .base import ObjectiveFunction, exp32, log1p32


def _sigmoid(score: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + exp32(-score))


class CrossEntropy(ObjectiveFunction):
    NAME = "cross_entropy"

    def check_label(self, label):
        if np.any(label < 0) or np.any(label > 1):
            log.fatal("[cross_entropy]: labels must be in [0, 1]")

    def get_gradients(self, score):
        p = _sigmoid(score)
        return self._apply_weight(p - self.label, p * (1.0 - p))

    def boost_from_score(self):
        if not self.config.boost_from_average:
            return np.zeros(1)
        lab = self.label_np.astype(np.float64)
        w = (np.ones_like(lab) if self.weight_np is None
             else self.weight_np.astype(np.float64))
        pavg = float(np.sum(lab * w) / np.sum(w))
        pavg = min(max(pavg, 1e-15), 1 - 1e-15)
        return np.array([np.log(pavg / (1.0 - pavg))])

    def convert_output(self, raw):
        return _sigmoid(raw)


class CrossEntropyLambda(ObjectiveFunction):
    NAME = "cross_entropy_lambda"

    def check_label(self, label):
        if np.any(label < 0) or np.any(label > 1):
            log.fatal("[cross_entropy_lambda]: labels must be in [0, 1]")

    def get_gradients(self, score):
        # the weighted link (xentropy_objective.hpp CrossEntropyLambda::
        # GetGradients); unweighted it is plain cross-entropy
        if self.weight is None:
            p = _sigmoid(score)
            return p - self.label, p * (1.0 - p)
        w, y = self.weight, self.label
        epf = exp32(score)
        hhat = log1p32(epf)
        z = 1.0 - exp32(-w * hhat)
        zs = torch.clamp(z, min=1e-15)
        sig = epf / (1.0 + epf)
        grad = (1.0 - y / zs) * w * sig
        c = 1.0 / torch.clamp(1.0 - z, min=1e-15)
        d1 = 1.0 + epf
        a = w * epf / (d1 * d1)
        d = torch.clamp(c - 1.0, min=1e-15)
        bb = (c / (d * d)) * (1.0 + w * epf - c)
        hess = a * (1.0 + y * bb)
        return grad, hess

    def boost_from_score(self):
        lab = self.label_np.astype(np.float64)
        pavg = min(max(float(np.mean(lab)), 1e-15), 1 - 1e-15)
        return np.array([np.log(np.expm1(-np.log1p(-pavg)))])

    def convert_output(self, raw):
        return log1p32(exp32(raw))
