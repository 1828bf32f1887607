"""Multiclass objectives, softmax and one-vs-all (reference
multiclass_objective.hpp; the port's copy of
``lightgbm_tpu/objective/multiclass.py``): K trees a boosting iteration,
scores class-major ``[K, n]``, the softmax hessian times the
reference's ``factor_`` ``K / (K - 1)``.

The softmax takes the max and the sum over the classes in an explicit
class loop (class 0 first, one f32 rounding per step) and ``exp`` in
f64 rounded once, so the CPU and the card compute the same bits: a
reduction over the class axis may add in other orders on each.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ..utils import log
from .base import ObjectiveFunction, exp32
from .binary import BinaryLogloss


def softmax_classes(score: torch.Tensor) -> torch.Tensor:
    """Softmax over the class axis of ``[K, n]`` f32: ``exp(s - max)``
    over its class sum, max and sum in class order."""
    m = score[0]
    for k in range(1, score.shape[0]):
        m = torch.maximum(m, score[k])
    e = exp32(score - m)
    s = e[0]
    for k in range(1, score.shape[0]):
        s = s + e[k]
    return e / s


class MulticlassSoftmax(ObjectiveFunction):
    NAME = "multiclass"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = config.num_class
        if self.num_class <= 1:
            log.fatal("num_class must be > 1 for multiclass objective")
        self.factor = self.num_class / (self.num_class - 1.0)

    def check_label(self, label):
        if np.any(label < 0) or np.any(label >= self.num_class):
            log.fatal("Label must be in [0, %d) for multiclass",
                      self.num_class)
        if not np.all(label == np.floor(label)):
            log.fatal("Multiclass labels must be integers")

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        classes = torch.arange(self.num_class, device=device)[:, None]
        self._onehot = (classes == self.label.to(torch.int64)[None, :]).to(
            torch.float32)

    def get_gradients(self, score):
        p = softmax_classes(score)
        grad = p - self._onehot
        hess = self.factor * p * (1.0 - p)
        if self.weight is not None:
            grad = grad * self.weight[None, :]
            hess = hess * self.weight[None, :]
        return grad, hess

    def boost_from_score(self):
        if not self.config.boost_from_average:
            return np.zeros(self.num_class)
        lab = self.label_np.astype(np.int64)
        w = (np.ones(len(lab)) if self.weight_np is None
             else self.weight_np.astype(np.float64))
        tot = np.sum(w)
        out = np.zeros(self.num_class)
        for k in range(self.num_class):
            pavg = float(np.sum(w[lab == k]) / max(tot, 1e-20))
            out[k] = np.log(max(pavg, 1e-10))
        return out

    def convert_output(self, raw):
        return softmax_classes(raw)

    def num_models(self):
        return self.num_class

    def __str__(self):
        return f"multiclass num_class:{self.num_class}"


class MulticlassOVA(ObjectiveFunction):
    NAME = "multiclassova"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = config.num_class
        if self.num_class <= 1:
            log.fatal("num_class must be > 1 for multiclassova objective")
        self.sigmoid = config.sigmoid

    def check_label(self, label):
        if np.any(label < 0) or np.any(label >= self.num_class):
            log.fatal("Label must be in [0, %d) for multiclassova",
                      self.num_class)

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        # one binary logloss a class, on the label "is class k"
        self._binaries = []
        lab = np.asarray(metadata.label)
        for k in range(self.num_class):
            md = copy.copy(metadata)
            md.label = (lab == k).astype(np.float32)
            sub = BinaryLogloss(self.config)
            sub.init(md, num_data, device)
            self._binaries.append(sub)

    def get_gradients(self, score):
        gh = [b.get_gradients(score[k]) for k, b in enumerate(self._binaries)]
        return (torch.stack([g for g, _ in gh]),
                torch.stack([h for _, h in gh]))

    def boost_from_score(self):
        return np.concatenate([b.boost_from_score() for b in self._binaries])

    def convert_output(self, raw):
        return 1.0 / (1.0 + exp32(-self.sigmoid * raw))

    def num_models(self):
        return self.num_class

    def __str__(self):
        return (f"multiclassova num_class:{self.num_class} "
                f"sigmoid:{self.sigmoid:g}")
