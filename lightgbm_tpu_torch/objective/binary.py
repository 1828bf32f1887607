"""Binary logloss (reference binary_objective.hpp; counterpart of
``lightgbm_tpu/objective/binary.py``).

The gradient expression keeps the JAX package's operation order, one
f32 rounding per operation; ``exp`` is taken in f64 and rounded, so the
CPU and the card agree and the JAX package's f32 ``exp`` differs by at
most a last-place unit.  :func:`binary_gradients` is the one home of
that arithmetic: the objective and the stream route's plain versions
(``ops/stream_grad.py``) both call it, and ``csrc/stream_grad.cu``
repeats it operation by operation.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import log
from .base import ObjectiveFunction


def binary_gradients(score, sign, label_weight, sigmoid: float):
    """(grad, hess) of binary logloss: ``z = (sign * sigmoid) * score``,
    ``abs_r = (1 / (1 + exp(z))) * sigmoid`` (PyTorch's ``s / t`` is
    ``t.reciprocal() * s``), ``grad = (-sign * abs_r) * lw``,
    ``hess = (abs_r * (sigmoid - abs_r)) * lw``."""
    s = sigmoid
    z = sign * s * score
    # exp in f64, rounded once to f32: the CPU's and the card's f32
    # exp differ in the last place, their f64 exps almost never do
    # after rounding, so both devices train the same trees
    abs_r = s / (1.0 + torch.exp(z.double()).to(torch.float32))
    grad = -sign * abs_r * label_weight
    hess = abs_r * (s - abs_r) * label_weight
    return grad, hess


class BinaryLogloss(ObjectiveFunction):
    NAME = "binary"
    STREAM_KIND = "binary"

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = config.sigmoid
        if self.sigmoid <= 0:
            log.fatal("Sigmoid parameter %f should be greater than zero",
                      self.sigmoid)

    def check_label(self, label):
        if not np.all(np.isin(label, (0.0, 1.0))):
            log.fatal("Binary objective requires 0/1 labels")

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        lab = np.asarray(metadata.label)
        cnt_pos = float(np.sum(lab > 0))
        cnt_neg = float(len(lab) - cnt_pos)
        if cnt_pos == 0 or cnt_neg == 0:
            log.warning("Contains only one class")
        if self.config.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if self.config.scale_pos_weight != 1.0:
                log.warning("Ignoring scale_pos_weight since is_unbalance "
                            "is set")
            self.pos_weight = cnt_neg / cnt_pos
        else:
            self.pos_weight = self.config.scale_pos_weight
        self._cnt_pos, self._cnt_neg = cnt_pos, cnt_neg
        pos = self.label > 0
        one = torch.ones_like(self.label)
        # label in {-1, +1}; the per-row weight folds in scale_pos_weight
        self._sign = torch.where(pos, one, -one)
        lw = torch.where(pos, one * self.pos_weight, one)
        self._label_weight = lw if self.weight is None else lw * self.weight

    def get_gradients(self, score):
        return binary_gradients(score, self._sign, self._label_weight,
                                self.sigmoid)

    def stream_consts(self):
        """Per-row constants of the stream route: [n, 2] (sign, label
        weight), the port's ``stream_grad.binary_consts``."""
        return torch.stack([self._sign, self._label_weight], dim=1)

    def boost_from_score(self):
        if not self.config.boost_from_average:
            return np.zeros(1)
        if self.weight is not None:
            w = self.weight.double().cpu().numpy()
            lab = self.label.double().cpu().numpy()
            pavg = float(np.sum(lab * w)) / float(np.sum(w))
        else:
            pavg = self._cnt_pos / max(self._cnt_pos + self._cnt_neg, 1.0)
        pavg = min(max(pavg, 1e-15), 1.0 - 1e-15)
        init = np.log(pavg / (1.0 - pavg)) / self.sigmoid
        log.info("[binary:BoostFromScore]: pavg=%.6f -> initscore=%.6f",
                 pavg, init)
        return np.array([init])

    def convert_output(self, raw):
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * raw))
