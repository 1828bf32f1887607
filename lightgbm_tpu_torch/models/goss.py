"""The GOSS booster: gradient-based one-side sampling (counterpart of
``lightgbm_tpu/models/goss.py``; reference goss.hpp:25-207).

Each iteration after the warm-up keeps the rows whose summed ``|g*h|``
over the classes reaches the ``top_k``-th largest, draws ``other_rate``
of the rest from the bagging key's uniform stream, and scales the drawn
rows' gradients and hessians by ``(1 - top_rate) / other_rate`` so the
histogram sums stay unbiased.  The threshold comes from a full sort of
the magnitudes on the device.  ``top_k`` counts the real rows, as
LightGBM does; the JAX package counts its padded rows too (ROADMAP C).
"""
from __future__ import annotations

import torch

from ..utils import log
from ..utils.random import uniform
from .gbdt import GBDT, sample_key


class GOSS(GBDT):
    NAME = "goss"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        cfg = self.config
        if cfg.top_rate + cfg.other_rate > 1.0:
            log.fatal("top_rate + other_rate cannot be larger than 1.0")
        if cfg.bagging_freq > 0 and cfg.bagging_fraction != 1.0:
            log.warning("cannot use bagging in GOSS")

    def _sample(self, grad: torch.Tensor, hess: torch.Tensor, it: int):
        cfg = self.config
        # the reference warms up for 1 / learning_rate iterations
        if it < int(1.0 / max(cfg.learning_rate, 1e-6)):
            return grad, hess, self._valid_rows
        f32, dev = torch.float32, grad.device
        n = grad.shape[1]
        top_k = max(int(n * cfg.top_rate), 1)
        prod = (grad * hess).abs()
        # the classes added left to right, as XLA:CPU reduces axis 0
        magnitude = prod[0]
        for c in range(1, prod.shape[0]):
            magnitude = magnitude + prod[c]
        thresh = torch.sort(magnitude).values[n - top_k]
        is_top = magnitude >= thresh
        u = uniform(sample_key(cfg, it), n, dev)
        keep_other = ~is_top & (u < torch.tensor(cfg.other_rate, dtype=f32,
                                                 device=dev))
        inbag = (is_top | keep_other).to(f32)
        amplify = torch.tensor((1.0 - cfg.top_rate)
                               / max(cfg.other_rate, 1e-12), dtype=f32,
                               device=dev)
        scale = torch.where(keep_other, amplify,
                            torch.ones((), dtype=f32, device=dev))
        return grad * scale, hess * scale, inbag
