"""Objective-function interface (reference objective_function.h:19).

Counterpart of ``lightgbm_tpu/objective/base.py``: ``get_gradients``
is elementwise torch math on the device the labels were put on, so the
gradients of a boosting round never leave the card.  Scores and
gradients of a multi-model objective (multiclass) are class-major,
``[K, n]``; a one-model objective takes and gives ``[n]``.

Transcendentals (``exp``, ``log1p``) are taken in f64 and rounded once
to f32 (:func:`exp32`), so the CPU and the card compute the same bits:
their f32 ``exp`` differ in the last place, their f64 ones almost
never do after the rounding.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..io.dataset_core import Metadata
from ..utils import log


def exp32(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of an f32 tensor, taken in f64 and rounded once."""
    return torch.exp(x.double()).to(torch.float32)


def log1p32(x: torch.Tensor) -> torch.Tensor:
    """``log1p`` of an f32 tensor, taken in f64 and rounded once."""
    return torch.log1p(x.double()).to(torch.float32)


class ObjectiveFunction:
    """Base class: subclasses set NAME and implement get_gradients."""

    NAME = "none"
    # gradient formula of the stream route's kernels, None when it has
    # none (ops/routing.py objective_not_streamable)
    STREAM_KIND = None
    # leaf outputs refit to a per-leaf percentile of the residuals after
    # each tree (reference RenewTreeOutput, objective_function.h:46)
    NEEDS_RENEW = False

    def __init__(self, config: Config):
        self.config = config
        self.num_data = 0
        self.label: Optional[torch.Tensor] = None
        self.weight: Optional[torch.Tensor] = None
        # host copies of the labels and weights, for the host-side
        # boost-from-average statistics
        self.label_np: Optional[np.ndarray] = None
        self.weight_np: Optional[np.ndarray] = None

    def init(self, metadata: Metadata, num_data: int,
             device: torch.device) -> None:
        self.num_data = num_data
        self.device = device
        if metadata.label is None:
            log.fatal("Objective %s requires labels", self.NAME)
        self.check_label(metadata.label)
        self.label_np = np.asarray(metadata.label, np.float32)
        self.weight_np = (None if metadata.weight is None
                          else np.asarray(metadata.weight, np.float32))
        self.label = torch.as_tensor(self.label_np, device=device)
        self.weight = (None if self.weight_np is None
                       else torch.as_tensor(self.weight_np, device=device))

    def check_label(self, label: np.ndarray) -> None:
        pass

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """score [n] (or [K, n]) f32 -> (grad, hess) of its shape."""
        raise NotImplementedError

    def stream_consts(self) -> torch.Tensor:
        """[n, 2] f32 per-row constants of the stream route."""
        raise NotImplementedError

    def boost_from_score(self) -> np.ndarray:
        """Initial raw score, one per model (reference BoostFromScore)."""
        return np.zeros(self.num_models(), dtype=np.float64)

    def convert_output(self, raw: torch.Tensor) -> torch.Tensor:
        return raw

    # ---- leaf refit (reference RenewTreeOutput) ------------------------
    def renew_leaf_percentile(self) -> Optional[float]:
        """For percentile-refit objectives: the percentile in (0, 1)."""
        return None

    def leaf_residual(self, score: torch.Tensor) -> torch.Tensor:
        """Residual whose per-leaf percentile becomes the leaf output."""
        return self.label - score

    def renew_weight(self) -> Optional[torch.Tensor]:
        """Percentile weights of the leaf refit: the sample weights when
        there are any (WeightedPercentileFun), else None (PercentileFun);
        mape refits against its label weights."""
        return self.weight

    def num_models(self) -> int:
        """Trees a boosting iteration (reference NumModelPerIteration)."""
        return 1

    def _apply_weight(self, grad, hess):
        if self.weight is not None:
            grad = grad * self.weight
            hess = hess * self.weight
        return grad, hess

    def __str__(self) -> str:   # the model file's objective string
        return self.NAME
