"""Objective-function interface (reference objective_function.h:19).

Counterpart of ``lightgbm_tpu/objective/base.py``: ``get_gradients``
is elementwise torch math on the device the labels were put on, so the
gradients of a boosting round never leave the card.  Single-model
objectives only in this slice (scores are ``[n]``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..io.dataset_core import Metadata
from ..utils import log


class ObjectiveFunction:
    """Base class: subclasses set NAME and implement get_gradients."""

    NAME = "none"
    # gradient formula of the stream route's kernels, None when it has
    # none (ops/routing.py objective_not_streamable)
    STREAM_KIND = None

    def __init__(self, config: Config):
        self.config = config
        self.num_data = 0
        self.label: Optional[torch.Tensor] = None
        self.weight: Optional[torch.Tensor] = None

    def init(self, metadata: Metadata, num_data: int,
             device: torch.device) -> None:
        self.num_data = num_data
        self.device = device
        if metadata.label is None:
            log.fatal("Objective %s requires labels", self.NAME)
        self.check_label(metadata.label)
        self.label = torch.as_tensor(metadata.label, dtype=torch.float32,
                                     device=device)
        self.weight = (None if metadata.weight is None
                       else torch.as_tensor(metadata.weight,
                                            dtype=torch.float32,
                                            device=device))

    def check_label(self, label: np.ndarray) -> None:
        pass

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """score [n] f32 -> (grad, hess), both [n] f32."""
        raise NotImplementedError

    def stream_consts(self) -> torch.Tensor:
        """[n, 2] f32 per-row constants of the stream route."""
        raise NotImplementedError

    def boost_from_score(self) -> np.ndarray:
        """Initial raw score (reference BoostFromScore)."""
        return np.zeros(1, dtype=np.float64)

    def convert_output(self, raw: torch.Tensor) -> torch.Tensor:
        return raw

    def num_models(self) -> int:
        return 1

    def __str__(self) -> str:   # the model file's objective string
        return self.NAME
