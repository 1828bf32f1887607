"""Training constraints: the monotone part of the JAX package's
``lightgbm_tpu/models/constraints.py`` (``build_grow_constraints``,
``:97-126``).

``monotone_constraints`` (one sign a raw column, reference
serial_tree_learner.cpp:767-786 and monotone_constraints.hpp) sets the
split search's ``use_monotone`` and ``monotone_penalty`` and gives the
grower the sign of each inner feature: that of its raw column, zero
past the list's end.  ``monotone_constraints_method``: ``basic`` (the
kernel split tail's constrained mode), ``intermediate`` (the PyTorch
tail and the grower's adjacency pass), ``advanced`` (intermediate, with
the JAX package's warning) and anything else ``basic``, with its
warning.

Interaction constraints, CEGB and forced splits are not ported
(``ROADMAP.md`` A9): ``models/gbdt.check_supported`` raises for them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..config import Config
from ..io.dataset_core import BinnedDataset
from ..utils import log


def build_grow_constraints(cfg: Config, ds: BinnedDataset
                           ) -> Tuple[dict, Optional[np.ndarray]]:
    """``(hp_updates, monotone)``: the ``SplitHyperParams`` fields the
    constraints set, and the i32 sign of each inner feature (None when
    no column is constrained).  ``monotone_constraints`` holds one sign
    a raw column; inner feature ``j`` is raw column
    ``ds.used_feature_map[j]``.  The JAX package gives inner feature
    ``j`` the sign of column ``j``, which shifts every later sign by
    one for each column dropped before it (``ROADMAP.md`` C)."""
    if not any(int(m) != 0 for m in cfg.monotone_constraints):
        return {}, None
    # one sign a raw column, read through the inner features' map
    # (dataset.cpp: monotone_types_[InnerFeatureIndex(i)]): a column the
    # dataset dropped (feature_pre_filter) takes its sign with it, and a
    # column past the list's end is free
    mc = np.asarray(cfg.monotone_constraints, np.int32)
    raw = np.asarray(ds.used_feature_map, np.int64)
    mono = np.where(raw < len(mc), mc[np.minimum(raw, len(mc) - 1)],
                    0).astype(np.int32)
    hp_updates = {"use_monotone": True,
                  "monotone_penalty": float(cfg.monotone_penalty)}
    method = cfg.monotone_constraints_method
    if method in ("intermediate", "advanced"):
        # the advanced method's per-feature piecewise constraints
        # (monotone_constraints.hpp:856) degrade to intermediate, its
        # documented base, as in the JAX package
        hp_updates["mono_intermediate"] = True
        if method == "advanced":
            log.warning("monotone_constraints_method=advanced not "
                        "implemented; using 'intermediate'")
    elif method != "basic":
        log.warning("monotone_constraints_method=%s unknown; using 'basic'",
                    method)
    return hp_updates, mono
