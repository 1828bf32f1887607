"""Training constraints: the port of the JAX package's
``lightgbm_tpu/models/constraints.py`` (``:25-170``).

From the user-facing ``Config`` fields it builds the split search's
``SplitHyperParams`` updates, the monotone signs and the grower's
per-dataset arrays (``ops.grow.GrowOptions``), as the reference threads
them from Config into the tree learner:

- ``monotone_constraints`` (serial_tree_learner.cpp:767-786,
  monotone_constraints.hpp): ``use_monotone``, ``monotone_penalty`` and
  one sign an inner feature.  ``monotone_constraints_method``: ``basic``
  (the kernel split tail's constrained mode), ``intermediate`` (the
  PyTorch tail and the grower's adjacency pass), ``advanced``
  (intermediate, with the JAX package's warning) and anything else
  ``basic``, with its warning;
- ``interaction_constraints`` (col_sampler.hpp): the allowed sets, bool
  ``[S, F]``;
- CEGB (cost_effective_gradient_boosting.hpp): ``use_cegb``,
  ``cegb_tradeoff``, ``cegb_penalty_split``, and ``cegb_tradeoff`` times
  each per-feature penalty (coupled: once a model; lazy: once a row);
  lazy costs only without the intermediate monotone method, else the
  JAX package's warning and they are ignored;
- ``forcedsplits_filename`` (serial_tree_learner.cpp:459 ForceSplits):
  the BFS schedule of ``(leaf, feature, bin, default_left)``.

Every per-feature list is indexed by raw column (the data's feature
indices, as LightGBM reads them), and inner feature ``j`` is raw column
``ds.used_feature_map[j]``: a column the dataset dropped
(``feature_pre_filter``) takes its entry with it.  The JAX package
indexes these lists by inner feature, which shifts every later entry by
one for each column dropped before it (``ROADMAP.md`` C).
"""
from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np

from ..config import Config
from ..io.dataset_core import BinnedDataset
from ..ops.grow import GrowOptions
from ..utils import log


def _inner_of_raw(ds: BinnedDataset) -> dict:
    return {int(r): j for j, r in enumerate(ds.used_feature_map)}


def _per_feature(values, ds: BinnedDataset, scale=None) -> np.ndarray:
    """The f32 entry of each inner feature from a list of one value a
    raw column (zero past the list's end), times ``scale`` in f32."""
    arr = np.asarray(values, np.float32)
    if scale is not None:
        arr = scale * arr
    raw = np.asarray(ds.used_feature_map, np.int64)
    out = np.zeros(len(raw), np.float32)
    inside = raw < len(arr)
    out[inside] = arr[raw[inside]]
    return out


def parse_interaction_constraints(spec, ds: BinnedDataset
                                  ) -> Optional[np.ndarray]:
    """``[[0, 1, 2], [2, 3]]``: a JSON string or a list of lists of raw
    column indices -> bool ``[S, F]``, set ``k`` holding the inner
    features whose raw columns it lists (a column out of range or
    dropped is left out).  None for an empty spec."""
    if isinstance(spec, str):
        spec = json.loads(spec) if spec.strip() else None
    if not spec:
        return None
    inner = _inner_of_raw(ds)
    sets = np.zeros((len(spec), len(ds.mappers)), dtype=bool)
    for k, group in enumerate(spec):
        for col in group:
            j = inner.get(int(col))
            if j is not None:
                sets[k, j] = True
    return sets


def build_forced_schedule(path: str, ds: BinnedDataset,
                          num_leaves: int) -> Optional[dict]:
    """The BFS schedule of the forced splits in the JSON file ``path``:
    ``{"leaf", "feature", "bin", "default_left"}`` arrays, one entry a
    step.  Leaves are numbered as the grower numbers them: at step ``s``
    the split's left child keeps the parent's leaf and the right child
    becomes leaf ``s + 1`` (reference Tree::Split, tree.h:541), so every
    node's leaf is known before training.  A node's ``feature`` is a raw
    column, its ``threshold`` a raw value (binned by the column's
    mapper); a column out of range or dropped by the dataset skips the
    node and its subtree without advancing the step, with a warning.
    None without a file or without a node."""
    if not path:
        return None
    with open(path) as fh:
        root = json.load(fh)
    if not root:
        return None
    inner = _inner_of_raw(ds)
    leaf_l, feat_l, bin_l, dl_l = [], [], [], []
    queue = [(root, 0)]
    step = 0
    while queue and step < num_leaves - 1:
        node, leaf = queue.pop(0)
        col = int(node["feature"])
        j = inner.get(col)
        if j is None:
            log.warning("forced split feature %d out of range or not used "
                        "by the dataset; subtree skipped", col)
            continue
        thr = float(node["threshold"])
        leaf_l.append(leaf)
        feat_l.append(j)
        bin_l.append(int(ds.mappers[j].values_to_bins(np.array([thr]))[0]))
        dl_l.append(bool(node.get("default_left", False)))
        if isinstance(node.get("left"), dict):
            queue.append((node["left"], leaf))
        if isinstance(node.get("right"), dict):
            queue.append((node["right"], step + 1))
        step += 1
    if not feat_l:
        return None
    return {"leaf": np.asarray(leaf_l, np.int32),
            "feature": np.asarray(feat_l, np.int32),
            "bin": np.asarray(bin_l, np.int32),
            "default_left": np.asarray(dl_l, bool)}


def cegb_enabled(cfg: Config) -> bool:
    """CostEfficientGradientBoosting::IsEnable
    (cost_effective_gradient_boosting.hpp:27)."""
    return (cfg.cegb_tradeoff < 1.0 or cfg.cegb_penalty_split > 0.0
            or bool(cfg.cegb_penalty_feature_coupled)
            or bool(cfg.cegb_penalty_feature_lazy))


def _monotone(cfg: Config, ds: BinnedDataset, hp_updates: dict
              ) -> Optional[np.ndarray]:
    if not any(int(m) != 0 for m in cfg.monotone_constraints):
        return None
    # one sign a raw column, read through the inner features' map
    # (dataset.cpp: monotone_types_[InnerFeatureIndex(i)]); a column past
    # the list's end is free
    mc = np.asarray(cfg.monotone_constraints, np.int32)
    raw = np.asarray(ds.used_feature_map, np.int64)
    mono = np.where(raw < len(mc), mc[np.minimum(raw, len(mc) - 1)],
                    0).astype(np.int32)
    hp_updates["use_monotone"] = True
    hp_updates["monotone_penalty"] = float(cfg.monotone_penalty)
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
    return mono


def build_grow_constraints(cfg: Config, ds: BinnedDataset
                           ) -> Tuple[dict, Optional[np.ndarray],
                                      GrowOptions]:
    """``(hp_updates, monotone, options)``: the ``SplitHyperParams``
    fields the constraints set, the i32 monotone sign of each inner
    feature (None when no column is constrained) and the grower's
    arrays (the by-node count and the seeds left at their defaults, for
    the booster to set)."""
    hp_updates: dict = {}
    mono = _monotone(cfg, ds, hp_updates)
    coupled = lazy = None
    if cegb_enabled(cfg):
        hp_updates["use_cegb"] = True
        hp_updates["cegb_tradeoff"] = float(cfg.cegb_tradeoff)
        hp_updates["cegb_penalty_split"] = float(cfg.cegb_penalty_split)
        if cfg.cegb_penalty_feature_lazy:
            # lazy per-row acquisition costs
            # (cost_effective_gradient_boosting.hpp:113-163): the paid mask
            # is single-learner state the row-order grower keeps; the
            # port's learner is always serial, so only the intermediate
            # monotone method leaves them out, as in the JAX package
            if hp_updates.get("mono_intermediate"):
                log.warning(
                    "cegb_penalty_feature_lazy is supported by the serial "
                    "tree learner only (without intermediate monotone "
                    "constraints); the per-row feature-acquisition costs "
                    "are ignored")
            else:
                lazy = _per_feature(cfg.cegb_penalty_feature_lazy, ds,
                                    cfg.cegb_tradeoff)
        if cfg.cegb_penalty_feature_coupled:
            coupled = _per_feature(cfg.cegb_penalty_feature_coupled, ds,
                                   cfg.cegb_tradeoff)
    return hp_updates, mono, GrowOptions(
        interaction_sets=parse_interaction_constraints(
            cfg.interaction_constraints, ds),
        cegb_coupled=coupled, cegb_lazy=lazy,
        forced=build_forced_schedule(cfg.forcedsplits_filename, ds,
                                     cfg.num_leaves))
