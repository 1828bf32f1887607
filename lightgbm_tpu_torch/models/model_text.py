"""Model text serialization (LightGBM-compatible format, version v4).

Reference: src/boosting/gbdt_model_text.cpp (SaveModelToString :311,
LoadModelFromString :473) and Tree::ToString (tree.cpp:340).  For a
model loaded from text, :func:`save_model_to_string` writes the same
bytes as ``lightgbm_tpu.models.model_text`` does for the same loaded
model, so one model file moves between the two packages unchanged; for a
trained booster it writes what the JAX package writes for the same
trees, bin mappers and parameters (:func:`feature_infos`).
:func:`dump_model_to_json` gives the JAX package's JSON dictionary key
for key.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .tree import Tree

MODEL_VERSION = "v4"


def save_model_to_string(
    booster,
    start_iteration: int = 0,
    num_iteration: int = -1,
    feature_importance_type: int = 0,
) -> str:
    """``booster``: an object with ``models``, ``num_class``,
    ``num_tree_per_iteration``, ``objective``, ``average_output``,
    ``feature_names``, ``feature_infos``, ``max_feature_idx`` and
    ``param_string`` (``basic._LoadedAdapter`` for a loaded model, the
    trained ``GBDT`` for a trained one)."""
    feature_names = booster.feature_names
    k = booster.num_tree_per_iteration

    # the reference writes SubModelName() == "tree" as the first line
    lines = ["tree"]
    lines.append(f"version={MODEL_VERSION}")
    lines.append(f"num_class={booster.num_class}")
    lines.append(f"num_tree_per_iteration={k}")
    lines.append("label_index=0")
    lines.append(f"max_feature_idx={booster.max_feature_idx}")
    if booster.objective is not None:
        lines.append(f"objective={booster.objective}")
    if booster.average_output:
        lines.append("average_output")
    lines.append("feature_names=" + " ".join(feature_names))
    lines.append("feature_infos=" + " ".join(booster.feature_infos))

    total_iter = len(booster.models) // max(k, 1)
    start_iteration = max(0, min(start_iteration, total_iter))
    num_used = len(booster.models)
    if num_iteration > 0:
        num_used = min((start_iteration + num_iteration) * k, num_used)
    start_model = start_iteration * k

    tree_strs = [booster.models[i].to_string(i - start_model)
                 for i in range(start_model, num_used)]
    lines.append("tree_sizes=" + " ".join(str(len(s)) for s in tree_strs))
    lines.append("")
    body = "\n".join(lines) + "\n" + "".join(tree_strs)
    body += "end of trees\n"

    # feature importances (split counts by default, gain if type 1)
    imps = feature_importance(booster, num_iteration, feature_importance_type)
    pairs = [(imps[i], feature_names[i]) for i in range(len(feature_names))
             if imps[i] > 0]
    pairs.sort(key=lambda p: -p[0])
    body += "\nfeature_importances:\n"
    for v, name in pairs:
        body += f"{name}={int(v) if feature_importance_type == 0 else v}\n"
    body += "\nparameters:\n" + booster.param_string + "\n"
    body += "end of parameters\n"
    return body


def loaded_param_string(num_class: int) -> str:
    """The ``parameters:`` body of a loaded model: the JAX package
    writes the non-default fields of a fresh ``Config`` in which only
    ``num_class`` is set, so that is all a loaded model keeps."""
    if num_class != 1:
        return f"[num_class: {num_class}]"
    return ""


def feature_infos(dataset) -> List[str]:
    """``feature_infos=`` entries of a trained model: ``[lo:hi]`` of the
    bin upper bounds of a numerical feature, the sorted category values
    of a categorical one, ``none`` for a feature dropped at binning."""
    infos = []
    used = {int(f): i for i, f in enumerate(dataset.used_feature_map)}
    for j in range(dataset.num_total_features):
        if j not in used:
            infos.append("none")
            continue
        m = dataset.mappers[used[j]]
        if m.bin_type == 1:  # categorical
            infos.append(":".join(str(int(v)) for v in
                                  sorted(m.cat_values.tolist())) or "none")
        else:
            ub = m.upper_bounds
            lo = float(ub[0]) if len(ub) else 0.0
            hi = float(ub[-2]) if len(ub) > 1 else lo
            infos.append(f"[{lo:g}:{hi:g}]")
    return infos


def feature_importance(booster, num_iteration: int = -1,
                       importance_type: int = 0) -> np.ndarray:
    nf = booster.max_feature_idx + 1
    k = booster.num_tree_per_iteration
    models = booster.models
    if num_iteration > 0:
        models = models[:num_iteration * k]
    out = np.zeros(nf)
    for t in models:
        if importance_type == 0:
            out += t.feature_split_counts(nf)
        else:
            out += t.feature_split_gains(nf)
    return out


def dump_model_to_json(booster, start_iteration: int = 0,
                       num_iteration: int = -1) -> dict:
    """DumpModel (gbdt_model_text.cpp:25): the JAX package's dictionary
    (``model_text.py:200-260``), for the writer's ``booster`` of
    :func:`save_model_to_string`.  A loaded model gives its own
    ``max_feature_idx`` and feature names (the JAX package gives 0 and
    none)."""
    k = booster.num_tree_per_iteration
    out = {
        "name": "tree",
        "version": MODEL_VERSION,
        "num_class": booster.num_class,
        "num_tree_per_iteration": k,
        "label_index": 0,
        "max_feature_idx": booster.max_feature_idx,
        "objective": str(booster.objective) if booster.objective else "",
        "average_output": booster.average_output,
        "feature_names": list(booster.feature_names),
        "feature_importances": feature_importance(booster).tolist(),
        "tree_info": [],
    }
    models = booster.models
    if num_iteration > 0:
        models = models[start_iteration * k:
                        (start_iteration + num_iteration) * k]
    for idx, t in enumerate(models):
        out["tree_info"].append({
            "tree_index": idx,
            "num_leaves": t.num_leaves,
            "num_cat": t.num_cat,
            "shrinkage": t.shrinkage,
            "tree_structure": (_node_to_json(t, 0) if t.num_leaves > 1
                               else {"leaf_value": float(t.leaf_value[0])}),
        })
    return out


def _node_to_json(t: Tree, node: int) -> dict:
    if node < 0:
        leaf = ~node
        return {
            "leaf_index": int(leaf),
            "leaf_value": float(t.leaf_value[leaf]),
            "leaf_weight": float(t.leaf_weight[leaf]),
            "leaf_count": int(t.leaf_count[leaf]),
        }
    d = int(t.decision_type[node])
    return {
        "split_index": int(node),
        "split_feature": int(t.split_feature[node]),
        "split_gain": float(t.split_gain[node]),
        "threshold": float(t.threshold[node]),
        "decision_type": "==" if d & 1 else "<=",
        "default_left": bool(d & 2),
        "missing_type": ["None", "Zero", "NaN"][(d >> 2) & 3],
        "internal_value": float(t.internal_value[node]),
        "internal_weight": float(t.internal_weight[node]),
        "internal_count": int(t.internal_count[node]),
        "left_child": _node_to_json(t, int(t.left_child[node])),
        "right_child": _node_to_json(t, int(t.right_child[node])),
    }


# ---------------------------------------------------------------------------
class LoadedModel:
    """A predictor-only booster parsed from model text
    (reference GBDT::LoadModelFromString, gbdt_model_text.cpp:473)."""

    def __init__(self):
        self.models: List[Tree] = []
        self.num_class = 1
        self.num_tree_per_iteration = 1
        self.max_feature_idx = 0
        self.objective_str = ""
        self.average_output = False
        self.feature_names: List[str] = []
        self.feature_infos: List[str] = []
        self.params: Dict[str, str] = {}
        self.boosting_type = "gbdt"


def load_model_from_string(text: str) -> LoadedModel:
    m = LoadedModel()
    lines = text.split("\n")
    i = 0
    # header
    if lines and lines[0].strip() in ("tree", "gbdt", "dart", "rf", "goss"):
        m.boosting_type = lines[0].strip()
        if m.boosting_type == "tree":
            m.boosting_type = "gbdt"
        i = 1
    header: Dict[str, str] = {}
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if line.startswith("Tree="):
            i -= 1
            break
        if line == "average_output":
            m.average_output = True
        elif "=" in line:
            key, v = line.split("=", 1)
            header[key] = v
    m.num_class = int(header.get("num_class", 1))
    m.num_tree_per_iteration = int(header.get("num_tree_per_iteration", 1))
    m.max_feature_idx = int(header.get("max_feature_idx", 0))
    m.objective_str = header.get("objective", "")
    m.feature_names = header.get("feature_names", "").split()
    m.feature_infos = header.get("feature_infos", "").split()

    # trees
    cur: List[str] = []
    for line in lines[i:]:
        s = line.strip()
        if s == "end of trees":
            if cur:
                m.models.append(Tree.from_string("\n".join(cur)))
            cur = []
            break
        if s.startswith("Tree=") and cur:
            m.models.append(Tree.from_string("\n".join(cur)))
            cur = [s]
        elif s:
            cur.append(s)
    # parameters section
    in_params = False
    for line in lines[i:]:
        s = line.strip()
        if s == "parameters:":
            in_params = True
        elif s == "end of parameters":
            in_params = False
        elif in_params and s.startswith("[") and ": " in s:
            key, v = s[1:-1].split(": ", 1)
            m.params[key] = v
    return m
