"""Model -> standalone C++ if-else code generation (``task=convert_model``).

Counterpart of ``lightgbm_tpu/models/codegen.py`` (``_emit_node`` :36,
``tree_to_function`` :76, ``model_to_ifelse_cpp`` :87): for the same
model text the generated C++ is byte for byte the JAX package's.
Reference: GBDT::SaveModelToIfElse (src/boosting/gbdt_model_text.cpp
``ModelToIfElse``/convert_model task) — emits a dependency-free .cpp with one
``PredictTree<i>`` function per tree and a ``PredictRaw`` accumulator, so a
trained model can be embedded in any C++ program without the framework.
Decision semantics mirror Tree::Decision (tree.h:393) exactly as implemented
in models/tree.py::_decide.
"""
from __future__ import annotations

from typing import List

from .tree import (_K_CATEGORICAL_MASK, _K_DEFAULT_LEFT_MASK,
                   _K_ZERO_THRESHOLD, Tree)

_HEADER = """\
// Generated by lightgbm_tpu (task=convert_model).
// Standalone single-row predictor: PredictRaw(features) -> raw score(s).
#include <cmath>
#include <cstdint>

namespace lightgbm_tpu_model {

static inline bool CatBit(const uint32_t* words, double fval, int n_words) {
  if (std::isnan(fval)) return false;
  long iv = static_cast<long>(fval);
  if (iv < 0 || iv >= n_words * 32) return false;
  return (words[iv / 32] >> (iv % 32)) & 1U;
}
"""


def _emit_node(t: Tree, node: int, lines: List[str], indent: str) -> None:
    if node < 0:
        leaf = ~node
        lines.append(f"{indent}return {float(t.leaf_value[leaf])!r};")
        return
    d = int(t.decision_type[node])
    feat = int(t.split_feature[node])
    left = int(t.left_child[node])
    right = int(t.right_child[node])
    if d & _K_CATEGORICAL_MASK:
        cat_idx = int(t.threshold[node])
        lo = int(t.cat_boundaries[cat_idx])
        hi = int(t.cat_boundaries[cat_idx + 1])
        words = ", ".join(f"{int(w)}U" for w in t.cat_threshold[lo:hi])
        lines.append(f"{indent}static const uint32_t cat_{node}[] = "
                     f"{{{words}}};")
        cond = f"CatBit(cat_{node}, arr[{feat}], {hi - lo})"
    else:
        thr = float(t.threshold[node])
        missing_type = (d >> 2) & 3
        default_left = bool(d & _K_DEFAULT_LEFT_MASK)
        v = f"arr[{feat}]"
        base = f"{v} <= {thr!r}"
        if missing_type == 1:  # ZERO as missing
            dflt = f"std::fabs({v}) <= {_K_ZERO_THRESHOLD!r}"
            branch = "true" if default_left else "false"
            cond = (f"(std::isnan({v}) ? (0.0 <= {thr!r}) : "
                    f"(({dflt}) ? {branch} : ({base})))")
        elif missing_type == 2:  # NaN as missing
            branch = "true" if default_left else "false"
            cond = f"(std::isnan({v}) ? {branch} : ({base}))"
        else:
            cond = f"(std::isnan({v}) ? (0.0 <= {thr!r}) : ({base}))"
    lines.append(f"{indent}if ({cond}) {{")
    _emit_node(t, left, lines, indent + "  ")
    lines.append(f"{indent}}} else {{")
    _emit_node(t, right, lines, indent + "  ")
    lines.append(f"{indent}}}")


def tree_to_function(t: Tree, index: int) -> str:
    lines = [f"double PredictTree{index}(const double* arr) {{"]
    if t.num_leaves <= 1:
        val = float(t.leaf_value[0]) if t.leaf_value is not None else 0.0
        lines.append(f"  (void)arr; return {val!r};")
    else:
        _emit_node(t, 0, lines, "  ")
    lines.append("}")
    return "\n".join(lines)


def model_to_ifelse_cpp(model) -> str:
    """``model`` is a GBDT-like object: .models (List[Tree]) and
    .num_tree_per_iteration."""
    trees: List[Tree] = model.models
    k = max(int(getattr(model, "num_tree_per_iteration", 1)), 1)
    parts = [_HEADER]
    for i, t in enumerate(trees):
        parts.append(tree_to_function(t, i))
    ptrs = ",\n  ".join(f"PredictTree{i}" for i in range(len(trees)))
    parts.append(f"""
typedef double (*TreeFn)(const double*);
static const TreeFn kTrees[] = {{
  {ptrs}
}};
static const int kNumTrees = {len(trees)};
static const int kNumClass = {k};

// raw scores for one row; out must hold kNumClass doubles
void PredictRaw(const double* arr, double* out) {{
  for (int c = 0; c < kNumClass; ++c) out[c] = 0.0;
  for (int i = 0; i < kNumTrees; ++i) out[i % kNumClass] += kTrees[i](arr);
}}

}}  // namespace lightgbm_tpu_model
""")
    return "\n\n".join(parts)
