"""Host-side tree model: array-of-nodes, LightGBM text format, and the
f64 host walk.

Reference: include/LightGBM/tree.h:25 + src/io/tree.cpp.  Nodes carry
original feature indices, real-valued thresholds, the ``decision_type``
bit field (bit0 categorical, bit1 default_left, bits2-3 missing_type)
and categorical bitsets over raw category values (tree.h:19-20,
271-279; CategoricalDecision tree.h:375).  Serialisation matches
Tree::ToString (tree.cpp:345-406) byte for byte with
``lightgbm_tpu.models.tree``.  The host walk (:meth:`Tree.predict_leaf`)
is the f64 reference every compiled serving path is held against.
:meth:`Tree.from_device` finalizes a tree the grower built.  A linear
tree (``is_linear``; reference tree.h ``leaf_coeff_`` / ``leaf_const_``
/ ``leaf_features_``) carries a linear model a leaf: :meth:`predict`
uses it, shrinkage and bias scale and shift it, and the model text
writes and reads its block as the JAX package does (``tree.py:321-333``,
``:398-411``).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..io.binning import MissingType
from ..ops.descriptor import words_to_members
from ..utils.log import LightGBMError

_K_CATEGORICAL_MASK = 1
_K_DEFAULT_LEFT_MASK = 2
_K_ZERO_THRESHOLD = 1e-35


def _bitset(values) -> np.ndarray:
    """uint32 words with bit ``v % 32`` of word ``v // 32`` set for each
    of the non-negative ints ``values`` (one zero word for none)."""
    vals = np.asarray(values, np.int64)
    words = np.zeros(int(vals.max()) // 32 + 1 if len(vals) else 1,
                     np.uint32)
    for v in vals:
        words[v // 32] |= np.uint32(1 << (int(v) % 32))
    return words


@dataclasses.dataclass
class Tree:
    num_leaves: int = 1
    # internal nodes [num_leaves - 1]
    split_feature: np.ndarray = None     # original feature indices
    threshold: np.ndarray = None         # float64 real threshold / cat slot idx
    threshold_bin: np.ndarray = None     # int32 bin threshold (training space)
    decision_type: np.ndarray = None     # uint8
    split_gain: np.ndarray = None
    left_child: np.ndarray = None        # int32, ~leaf encoding
    right_child: np.ndarray = None
    internal_value: np.ndarray = None
    internal_weight: np.ndarray = None
    internal_count: np.ndarray = None
    # leaves [num_leaves]
    leaf_value: np.ndarray = None
    leaf_weight: np.ndarray = None
    leaf_count: np.ndarray = None
    # categorical split storage (tree.h cat_boundaries_/cat_threshold_)
    num_cat: int = 0
    cat_boundaries: np.ndarray = None    # int32 [num_cat + 1]
    cat_threshold: np.ndarray = None     # uint32 bitset words over raw values
    # the same bitsets over bins (training space; not in the model text)
    cat_boundaries_inner: np.ndarray = None
    cat_threshold_inner: np.ndarray = None
    shrinkage: float = 1.0
    is_linear: bool = False
    # linear-leaf models (linear_tree): the constant, the coefficients and
    # their original feature ids a leaf, and the inner ids (None for a
    # loaded tree: rebuilt against a dataset)
    leaf_const: np.ndarray = None            # float64 [num_leaves]
    leaf_coeff: List[np.ndarray] = None      # per-leaf float64
    leaf_features: List[np.ndarray] = None   # per-leaf original ids
    leaf_features_inner: List[np.ndarray] = None

    # ------------------------------------------------------------------
    @classmethod
    def single_leaf(cls, value: float) -> "Tree":
        t = cls(num_leaves=1)
        t.split_feature = np.zeros(0, np.int32)
        t.threshold = np.zeros(0, np.float64)
        t.threshold_bin = np.zeros(0, np.int32)
        t.decision_type = np.zeros(0, np.uint8)
        t.split_gain = np.zeros(0, np.float64)
        t.left_child = np.zeros(0, np.int32)
        t.right_child = np.zeros(0, np.int32)
        t.internal_value = np.zeros(0, np.float64)
        t.internal_weight = np.zeros(0, np.float64)
        t.internal_count = np.zeros(0, np.int64)
        t.leaf_value = np.array([value], np.float64)
        t.leaf_weight = np.zeros(1, np.float64)
        t.leaf_count = np.zeros(1, np.int64)
        t.num_cat = 0
        t.cat_boundaries = np.array([0], np.int32)
        t.cat_threshold = np.zeros(0, np.uint32)
        t.cat_boundaries_inner = np.array([0], np.int32)
        t.cat_threshold_inner = np.zeros(0, np.uint32)
        return t

    @classmethod
    def from_device(cls, ta, dataset) -> "Tree":
        """Finalize grown ``TreeArrays`` into model space (the JAX
        package's ``Tree.from_device``): inner -> original feature ids,
        bin thresholds -> real thresholds by the dataset's bin mappers,
        and the ``decision_type`` bits.  A categorical split gets a
        bitset over the raw category values that go left: those of its
        member bins (``ta.cat_members``, the sorted-subset search) or of
        its one bin (one-hot); bin 0 holds no raw value, so other, NaN,
        negative and unseen categories go right.  The bitsets over bins
        are kept beside them (``cat_threshold_inner``)."""
        nl = int(ta.num_leaves)
        ni = max(nl - 1, 0)
        t = cls(num_leaves=nl)
        sf_inner = np.asarray(ta.split_feature)[:ni]
        tb = np.asarray(ta.threshold_bin)[:ni]
        dl = np.asarray(ta.default_left)[:ni]
        cat = np.asarray(ta.is_categorical)[:ni]
        t.split_feature = dataset.used_feature_map[sf_inner].astype(np.int32)
        t.threshold_bin = tb.astype(np.int32)
        t.split_gain = np.asarray(ta.split_gain)[:ni].astype(np.float64)
        t.left_child = np.asarray(ta.left_child)[:ni].astype(np.int32)
        t.right_child = np.asarray(ta.right_child)[:ni].astype(np.int32)
        t.internal_value = np.asarray(ta.internal_value)[:ni].astype(
            np.float64)
        t.internal_weight = np.asarray(ta.internal_weight)[:ni].astype(
            np.float64)
        t.internal_count = np.asarray(ta.internal_count)[:ni].astype(np.int64)
        t.leaf_value = np.asarray(ta.leaf_value)[:nl].astype(np.float64)
        t.leaf_weight = np.asarray(ta.leaf_weight)[:nl].astype(np.float64)
        t.leaf_count = np.asarray(ta.leaf_count)[:nl].astype(np.int64)
        members = ta.cat_members
        thresh = np.zeros(ni, np.float64)
        dtype_arr = np.zeros(ni, np.uint8)
        cat_bounds, cat_bounds_inner = [0], [0]
        cat_words: List[np.ndarray] = []
        cat_words_inner: List[np.ndarray] = []
        for i in range(ni):
            mapper = dataset.mappers[sf_inner[i]]
            d = 0
            if cat[i]:
                d |= _K_CATEGORICAL_MASK
                in_set = (np.flatnonzero(members[i]) if members is not None
                          else np.array([int(tb[i])]))
                vals = mapper.cat_values[np.isin(mapper.cat_bins, in_set)]
                words = _bitset(vals)
                thresh[i] = len(cat_words)   # slot into cat_boundaries
                cat_words.append(words)
                cat_bounds.append(cat_bounds[-1] + len(words))
                wi = _bitset(in_set)
                cat_words_inner.append(wi)
                cat_bounds_inner.append(cat_bounds_inner[-1] + len(wi))
                d |= MissingType.NAN << 2    # NaN goes right
            else:
                d |= int(mapper.missing_type) << 2
                if mapper.missing_type == MissingType.NAN:
                    if dl[i]:
                        d |= _K_DEFAULT_LEFT_MASK
                elif mapper.missing_type == MissingType.ZERO:
                    # zero goes by its bin position vs the threshold
                    if mapper.default_bin <= tb[i]:
                        d |= _K_DEFAULT_LEFT_MASK
                thresh[i] = mapper.bin_to_threshold(int(tb[i]))
            dtype_arr[i] = d
        t.threshold = thresh
        t.decision_type = dtype_arr
        t.num_cat = len(cat_words)
        t.cat_boundaries = np.asarray(cat_bounds, np.int32)
        t.cat_threshold = (np.concatenate(cat_words) if cat_words
                           else np.zeros(0, np.uint32))
        t.cat_boundaries_inner = np.asarray(cat_bounds_inner, np.int32)
        t.cat_threshold_inner = (np.concatenate(cat_words_inner)
                                 if cat_words_inner
                                 else np.zeros(0, np.uint32))
        return t

    def bin_members(self, padded_bins: int) -> np.ndarray:
        """bool [num_leaves - 1, padded_bins]: the bins each categorical
        node sends left, from the bitsets over bins a trained tree keeps
        (``predict_leaf_bins``' ``cat_members``)."""
        if self.cat_threshold_inner is None:
            raise LightGBMError("the tree keeps no bitsets over bins (it was "
                                "not trained in this process)")
        ni = self.num_leaves - 1
        out = np.zeros((ni, padded_bins), bool)
        for i in range(ni):
            if self.decision_type[i] & _K_CATEGORICAL_MASK:
                slot = int(self.threshold[i])
                lo, hi = (self.cat_boundaries_inner[slot],
                          self.cat_boundaries_inner[slot + 1])
                out[i] = words_to_members(
                    self.cat_threshold_inner[lo:hi].tolist(), padded_bins)
        return out

    def apply_shrinkage(self, rate: float) -> None:
        """Tree::Shrinkage (tree.h:207); scales the leaf models too."""
        self.leaf_value *= rate
        self.internal_value *= rate
        self.shrinkage *= rate
        if self.is_linear:
            self.leaf_const = self.leaf_const * rate
            self.leaf_coeff = [c * rate for c in self.leaf_coeff]

    def add_bias(self, val: float) -> None:
        """Tree::AddBias (boost_from_average folded into the first
        tree); shifts the leaf models' constants too."""
        self.leaf_value = self.leaf_value + val
        self.internal_value = self.internal_value + val
        if self.is_linear:
            self.leaf_const = self.leaf_const + val

    # ------------------------------------------------------------------
    def _decide(self, node: int, fval: np.ndarray) -> np.ndarray:
        """Vectorized Decision (tree.h:393) for one node over many rows.
        Returns next node (or ~leaf) per row."""
        d = int(self.decision_type[node])
        left, right = self.left_child[node], self.right_child[node]
        if d & _K_CATEGORICAL_MASK:
            cat_idx = int(self.threshold[node])
            lo = self.cat_boundaries[cat_idx]
            hi = self.cat_boundaries[cat_idx + 1]
            words = self.cat_threshold[lo:hi]
            iv = np.where(np.isfinite(fval), fval, -1).astype(np.int64)
            ok = (iv >= 0) & (iv < (hi - lo) * 32)
            idx = np.clip(iv, 0, max((hi - lo) * 32 - 1, 0))
            bit = (words[idx // 32] >> (idx % 32).astype(np.uint32)) & 1
            return np.where(ok & (bit > 0), left, right)
        missing_type = (d >> 2) & 3
        default_left = bool(d & _K_DEFAULT_LEFT_MASK)
        isnan = np.isnan(fval)
        v = np.where(isnan & (missing_type != MissingType.NAN), 0.0, fval)
        if missing_type == MissingType.ZERO:
            is_default = np.abs(v) <= _K_ZERO_THRESHOLD
        elif missing_type == MissingType.NAN:
            is_default = isnan
        else:
            is_default = np.zeros(v.shape, bool)
        go_left = np.where(is_default, default_left, v <= self.threshold[node])
        return np.where(go_left, left, right)

    def predict_leaf(self, X: np.ndarray) -> np.ndarray:
        """Row -> leaf index: every row advances one level per pass with
        per-row node parameters gathered up front."""
        n = X.shape[0]
        if self.num_leaves == 1:
            return np.zeros(n, np.int32)
        d = self.decision_type.astype(np.int64)
        is_cat_node = (d & _K_CATEGORICAL_MASK) > 0
        missing_type = (d >> 2) & 3
        default_left = (d & _K_DEFAULT_LEFT_MASK) > 0
        thr = self.threshold
        lc, rc = self.left_child, self.right_child
        sf = self.split_feature

        node = np.zeros(n, np.int32)  # >= 0 internal, < 0 ~leaf
        for _ in range(self.num_leaves):  # max depth bound
            active = node >= 0
            if not active.any():
                break
            rows = np.flatnonzero(active)
            nd = node[rows]
            fv = X[rows, sf[nd]]
            t = thr[nd]
            isnan = np.isnan(fv)
            mt = missing_type[nd]
            v = np.where(isnan & (mt != MissingType.NAN), 0.0, fv)
            is_default = np.where(
                mt == MissingType.ZERO, np.abs(v) <= _K_ZERO_THRESHOLD,
                np.where(mt == MissingType.NAN, isnan, False))
            go_left = np.where(is_default, default_left[nd], v <= t)
            if is_cat_node.any():
                cn = is_cat_node[nd]
                if cn.any():
                    cat_idx = t[cn].astype(np.int64)
                    lo = self.cat_boundaries[cat_idx]
                    hi = self.cat_boundaries[cat_idx + 1]
                    iv = np.where(np.isfinite(fv[cn]), fv[cn], -1).astype(
                        np.int64)
                    ok = (iv >= 0) & (iv < (hi - lo) * 32)
                    widx = lo + np.clip(iv, 0, None) // 32
                    widx = np.minimum(widx, np.maximum(hi - 1, lo))
                    bit = (self.cat_threshold[widx]
                           >> (np.clip(iv, 0, None) % 32).astype(
                               np.uint32)) & 1
                    go_left[cn] = ok & (bit > 0)
            node[rows] = np.where(go_left, lc[nd], rc[nd])
        return (~node).astype(np.int32)

    def predict(self, X: np.ndarray) -> np.ndarray:
        """The f64 host walk's outputs; a linear tree's leaf models
        (LeafOutputWithLinearModel): a row with NaN in a model feature
        keeps the leaf value, a leaf without features outputs its
        constant (JAX ``tree.py:277-291``)."""
        leaf = self.predict_leaf(X)
        out = self.leaf_value[leaf]
        if not self.is_linear:
            return out
        for lf in range(self.num_leaves):
            feats = self.leaf_features[lf]
            if len(feats) == 0:
                out[leaf == lf] = self.leaf_const[lf]
                continue
            rows = np.flatnonzero(leaf == lf)
            if len(rows) == 0:
                continue
            xs = np.asarray(X, np.float64)[np.ix_(rows, feats)]
            lin = self.leaf_const[lf] + xs @ self.leaf_coeff[lf]
            out[rows] = np.where(np.isnan(xs).any(axis=1),
                                 self.leaf_value[lf], lin)
        return out

    # ------------------------------------------------------------------
    # text serialization (reference tree.cpp:340-406)
    def to_string(self, index: int) -> str:
        def j(a, fmt="{}"):
            return " ".join(fmt.format(x) for x in a)
        ni = self.num_leaves - 1
        lines = [f"Tree={index}",
                 f"num_leaves={self.num_leaves}",
                 f"num_cat={self.num_cat}"]
        if ni > 0:
            lines.append("split_feature=" + j(self.split_feature))
            lines.append("split_gain=" + j(self.split_gain, "{:g}"))
            lines.append("threshold=" + j(self.threshold, "{:.17g}"))
            lines.append("decision_type=" + j(self.decision_type))
            lines.append("left_child=" + j(self.left_child))
            lines.append("right_child=" + j(self.right_child))
            lines.append("leaf_value=" + j(self.leaf_value, "{:.17g}"))
            lines.append("leaf_weight=" + j(self.leaf_weight, "{:.17g}"))
            lines.append("leaf_count=" + j(self.leaf_count))
            lines.append("internal_value=" + j(self.internal_value, "{:.17g}"))
            lines.append("internal_weight=" + j(self.internal_weight, "{:g}"))
            lines.append("internal_count=" + j(self.internal_count))
            if self.num_cat > 0:
                lines.append("cat_boundaries=" + j(self.cat_boundaries))
                lines.append("cat_threshold=" + j(self.cat_threshold))
        else:
            lines.append("leaf_value=" + j(self.leaf_value, "{:.17g}"))
        lines.append(f"is_linear={int(self.is_linear)}")
        if self.is_linear:
            # the leaf models' block (reference tree.cpp SaveToString)
            lines.append("leaf_const=" + j(self.leaf_const, "{:.17g}"))
            lines.append("num_features="
                         + j([len(f) for f in self.leaf_features]))
            lines.append("leaf_features=" + " ".join(
                " ".join(str(int(x)) for x in f) for f in self.leaf_features
                if len(f)))
            lines.append("leaf_coeff=" + " ".join(
                " ".join("{:.17g}".format(x) for x in c)
                for c in self.leaf_coeff if len(c)))
        lines.append(f"shrinkage={self.shrinkage:g}")
        lines.append("")
        return "\n".join(lines) + "\n"

    @classmethod
    def from_string(cls, text: str) -> "Tree":
        kv = {}
        for line in text.splitlines():
            line = line.strip()
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k] = v
        t = cls(num_leaves=int(kv["num_leaves"]))

        def arr(key, dtype, default=None):
            if key not in kv or kv[key] == "":
                return default
            return np.array(kv[key].split(), dtype=dtype)

        t.num_cat = int(kv.get("num_cat", 0))
        t.leaf_value = arr("leaf_value", np.float64)
        ni = t.num_leaves - 1
        if ni > 0:
            t.split_feature = arr("split_feature", np.int32)
            t.split_gain = arr("split_gain", np.float64,
                               np.zeros(ni, np.float64))
            t.threshold = arr("threshold", np.float64)
            t.decision_type = arr("decision_type", np.uint8,
                                  np.zeros(ni, np.uint8))
            t.left_child = arr("left_child", np.int32)
            t.right_child = arr("right_child", np.int32)
            t.leaf_weight = arr("leaf_weight", np.float64,
                                np.zeros(t.num_leaves, np.float64))
            t.leaf_count = arr("leaf_count", np.int64,
                               np.zeros(t.num_leaves, np.int64))
            t.internal_value = arr("internal_value", np.float64,
                                   np.zeros(ni, np.float64))
            t.internal_weight = arr("internal_weight", np.float64,
                                    np.zeros(ni, np.float64))
            t.internal_count = arr("internal_count", np.int64,
                                   np.zeros(ni, np.int64))
            t.threshold_bin = np.zeros(ni, np.int32)
        else:
            t.split_feature = np.zeros(0, np.int32)
            t.threshold = np.zeros(0, np.float64)
            t.threshold_bin = np.zeros(0, np.int32)
            t.decision_type = np.zeros(0, np.uint8)
            t.split_gain = np.zeros(0, np.float64)
            t.left_child = np.zeros(0, np.int32)
            t.right_child = np.zeros(0, np.int32)
            t.internal_value = np.zeros(0, np.float64)
            t.internal_weight = np.zeros(0, np.float64)
            t.internal_count = np.zeros(0, np.int64)
            t.leaf_weight = np.zeros(1, np.float64)
            t.leaf_count = np.zeros(1, np.int64)
        if t.num_cat > 0:
            t.cat_boundaries = arr("cat_boundaries", np.int32)
            t.cat_threshold = arr("cat_threshold", np.uint32)
        else:
            t.cat_boundaries = np.array([0], np.int32)
            t.cat_threshold = np.zeros(0, np.uint32)
        t.shrinkage = float(kv.get("shrinkage", 1.0))
        t.is_linear = bool(int(kv.get("is_linear", 0)))
        if t.is_linear:
            t.leaf_const = arr("leaf_const", np.float64,
                               np.zeros(t.num_leaves, np.float64))
            nf = arr("num_features", np.int64,
                     np.zeros(t.num_leaves, np.int64))
            flat_f = arr("leaf_features", np.int64, np.zeros(0, np.int64))
            flat_c = arr("leaf_coeff", np.float64, np.zeros(0, np.float64))
            if nf.sum() != len(flat_f) or nf.sum() != len(flat_c):
                raise LightGBMError("a linear tree's num_features does not "
                                    "match its leaf_features / leaf_coeff")
            bounds = np.concatenate([[0], np.cumsum(nf)])
            t.leaf_features = [flat_f[a:b].astype(np.int32)
                               for a, b in zip(bounds[:-1], bounds[1:])]
            t.leaf_coeff = [flat_c[a:b] for a, b in zip(bounds[:-1],
                                                        bounds[1:])]
        return t

    # ------------------------------------------------------------------
    def feature_split_counts(self, num_features: int) -> np.ndarray:
        out = np.zeros(num_features, np.float64)
        for f in self.split_feature:
            out[f] += 1
        return out

    def feature_split_gains(self, num_features: int) -> np.ndarray:
        out = np.zeros(num_features, np.float64)
        for f, g in zip(self.split_feature, self.split_gain):
            out[f] += g
        return out
