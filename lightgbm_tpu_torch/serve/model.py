"""ServingModel: one-time build of a booster (loaded from model text or
trained by the port) into stacked forest arrays and quantizer tables on
one device.

The build is host-side numpy, the same arithmetic as the ``derive``
branch of ``lightgbm_tpu/serve/model.py``: every numerical split
threshold becomes a bin edge, floor-rounded to f32, so for f32 inputs
``x <= floor_f32(t)`` reproduces the host's ``x <= t`` exactly and the
bin-space walk matches the f64 host walk leaf for leaf.  The arrays,
``n_steps`` and the content ``digest`` equal the JAX build's for the
same model text.  A booster trained by the JAX package crosses over
through ``lightgbm_tpu_torch.convert`` instead.  A model with linear
trees is refused (routing rule ``predict_linear_tree``: the leaf models
read raw feature vectors outside the stacked node arrays), except as a
model of its structure (``leaves_only``), whose leaf entry
``Booster.predict`` reads before it adds the leaf models.
"""
from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np
import torch

from ..config import env_knob
from ..io.binning import MissingType
from ..ops.predict import ServingForest
from ..ops.serve_kernel import PackedForest, pack_forest
from ..utils.device import resolve_device
from ..utils.log import LightGBMError

SERVING_SCHEMA = "lightgbm_tpu/serving/v1"
# node arrays and the leaf table are padded to this multiple, as the JAX
# build pads them, so the two builds compare array for array
_PAD = 128


def _floor_to_f32(ub64: np.ndarray) -> np.ndarray:
    """f64 bin upper bounds -> the largest f32 <= each bound.  For any
    f32 input x, ``x <= floor_f32(t)`` equals ``x <= t``."""
    ub32 = ub64.astype(np.float32)
    over = ub32.astype(np.float64) > ub64
    if over.any():
        ub32[over] = np.nextafter(ub32[over],
                                  np.float32(-np.inf), dtype=np.float32)
    return ub32


def _tree_depth(left: np.ndarray, right: np.ndarray) -> int:
    """Max root->leaf depth of one tree's child arrays (~leaf < 0)."""
    if len(left) == 0:
        return 0
    depth = 0
    stack = [(0, 1)]
    while stack:
        node, d = stack.pop()
        depth = max(depth, d)
        for child in (int(left[node]), int(right[node])):
            if child >= 0:
                stack.append((child, d + 1))
    return depth


def _pad_to(n: int, mult: int = _PAD) -> int:
    """Round ``n`` up to a positive multiple of ``mult``."""
    return mult * max(-(-int(n) // mult), 1)


def leaf_dtype_name(dtype) -> str:
    """The numpy-style dtype name the digest and ``to_json`` carry
    (``"float32"`` / ``"bfloat16"``), for a torch or numpy dtype."""
    return str(dtype).replace("torch.", "")


def serving_digest(arrays: dict, *, t_cnt, ni_pad, nl_pad, n_steps, k,
                   average_output, objective_str, leaf_dtype) -> str:
    """Content digest of a stacked forest: the sha256 of the arrays'
    bytes (f32 leaf values, uint32 bitset words) and of the geometry
    repr, the same bytes the JAX build hashes."""
    h = hashlib.sha256()
    for name in ("split_feature", "threshold_bin", "default_left",
                 "is_categorical", "left_child", "right_child",
                 "leaf_value", "init_node", "cat_words", "cat_nbits",
                 "used_cols", "ub", "default_bin", "num_bins", "has_nan",
                 "missing_zero", "node_meta", "cat_col"):
        h.update(np.ascontiguousarray(arrays[name]).tobytes())
    h.update(repr((t_cnt, ni_pad, nl_pad, n_steps, k,
                   bool(average_output), objective_str,
                   leaf_dtype_name(leaf_dtype))).encode())
    return h.hexdigest()[:12]


def forest_from_numpy(arrays: dict, *, leaf_bf16: bool,
                      device) -> ServingForest:
    """Numpy field arrays (cat_words flat [T, ni_pad * W] i32) ->
    a :class:`ServingForest` on ``device``."""
    def tensor(name):
        a = np.array(arrays[name], order="C")     # owned, writable
        if a.dtype.name == "bfloat16":
            # numpy bf16 arrays (ml_dtypes) have no torch counterpart
            # in from_numpy: reinterpret the 16-bit words
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)
    fields = {name: tensor(name) for name in ServingForest.__dataclass_fields__}
    lv = fields["leaf_value"]
    fields["leaf_value"] = lv.to(torch.bfloat16 if leaf_bf16
                                 else torch.float32)
    return ServingForest(**fields).to(device)


class ServingModel:
    """Stacked-forest + quantizer arrays for one booster slice, on one
    device.  ``digest`` identifies the exact content (array bytes +
    geometry + leaf dtype)."""

    def __init__(self, forest: ServingForest, *, n_steps: int,
                 num_class: int, average_output: bool, objective_str: str,
                 n_orig_features: int, start_iteration: int,
                 end_iteration: int, n_trees: int, digest: str,
                 linear: bool = False):
        self.forest = forest
        # built leaves_only from linear trees: its leaf table lacks the
        # leaf models, so only the leaf entry may read it
        self.linear = bool(linear)
        self.n_steps = int(n_steps)
        self.num_class = int(num_class)
        self.average_output = bool(average_output)
        self.objective_str = objective_str
        self.n_orig_features = int(n_orig_features)
        self.start_iteration = int(start_iteration)
        self.end_iteration = int(end_iteration)
        self.n_trees = int(n_trees)
        self.digest = digest
        self._packed: Optional[PackedForest] = None

    def packed(self) -> PackedForest:
        """The forest as the traversal kernel reads it
        (``serve_kernel.pack_forest``), built at the first call: derived
        data beside the ``ServingForest`` fields, which the digest
        covers."""
        if self._packed is None or self._packed.forest is not self.forest:
            self._packed = pack_forest(self.forest, self.n_steps)
        return self._packed

    @property
    def device(self) -> torch.device:
        return self.forest.device

    # ------------------------------------------------------------------
    def kernel_geometry(self) -> dict:
        """The padded forest geometry the traversal kernel sees and
        ``PERF.md`` prices it with."""
        t_cnt, ni_pad = (int(s) for s in self.forest.split_feature.shape)
        nl_pad = int(self.forest.leaf_value.shape[1])
        flat_w = int(self.forest.cat_words.shape[1])
        return {
            "trees": t_cnt,
            "ni_pad": ni_pad,
            "nl_pad": nl_pad,
            "cat_words_w": flat_w // ni_pad if ni_pad else 0,
            "leaf_itemsize": int(self.forest.leaf_value.dtype.itemsize),
        }

    # ------------------------------------------------------------------
    @classmethod
    def from_booster(cls, booster, *, start_iteration: int = 0,
                     end_iteration: Optional[int] = None,
                     device="cuda", leaves_only: bool = False
                     ) -> "ServingModel":
        """Stack the ``[start, end)`` iteration slice of a booster
        (loaded from model text or trained by the port), re-deriving an
        exact quantizer from the trees' own thresholds.  Linear trees
        raise unless ``leaves_only``: then the model serves their leaves
        only (``ServingEngine.predict_leaves``)."""
        dev = resolve_device(device)
        models = booster._models
        k = booster._k
        total_iter = len(models) // max(k, 1)
        end = total_iter if end_iteration is None \
            else min(int(end_iteration), total_iter)
        start = max(int(start_iteration), 0)
        trees = models[start * k:end * k]
        linear = any(t.is_linear for t in trees)
        if linear and not leaves_only:
            raise LightGBMError(
                "ServingModel does not support linear trees "
                "(routing rule predict_linear_tree)")

        t_cnt = len(trees)
        ni_max = max([max(t.num_leaves - 1, 0) for t in trees] + [1])
        nl_max = max([t.num_leaves for t in trees] + [1])
        ni_pad = _pad_to(ni_max)
        nl_pad = _pad_to(nl_max)

        f_cnt = max(int(booster.num_feature()), 1)
        used_cols = np.arange(f_cnt, dtype=np.int32)

        sf = np.zeros((t_cnt, ni_pad), np.int32)
        tb = np.zeros((t_cnt, ni_pad), np.int32)
        dl = np.zeros((t_cnt, ni_pad), bool)
        cat = np.zeros((t_cnt, ni_pad), bool)
        lc = np.zeros((t_cnt, ni_pad), np.int32)
        rc = np.zeros((t_cnt, ni_pad), np.int32)
        lv = np.zeros((t_cnt, nl_pad), np.float32)
        init_node = np.zeros(t_cnt, np.int32)
        cat_col = np.zeros(f_cnt, bool)
        n_steps = 0
        # raw-value cat bitset width across the whole forest
        w_max = 0
        for t in trees:
            if t.num_cat > 0:
                for s in range(t.num_cat):
                    w_max = max(w_max, int(t.cat_boundaries[s + 1]
                                           - t.cat_boundaries[s]))
        cw = np.zeros((t_cnt, ni_pad, w_max), np.uint32)
        cb = np.zeros((t_cnt, ni_pad), np.int32)
        # every numerical split threshold per feature, plus the
        # feature's missing_type from decision_type bits 2-3 (a
        # per-feature fact; mixed values mean a corrupt model)
        thr64 = np.zeros((t_cnt, ni_pad), np.float64)
        thr_by_feat = [set() for _ in range(f_cnt)]
        mt_by_feat = [None] * f_cnt

        for ti, t in enumerate(trees):
            ni = t.num_leaves - 1
            if ni <= 0:
                init_node[ti] = -1
                # the kernel starts every tree at node 0: point both
                # children at leaf 0 (~0) so one step parks here
                lc[ti, 0] = -1
                rc[ti, 0] = -1
                lv[ti, 0] = np.float32(t.leaf_value[0])
                continue
            sf[ti, :ni] = t.split_feature[:ni]
            d = t.decision_type[:ni].astype(np.int32)
            cat[ti, :ni] = (d & 1) > 0
            dl[ti, :ni] = (d & 2) > 0
            lc[ti, :ni] = t.left_child[:ni]
            rc[ti, :ni] = t.right_child[:ni]
            lv[ti, :t.num_leaves] = t.leaf_value[:t.num_leaves]
            n_steps = max(n_steps, _tree_depth(t.left_child[:ni],
                                               t.right_child[:ni]))
            thr64[ti, :ni] = np.asarray(t.threshold[:ni], np.float64)
            mt = (d >> 2) & 3
            for i in range(ni):
                fi = int(sf[ti, i])
                if cat[ti, i]:
                    cat_col[fi] = True
                    continue
                thr_by_feat[fi].add(float(thr64[ti, i]))
                if mt_by_feat[fi] is None:
                    mt_by_feat[fi] = int(mt[i])
                elif mt_by_feat[fi] != int(mt[i]):
                    raise LightGBMError(
                        f"model text declares conflicting missing types "
                        f"({mt_by_feat[fi]} vs {int(mt[i])}) for feature "
                        f"{fi}; cannot derive a serving quantizer from a "
                        f"corrupt model")
            if t.num_cat > 0:
                for i in range(ni):
                    if not cat[ti, i]:
                        continue
                    slot = int(t.threshold[i])
                    lo = int(t.cat_boundaries[slot])
                    hi = int(t.cat_boundaries[slot + 1])
                    cw[ti, i, :hi - lo] = t.cat_threshold[lo:hi]
                    cb[ti, i] = (hi - lo) * 32

        # every numerical threshold, floor-rounded to f32, is a bin edge:
        # searchsorted(core, x, 'left') <= tb  iff  x <= floor_f32(thr)
        # iff  x <= thr for f32 x
        cores = []
        for fi in range(f_cnt):
            if thr_by_feat[fi]:
                cores.append(np.unique(_floor_to_f32(np.asarray(
                    sorted(thr_by_feat[fi]), np.float64))))
            else:
                cores.append(np.zeros(0, np.float32))
        b_max = max([len(c) for c in cores] + [1])
        ub = np.full((f_cnt, b_max), np.inf, np.float32)
        default_bin = np.zeros(f_cnt, np.int32)
        num_bins = np.zeros(f_cnt, np.int32)
        has_nan = np.zeros(f_cnt, bool)
        missing_zero = np.zeros(f_cnt, bool)
        for fi, core in enumerate(cores):
            ub[fi, :len(core)] = core
            mt = mt_by_feat[fi]
            has_nan[fi] = mt == MissingType.NAN
            missing_zero[fi] = mt == MissingType.ZERO
            # one bin past every edge, plus a NaN bin under missing NAN
            num_bins[fi] = len(core) + (2 if has_nan[fi] else 1)
            # NaN under NONE/ZERO follows the host's v=0.0 path
            default_bin[fi] = np.searchsorted(core, np.float32(0.0),
                                              side="left")
        for ti, t in enumerate(trees):
            for i in range(max(t.num_leaves - 1, 0)):
                if cat[ti, i]:
                    continue
                fi = int(sf[ti, i])
                t32 = _floor_to_f32(thr64[ti, i:i + 1])[0]
                tb[ti, i] = np.searchsorted(cores[fi], t32, side="left")

        # per-node metadata word:
        #   (nan_bin << 3) | (is_categorical << 2) | (has_nan << 1)
        #                  | default_left
        nm = (((num_bins[sf] - 1).astype(np.int32) << 3)
              | (cat.astype(np.int32) << 2)
              | (has_nan[sf].astype(np.int32) << 1)
              | dl.astype(np.int32))

        arrays = dict(
            split_feature=sf, threshold_bin=tb, default_left=dl,
            is_categorical=cat, left_child=lc, right_child=rc,
            leaf_value=lv, init_node=init_node,
            # flat per tree, node-major: [T, ni_pad * W]
            cat_words=cw.view(np.int32).reshape(t_cnt, ni_pad * w_max),
            cat_nbits=cb, used_cols=used_cols, ub=ub,
            default_bin=default_bin, num_bins=num_bins, has_nan=has_nan,
            missing_zero=missing_zero, node_meta=nm, cat_col=cat_col)
        leaf_bf16 = env_knob("LGBM_TPU_SERVE_LEAF_BF16") == "1"
        digest = serving_digest(
            arrays, t_cnt=t_cnt, ni_pad=ni_pad, nl_pad=nl_pad,
            n_steps=n_steps, k=k, average_output=booster._average_output,
            objective_str=booster._objective_str,
            leaf_dtype="bfloat16" if leaf_bf16 else "float32")
        forest = forest_from_numpy(arrays, leaf_bf16=leaf_bf16, device=dev)
        return cls(forest, n_steps=n_steps, num_class=k,
                   average_output=bool(booster._average_output),
                   objective_str=booster._objective_str,
                   n_orig_features=f_cnt,
                   start_iteration=start, end_iteration=end,
                   n_trees=t_cnt, digest=digest, linear=linear)

    # ------------------------------------------------------------------
    def to(self, device) -> "ServingModel":
        """This model with its forest on ``device`` (self if already)."""
        dev = resolve_device(device)
        if self.device == dev:
            return self
        return ServingModel(
            self.forest.to(dev), n_steps=self.n_steps,
            num_class=self.num_class, average_output=self.average_output,
            objective_str=self.objective_str,
            n_orig_features=self.n_orig_features,
            start_iteration=self.start_iteration,
            end_iteration=self.end_iteration, n_trees=self.n_trees,
            digest=self.digest, linear=self.linear)

    def to_json(self) -> dict:
        """Identity block of the compiled model."""
        return {
            "schema": SERVING_SCHEMA,
            "digest": self.digest,
            "trees": self.n_trees,
            "num_class": self.num_class,
            "max_depth": self.n_steps,
            "start_iteration": self.start_iteration,
            "end_iteration": self.end_iteration,
            "leaf_dtype": leaf_dtype_name(self.forest.leaf_value.dtype),
        }
