"""The training route of the serial learner, decided up front.

Counterpart of the serial-learner part of ``lightgbm_tpu/ops/routing.py``
(the physical rules ``non_u8_bins`` and ``phys_env_off`` at
``:182-202``, the stream rules at ``:211-236`` and the ``fused``
decision of ``decide``, ``:383-413``) and of the split-tail choice in
``lightgbm_tpu/ops/grow.py`` (``use_kernel_tail``, ``:879-888`` and
``:1224-1262``).  A route is these choices:

- ``physical``: the physically partitioned row matrix, or the
  ``row_order`` path (an index vector partitioned per split, histograms
  read through it, ``ops/grow.RowOrderGrower``) when the bins are wider
  than u8, under ``gpu_use_dp`` (the f64-accumulating mode of the
  row-order histogram, ``hist_kernel2.build_histogram_rows``), under lazy
  CEGB or ``LGBM_TPU_PHYS=0``, and for the feature and voting learners
  (rule ``learner_row_order``, the JAX package's); a rule marked
  ``loud`` (a configuration's own fallback, JAX ``routing.py:142-155``)
  is logged as a warning when the booster takes its route;
- ``stream``: score-resident gradients (``ops/stream_grad.py``) or the
  objective's gradients gathered into the rows per tree (slice 2);
- ``fused``: the fused partition + dual histogram (``ops/fused_split.py``)
  or the partition and the smaller child's histogram;
- ``scheme``: the partition of the unfused split, ``permute`` (the
  single-scan kernel and its copyback) or ``3ph`` (``LGBM_TPU_PART=3ph``,
  the 3-phase kernel ``partition_3ph``, which keeps the unfused pipeline:
  rule ``part_3ph``, ``grow.py:747-750``); ``none`` off the physical
  path;
- ``tail``: ``kernel`` (``ops/apply_find.py``) or ``xla``, the PyTorch
  split tail of slice 2 (the name is the JAX package's), which the
  sorted-subset categorical search also takes (rule
  ``tail_cat_subset``: the kernel tail searches no subsets, as the JAX
  package's ``use_kernel_tail`` requires ``not hp.use_cat_subset``,
  ``grow.py:877-888``), and so does the intermediate monotone method
  (rule ``tail_mono_intermediate``: the kernel tail runs the basic
  method only, ``use_kernel_tail`` requires ``not (hp.use_monotone and
  hp.mono_intermediate)``), and so do the split options whose children
  search with inputs of their own or whose splits are forced (rules
  ``tail_interaction``, ``tail_cegb``, ``tail_forced``, ``tail_bynode``,
  ``tail_extra_trees``: ``use_kernel_tail`` requires ``not use_ic``,
  ``not hp.use_cegb``, ``n_forced == 0``, ``bynode_count == 0`` and ``not
  hp.use_extra_trees``), and so does the voting learner (rule
  ``tail_voting``: each child searches its own elected features,
  ``use_kernel_tail`` requires ``not use_voting``); with
  ``pool_tail`` off (``LGBM_TPU_POOL_TAIL=0``, ``grow.py:1253-1262``)
  the kernel tail is the plain-pool entry ``apply_find`` after the pool
  ops in PyTorch;
- ``pack``: rows per 128-lane line of the JAX package's comb
  (``LGBM_TPU_COMB_PACK``, its pack rules at ``:237-245`` and
  ``:398-406``), decided by the JAX package's rules so that the port
  engages pack=2 exactly where it does.  At pack=2 the port keeps one
  64-byte record per row at 28 features (``device_data.PackedRows``)
  and runs the pack=2 kernels of the route, with the fused split or
  without it;
- ``hist_merge``: under ``tree_learner=data`` the histogram merge of
  the ranks (``parallel/``), ``scatter`` (each rank keeps its feature
  chunk) unless a ``hist_scatter`` rule applies (the JAX package's
  ``hist_scatter_env_off``; ``scatter_features_below_world`` where a
  rank would get no feature), then ``full``; ``vote`` under the voting
  learner, ``none`` otherwise.  The JAX package's other ``hist_scatter``
  rules do not arise: EFB is not ported, the feature chunks may be
  uneven (``scatter_f_log_indivisible``), and forced splits, coupled
  CEGB and the intermediate monotone method refuse a parallel learner
  (``models/gbdt.check_supported``).

A sorted-subset model (``cat_subset``) keeps the physical path with its
membership words in every split descriptor, up to
``descriptor.MAX_MEMBER_WORDS`` words (:func:`cat_bitset_fit`, 256
padded bins); over wider bins it goes to ``row_order`` (rule
``cat_overwide``, the JAX package's ``:176-181``), where the membership
test is a gather in PyTorch.

On ``row_order``, ``stream`` and ``fused`` are off: both move rows of
the physical matrix, and their reason is the path itself.  The knobs are
the JAX package's: ``LGBM_TPU_STREAM=0``, ``LGBM_TPU_FUSED=0`` and
``LGBM_TPU_APPLY_IMPL=xla`` together select slice 2's route.  The shape
gates are the port's own kernels' shared memory (the TPU's VMEM gates do
not apply); a build or launch failure is never a reason to change route,
it raises.

:func:`enumerate_matrix` decides every cell of the port's lattice of
inputs; ``python -m lightgbm_tpu_torch.ops.routing`` writes it to the
golden ``analysis/routing_matrix.json`` that the analyzer's routing pass
holds the rules against.
"""
from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple

from ..config import env_knob
from ..utils.log import LightGBMError
from .descriptor import MAX_MEMBER_WORDS

# the JAX package's comb layout: logical columns of a pack=2 half line
# (layout.PACK_W), and the columns beside the bins (routing.py:315,
# stream_grad.stream_columns: COL_CONSTS + N_CONSTS[kind])
PACK_W = 64
NON_STREAM_EXTRA_COLS = 6
STREAM_EXTRA_COLS = {"binary": 13, "l2": 15}
PACK_REQUIRES_PHYSICAL = "pack_requires_physical"


def cat_bitset_fit(padded_bins: int) -> bool:
    """Whether a membership bitset over ``padded_bins`` bins fits the
    descriptor's words (``layout.cat_bitset_fit``): the shape fact behind
    ``cat_overwide``, shared with the grower's refusal."""
    return 0 < int(padded_bins) <= 32 * MAX_MEMBER_WORDS


@dataclass(frozen=True)
class RouteInputs:
    """What the rules read: the configuration and the data's shape."""
    objective_kind: str = "binary"   # the objective's STREAM_KIND or "none"
    boosting: str = "gbdt"
    multi_tree: bool = False
    bagging: bool = False
    linear_tree: bool = False
    gpu_use_dp: bool = False         # f64 histogram accumulation
    learner: str = "serial"
    bins_u8: bool = True             # every feature's bins fit uint8
    cat_subset: bool = False         # the sorted-subset categorical search
    mono_intermediate: bool = False  # hp.use_monotone and intermediate
    interaction: bool = False        # interaction_constraints
    cegb: bool = False               # hp.use_cegb (any CEGB term)
    cegb_lazy: bool = False          # cegb_penalty_feature_lazy
    forced_splits: bool = False      # forcedsplits_filename
    bynode: bool = False             # feature_fraction_bynode < 1
    extra_trees: bool = False        # hp.use_extra_trees
    phys_env: str = "auto"
    stream_env: str = "auto"
    fused_env: str = "1"
    apply_impl_env: str = "kernel"
    fused_ok: bool = True            # fused_split.fused_supported
    tail_ok: bool = True             # apply_find.apply_find_supported
    part_env: str = "ss"             # LGBM_TPU_PART: ss | 3ph
    pool_tail_env: str = "1"
    pack_env: str = "1"              # LGBM_TPU_COMB_PACK: 1 | 2
    wide_layout: bool = False        # JAX comb columns > PACK_W
    hist_scatter_env: str = "1"      # LGBM_TPU_HIST_SCATTER
    features_per_rank: bool = True   # every rank gets a feature chunk

    def key(self) -> str:
        """Stable lattice-cell key (matrix row id).  The fields both
        packages have keep the JAX package's names and spelling
        (``RouteInputs.key``, ``lightgbm_tpu/ops/routing.py``); the port's
        own knobs and shape gates follow them."""
        b = lambda v: "1" if v else "0"  # noqa: E731
        return (
            f"learner={self.learner};u8={b(self.bins_u8)};"
            f"wide={b(self.wide_layout)};dp={b(self.gpu_use_dp)};"
            f"cegb={b(self.cegb_lazy)};"
            f"cat={b(self.cat_subset)};bag={b(self.bagging)};"
            f"lin={b(self.linear_tree)};boost={self.boosting};"
            f"obj={self.objective_kind};"
            f"k={'multi' if self.multi_tree else '1'};"
            f"forced={b(self.forced_splits)};"
            f"mono={b(self.mono_intermediate)};"
            f"ic={b(self.interaction)};cegbon={b(self.cegb)};"
            f"bynode={b(self.bynode)};et={b(self.extra_trees)};"
            f"phys={self.phys_env};stream={self.stream_env};"
            f"pack={self.pack_env};impl={self.part_env};"
            f"fused={self.fused_env};apply={self.apply_impl_env};"
            f"pool={self.pool_tail_env};fok={b(self.fused_ok)};"
            f"tok={b(self.tail_ok)};hs={self.hist_scatter_env};"
            f"fw={b(self.features_per_rank)}")


@dataclass(frozen=True)
class Rule:
    name: str
    blocks: str                      # physical | stream | fused | tail
    knob: str
    reason: str
    pred: Callable[[RouteInputs], bool] = field(repr=False, default=None)
    loud: bool = False


RULES: Tuple[Rule, ...] = (
    Rule("cat_overwide", "physical", "max_bin",
         "the categorical membership bitset would exceed the 8-word / "
         "256-bin split descriptor (MAX_MEMBER_WORDS); sorted-subset "
         "splits over wider bins keep the row_order path",
         lambda i: i.cat_subset and not i.bins_u8),
    Rule("non_u8_bins", "physical", "max_bin",
         "bins are wider than uint8 (max_bin > 256); the partition "
         "kernel's bf16 extract matmuls would round bin ids",
         lambda i: not i.bins_u8),
    Rule("gpu_use_dp", "physical", "gpu_use_dp",
         "double-precision histograms disable the f32 comb-direct "
         "histogram kernel",
         lambda i: i.gpu_use_dp, loud=True),
    Rule("cegb_lazy", "physical", "cegb_penalty_feature_lazy",
         "the per-(feature,row) paid mask is not plumbed through the "
         "partition kernel",
         lambda i: i.cegb_lazy),
    Rule("learner_row_order", "physical", "tree_learner",
         "the feature/voting-parallel learners run the row_order path on "
         "each rank",
         lambda i: i.learner in ("feature", "voting")),
    Rule("phys_env_off", "physical", "LGBM_TPU_PHYS",
         "physical partition mode disabled by LGBM_TPU_PHYS=0",
         lambda i: i.phys_env == "0"),
    Rule("stream_env_off", "stream", "LGBM_TPU_STREAM",
         "score-resident streaming disabled by LGBM_TPU_STREAM=0",
         lambda i: i.stream_env == "0"),
    Rule("objective_not_streamable", "stream", "objective",
         "the streaming refresh kernel knows binary and l2 gradient "
         "formulas only",
         lambda i: i.objective_kind not in ("binary", "l2")),
    Rule("boosting_not_gbdt", "stream", "boosting",
         "DART/GOSS/RF mutate scores or sample weights behind the row "
         "matrix's back",
         lambda i: i.boosting != "gbdt"),
    Rule("multi_tree_iter", "stream", "num_class",
         "K trees per iteration share one score matrix; the in-matrix "
         "score is not the whole story",
         lambda i: i.multi_tree),
    Rule("bagging_on", "stream", "bagging_freq",
         "bagging weights are not representable in the streamed score "
         "columns",
         lambda i: i.bagging),
    Rule("linear_tree", "stream", "linear_tree",
         "per-leaf linear refits rewrite scores outside the kernel",
         lambda i: i.linear_tree),
    Rule("mesh_stream_unwired", "stream", "tree_learner",
         "score-resident streaming is serial-only",
         lambda i: i.learner != "serial"),
    Rule("fused_env_off", "fused", "LGBM_TPU_FUSED",
         "the fused partition+histogram split disabled by "
         "LGBM_TPU_FUSED=0",
         lambda i: i.fused_env == "0"),
    Rule("part_3ph", "fused", "LGBM_TPU_PART",
         "the 3-phase partition kernel keeps the unfused pipeline",
         lambda i: i.part_env == "3ph"),
    Rule("fused_smem", "fused", "max_bin",
         "one block's shared histogram and row staging exceed the card's "
         "227 KB of shared memory (fused_split.fused_supported)",
         lambda i: not i.fused_ok),
    Rule("tail_env_xla", "tail", "LGBM_TPU_APPLY_IMPL",
         "the one-kernel split tail disabled by LGBM_TPU_APPLY_IMPL=xla",
         lambda i: i.apply_impl_env == "xla"),
    Rule("tail_smem", "tail", "max_bin",
         "both children's histograms exceed the shared memory of a "
         "cluster of 16 blocks (apply_find.apply_find_supported)",
         lambda i: not i.tail_ok),
    Rule("tail_cat_subset", "tail", "max_cat_to_onehot",
         "the one-kernel split tail searches no sorted subsets "
         "(grow.py use_kernel_tail requires not use_cat_subset)",
         lambda i: i.cat_subset),
    Rule("tail_mono_intermediate", "tail", "monotone_constraints_method",
         "the one-kernel split tail runs the basic monotone method only; "
         "the intermediate method's adjacency pass follows the PyTorch "
         "tail (grow.py use_kernel_tail requires not mono_intermediate)",
         lambda i: i.mono_intermediate),
    Rule("tail_interaction", "tail", "interaction_constraints",
         "each child searches the union of the interaction sets holding "
         "its path's features; the one-kernel tail takes one mask for "
         "both (grow.py use_kernel_tail requires not use_ic)",
         lambda i: i.interaction),
    Rule("tail_cegb", "tail", "cegb_penalty_split",
         "the one-kernel split tail pays no CEGB penalty (grow.py "
         "use_kernel_tail requires not hp.use_cegb)",
         lambda i: i.cegb),
    Rule("tail_forced", "tail", "forcedsplits_filename",
         "forced splits are computed beside the tail from the pooled "
         "histogram (grow.py use_kernel_tail requires n_forced == 0)",
         lambda i: i.forced_splits),
    Rule("tail_bynode", "tail", "feature_fraction_bynode",
         "each child searches its own by-node feature sample (grow.py "
         "use_kernel_tail requires bynode_count == 0)",
         lambda i: i.bynode),
    Rule("tail_extra_trees", "tail", "extra_trees",
         "each child searches one random threshold a feature (grow.py "
         "use_kernel_tail requires not hp.use_extra_trees)",
         lambda i: i.extra_trees),
    Rule("tail_voting", "tail", "tree_learner",
         "each child searches its own elected features; the one-kernel "
         "tail takes one mask for both (grow.py use_kernel_tail requires "
         "not use_voting)",
         lambda i: i.learner == "voting"),
    Rule("hist_scatter_env_off", "hist_scatter", "LGBM_TPU_HIST_SCATTER",
         "reduce-scatter histogram merge disabled by "
         "LGBM_TPU_HIST_SCATTER=0",
         lambda i: i.hist_scatter_env == "0"),
    Rule("scatter_features_below_world", "hist_scatter", "tree_learner",
         "fewer features than ranks would leave a rank no chunk to "
         "search; the merge stays full",
         lambda i: not i.features_per_rank),
)

# the pack rules, read only for a pack=2 request on the physical path;
# their names go to RouteDecision.pack_reasons, as in the JAX package
PACK_RULES: Tuple[Rule, ...] = (
    Rule("pack_layout_too_wide", "pack", "LGBM_TPU_COMB_PACK",
         "padded features + value/rid/stream columns exceed the "
         "64-lane half-line budget (layout.PACK_W)",
         lambda i: i.wide_layout),
    Rule("pack_part_3ph", "pack", "LGBM_TPU_PART",
         "the 3-phase partition kernel has no pack=2 variant "
         "(config.check_conflicts refuses the combo at runtime)",
         lambda i: i.part_env == "3ph"),
)


@dataclass(frozen=True)
class RouteDecision:
    stream: bool
    fused: bool
    tail: str                        # kernel | xla
    reasons: Tuple[str, ...] = ()    # the rules that blocked a faster part
    physical: bool = True
    scheme: str = "permute"          # permute | 3ph | none (row_order)
    pool_tail: bool = True           # the kernel tail's pool entry
    pack: int = 1
    pack_reasons: Tuple[str, ...] = ()   # why a pack=2 request got pack=1
    hist_merge: str = "none"         # scatter | full | vote | none

    @property
    def path(self) -> str:
        if not self.physical:
            return "row_order"
        return "stream" if self.stream else "physical"

    def digest(self) -> str:
        """12 hex digits naming the engaged route's fields that change
        the rows' order or the arithmetic (path, stream, pack, fused,
        tail, partition scheme; not the reasons): the identity a
        checkpoint's resume is held to (JAX ``routing.py:351``)."""
        ident = {"path": self.path, "stream": self.stream,
                 "pack": self.pack, "fused": self.fused, "tail": self.tail,
                 "scheme": self.scheme}
        return hashlib.sha256(
            json.dumps(ident, sort_keys=True).encode()).hexdigest()[:12]

    def describe(self) -> str:
        """``path=.. fused=.. tail=.. (reasons)``; the scheme is named
        when it is ``3ph``, the pool tail when it is off, the pack when it
        is 2 and a parallel learner's histogram merge."""
        why = f" ({', '.join(self.reasons)})" if self.reasons else ""
        scheme = " scheme=3ph" if self.scheme == "3ph" else ""
        pool = (" pool_tail=0" if self.tail == "kernel" and not self.pool_tail
                else "")
        pack = " pack=2" if self.pack == 2 else ""
        merge = (f" hist_merge={self.hist_merge}"
                 if self.hist_merge != "none" else "")
        return (f"path={self.path}{scheme} fused={int(self.fused)} "
                f"tail={self.tail}{pool}{pack}{merge}{why}")


def loud_rules(d: RouteDecision) -> Tuple[Rule, ...]:
    """The rules marked ``loud`` among ``d``'s reasons."""
    return tuple(r for r in RULES if r.loud and r.name in d.reasons)


def inputs_from_env(environ=None, **kw) -> RouteInputs:
    """RouteInputs with the route knobs read through ``env_knob``.
    ``LGBM_TPU_PART`` other than ``ss`` / ``3ph`` and
    ``LGBM_TPU_COMB_PACK`` other than ``1`` / ``2`` raise."""
    part = env_knob("LGBM_TPU_PART", environ)
    if part not in ("ss", "3ph"):
        raise LightGBMError(f"LGBM_TPU_PART must be ss or 3ph (got {part!r})")
    pack = env_knob("LGBM_TPU_COMB_PACK", environ)
    if pack not in ("1", "2"):
        raise LightGBMError(f"LGBM_TPU_COMB_PACK must be 1 or 2 (got "
                            f"{pack!r})")
    return RouteInputs(
        hist_scatter_env=env_knob("LGBM_TPU_HIST_SCATTER", environ),
        phys_env=env_knob("LGBM_TPU_PHYS", environ),
        stream_env=env_knob("LGBM_TPU_STREAM", environ),
        fused_env=env_knob("LGBM_TPU_FUSED", environ),
        apply_impl_env=env_knob("LGBM_TPU_APPLY_IMPL", environ),
        part_env=part, pack_env=pack,
        pool_tail_env=env_knob("LGBM_TPU_POOL_TAIL", environ), **kw)


def jax_feature_pad(num_features: int, padded_bins: int) -> int:
    """The JAX package's padded feature count of a dataset
    (``device_data.to_device``: whole histogram matmul groups of
    ``histogram.feature_group_size``)."""
    g = max(min(128 // max(padded_bins // 16, 1), 16), 1)
    return -(-max(num_features, 1) // g) * g


def resolve_layout(i: RouteInputs, *, num_features: int,
                   padded_bins: int) -> RouteInputs:
    """``i`` with ``wide_layout`` from the JAX comb's columns
    (``routing.resolve_layout``): the padded features plus the stream
    or the plain layout's extra columns, by a provisional decision
    (pack never feeds back into the stream decision)."""
    extra = (STREAM_EXTRA_COLS[i.objective_kind] if decide(i).stream
             else NON_STREAM_EXTRA_COLS)
    cols = jax_feature_pad(num_features, padded_bins) + extra
    return replace(i, wide_layout=cols > PACK_W)


def decide(i: RouteInputs) -> RouteDecision:
    """Evaluate the rule table; pure.  Off the physical path the stream
    and fused rules are not read, and the scheme is ``none``."""
    blocked = {k: [r.name for r in RULES if r.blocks == k and r.pred(i)]
               for k in ("physical", "stream", "fused", "tail",
                         "hist_scatter")}
    physical = not blocked["physical"]
    if not physical:
        blocked["stream"] = blocked["fused"] = []
    pack, pack_reasons = 1, ()
    if i.pack_env == "2":
        pack_reasons = ((PACK_REQUIRES_PHYSICAL,) if not physical else
                        tuple(r.name for r in PACK_RULES if r.pred(i)))
        pack = 1 if pack_reasons else 2
    tail = "xla" if blocked["tail"] else "kernel"
    if i.learner != "data":
        blocked["hist_scatter"] = []
    merge = {"data": "full" if blocked["hist_scatter"] else "scatter",
             "voting": "vote"}.get(i.learner, "none")
    return RouteDecision(
        stream=physical and not blocked["stream"],
        fused=physical and not blocked["fused"],
        tail=tail,
        reasons=tuple(blocked["physical"] + blocked["stream"]
                      + blocked["fused"] + blocked["tail"]
                      + blocked["hist_scatter"]),
        physical=physical,
        scheme=(("3ph" if i.part_env == "3ph" else "permute") if physical
                else "none"),
        pool_tail=tail == "kernel" and i.pool_tail_env != "0",
        pack=pack, pack_reasons=pack_reasons, hist_merge=merge)



# ---------------------------------------------------------------------
# lattice enumeration and the golden matrix (the counterpart of
# lightgbm_tpu/ops/routing.py:1126-1260 over the port's RouteInputs)
# ---------------------------------------------------------------------
ROUTING_SCHEMA = "lightgbm_tpu_torch/routing/v1"
_BOOL = (False, True)
# (objective_kind, multi_tree), as the JAX package's _OBJ
_OBJ = (("binary", False), ("l2", False), ("other", True),
        ("other", False))


def enumerate_inputs() -> List[RouteInputs]:
    """The audited lattice, deterministic and deduplicated by key: the
    config lattice under the default knobs, every knob combination over
    the default config, and the shape and boosting edge cells."""
    cells: List[RouteInputs] = []
    seen = set()

    def add(**kw):
        i = RouteInputs(**kw)
        if i.key() not in seen:
            seen.add(i.key())
            cells.append(i)

    for u8 in _BOOL:
        for bag in _BOOL:
            for lin in _BOOL:
                for obj, multi in _OBJ:
                    add(bins_u8=u8, bagging=bag, linear_tree=lin,
                        objective_kind=obj, multi_tree=multi)
    knobs = [dict(phys_env=phys, stream_env=stream, fused_env=fused,
                  apply_impl_env=apply_impl, pool_tail_env=pool,
                  part_env=part, pack_env=pack)
             for phys in ("auto", "0") for stream in ("auto", "0")
             for fused in ("1", "0") for apply_impl in ("kernel", "xla")
             for pool in ("1", "0") for part in ("ss", "3ph")
             for pack in ("1", "2")]
    for obj in ("binary", "l2"):
        for kw in knobs:
            add(objective_kind=obj, **kw)
    for pack in ("1", "2"):
        for part in ("ss", "3ph"):
            add(wide_layout=True, pack_env=pack, part_env=part)
        add(bins_u8=False, pack_env=pack)
        add(fused_ok=False, pack_env=pack)
        add(tail_ok=False, pack_env=pack)
        add(fused_ok=False, tail_ok=False, bins_u8=False, pack_env=pack)
    for boost in ("dart", "goss", "rf"):
        add(boosting=boost)
    add(objective_kind="none")
    # the sorted-subset search on each route a user selects, and over
    # bins wider than u8
    for kw in ({}, dict(pack_env="2"), dict(fused_env="0"),
               dict(fused_env="0", pack_env="2"), dict(part_env="3ph"),
               dict(stream_env="0", fused_env="0", apply_impl_env="xla"),
               dict(phys_env="0"), dict(bins_u8=False),
               dict(bins_u8=False, pack_env="2")):
        add(cat_subset=True, **kw)
    # the intermediate monotone method on the same routes
    for kw in ({}, dict(pack_env="2"), dict(fused_env="0"),
               dict(part_env="3ph"), dict(pool_tail_env="0"),
               dict(bins_u8=False), dict(tail_ok=False),
               dict(cat_subset=True)):
        add(mono_intermediate=True, **kw)
    # the split options on the same routes; lazy CEGB (CEGB on) also
    # where the physical path is already gone and under pack=2
    routes = ({}, dict(pack_env="2"), dict(fused_env="0"),
              dict(fused_env="0", pack_env="2"), dict(part_env="3ph"),
              dict(stream_env="0", fused_env="0", apply_impl_env="xla"),
              dict(pool_tail_env="0"), dict(bins_u8=False),
              dict(tail_ok=False), dict(cat_subset=True),
              dict(mono_intermediate=True), dict(bagging=True),
              dict(objective_kind="other", multi_tree=True))
    for opt in (dict(interaction=True), dict(cegb=True),
                dict(cegb=True, cegb_lazy=True), dict(forced_splits=True),
                dict(bynode=True), dict(extra_trees=True)):
        for kw in routes:
            add(**opt, **kw)
    add(interaction=True, cegb=True, forced_splits=True, bynode=True,
        extra_trees=True)
    add(cegb=True, cegb_lazy=True, phys_env="0")
    # the parallel learners on the routes a user selects (the multiclass
    # objectives and l2 beside binary)
    for learner in ("data", "voting", "feature"):
        for kw in ({}, dict(fused_env="0"), dict(phys_env="0"),
                   dict(bins_u8=False), dict(hist_scatter_env="0"),
                   dict(features_per_rank=False), dict(apply_impl_env="xla"),
                   dict(pool_tail_env="0"), dict(objective_kind="l2"),
                   dict(objective_kind="other", multi_tree=True)):
            add(learner=learner, **kw)
    # gpu_use_dp on the routes a user selects and beside the options
    # that already leave a part of the route
    for kw in ({}, dict(pack_env="2"), dict(fused_env="0"),
               dict(part_env="3ph"), dict(bins_u8=False), dict(phys_env="0"),
               dict(linear_tree=True), dict(bagging=True),
               dict(objective_kind="other", multi_tree=True),
               dict(cat_subset=True), dict(cegb=True, cegb_lazy=True),
               dict(interaction=True)):
        add(gpu_use_dp=True, **kw)
    return cells


def encode_cell(d: RouteDecision) -> str:
    """One-line cell encoding.  ``path``, ``pack``, ``scheme``, ``fused``,
    ``why`` (the physical rules, else the stream rules) and ``pack_why``
    are the JAX package's fields; ``tail``, ``pool``, ``fused_why`` and
    ``tail_why`` are the port's."""
    reasons = set(d.reasons)
    j = lambda rules: "+".join(  # noqa: E731
        r.name for r in rules if r.name in reasons) or "-"
    by = {k: [r for r in RULES if r.blocks == k]
          for k in ("physical", "stream", "fused", "tail", "hist_scatter")}
    why = j(by["physical"]) if not d.physical else j(by["stream"])
    return (f"path={d.path};pack={d.pack};scheme={d.scheme};"
            f"fused={int(d.fused)};tail={d.tail};pool={int(d.pool_tail)};"
            f"why={why};pack_why={'+'.join(d.pack_reasons) or '-'};"
            f"fused_why={j(by['fused'])};tail_why={j(by['tail'])};"
            f"merge={d.hist_merge};merge_why={j(by['hist_scatter'])}")


def decode_cell(enc: str) -> Dict[str, object]:
    """``field -> value`` of a cell, ``*why`` fields as lists of rule
    names; reads the JAX package's cells as well (the analyzer audits
    cells the port cannot produce yet)."""
    out: Dict[str, object] = {}
    for part in enc.split(";"):
        k, sep, v = part.partition("=")
        if not sep:
            raise ValueError(f"unparseable cell field {part!r}")
        out[k] = ([] if v == "-" else v.split("+")) if k.endswith("why") \
            else v
    for k in ("path", "pack", "scheme", "fused"):
        if k not in out:
            raise ValueError(f"cell has no {k!r} field")
    return out


def enumerate_matrix() -> dict:
    """The golden routing matrix document."""
    cells: Dict[str, str] = {}
    paths: Dict[str, int] = {}
    reasons: Dict[str, int] = {}
    for i in enumerate_inputs():
        d = decide(i)
        cells[i.key()] = encode_cell(d)
        paths[d.path] = paths.get(d.path, 0) + 1
        for name in d.reasons + d.pack_reasons:
            reasons[name] = reasons.get(name, 0) + 1
    return {"schema": ROUTING_SCHEMA, "cells": cells,
            "summary": {"n_cells": len(cells), "paths": paths,
                        "reasons": reasons}}


def canonical_bytes(doc: dict) -> bytes:
    """The byte-for-byte form the golden file is checked against."""
    return (json.dumps(doc, indent=0, sort_keys=True) + "\n").encode()


def default_matrix_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "analysis", "routing_matrix.json")


def write_matrix(path: Optional[str] = None) -> str:
    path = path or default_matrix_path()
    with open(path, "wb") as fh:
        fh.write(canonical_bytes(enumerate_matrix()))
    return path


if __name__ == "__main__":
    import sys
    print(write_matrix(sys.argv[1] if len(sys.argv) > 1 else None))
