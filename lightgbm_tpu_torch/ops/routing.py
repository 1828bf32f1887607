"""The training route of the serial learner, decided up front.

Counterpart of the serial-learner part of ``lightgbm_tpu/ops/routing.py``
(the physical rules ``non_u8_bins`` and ``phys_env_off`` at
``:182-202``, the stream rules at ``:211-236`` and the ``fused``
decision of ``decide``, ``:383-413``) and of the split-tail choice in
``lightgbm_tpu/ops/grow.py`` (``use_kernel_tail``, ``:879-888`` and
``:1224-1262``).  A route is four choices:

- ``physical``: the physically partitioned row matrix, or the
  ``row_order`` path (an index vector partitioned per split, histograms
  read through it, ``ops/grow.RowOrderGrower``) when the bins are wider
  than u8 or ``LGBM_TPU_PHYS=0``.  The JAX package's other row-order
  triggers (``gpu_use_dp``, lazy CEGB, the feature and voting learners)
  raise ``LightGBMError`` in ``models/gbdt.check_supported``;
- ``stream``: score-resident gradients (``ops/stream_grad.py``) or the
  objective's gradients gathered into the rows per tree (slice 2);
- ``fused``: the fused partition + dual histogram (``ops/fused_split.py``)
  or the partition scan and the smaller child's histogram;
- ``tail``: ``kernel`` (``ops/apply_find.py``) or ``xla``, the PyTorch
  split tail of slice 2 (the name is the JAX package's).

On ``row_order``, ``stream`` and ``fused`` are off: both move rows of
the physical matrix, and their reason is the path itself.  The knobs are
the JAX package's: ``LGBM_TPU_STREAM=0``, ``LGBM_TPU_FUSED=0`` and
``LGBM_TPU_APPLY_IMPL=xla`` together select slice 2's route.  The shape
gates are the port's own kernels' shared memory (the TPU's VMEM gates do
not apply); a build or launch failure is never a reason to change route,
it raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Tuple

from ..config import env_knob


@dataclass(frozen=True)
class RouteInputs:
    """What the rules read: the configuration and the data's shape."""
    objective_kind: str = "binary"   # the objective's STREAM_KIND or "none"
    boosting: str = "gbdt"
    multi_tree: bool = False
    bagging: bool = False
    linear_tree: bool = False
    learner: str = "serial"
    bins_u8: bool = True             # every feature's bins fit uint8
    phys_env: str = "auto"
    stream_env: str = "auto"
    fused_env: str = "1"
    apply_impl_env: str = "kernel"
    fused_ok: bool = True            # fused_split.fused_supported
    tail_ok: bool = True             # apply_find.apply_find_supported


@dataclass(frozen=True)
class Rule:
    name: str
    blocks: str                      # physical | stream | fused | tail
    knob: str
    reason: str
    pred: Callable[[RouteInputs], bool] = field(repr=False, default=None)


RULES: Tuple[Rule, ...] = (
    Rule("non_u8_bins", "physical", "max_bin",
         "bins are wider than uint8 (max_bin > 256); the partition "
         "kernel's bf16 extract matmuls would round bin ids",
         lambda i: not i.bins_u8),
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
    Rule("fused_smem", "fused", "max_bin",
         "one block's shared histogram and row staging exceed the card's "
         "227 KB of shared memory (fused_split.fused_supported)",
         lambda i: not i.fused_ok),
    Rule("tail_env_xla", "tail", "LGBM_TPU_APPLY_IMPL",
         "the one-kernel split tail disabled by LGBM_TPU_APPLY_IMPL=xla",
         lambda i: i.apply_impl_env == "xla"),
    Rule("tail_smem", "tail", "max_bin",
         "both children's histograms exceed one block's shared memory "
         "(apply_find.apply_find_supported)",
         lambda i: not i.tail_ok),
)


@dataclass(frozen=True)
class RouteDecision:
    stream: bool
    fused: bool
    tail: str                        # kernel | xla
    reasons: Tuple[str, ...] = ()    # the rules that blocked a faster part
    physical: bool = True

    @property
    def path(self) -> str:
        if not self.physical:
            return "row_order"
        return "stream" if self.stream else "physical"

    def describe(self) -> str:
        why = f" ({', '.join(self.reasons)})" if self.reasons else ""
        return (f"path={self.path} fused={int(self.fused)} "
                f"tail={self.tail}{why}")


def inputs_from_env(environ=None, **kw) -> RouteInputs:
    """RouteInputs with the four knobs read through ``env_knob``."""
    return RouteInputs(
        phys_env=env_knob("LGBM_TPU_PHYS", environ),
        stream_env=env_knob("LGBM_TPU_STREAM", environ),
        fused_env=env_knob("LGBM_TPU_FUSED", environ),
        apply_impl_env=env_knob("LGBM_TPU_APPLY_IMPL", environ), **kw)


def decide(i: RouteInputs) -> RouteDecision:
    """Evaluate the rule table; pure.  Off the physical path the stream
    and fused rules are not read."""
    blocked = {k: [r.name for r in RULES if r.blocks == k and r.pred(i)]
               for k in ("physical", "stream", "fused", "tail")}
    physical = not blocked["physical"]
    if not physical:
        blocked["stream"] = blocked["fused"] = []
    return RouteDecision(
        stream=physical and not blocked["stream"],
        fused=physical and not blocked["fused"],
        tail="xla" if blocked["tail"] else "kernel",
        reasons=tuple(blocked["physical"] + blocked["stream"]
                      + blocked["fused"] + blocked["tail"]),
        physical=physical)
