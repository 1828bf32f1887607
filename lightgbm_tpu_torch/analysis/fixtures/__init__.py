"""Red-team fixtures of the port's analyzer: one seeded violation per pass.

The counterpart of ``lightgbm_tpu/analysis/fixtures``.  Each fixture
injects a deliberately broken artifact into a normal run (``--fixture
NAME`` on the CLI, ``fixtures=[...]`` through ``run_analysis``), and the
run must then report that fixture's code; fixture findings are never
allowlisted.

The kernel fixtures register the kernels of ``csrc/analysis_fixtures.cu``
at a seeded geometry that breaks the port's rule the way the JAX
fixture's kernel breaks the TPU's (the legal geometries are in
``entries.py``; a seeded geometry is never launched):

=================  ================================  =====================
fixture            seeded                            code
=================  ================================  =====================
bad_lane           F1, (256, 14) f32 rows of 56 B    ALIGN_ROW_STRIDE
bad_vmem           F2, 8192 x 4096 f32 accumulator   SMEM_OVER_BUDGET
bad_cat            F3, (256, 8 + 7) i32 bitset rows  ALIGN_ROW_STRIDE
bad_serve_kernel   F4, (64, 63) i32 node lines       ALIGN_ROW_STRIDE
bad_mc_batch       F5, (4, 16, 63) f32 class slices  ALIGN_ROW_STRIDE
                   and a serial-K multiclass cell    ROUTING_UNJUSTIFIED_...
bad_host           F6, ``bad_host_wrapper.py``       HOST_PULL_IN_WRAPPER
bad_async          ``bad_async.cu``                  ASYNC_* (all three)
bad_purity         a knob that leaks                 PURITY_DIVERGES
bad_route          row_order with no rule            ROUTING_UNJUSTIFIED_...
efb_overwide       efb_overwide without ew=1         ROUTING_EFB_OVERWIDE_...
=================  ================================  =====================

``bad_async.cu`` and ``bad_host_wrapper.py`` are parsed only: never
built, never imported.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

from ..astutil import PyModule
from ..entries import smem_acc_entry, stage_copy_entry
from ..registry import KernelEntry

_DIR = Path(__file__).resolve().parent

# (name, dtype, classes, rows, cols, copied rows, JAX fixture): the
# seeded twin of entries.FIXTURE_STAGE_LEGAL
STAGE_SEEDED = {
    # 14 f32: a pack=1 row's 56 bytes (28 u8 bins + 7 f32) without
    # RecPtr's pad to 64
    "bad_lane": ("fixture_bad_lane", "float32", 1, 256, 14, 8,
                 "__init__.py:77"),
    # SEL_MEMBER + 7 bitset words (200 bins), not rounded to 4 words
    "bad_cat": ("fixture_bad_cat", "int32", 1, 256, 15, 8,
                "__init__.py:280"),
    # the 63 inner nodes of a 64-leaf tree at their true count
    "bad_serve_kernel": ("fixture_bad_serve_kernel", "int32", 1, 64, 63, 64,
                         "__init__.py:326"),
    # 63 bins a class at their true count
    "bad_mc_batch": ("fixture_bad_mc_batch", "float32", 4, 16, 63, 16,
                     "__init__.py:393"),
}
# 8192 x 4096 f32: the JAX fixture's resident VMEM scratch, as dynamic
# shared memory
SMEM_ACC_SEEDED = 8192 * 4096 * 4


@dataclass
class FixtureBundle:
    entries: List[KernelEntry] = field(default_factory=list)
    pins: Dict[str, object] = field(default_factory=dict)
    cuda_files: List[Path] = field(default_factory=list)
    py_modules: List[PyModule] = field(default_factory=list)
    routing_cells: List[tuple] = field(default_factory=list)


def load(name: str) -> FixtureBundle:
    """The named fixture bundle (see ``FIXTURES``)."""
    try:
        maker = FIXTURES[name]
    except KeyError:
        raise ValueError(
            f"unknown fixture {name!r}; known: {sorted(FIXTURES)}")
    return maker()


def _stage(name: str) -> FixtureBundle:
    return FixtureBundle(entries=[stage_copy_entry(*STAGE_SEEDED[name],
                                                   fixture=True)])


def _bad_vmem() -> FixtureBundle:
    return FixtureBundle(entries=[smem_acc_entry(
        "fixture_bad_vmem", SMEM_ACC_SEEDED, fixture=True)])


def _bad_host() -> FixtureBundle:
    return FixtureBundle(py_modules=[
        PyModule(_DIR / "bad_host_wrapper.py", "wrappers")])


def _bad_async() -> FixtureBundle:
    return FixtureBundle(cuda_files=[_DIR / "bad_async.cu"])


def _bad_purity() -> FixtureBundle:
    def variants():
        import numpy as np
        import torch
        x = torch.from_numpy(
            np.random.default_rng(0).normal(size=(8, 128)).astype(
                np.float32))

        def off():
            return x * 2.0

        def leaky_off():
            return x * 2.0 + 0.0 * torch.sum(x)   # the leak

        return [("off", off), ("knob-off-leaky", leaky_off)]

    return FixtureBundle(pins={"fixture-bad-purity": variants})


# the JAX package's injected cells, verbatim (fixtures/__init__.py
# _bad_route, _efb_overwide, _bad_mc_batch): keys the port cannot produce
_BAD_ROUTE = (
    "learner=serial;shards=1;be=tpu;efb=0;u8=1;over=0;wide=0;"
    "fdiv=1;dp=0;cegb=0;cat=0;bag=0;lin=0;boost=gbdt;"
    "obj=binary;k=1;forced=0;mono=0;cegbc=0;phys=auto;"
    "stream=auto;pack=1;part=permute;impl=ss;fused=1;scat=1;"
    "ob=0;pg=auto;fixture=bad_route",
    "path=row_order;pack=1;scheme=none;fused=0;merge=none;"
    "paged=0;why=-;pack_why=-;merge_why=-;paged_why=-;"
    "prog=row_order|pack1|none|fused0|serial|shards1|none|"
    "dp0|cegb0|cat0|efb0|u81|paged0")
_EFB_OVERWIDE = (
    "learner=serial;shards=1;be=tpu;efb=1;u8=1;over=0;wide=0;"
    "ew=0;fdiv=1;dp=0;cegb=0;cat=0;bag=0;lin=0;boost=gbdt;"
    "obj=binary;k=1;forced=0;mono=0;cegbc=0;phys=auto;"
    "stream=auto;pack=1;part=permute;impl=ss;fused=1;scat=1;"
    "ob=0;pg=auto;fixture=efb_overwide",
    "path=row_order;pack=1;scheme=none;fused=0;merge=none;"
    "paged=0;why=efb_overwide;pack_why=-;merge_why=-;"
    "paged_why=-;"
    "prog=row_order|pack1|none|fused0|serial|shards1|none|"
    "dp0|cegb0|cat0|efb1|u81|paged0")
_MC_BATCH = (
    "learner=serial;shards=1;be=tpu;efb=0;u8=1;over=0;wide=0;"
    "ew=0;fdiv=1;dp=0;cegb=0;cat=0;bag=0;lin=0;boost=gbdt;"
    "obj=other;k=multi;forced=0;mono=0;cegbc=0;phys=auto;"
    "stream=auto;pack=1;part=permute;impl=ss;fused=1;scat=1;"
    "ob=0;pg=auto;mcb=auto;fixture=bad_mc_batch",
    "path=physical;pack=1;scheme=permute;fused=1;merge=none;"
    "paged=0;mcb=0;why=-;pack_why=-;merge_why=-;paged_why=-;"
    "mcb_why=-;"
    "prog=physical|pack1|permute|fused1|serial|shards1|none|"
    "dp0|cegb0|cat0|efb0|u81|paged0|mcb0")


def _bad_mc_batch() -> FixtureBundle:
    bundle = _stage("bad_mc_batch")
    bundle.routing_cells.append(_MC_BATCH)
    return bundle


FIXTURES = {
    "bad_lane": lambda: _stage("bad_lane"),
    "bad_vmem": _bad_vmem,
    "bad_cat": lambda: _stage("bad_cat"),
    "bad_serve_kernel": lambda: _stage("bad_serve_kernel"),
    "bad_mc_batch": _bad_mc_batch,
    "bad_host": _bad_host,
    "bad_async": _bad_async,
    "bad_purity": _bad_purity,
    "bad_route": lambda: FixtureBundle(routing_cells=[_BAD_ROUTE]),
    "efb_overwide": lambda: FixtureBundle(routing_cells=[_EFB_OVERWIDE]),
}

# the codes each fixture must give, and only those
EXPECTED = {
    "bad_lane": {"ALIGN_ROW_STRIDE"},
    "bad_vmem": {"SMEM_OVER_BUDGET"},
    "bad_cat": {"ALIGN_ROW_STRIDE"},
    "bad_serve_kernel": {"ALIGN_ROW_STRIDE"},
    "bad_mc_batch": {"ALIGN_ROW_STRIDE", "ROUTING_UNJUSTIFIED_FALLBACK"},
    "bad_host": {"HOST_PULL_IN_WRAPPER"},
    "bad_async": {"ASYNC_UNPAIRED_COMMIT", "ASYNC_READ_BEFORE_WAIT",
                  "ASYNC_NEVER_COMMITTED"},
    "bad_purity": {"PURITY_DIVERGES"},
    "bad_route": {"ROUTING_UNJUSTIFIED_FALLBACK"},
    "efb_overwide": {"ROUTING_EFB_OVERWIDE_UNJUSTIFIED"},
}
