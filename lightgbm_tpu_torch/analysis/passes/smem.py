"""smem pass: shared memory and registers against the card's budget, the
counterpart of the JAX package's VMEM budget
(``lightgbm_tpu/analysis/passes/vmem.py``).

For each registered entry, with the resources ``ptxas`` gave its symbol
(``ctx.resources``, see ``resources.py``):

- static plus dynamic shared memory must be at most ``MAX_SMEM`` =
  232,448 bytes a block (``SMEM_OVER_BUDGET``), with a warning above
  ``WARN_FRACTION`` of it (``SMEM_NEAR_BUDGET``);
- dynamic shared memory above 48 KB needs a ``cudaFuncSetAttribute``
  opt-in on that kernel in its source, or the launch is refused
  (``SMEM_OPTIN_MISSING``);
- registers x threads per block must be at most 65,536
  (``REGS_OVER_BUDGET``); spills are a warning (``REGS_SPILL``);
- where the library exports its own shared-memory formula and is built
  (on the card), the wrapper's Python formula must give the same bytes
  (``SMEM_FORMULA_DIVERGES``);
- a cluster launch (``KernelEntry.cluster``) may hold at most
  ``MAX_CLUSTER`` = 16 blocks (``CLUSTER_OVER_LIMIT``); above
  ``PORTABLE_CLUSTER`` = 8 the kernel needs a ``cudaFuncSetAttribute(...,
  cudaFuncAttributeNonPortableClusterSizeAllowed, 1)`` in its source, or
  the launch is refused (``CLUSTER_OPTIN_MISSING``); a registered grid
  must be whole clusters (``CLUSTER_GRID``).  Each block of a cluster
  keeps the one-block budget above.

A report whose content hash no longer matches a source gives
``RESOURCES_STALE`` (a warning from the checked-in report off the card,
an error on the card), a source missing from it ``RESOURCES_MISSING``
and an entry whose symbol it lacks ``RESOURCES_NO_SYMBOL``.
"""
from __future__ import annotations

import ctypes
import re
from typing import Dict, List

from ..astutil import PACKAGE, strip_cuda
from ..findings import Finding, SEV_ERROR, SEV_WARNING
from ..resources import Usage, stale_sources

PASS_NAME = "smem"

MAX_SMEM = 232448            # one block's shared memory on the H100
DEFAULT_SMEM = 48 * 1024     # dynamic shared memory without an opt-in
MAX_REGS = 65536             # 32-bit registers of one SM
WARN_FRACTION = 0.8          # as vmem.WARN_FRACTION
MAX_CLUSTER = 16             # blocks of a non-portable cluster
PORTABLE_CLUSTER = 8

_OPTIN = re.compile(r"cudaFuncSetAttribute\s*\(\s*([A-Za-z_][\w:]*)")
_CLUSTER_OPTIN = re.compile(
    r"cudaFuncSetAttribute\s*\(\s*([A-Za-z_][\w:]*)[^;]*?"
    r"cudaFuncAttributeNonPortableClusterSizeAllowed")


def base_name(symbol: str) -> str:
    """``ns::kernel<args>`` -> ``kernel``."""
    return symbol.split("<", 1)[0].rsplit("::", 1)[-1]


_INCLUDE = re.compile(r'#\s*include\s*"([\w.]+)"')


def source_text(name: str, seen=None) -> str:
    """``csrc/<name>`` with the package headers it includes, the headers
    they include, each once."""
    seen = set() if seen is None else seen
    seen.add(name)
    text = (PACKAGE / "csrc" / name).read_text()
    return text + "".join(source_text(h, seen)
                          for h in _INCLUDE.findall(text)
                          if h not in seen and (PACKAGE / "csrc" / h).exists())


def opted_in(source: str, pattern=_OPTIN) -> set:
    """Kernel names a ``cudaFuncSetAttribute`` call names in
    ``csrc/<source>.cu`` and the headers it includes (with
    ``_CLUSTER_OPTIN``: a call that allows a non-portable cluster)."""
    text = strip_cuda(source_text(f"{source}.cu"))
    return {m.rsplit("::", 1)[-1].split("<", 1)[0]
            for m in pattern.findall(text)}


def _cluster_findings(e, where: str, cluster_optins: Dict[str, set]
                      ) -> List[Finding]:
    out: List[Finding] = []
    n = e.cluster
    if n is None:
        return out
    if not 1 <= n <= MAX_CLUSTER:
        out.append(Finding(
            pass_name=PASS_NAME, code="CLUSTER_OVER_LIMIT",
            severity=SEV_ERROR, where=where,
            message=(f"a cluster of {n} blocks: the card schedules 1 to "
                     f"{MAX_CLUSTER} blocks a cluster; the launch is "
                     f"refused"),
            entry=e.name, fixture=e.fixture))
    elif n > PORTABLE_CLUSTER:
        if e.source not in cluster_optins:
            cluster_optins[e.source] = opted_in(e.source, _CLUSTER_OPTIN)
        if base_name(e.symbol) not in cluster_optins[e.source]:
            out.append(Finding(
                pass_name=PASS_NAME, code="CLUSTER_OPTIN_MISSING",
                severity=SEV_ERROR, where=where,
                message=(f"a cluster of {n} blocks is above the portable "
                         f"{PORTABLE_CLUSTER}, and csrc/{e.source}.cu "
                         f"sets no cudaFuncAttributeNonPortableCluster"
                         f"SizeAllowed on {base_name(e.symbol)}: the "
                         f"launch is refused"),
                entry=e.name, fixture=e.fixture))
    if e.grid is not None and n >= 1 and e.grid[0] % n:
        out.append(Finding(
            pass_name=PASS_NAME, code="CLUSTER_GRID",
            severity=SEV_ERROR, where=where,
            message=(f"a grid of {e.grid[0]} blocks is not whole clusters "
                     f"of {n}: the launch is refused"),
            entry=e.name, fixture=e.fixture))
    return out


def library_export(source: str, export: str, args) -> int:
    """The built library's own formula, without building anything."""
    from ...ops import _build
    lib = ctypes.CDLL(str(_build.library_path(source)))
    fn = getattr(lib, export)
    fn.argtypes = [ctypes.c_int] * len(args)
    fn.restype = ctypes.c_int
    return int(fn(*args))


def _resource_findings(ctx) -> List[Finding]:
    out: List[Finding] = []
    if ctx.resources_fresh:
        return out
    stale, missing = stale_sources(ctx.resources)
    sev = SEV_ERROR if ctx.on_card else SEV_WARNING
    for name in stale:
        out.append(Finding(
            pass_name=PASS_NAME, code="RESOURCES_STALE", severity=sev,
            where=f"resources:{name}",
            message=(f"{ctx.resources_origin} was written for another "
                     f"csrc/{name}.cu (content hash "
                     f"{ctx.resources[name].digest}): registers and shared "
                     f"memory are those of the old source; regenerate the "
                     f"report on the card")))
    for name in missing:
        out.append(Finding(
            pass_name=PASS_NAME, code="RESOURCES_MISSING", severity=sev,
            where=f"resources:{name}",
            message=f"{ctx.resources_origin} has no csrc/{name}.cu"))
    return out


def run(ctx) -> List[Finding]:
    out = _resource_findings(ctx)
    optins: Dict[str, set] = {}
    cluster_optins: Dict[str, set] = {}
    for e in ctx.entries:
        where = f"entry:{e.name} kernel:{e.symbol}"
        out += _cluster_findings(e, where, cluster_optins)
        su = ctx.resources.get(e.source)
        u = su.kernels.get(e.symbol) if su else None
        if u is None:
            if su is not None:
                out.append(Finding(
                    pass_name=PASS_NAME, code="RESOURCES_NO_SYMBOL",
                    severity=SEV_ERROR, where=where,
                    message=(f"no kernel {e.symbol!r} in the resources of "
                             f"csrc/{e.source}.cu: the entry names a "
                             f"symbol the build does not have"),
                    entry=e.name, fixture=e.fixture))
            u = Usage()
        total = u.smem + e.dyn_smem
        if total > MAX_SMEM:
            out.append(Finding(
                pass_name=PASS_NAME, code="SMEM_OVER_BUDGET",
                severity=SEV_ERROR, where=where,
                message=(f"{u.smem} B static + {e.dyn_smem} B dynamic "
                         f"shared memory = {total} B exceeds one block's "
                         f"{MAX_SMEM} B: the launch is refused"),
                entry=e.name, fixture=e.fixture))
        elif total > WARN_FRACTION * MAX_SMEM:
            out.append(Finding(
                pass_name=PASS_NAME, code="SMEM_NEAR_BUDGET",
                severity=SEV_WARNING, where=where,
                message=(f"{total} B of shared memory is within "
                         f"{100 - int(WARN_FRACTION * 100)} % of one "
                         f"block's {MAX_SMEM} B"),
                entry=e.name, fixture=e.fixture))
        if e.dyn_smem > DEFAULT_SMEM:
            if e.source not in optins:
                optins[e.source] = opted_in(e.source)
            if base_name(e.symbol) not in optins[e.source]:
                out.append(Finding(
                    pass_name=PASS_NAME, code="SMEM_OPTIN_MISSING",
                    severity=SEV_ERROR, where=where,
                    message=(f"{e.dyn_smem} B of dynamic shared memory is "
                             f"above the {DEFAULT_SMEM} B default, and "
                             f"csrc/{e.source}.cu calls no "
                             f"cudaFuncSetAttribute on "
                             f"{base_name(e.symbol)}: the launch is "
                             f"refused"),
                    entry=e.name, fixture=e.fixture))
        if u.regs * e.threads > MAX_REGS:
            out.append(Finding(
                pass_name=PASS_NAME, code="REGS_OVER_BUDGET",
                severity=SEV_ERROR, where=where,
                message=(f"{u.regs} registers x {e.threads} threads = "
                         f"{u.regs * e.threads} exceeds the SM's "
                         f"{MAX_REGS}: the launch is refused"),
                entry=e.name, fixture=e.fixture))
        if u.spills:
            out.append(Finding(
                pass_name=PASS_NAME, code="REGS_SPILL",
                severity=SEV_WARNING, where=where,
                message=(f"ptxas spills {u.spill_stores} B stores and "
                         f"{u.spill_loads} B loads a thread to local "
                         f"memory"),
                entry=e.name, fixture=e.fixture))
        if ctx.resources_fresh and e.export:
            export, args = e.export
            lib_bytes = library_export(e.source, export, args)
            if lib_bytes != e.dyn_smem:
                out.append(Finding(
                    pass_name=PASS_NAME, code="SMEM_FORMULA_DIVERGES",
                    severity=SEV_ERROR, where=where,
                    message=(f"the wrapper's formula gives {e.dyn_smem} B "
                             f"but the library's {export}{tuple(args)} "
                             f"gives {lib_bytes} B"),
                    entry=e.name, fixture=e.fixture))
    return out
