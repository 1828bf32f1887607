"""Analyzer orchestration: build the context (registered entries, sources,
resources and injected fixtures), run the passes, apply the allowlist.

``run_analysis`` is the in-process API (the tests and ``chip_smoke.py``
drive it); ``__main__`` wraps it as the CLI.  Nothing here builds or
launches a kernel: the resources come from the checked-in report, a
report file, or ``cuobjdump`` of libraries already built.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from . import allowlist as allowlist_mod
from . import registry
from .astutil import PyModule, default_cuda_files, default_python_modules
from .astutil import rel_path
from .findings import Finding, Report, SEV_WARNING
from .resources import DEFAULT_REPORT, SourceUsage, load_report, read_built

PASS_NAMES = ("align", "smem", "async-copy", "host", "purity", "routing")
BUILT = "built"          # --resources built: cuobjdump of the built libraries


@dataclass
class Context:
    """Everything a pass sees."""
    entries: List[registry.KernelEntry] = field(default_factory=list)
    resources: Dict[str, SourceUsage] = field(default_factory=dict)
    resources_origin: str = ""
    # read from the built libraries: no staleness, and the wrappers'
    # formulas are held against the libraries' exports
    resources_fresh: bool = False
    on_card: bool = False
    cuda_files: List[Path] = field(default_factory=list)
    py_modules: List[PyModule] = field(default_factory=list)
    fixture_files: set = field(default_factory=set)   # rel paths
    fixture_pins: dict = field(default_factory=dict)
    routing_cells: List[tuple] = field(default_factory=list)
    routing_matrix_path: Optional[str] = None


def _on_card() -> bool:
    import torch
    return torch.cuda.is_available()


def build_context(fixtures=(), resources=None,
                  routing_matrix_path: str = None) -> Context:
    from . import fixtures as fixtures_mod
    ctx = Context(entries=list(registry.collect().values()),
                  cuda_files=default_cuda_files(),
                  py_modules=default_python_modules(),
                  routing_matrix_path=routing_matrix_path,
                  on_card=_on_card())
    if resources == BUILT:
        ctx.resources = read_built()
        ctx.resources_origin = "the built libraries"
        ctx.resources_fresh = True
    else:
        path = resources or DEFAULT_REPORT
        ctx.resources_origin = rel_path(path)
        try:
            ctx.resources = load_report(path)
        except FileNotFoundError:
            if resources:
                raise ValueError(f"resource report {path} not found")
    for name in fixtures:
        bundle = fixtures_mod.load(name)
        ctx.entries += bundle.entries
        ctx.fixture_pins.update(bundle.pins)
        ctx.routing_cells += bundle.routing_cells
        ctx.cuda_files += bundle.cuda_files
        ctx.py_modules += bundle.py_modules
        ctx.fixture_files |= {rel_path(p) for p in bundle.cuda_files}
        ctx.fixture_files |= {m.rel for m in bundle.py_modules}
    return ctx


def run_analysis(passes=None, fixtures=(), allowlist_path: str = None,
                 strict: bool = False, resources=None,
                 routing_matrix_path: str = None) -> Report:
    """Run ``passes`` (default: all) over the registered entries and the
    sources, with ``fixtures`` injected.  ``resources``: None for the
    checked-in report, a report path, or ``"built"``."""
    from .passes import PASSES
    names = list(passes or PASS_NAMES)
    unknown = [p for p in names if p not in PASSES]
    if unknown:
        raise ValueError(f"unknown pass(es) {unknown}; known: "
                         f"{sorted(PASSES)}")
    allow = allowlist_mod.load(allowlist_path)
    ctx = build_context(fixtures=fixtures, resources=resources,
                        routing_matrix_path=routing_matrix_path)
    report = Report(strict=strict, passes=names,
                    entries=[e.name for e in ctx.entries])
    for name in names:
        report.findings.extend(PASSES[name].run(ctx))
    unused = allowlist_mod.apply(report.findings, allow)
    if passes is None:      # a subset of passes leaves entries unused
        for e in unused:
            report.findings.append(Finding(
                pass_name="allowlist", code="ALLOWLIST_UNUSED",
                severity=SEV_WARNING,
                where=f"{e.pass_name}:{e.code}:{e.match}",
                message=(f"allowlist entry matches no finding any more "
                         f"(justification: {e.justification!r}): remove "
                         f"it")))
    return report
