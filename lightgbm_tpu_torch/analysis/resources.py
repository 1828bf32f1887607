"""The resources ``ptxas`` gave each kernel: registers, static shared
memory, stack, local memory and spills, per kernel symbol.

The counterpart of the JAX analyzer's ``jaxpr_tools.py``: what the passes
read about the compiled program.  Three sources, one record type
(:class:`Usage`):

- ``cuobjdump -res-usage`` of a built library (``build/lib<name>-<hash>.so``),
  which works whether or not this process ran the build
  (:func:`parse_res_usage`, :func:`read_built`);
- the ``-Xptxas -v`` report of a build done in this process
  (``_build.BUILD_LOGS``, :func:`parse_ptxas`), the only one that counts
  spill stores and loads;
- the report checked into the package, ``resources_sm90a.txt``
  (:func:`load_report`), written from a run on the card
  (:func:`format_report`) and keyed by ``_build.library_path``'s content
  hash of each source, so the CPU can read what the card's compiler did.

Symbols are mangled; a template instantiation appears once per
instantiation.  On the card :func:`by_symbol` demangles them with
``cu++filt`` and :func:`normalise` drops the anonymous namespace, the
return type and the parameters: ``hist_comb_partial<CombRows>``; the
checked-in report holds these names, so the CPU never demangles.  On
sm_90 ``cuobjdump``'s ``SHARED`` includes the 1 KB the system reserves in
each block that uses shared memory; :class:`Usage` keeps the kernel's own
static shared memory, as ``ptxas -v`` reports it.
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
from dataclasses import dataclass, fields, replace
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

REPORT_SCHEMA = "lightgbm_tpu_torch/analysis/resources/v1"
DEFAULT_REPORT = Path(__file__).resolve().parent / "resources_sm90a.txt"
ANON = ("(anonymous namespace)::", "<unnamed>::")   # c++filt's, cu++filt's
# shared memory the system reserves in every block that uses shared
# memory on sm_90; cuobjdump's SHARED counts it, ptxas's smem does not
RESERVED_SMEM = 1024


@dataclass(frozen=True)
class Usage:
    """One kernel's resources; ``None`` where the source did not say."""
    regs: int = 0
    smem: int = 0                       # static shared memory, bytes
    stack: int = 0                      # stack frame, bytes a thread
    local: int = 0                      # local memory, bytes a thread
    spill_stores: Optional[int] = None  # bytes a thread (ptxas -v only)
    spill_loads: Optional[int] = None

    @property
    def spills(self) -> Optional[int]:
        if self.spill_stores is None and self.spill_loads is None:
            return None
        return (self.spill_stores or 0) + (self.spill_loads or 0)


# ---------------------------------------------------------------------
# symbol names
# ---------------------------------------------------------------------
def normalise(name: str) -> str:
    """The anonymous namespace dropped, ``(bool)1`` spelled ``true``, and
    for ``cu++filt``'s full spelling the return type and the parameter
    list dropped too."""
    for prefix in ANON:
        name = name.replace(prefix, "")
    name = name.replace("(bool)1", "true").replace("(bool)0", "false")
    depth = 0
    for k, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:k]
            break
    if name.startswith("void "):
        name = name[5:]
    return name.replace(" >", ">").strip()


def cuda_tool(name: str) -> Optional[str]:
    """Path of a CUDA toolkit program (PATH, then CUDA_HOME or
    /usr/local/cuda), or None."""
    found = shutil.which(name)
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name
    return str(cand) if cand.exists() else None


def demangle_with_filt(names: Iterable[str]) -> Dict[str, str]:
    """``cu++filt``'s demangling of ``names``.  Raises when the program
    is not installed: only the card demangles."""
    names = sorted(set(names))
    tool = cuda_tool("cu++filt")
    if tool is None:
        raise FileNotFoundError("cu++filt not found (PATH, CUDA_HOME/bin, "
                                "/usr/local/cuda/bin)")
    if not names:
        return {}
    out = subprocess.run([tool], input="\n".join(names) + "\n",
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.splitlines()
    return dict(zip(names, out))


# ---------------------------------------------------------------------
# parsers
# ---------------------------------------------------------------------
_RES_FUNC = re.compile(r"^\s*Function\s+(\S+?):?\s*$")
_RES_FIELD = re.compile(r"\b(REG|STACK|SHARED|LOCAL):(\d+)")


def parse_res_usage(text: str) -> Dict[str, Usage]:
    """``cuobjdump -res-usage`` output: mangled symbol -> Usage (spills
    unknown; ``SHARED`` less the ``RESERVED_SMEM`` it includes)."""
    out: Dict[str, Usage] = {}
    current = None
    for line in text.splitlines():
        m = _RES_FUNC.match(line)
        if m:
            current = m.group(1)
            continue
        vals = dict(_RES_FIELD.findall(line))
        if current and "REG" in vals:
            out[current] = Usage(regs=int(vals["REG"]),
                                 smem=max(int(vals.get("SHARED", 0))
                                          - RESERVED_SMEM, 0),
                                 stack=int(vals.get("STACK", 0)),
                                 local=int(vals.get("LOCAL", 0)))
            current = None
    return out


_PTX_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTX_PROPS = re.compile(r"Function properties for (\S+)")
_PTX_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                        r"stores, (\d+) bytes spill loads")
_PTX_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def parse_ptxas(text: str) -> Dict[str, Usage]:
    """``ptxas -v`` output: mangled entry symbol -> Usage."""
    out: Dict[str, Usage] = {}
    entry = props = None
    for line in text.splitlines():
        m = _PTX_ENTRY.search(line)
        if m:
            entry = props = m.group(1)
            out.setdefault(entry, Usage())
            continue
        m = _PTX_PROPS.search(line)
        if m:
            props = m.group(1)
            continue
        m = _PTX_FRAME.search(line)
        if m and props in out:
            stack, st, ld = (int(v) for v in m.groups())
            out[props] = replace(out[props], stack=stack, spill_stores=st,
                                 spill_loads=ld)
            continue
        m = _PTX_USED.search(line)
        if m and entry in out:
            out[entry] = replace(out[entry], regs=int(m.group(1)),
                                 smem=int(m.group(2) or 0))
    return out


def by_symbol(usages: Dict[str, Usage]) -> Dict[str, Usage]:
    """Mangled -> Usage re-keyed by the normalised ``cu++filt`` name (one
    library is one translation unit: its symbols stay distinct)."""
    names = demangle_with_filt(usages)
    return {normalise(names[m]): u for m, u in usages.items()}


# ---------------------------------------------------------------------
# per-source reports
# ---------------------------------------------------------------------
@dataclass
class SourceUsage:
    """The kernels of one ``csrc/<source>.cu`` build."""
    source: str
    digest: str                      # library_path's 12-hex content hash
    kernels: Dict[str, Usage]        # normalised symbol -> Usage


def library_digest(source: str) -> str:
    from ..ops import _build
    return _build.library_path(source).stem.rsplit("-", 1)[1]


def res_usage_text(source: str) -> str:
    """``cuobjdump -res-usage`` of the built library of ``source``.
    Raises when the library or ``cuobjdump`` is missing: nothing is
    built here."""
    from ..ops import _build
    tool = cuda_tool("cuobjdump")
    if tool is None:
        raise FileNotFoundError("cuobjdump not found (PATH, CUDA_HOME/bin, "
                                "/usr/local/cuda/bin)")
    path = _build.library_path(source)
    if not path.exists():
        raise FileNotFoundError(f"{path} is not built")
    return subprocess.run([tool, "-res-usage", str(path)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout


def read_built(sources: Iterable[str] = None) -> Dict[str, SourceUsage]:
    """Resources of the built libraries of ``sources`` (default: every
    source), from ``cuobjdump -res-usage``, with the spills of the
    ``ptxas -v`` report where this process built the library."""
    from ..ops import _build
    out: Dict[str, SourceUsage] = {}
    for name in sources or _build.SOURCES:
        usages = parse_res_usage(res_usage_text(name))
        spills = parse_ptxas(_build.BUILD_LOGS.get(name, ""))
        for sym, u in spills.items():
            if sym in usages:
                usages[sym] = replace(usages[sym],
                                      spill_stores=u.spill_stores,
                                      spill_loads=u.spill_loads)
        out[name] = SourceUsage(name, library_digest(name),
                                by_symbol(usages))
    return out


def format_report(report: Dict[str, SourceUsage], header: str = "") -> str:
    """The text of ``resources_sm90a.txt``: one ``source`` line (name and
    content hash) and one tab-separated ``kernel`` line per symbol."""
    lines = [f"# {REPORT_SCHEMA}: registers and shared memory per kernel, "
             "sm_90a",
             "# written on the card by chip_smoke.py"]
    lines += [f"# {h}" for h in header.splitlines() if h]
    for name in sorted(report):
        su = report[name]
        lines.append(f"source\t{name}\t{su.digest}")
        for sym in sorted(su.kernels):
            u = su.kernels[sym]
            vals = " ".join(
                f"{f.name}={'-' if v is None else v}"
                for f in fields(Usage) for v in [getattr(u, f.name)])
            lines.append(f"kernel\t{name}\t{sym}\t{vals}")
    return "\n".join(lines) + "\n"


def parse_report(text: str) -> Dict[str, SourceUsage]:
    """Inverse of :func:`format_report`."""
    out: Dict[str, SourceUsage] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.split("\t")
        if parts[0] == "source":
            out[parts[1]] = SourceUsage(parts[1], parts[2], {})
        elif parts[0] == "kernel":
            vals = dict(kv.split("=") for kv in parts[3].split())
            out[parts[1]].kernels[parts[2]] = Usage(**{
                k: None if v == "-" else int(v) for k, v in vals.items()})
        else:
            raise ValueError(f"unreadable resource report line {line!r}")
    return out


def load_report(path=None) -> Dict[str, SourceUsage]:
    with open(path or DEFAULT_REPORT) as fh:
        return parse_report(fh.read())


def stale_sources(report: Dict[str, SourceUsage],
                  sources: Iterable[str] = None) -> Tuple[list, list]:
    """(sources whose hash differs from the tree's, sources missing from
    the report)."""
    from ..ops import _build
    stale, missing = [], []
    for name in sources or _build.SOURCES:
        if name not in report:
            missing.append(name)
        elif report[name].digest != library_digest(name):
            stale.append(name)
    return stale, missing
