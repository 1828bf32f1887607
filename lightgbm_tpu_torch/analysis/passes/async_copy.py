"""async-copy pass: the asynchronous copy discipline of the CUDA kernels,
the counterpart of the JAX package's DMA pass
(``lightgbm_tpu/analysis/passes/dma.py``), read from source.

Each ``__global__`` function of ``csrc/*.cu`` and ``*.cuh`` (comments and
strings stripped, ``asm`` strings kept: ``astutil.strip_cuda``) is read
statement by statement, in source order:

- a **start** is ``cp.async.ca`` / ``cp.async.cg``, ``cp.async.bulk``,
  ``__pipeline_memcpy_async`` or ``cuda::memcpy_async``; its shared
  destination is the first argument taken by address (the second
  argument of ``cuda::memcpy_async(group, dst, ...)``);
- a **commit** is ``cp.async.commit_group``,
  ``cp.async.bulk.commit_group``, ``__pipeline_commit``, an ``mbarrier``
  arrive or ``producer_commit``;
- a **wait** is ``cp.async.wait_group`` / ``wait_all``,
  ``cp.async.bulk.wait_group``, ``__pipeline_wait_prior``, an
  ``mbarrier`` test / try wait, ``consumer_wait``, ``arrive_and_wait``
  or ``.wait(``.

A statement that calls a ``__device__`` helper of the same file counts
as the starts, commits and waits of the helper's body, in order, helpers
called by helpers followed (``device_helpers``): ``fused_hist`` in
``csrc/fused_split.cu`` starts its ``cp.async`` copies through
``issue_stage`` -> ``copy_bytes`` -> ``cp_async16`` and commits and waits
through ``cp_async_commit`` / ``cp_async_wait``.  A helper's copy lands
in the argument the helper passes on as the destination (the parameter
its ``__cvta_generic_to_shared`` converts), so ``issue_stage(..., ring +
k * sb)`` starts a copy into ``ring``.

Rules: a kernel that commits must wait (``ASYNC_UNPAIRED_COMMIT``); a
statement that names a started copy's destination before the next wait
reads it in flight (``ASYNC_READ_BEFORE_WAIT``); a copy started after the
last commit is never committed (``ASYNC_NEVER_COMMITTED``, a warning, as
the JAX pass's ``DMA_NEVER_STARTED``).  The reading is straight-line and
by name: a wait in another branch or iteration counts as a wait, and a
pointer taken from a destination before its copy starts is not followed
(``fused_hist`` takes its step's ring stage that way before it refills
another stage); the page-schedule audit of the JAX pass waits for
``ops/paged.py``.
"""
from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional, Tuple

from ..astutil import cuda_kernels, rel_path, strip_cuda
from ..findings import Finding, SEV_ERROR, SEV_WARNING

PASS_NAME = "async-copy"

_WAIT = re.compile(
    r"cp\.async\.wait_(?:group|all)|cp\.async\.bulk\.wait_group|"
    r"__pipeline_wait_prior\s*\(|mbarrier\.(?:try|test)_wait|"
    r"consumer_wait\s*\(|arrive_and_wait\s*\(|\.wait\s*\(")
_COMMIT = re.compile(
    r"cp\.async\.(?:bulk\.)?commit_group|__pipeline_commit\s*\(|"
    r"mbarrier\.arrive|producer_commit\s*\(")
_START = re.compile(
    r"cp\.async\.(?:ca|cg)\b|cp\.async\.bulk\.|"
    r"__pipeline_memcpy_async\s*\(|cuda::memcpy_async\s*\(")


def _args(stmt: str, at: int) -> List[str]:
    """The top-level arguments of the call whose '(' follows ``at``."""
    i = stmt.find("(", at)
    depth, cur, out = 0, "", []
    for ch in stmt[i:]:
        if ch in "([":
            depth += 1
            if depth == 1:
                continue
        elif ch in ")]":
            depth -= 1
            if depth == 0:
                out.append(cur)
                break
        elif ch == "," and depth == 1:
            out.append(cur)
            cur = ""
            continue
        cur += ch
    return [a.strip() for a in out]


_CVTA = re.compile(r"__cvta_generic_to_shared\s*\(\s*&?\s*([A-Za-z_]\w*)")
_DEVICE = re.compile(r"__device__\b")
_CALL = re.compile(r"\b([A-Za-z_]\w*)\s*(?:<[^<>;(){}]*>)?\s*\(")
_LEAD = re.compile(r"[&(\s]*([A-Za-z_]\w*)")


class Helper(NamedTuple):
    """A ``__device__`` function's asynchronous-copy events in body
    order: ("start", index of the parameter the copy lands in, or None),
    ("commit", None) or ("wait", None)."""
    params: Tuple[str, ...]
    events: Tuple[Tuple[str, Optional[int]], ...]


def _statements(body: str):
    return re.split(r"(?<=[;{}])", body)


def _leading_name(arg: str) -> str:
    found = _LEAD.match(arg)
    return found.group(1) if found else ""


def events(stmt: str, helpers: Dict[str, Helper]) -> list:
    """[(kind, destination)] of one statement: its own start, commit or
    wait, else those of the helpers it calls, in order."""
    if _WAIT.search(stmt):
        return [("wait", "")]
    if _COMMIT.search(stmt):
        return [("commit", "")]
    if _START.search(stmt):
        return [("start", destination(stmt))]
    out = []
    for m in _CALL.finditer(stmt):
        h = helpers.get(m.group(1))
        if h is None:
            continue
        args = _args(stmt, m.end() - 1)
        for kind, idx in h.events:
            dst = (_leading_name(args[idx])
                   if idx is not None and idx < len(args) else "")
            out.append((kind, dst))
    return out


def device_helpers(stripped: str) -> Dict[str, Helper]:
    """name -> :class:`Helper` of the ``__device__`` functions of a
    stripped source that start, commit or wait for copies, directly or
    through each other."""
    bodies = {}
    for m in _DEVICE.finditer(stripped):
        open_at = stripped.find("{", m.end())
        semi = stripped.find(";", m.end())
        if open_at < 0 or 0 <= semi < open_at:
            continue
        head = stripped[m.end():open_at]
        found = re.search(r"([A-Za-z_]\w*)\s*\(", head)
        if not found or "__global__" in head:
            continue
        params = tuple((re.findall(r"[A-Za-z_]\w*", p.split("=")[0])
                        or [""])[-1]
                       for p in _args(head, found.end() - 1) if p)
        depth, j = 0, open_at
        while j < len(stripped):
            depth += {"{": 1, "}": -1}.get(stripped[j], 0)
            if depth == 0:
                break
            j += 1
        bodies[found.group(1)] = (params, stripped[open_at + 1:j])
    helpers: Dict[str, Helper] = {}
    for _ in range(len(bodies) + 1):        # helpers calling helpers
        changed = False
        for name, (params, body) in bodies.items():
            cvta = _CVTA.search(body)
            evs = []
            for stmt in _statements(body):
                for kind, dst in events(stmt, helpers):
                    if kind == "start" and not dst and cvta:
                        dst = cvta.group(1)
                    ev = (kind, params.index(dst) if dst in params else None)
                    if not evs or evs[-1] != ev:
                        evs.append(ev)
            if evs and (name not in helpers
                        or helpers[name].events != tuple(evs)):
                helpers[name] = Helper(params, tuple(evs))
                changed = True
        if not changed:
            break
    return helpers


def destination(stmt: str) -> str:
    """The shared destination a start statement names, or ''."""
    m = re.search(r"__cvta_generic_to_shared\s*\(\s*&?\s*([A-Za-z_]\w*)",
                  stmt)
    if m:
        return m.group(1)
    m = re.search(r"__pipeline_memcpy_async|cuda::memcpy_async", stmt)
    if not m:
        return ""
    args = _args(stmt, m.end())
    pick = next((a for a in args if a.startswith("&")), None)
    if pick is None and args:
        pick = args[1] if (m.group().startswith("cuda")
                           and len(args) >= 4) else args[0]
    found = re.match(r"&?\s*([A-Za-z_]\w*)", pick or "")
    return found.group(1) if found else ""


def check_kernel(body: str, body_line: int,
                 helpers: Optional[Dict[str, Helper]] = None):
    """[(code, line, detail)] of one kernel body (``helpers``: the
    file's :func:`device_helpers`)."""
    out = []
    pending = {}                  # destination -> line of its start
    committed = waited = False
    open_start = None             # line of a start after the last commit
    line = body_line
    for stmt in _statements(body):
        start = line + stmt[:len(stmt) - len(stmt.lstrip())].count("\n")
        line += stmt.count("\n")
        evs = events(stmt, helpers or {})
        for kind, dst in evs:
            if kind == "wait":
                waited = True
                pending.clear()
            elif kind == "commit":
                committed = True
                open_start = None
            else:
                if dst:
                    pending[dst] = start
                open_start = open_start or start
        if evs:
            continue
        for dst in list(pending):
            if re.search(rf"\b{re.escape(dst)}\b", stmt):
                out.append(("ASYNC_READ_BEFORE_WAIT", start,
                            f"reads {dst!r}, the destination of the "
                            f"copy started at line {pending.pop(dst)}, "
                            f"before any wait"))
    if committed and not waited:
        out.append(("ASYNC_UNPAIRED_COMMIT", body_line,
                    "commits asynchronous copies but never waits for "
                    "them: their data is never known to have landed"))
    if open_start is not None:
        out.append(("ASYNC_NEVER_COMMITTED", open_start,
                    "starts an asynchronous copy after its last commit: "
                    "no wait covers it"))
    return out


def run(ctx) -> List[Finding]:
    out: List[Finding] = []
    for path in ctx.cuda_files:
        rel = rel_path(path)
        stripped = strip_cuda(path.read_text())
        helpers = device_helpers(stripped)
        for k in cuda_kernels(stripped):
            for code, line, detail in check_kernel(k.body, k.body_line,
                                                   helpers):
                out.append(Finding(
                    pass_name=PASS_NAME, code=code,
                    severity=(SEV_WARNING if code == "ASYNC_NEVER_COMMITTED"
                              else SEV_ERROR),
                    where=f"{rel}:{k.name}:{line}",
                    message=f"{k.name} {detail}", file=rel, line=line,
                    fixture=rel in ctx.fixture_files))
    return out
