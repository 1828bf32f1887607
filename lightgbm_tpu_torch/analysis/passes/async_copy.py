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

Rules: a kernel that commits must wait (``ASYNC_UNPAIRED_COMMIT``); a
statement that names a started copy's destination before the next wait
reads it in flight (``ASYNC_READ_BEFORE_WAIT``); a copy started after the
last commit is never committed (``ASYNC_NEVER_COMMITTED``, a warning, as
the JAX pass's ``DMA_NEVER_STARTED``).  The reading is straight-line: a
wait in another branch or iteration counts as a wait.  The port's kernels
start no asynchronous copy today, so the pass is clean on them; the
page-schedule audit of the JAX pass waits for ``ops/paged.py``.
"""
from __future__ import annotations

import re
from typing import List

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


def check_kernel(body: str, body_line: int):
    """[(code, line, detail)] of one kernel body."""
    out = []
    pending = {}                  # destination -> line of its start
    committed = waited = False
    open_start = None             # line of a start after the last commit
    line = body_line
    for stmt in re.split(r"(?<=[;{}])", body):
        start = line + stmt[:len(stmt) - len(stmt.lstrip())].count("\n")
        line += stmt.count("\n")
        if _WAIT.search(stmt):
            waited = True
            pending.clear()
        elif _COMMIT.search(stmt):
            committed = True
            open_start = None
        elif _START.search(stmt):
            dst = destination(stmt)
            if dst:
                pending[dst] = start
            open_start = open_start or start
        else:
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
        for k in cuda_kernels(strip_cuda(path.read_text())):
            for code, line, detail in check_kernel(k.body, k.body_line):
                out.append(Finding(
                    pass_name=PASS_NAME, code=code,
                    severity=(SEV_WARNING if code == "ASYNC_NEVER_COMMITTED"
                              else SEV_ERROR),
                    where=f"{rel}:{k.name}:{line}",
                    message=f"{k.name} {detail}", file=rel, line=line,
                    fixture=rel in ctx.fixture_files))
    return out
