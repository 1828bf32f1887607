"""routing pass: the routing-matrix audit, the matrix half of the JAX
package's routing pass (``lightgbm_tpu/analysis/passes/routing.py``).

- A fresh enumeration of the port's lattice
  (``ops/routing.enumerate_matrix``) must equal the checked-in golden
  (``analysis/routing_matrix.json``) byte for byte: a silent routing
  change is ``ROUTING_MATRIX_STALE``.  Regenerate with
  ``python -m lightgbm_tpu_torch.ops.routing``.
- Every checked-in cell, and every cell a fixture injects, is audited as
  the JAX pass audits its golden: a ``row_order`` cell must name a rule
  (``ROUTING_UNJUSTIFIED_FALLBACK``); ``efb_overwide`` may only justify a
  cell whose key carries the over-wide fact ``ew=1``
  (``ROUTING_EFB_OVERWIDE_UNJUSTIFIED``); a multiclass cell (``k=multi``)
  on the physical path that trains its classes serially (``mcb=0``) must
  name an ``mc_batch`` rule (``ROUTING_UNJUSTIFIED_FALLBACK``).  The
  injected cells may carry keys and fields the port cannot produce yet
  (EFB, batched multiclass): the audit reads them all the same.

The recompile and retrace audit has nothing to audit in eager PyTorch; its
counterpart comes with per-tree CUDA graphs (ROADMAP A4), where a
re-capture per shape bucket is what it would pin.
"""
from __future__ import annotations

import json
import os
from typing import List

from ..findings import Finding, SEV_ERROR

PASS_NAME = "routing"


def _finding(code: str, where: str, message: str, fixture=False):
    return Finding(pass_name=PASS_NAME, code=code, severity=SEV_ERROR,
                   where=where, message=message, fixture=fixture)


def audit_cell(key: str, enc: str, fixture: bool = False) -> List[Finding]:
    from ...ops.routing import decode_cell
    where = f"cell:{key}"
    try:
        c = decode_cell(enc)
    except ValueError as e:
        return [_finding("ROUTING_CELL_UNPARSEABLE", where,
                         f"cell does not parse: {e}", fixture)]
    kf = dict(p.partition("=")[::2] for p in key.split(";"))
    out = []
    if c["path"] == "row_order" and not c.get("why"):
        out.append(_finding(
            "ROUTING_UNJUSTIFIED_FALLBACK", where,
            "cell sends a config to the row_order path with no named "
            "fallback rule: a routing regression or a mutated golden",
            fixture))
    if "efb_overwide" in c.get("why", []) and kf.get("ew") != "1":
        out.append(_finding(
            "ROUTING_EFB_OVERWIDE_UNJUSTIFIED", where,
            "cell blames efb_overwide for a fallback but its key says the "
            "unbundled layout fits (ew=0): bundled configs that fit must "
            "keep the physical path", fixture))
    if (kf.get("k") == "multi" and c["path"] == "physical"
            and c.get("mcb") == "0" and not c.get("mcb_why")):
        out.append(_finding(
            "ROUTING_UNJUSTIFIED_FALLBACK", where,
            "multiclass cell on the physical path trains its K class "
            "trees serially with no named mc_batch rule", fixture))
    return out


def run(ctx) -> List[Finding]:
    from ...ops import routing as model
    path = ctx.routing_matrix_path or model.default_matrix_path()
    rel = os.path.basename(path)
    out: List[Finding] = []
    fresh = model.canonical_bytes(model.enumerate_matrix())
    golden = {}
    try:
        with open(path, "rb") as fh:
            raw = fh.read()
        golden = json.loads(raw.decode())
    except FileNotFoundError:
        out.append(_finding("ROUTING_MATRIX_MISSING", f"file:{rel}",
                            "golden routing matrix not found: regenerate "
                            "with python -m lightgbm_tpu_torch.ops.routing"))
        raw = None
    except ValueError as e:
        out.append(_finding("ROUTING_MATRIX_UNREADABLE", f"file:{rel}",
                            f"golden routing matrix unreadable: {e}"))
        raw = None
    if raw is not None and raw != fresh:
        new = json.loads(fresh.decode())["cells"]
        old = golden.get("cells") or {}
        changed = sorted(k for k in set(new) & set(old) if new[k] != old[k])
        added = sorted(set(new) - set(old))
        removed = sorted(set(old) - set(new))
        sample = (changed or added or removed)[:3]
        out.append(_finding(
            "ROUTING_MATRIX_STALE", f"file:{rel}",
            f"golden matrix differs from a fresh enumeration "
            f"({len(changed)} changed, {len(added)} new, {len(removed)} "
            f"removed; e.g. {sample}): a routing rule changed without "
            f"regenerating the golden, or the golden was edited"))
    for key, enc in sorted((golden.get("cells") or {}).items()):
        out += audit_cell(key, enc)
    for key, enc in ctx.routing_cells:
        out += audit_cell(key, enc, fixture=True)
    return out
