"""Analyzer allowlist: findings kept on purpose, each with a REQUIRED
justification.

Format (JSON, default file ``analysis/allowlist.json``), the JAX
package's (``lightgbm_tpu/analysis/allowlist.py``) under the port's
schema string:

    {"schema": "lightgbm_tpu_torch/analysis-allowlist/v1",
     "entries": [
        {"pass": "host",                   # pass_name to match
         "code": "HOST_PULL_IN_LOOP",      # finding code to match
         "match": "ops/grow.py:_grow",     # substring of Finding.where
         "justification": "why this stays"}]}

A finding is allowlisted when an entry's pass and code match exactly and
``match`` is a substring of its ``where``.  An entry without a
justification is a load error, an entry that matches nothing is reported
(``ALLOWLIST_UNUSED``), and a fixture's finding is never allowlisted.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List

from .findings import Finding

ALLOWLIST_SCHEMA = "lightgbm_tpu_torch/analysis-allowlist/v1"
DEFAULT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "allowlist.json")


class AllowlistError(ValueError):
    """Malformed allowlist file (bad schema, missing justification)."""


@dataclass
class AllowEntry:
    pass_name: str
    code: str
    match: str
    justification: str
    used: bool = False

    def matches(self, f: Finding) -> bool:
        return (f.pass_name == self.pass_name and f.code == self.code
                and self.match in f.where)


def load(path: str = None) -> List[AllowEntry]:
    """Load and validate an allowlist; a missing default file is an
    empty allowlist, a missing explicit path is an error."""
    explicit = path is not None
    path = path or DEFAULT_PATH
    if not os.path.exists(path):
        if explicit:
            raise AllowlistError(f"allowlist file not found: {path}")
        return []
    with open(path) as fh:
        try:
            doc = json.load(fh)
        except json.JSONDecodeError as e:
            raise AllowlistError(f"allowlist {path} is not valid JSON: "
                                 f"{e}") from e
    if doc.get("schema") != ALLOWLIST_SCHEMA:
        raise AllowlistError(
            f"allowlist {path} has schema {doc.get('schema')!r}, "
            f"expected {ALLOWLIST_SCHEMA!r}")
    out = []
    for i, e in enumerate(doc.get("entries", [])):
        just = str(e.get("justification", "")).strip()
        if not just:
            raise AllowlistError(
                f"allowlist {path} entry {i} ({e.get('pass')}:"
                f"{e.get('code')}) has no justification: every "
                f"suppressed finding needs a written reason")
        if not e.get("pass") or not e.get("code"):
            raise AllowlistError(
                f"allowlist {path} entry {i} needs 'pass' and 'code'")
        out.append(AllowEntry(pass_name=str(e["pass"]),
                              code=str(e["code"]),
                              match=str(e.get("match", "")),
                              justification=just))
    return out


def dump(entries: List[AllowEntry], path: str) -> None:
    """Write ``entries`` in the format :func:`load` reads."""
    doc = {"schema": ALLOWLIST_SCHEMA,
           "entries": [{"pass": e.pass_name, "code": e.code,
                        "match": e.match,
                        "justification": e.justification}
                       for e in entries]}
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2)
        fh.write("\n")


def apply(findings: List[Finding], entries: List[AllowEntry]
          ) -> List[AllowEntry]:
    """Mark allowlisted findings in place and return the unused entries.
    Fixture findings are never allowlisted: the red-team set must always
    fire."""
    for f in findings:
        if f.fixture:
            continue
        for e in entries:
            if e.matches(f):
                f.allowlisted = True
                f.justification = e.justification
                e.used = True
                break
    return [e for e in entries if not e.used]
