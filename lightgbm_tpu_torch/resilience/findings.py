"""The finding shape the resilience layer reports in: the port's own copy
of ``lightgbm_tpu/obs/findings.py``'s ``make_finding`` / ``render``
contract (``obs/`` itself is not ported).

A finding is ``{"layer", "code", "severity", "message"[, "detail"]}``;
the command-line layers print :func:`render`'s lines and exit with
:data:`EXIT_CLEAN` (0), :data:`EXIT_FINDINGS` (1) or
:data:`EXIT_UNUSABLE` (2).
"""
from __future__ import annotations

from typing import Any, Dict, List

EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_UNUSABLE = 2

SEVERITIES = ("info", "warning", "error")


def make_finding(layer: str, code: str, message: str,
                 severity: str = "error", **detail: Any) -> Dict[str, Any]:
    """One finding: ``layer`` names the check family, ``code`` is the
    stable machine key (SCREAMING_SNAKE), ``message`` the one-line human
    text; extra keyword detail rides verbatim."""
    if severity not in SEVERITIES:
        raise ValueError(f"severity must be one of {SEVERITIES}, "
                         f"got {severity!r}")
    f: Dict[str, Any] = {"layer": layer, "code": code,
                         "severity": severity, "message": message}
    if detail:
        f["detail"] = detail
    return f


def render(findings: List[Dict[str, Any]], *, indent: str = "  ",
           min_severity: str = "info") -> List[str]:
    """The uniform finding lines, most severe first within input order;
    ``min_severity`` filters the rest."""
    keep = SEVERITIES[SEVERITIES.index(min_severity):]
    order = {"error": 0, "warning": 1, "info": 2}
    lines = []
    for f in sorted((f for f in findings
                     if f.get("severity", "info") in keep),
                    key=lambda f: order.get(f.get("severity"), 3)):
        lines.append(f"{indent}{f.get('severity', '?').upper():<8} "
                     f"{f.get('layer', '?')}/{f.get('code', '?')}  "
                     f"{f.get('message', '')}")
    return lines
