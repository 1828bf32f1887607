"""Finding record and versioned JSON schema of the port's analyzer.

``lightgbm_tpu_torch/analysis/v1``: a report is

    {"schema": "lightgbm_tpu_torch/analysis/v1",
     "strict": bool,
     "passes": [pass names run],
     "entries": [registered kernel entries analyzed],
     "findings": [Finding.to_json() ...],
     "summary": {"errors": n, "warnings": n, "allowlisted": n}}

and a finding is the flat dict of :class:`Finding`, with the fields of
the JAX package's analyzer (``lightgbm_tpu/analysis/findings.py``).
Schema changes are additive within v1; ``tests/test_torch_analysis.py``
pins the key set.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field

SCHEMA = "lightgbm_tpu_torch/analysis/v1"

SEV_ERROR = "error"
SEV_WARNING = "warning"


@dataclass
class Finding:
    """One contract violation (or warning) from one pass."""
    pass_name: str          # align / smem / async-copy / host / purity /
                            # routing / resources / allowlist
    code: str               # stable machine code, e.g. ALIGN_ROW_STRIDE
    severity: str           # "error" | "warning"
    where: str              # "entry:<name> ..." or "<file>:<line>"
    message: str
    file: str = ""          # repo-relative when located in a source
    line: int = 0
    entry: str = ""         # registered kernel entry, when there is one
    fixture: bool = False   # seeded by an injected fixture
    allowlisted: bool = False
    justification: str = ""

    def key(self) -> str:
        """Stable identity the allowlist matches against."""
        return f"{self.pass_name}:{self.code}:{self.where}"

    def to_json(self) -> dict:
        return asdict(self)


@dataclass
class Report:
    strict: bool
    passes: list = field(default_factory=list)
    entries: list = field(default_factory=list)
    findings: list = field(default_factory=list)   # [Finding]

    def failing(self) -> list:
        """Findings that fail the run: unallowlisted errors, plus
        unallowlisted warnings under --strict."""
        return [f for f in self.findings if not f.allowlisted
                and (f.severity == SEV_ERROR or self.strict)]

    def to_json(self) -> dict:
        live = [f for f in self.findings if not f.allowlisted]
        return {
            "schema": SCHEMA,
            "strict": self.strict,
            "passes": list(self.passes),
            "entries": list(self.entries),
            "findings": [f.to_json() for f in self.findings],
            "summary": {
                "errors": sum(f.severity == SEV_ERROR for f in live),
                "warnings": sum(f.severity == SEV_WARNING for f in live),
                "allowlisted": len(self.findings) - len(live),
            },
        }
