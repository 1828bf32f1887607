"""host pass: no implicit device-to-host read in the kernel wrappers or on
the training loop's path, the counterpart of the JAX package's host-sync
pass (``lightgbm_tpu/analysis/passes/host.py``).

On the TPU a host pull inside a kernel body is a trace-time failure; in
the port it is a silent stall: every ``.item()``, ``.tolist()``,
``.cpu()``, ``.numpy()``, ``np.asarray`` or ``torch.cuda.synchronize``
waits for the card to drain and copies to the host.  Read by ``ast``
(``astutil.PyModule``):

- ``HOST_PULL_IN_WRAPPER``: a pull inside a kernel wrapper of
  ``ops/*.py`` (a function that launches a kernel; plain ``*_ref``
  versions, which run only on the CPU, are exempt);
- ``HOST_PULL_IN_LOOP``: a pull on the training loop's path, every
  function of ``ops/grow.py``, the boosters (``models/gbdt.py``,
  ``goss.py``, ``rf.py``, ``dart.py``) and ``utils/random.py`` but
  ``__init__`` (per iteration, per tree or per split).

A pull the design needs today stays as an allowlist entry whose
justification names the roadmap item that removes it.
"""
from __future__ import annotations

from typing import List

from ..findings import Finding, SEV_ERROR

PASS_NAME = "host"

_CODES = {"wrappers": "HOST_PULL_IN_WRAPPER", "loop": "HOST_PULL_IN_LOOP"}
_WHAT = {"wrappers": "kernel wrapper",
         "loop": "function on the training loop's path"}


def run(ctx) -> List[Finding]:
    out: List[Finding] = []
    for mod in ctx.py_modules:
        for fn, line, what in mod.hits():
            out.append(Finding(
                pass_name=PASS_NAME, code=_CODES[mod.role],
                severity=SEV_ERROR, where=f"{mod.rel}:{fn}:{line}",
                message=(f"{_WHAT[mod.role]} {fn} calls {what}: the host "
                         f"waits for the card and copies to the host "
                         f"(a device-to-host sync)"),
                file=mod.rel, line=line,
                fixture=mod.rel in ctx.fixture_files))
    return out
