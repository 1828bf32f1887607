"""purity pass: registered "knob off => the same program" invariants, the
counterpart of the JAX package's purity pins
(``lightgbm_tpu/analysis/passes/purity.py``).

JAX pins compare jaxpr digests.  PyTorch runs eagerly, so the port's
program is what a run does, recorded on the CPU (:func:`record`): the
sequence of ATen operators with their argument shapes and dtypes (a
``TorchDispatchMode``) and the sequence of kernel-wrapper calls with their
tensor arguments' shapes (a profile hook on the wrappers' code, the
functions that launch a kernel on CUDA tensors and take their plain
versions on CPU tensors).  A pin returns ``[(variant, fn), ...]``;
every variant's digest must equal the first's (``PURITY_DIVERGES``).
"""
from __future__ import annotations

import hashlib
import sys
from typing import Callable, List

from .. import registry
from ..findings import Finding, SEV_ERROR

PASS_NAME = "purity"


def _shape_sig(v) -> str:
    import torch
    if isinstance(v, torch.Tensor):
        return f"{str(v.dtype)[6:]}{list(v.shape)}"
    if isinstance(v, (list, tuple)):
        return "(" + ",".join(_shape_sig(x) for x in v) + ")"
    return type(v).__name__


def _wrapper_codes():
    """Code objects of every kernel wrapper of ``ops/*.py``."""
    import importlib

    from ..astutil import PACKAGE, PyModule, functions, is_wrapper
    codes = {}
    for path in sorted((PACKAGE / "ops").glob("*.py")):
        mod = importlib.import_module(f"lightgbm_tpu_torch.ops.{path.stem}")
        for qual, node in functions(PyModule(path, "wrappers").tree()):
            fn = getattr(mod, qual, None)
            if "." not in qual and is_wrapper(node) and callable(fn):
                code = getattr(fn, "__code__", None)
                if code is not None:
                    codes[code] = f"{path.stem}.{qual}"
    return codes


def record(fn: Callable) -> List[str]:
    """The program ``fn()`` runs: one line per ATen operator and per
    kernel-wrapper call, in order."""
    from torch.utils._python_dispatch import TorchDispatchMode

    events: List[str] = []

    class _Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            events.append(f"aten {func} {_shape_sig(args)}")
            return func(*args, **(kwargs or {}))

    codes = _wrapper_codes()

    def prof(frame, event, arg):
        if event == "call" and frame.f_code in codes:
            co = frame.f_code
            shapes = [_shape_sig(frame.f_locals.get(n))
                      for n in co.co_varnames[:co.co_argcount]]
            events.append(f"wrapper {codes[co]} {shapes}")

    old = sys.getprofile()
    sys.setprofile(prof)
    try:
        with _Ops():
            fn()
    finally:
        sys.setprofile(old)
    return events


def digest(fn: Callable) -> str:
    return hashlib.sha256("\n".join(record(fn)).encode()).hexdigest()


def check_pin(name: str, variants) -> List[Finding]:
    digests = [(vname, digest(fn)) for vname, fn in variants()]
    base_name, base = digests[0]
    return [Finding(
        pass_name=PASS_NAME, code="PURITY_DIVERGES", severity=SEV_ERROR,
        where=f"pin:{name} variant:{vname}",
        message=(f"variant {vname!r} runs a different program than "
                 f"{base_name!r} (digest {d[:12]} != {base[:12]}): the "
                 f"knob leaks into the program when off"),
        entry=name)
        for vname, d in digests[1:] if d != base]


def run(ctx) -> List[Finding]:
    out: List[Finding] = []
    pins = dict(registry.PURITY_PINS)
    pins.update(ctx.fixture_pins)
    for name, variants in sorted(pins.items()):
        try:
            findings = check_pin(name, variants)
        except Exception as e:  # noqa: BLE001 - a pin that cannot run
            findings = [Finding(
                pass_name=PASS_NAME, code="PIN_BUILD_FAILED",
                severity=SEV_ERROR, where=f"pin:{name}",
                message=f"pin raised: {type(e).__name__}: {e}",
                entry=name)]
        for f in findings:
            f.fixture = name in ctx.fixture_pins
            out.append(f)
    return out
