"""Logging for lightgbm_tpu_torch.

Verbosity-levelled Debug/Info/Warning/Fatal where Fatal raises, plus a
registerable callback so host applications (tests, notebooks, services)
can redirect output -- the analog of LGBM_RegisterLogCallback
(c_api.h:71).  Same surface as ``lightgbm_tpu.utils.log``; the port
keeps its own copy so it never imports the JAX package.
"""
from __future__ import annotations

import sys
from typing import Callable, Optional


class LightGBMError(Exception):
    """Raised on fatal errors (reference: Log::Fatal throwing std::runtime_error)."""


class _LogState:
    # verbosity: <0 = fatal only, 0 = warning, 1 = info (default), >1 = debug
    verbosity: int = 1
    callback: Optional[Callable[[str], None]] = None


_STATE = _LogState()


def set_verbosity(level: int) -> None:
    _STATE.verbosity = int(level)


def get_verbosity() -> int:
    return _STATE.verbosity


def register_log_callback(cb: Optional[Callable[[str], None]]) -> None:
    """Redirect log output to ``cb`` (None restores stderr printing)."""
    _STATE.callback = cb


def _emit(msg: str) -> None:
    if _STATE.callback is not None:
        _STATE.callback(msg + "\n")
    else:
        print(msg, file=sys.stderr, flush=True)


def debug(msg: str, *args) -> None:
    if _STATE.verbosity > 1:
        _emit("[LightGBM-TPU] [Debug] " + (msg % args if args else msg))


def info(msg: str, *args) -> None:
    if _STATE.verbosity >= 1:
        _emit("[LightGBM-TPU] [Info] " + (msg % args if args else msg))


def warning(msg: str, *args) -> None:
    if _STATE.verbosity >= 0:
        _emit("[LightGBM-TPU] [Warning] " + (msg % args if args else msg))


def fatal(msg: str, *args) -> None:
    text = msg % args if args else msg
    _emit("[LightGBM-TPU] [Fatal] " + text)
    raise LightGBMError(text)
