"""The one place the port turns a ``device=`` argument into a
``torch.device``.  Entry points default to ``"cuda"``; with no GPU they
raise rather than run on the CPU, which only an explicit
``device="cpu"`` selects (the plain PyTorch versions of the kernels)."""
from __future__ import annotations

import torch

from .log import LightGBMError


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise LightGBMError(
                "lightgbm_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run the plain "
                "PyTorch versions of its kernels")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise LightGBMError(f"unsupported device {device!r}: use 'cuda' "
                            "or 'cpu'")
    return dev


def device_from_params(device_type) -> str:
    """The device of an entry point that takes only strings (the CLI,
    the C API): ``device_type=cpu`` (alias ``device``) is the CPU, any
    other value, ``Config``'s default ``"tpu"`` included, the card."""
    return "cpu" if str(device_type).strip().lower() == "cpu" else "cuda"
