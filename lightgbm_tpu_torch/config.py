"""Environment knobs the serving slice reads.

Only :func:`env_knob` and the serve knobs live here, under the same
names and defaults as ``lightgbm_tpu.config.ENV_KNOBS``, so one
environment drives both packages.  The training ``Config`` class comes
with the training slice of the port.
"""
from __future__ import annotations

import os
from typing import Dict

# name -> (default, one-line effect)
ENV_KNOBS: Dict[str, tuple] = {
    "LGBM_TPU_SERVE_LEAF_BF16": ("0", "store stacked leaf values as "
                                      "bfloat16 (halves leaf-table "
                                      "bytes; scores still accumulate "
                                      "f32, and the serving digest "
                                      "carries the leaf dtype)"),
    "LGBM_TPU_SERVE_BUCKETS": ("16:65536", "FLOOR:CAP power-of-two row "
                                           "buckets for serving batch "
                                           "shapes; larger batches "
                                           "chunk at CAP"),
    "LGBM_TPU_SERVE_QUEUE": ("2", "dispatch queue depth for bulk and "
                                  "small-batch serving (submit batch "
                                  "t+1 while t is in flight)"),
}


def env_knob(name: str, environ=None) -> str:
    """Documented read of one ``LGBM_TPU_*`` environment knob: the name
    must be registered in :data:`ENV_KNOBS`, and an unset or empty
    variable returns the table's default.  Raises ``KeyError`` for an
    unregistered name: an undocumented knob read is a bug."""
    if name not in ENV_KNOBS:
        raise KeyError(
            f"{name!r} is not a registered LGBM_TPU knob of "
            "lightgbm_tpu_torch; add it to config.ENV_KNOBS before "
            "reading it")
    val = (environ if environ is not None else os.environ).get(name, "")
    return val if val != "" else ENV_KNOBS[name][0]
