"""align pass: the port's layout rule, the counterpart of the JAX
package's lane contract (``lightgbm_tpu/analysis/passes/lane.py``).

On the TPU a dynamic row offset into an HBM ref must fall on the 128-lane
tiling.  On the card the rule is the vector access: a kernel that moves a
tensor in V-byte words (``uint4``: 16, ``uint32_t`` words of u8 bins: 4)
at dynamic row offsets needs every row to start on a V-byte boundary, so

    row stride % V == 0   and   base offset % V == 0.

A misaligned vector access is not rounded: it is a sticky
``cudaErrorMisalignedAddress`` that ends the process's CUDA context.
``part::RecPtr`` rests on this rule (``S = 16·ceil((Fb + 28) / 16)``,
``csrc/partition_common.cuh``).  Every registered entry's tensor
arguments are checked.  Codes: ``ALIGN_ROW_STRIDE``,
``ALIGN_BASE_OFFSET``.
"""
from __future__ import annotations

from typing import List

from ..findings import Finding, SEV_ERROR

PASS_NAME = "align"


def run(ctx) -> List[Finding]:
    out: List[Finding] = []
    for e in ctx.entries:
        for a in e.args:
            where = f"entry:{e.name} kernel:{e.symbol} arg:{a.name}"
            if a.row_stride % a.vec:
                out.append(Finding(
                    pass_name=PASS_NAME, code="ALIGN_ROW_STRIDE",
                    severity=SEV_ERROR, where=where,
                    message=(
                        f"{a.dtype}{list(a.shape)} rows are {a.row_stride} "
                        f"bytes apart but the kernel moves them in "
                        f"{a.vec}-byte words: every row after the first "
                        f"is misaligned (a sticky misaligned-address "
                        f"error on the card); pad the row to a multiple "
                        f"of {a.vec} bytes"),
                    entry=e.name, fixture=e.fixture))
            if a.base_offset % a.vec:
                out.append(Finding(
                    pass_name=PASS_NAME, code="ALIGN_BASE_OFFSET",
                    severity=SEV_ERROR, where=where,
                    message=(
                        f"{a.dtype}{list(a.shape)} starts {a.base_offset} "
                        f"bytes into its allocation, not on the "
                        f"{a.vec}-byte boundary its vector accesses need"),
                    entry=e.name, fixture=e.fixture))
    return out
