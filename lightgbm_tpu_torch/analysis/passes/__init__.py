"""Analyzer pass pipeline.  Each pass module exposes ``PASS_NAME`` and
``run(ctx) -> [Finding]``; the registry of passes lives here."""
from . import align, async_copy, host, purity, routing, smem  # noqa: F401

PASSES = {
    align.PASS_NAME: align,
    smem.PASS_NAME: smem,
    async_copy.PASS_NAME: async_copy,
    host.PASS_NAME: host,
    purity.PASS_NAME: purity,
    routing.PASS_NAME: routing,
}
