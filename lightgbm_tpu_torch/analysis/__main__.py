"""CLI: ``python -m lightgbm_tpu_torch.analysis [--strict] [--json]
[--fixture NAME]... [--resources FILE|built]``.

Exit codes, as the JAX package's CLI: 0 = clean (no unallowlisted error;
warnings tolerated unless --strict), 1 = findings, 2 = usage or allowlist
error.  With ``--fixture`` the run exits 1 when the seeded violation is
detected and 0 when a pass went blind, so a gate of "must exit nonzero"
catches the blindness.  Runs on the CPU without a GPU, ``nvcc`` or JAX;
``--resources built`` reads the libraries built on the card.
"""
from __future__ import annotations

import argparse
import json
import sys

from .allowlist import AllowlistError
from .findings import SEV_ERROR
from .run import PASS_NAMES, run_analysis


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.analysis",
        description="Static kernel-contract analyzer of the PyTorch / "
                    "CUDA port (reads sources and registered launch "
                    "geometry; builds and launches nothing).")
    ap.add_argument("--strict", action="store_true",
                    help="warnings also fail the run")
    ap.add_argument("--json", action="store_true",
                    help="print the lightgbm_tpu_torch/analysis/v1 report")
    ap.add_argument("--passes", default=None,
                    help="comma-separated subset of: "
                         + ",".join(PASS_NAMES))
    ap.add_argument("--fixture", action="append", default=[],
                    metavar="NAME",
                    help="inject a seeded-violation fixture "
                         "(analysis/fixtures/); the run must then report it")
    ap.add_argument("--resources", default=None, metavar="FILE|built",
                    help="resource report to read (default: the checked-in "
                         "analysis/resources_sm90a.txt); 'built' runs "
                         "cuobjdump on the built libraries")
    ap.add_argument("--routing-matrix", default=None, metavar="PATH",
                    help="golden routing matrix (default: analysis/"
                         "routing_matrix.json)")
    ap.add_argument("--allowlist", default=None, metavar="PATH",
                    help="allowlist file (default: analysis/allowlist.json)")
    ap.add_argument("--list", action="store_true", dest="list_entries",
                    help="list the registered kernel entries and exit")
    args = ap.parse_args(argv)

    if args.list_entries:
        from . import registry
        for name, e in sorted(registry.collect().items()):
            print(f"{name:28s} {e.source:18s} {e.symbol} grid={e.grid} "
                  f"block={e.block} smem={e.dyn_smem} wrapper={e.wrapper} "
                  f"replaces={e.replaces}")
        for name in sorted(registry.PURITY_PINS):
            print(f"{name:28s} purity pin")
        return 0
    try:
        report = run_analysis(
            passes=args.passes.split(",") if args.passes else None,
            fixtures=args.fixture, allowlist_path=args.allowlist,
            strict=args.strict, resources=args.resources,
            routing_matrix_path=args.routing_matrix)
    except AllowlistError as e:
        print(f"analysis: allowlist error: {e}", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"analysis: {e}", file=sys.stderr)
        return 2
    doc = report.to_json()
    if args.json:
        print(json.dumps(doc, indent=2, sort_keys=True))
    else:
        render(report, doc)
    if args.fixture:
        if any(f.fixture for f in report.findings):
            return 1
        print(f"analysis: FIXTURE NOT DETECTED: {args.fixture} produced no "
              f"finding; exiting 0 so a must-fail gate fails",
              file=sys.stderr)
        return 0
    return 1 if report.failing() else 0


def render(report, doc) -> None:
    s = doc["summary"]
    print(f"static analysis [{doc['schema']}]: {len(report.passes)} passes "
          f"over {len(report.entries)} kernel entries: {s['errors']} "
          f"error(s), {s['warnings']} warning(s), {s['allowlisted']} "
          f"allowlisted")
    for f in sorted(report.findings,
                    key=lambda f: (f.severity != SEV_ERROR, f.pass_name,
                                   f.where)):
        tag = "ALLOWED" if f.allowlisted else f.severity.upper()
        fx = " [fixture]" if f.fixture else ""
        print(f"  {tag:7s} {f.pass_name} {f.code}{fx}\n"
              f"          at {f.where}\n          {f.message}")
        if f.allowlisted:
            print(f"          justification: {f.justification}")


if __name__ == "__main__":
    sys.exit(main())
