"""Times of the fused split on the card: ``fused_split`` (pack=1) and
``fused_split_p2`` (pack=2) at given segment sizes, eager (20 calls back
to back, CUDA events) and as one replay of a CUDA graph of 20 calls,
beside the byte bound and, with ``--plain``, the plain version on the
card.  Each case's histograms, scratch segment and ``nleft`` are held
bitwise against the plain version on CPU copies before anything is
timed.

    python lightgbm_tpu_torch/tools/profile_fused.py \\
        [--segments 1000000,13128] [--plain] [--package-root DIR] \\
        [--variants]

``--variants`` times, instead, the pack=1 split at each segment on the
histogram pass's other geometries (:func:`variant_geometries`: range
mode against feature mode at several feature groups), each held bitwise
against the plain version first, in a replayed graph of 20 calls.

Rows: 1,000,000 seeded rows x 28 features (uniform bins below 255, 5 %
of feature 0's rows in the NaN bin 255), split on feature 0 at bin 120
with the NaN bin routed left; a segment of fewer rows than the matrix
starts at row 1 (odd), the whole matrix at row 0.  Run by path, the
script imports the package from ``--package-root`` (default: the
checkout it lies in), so one call can time two commits in turns: unpack
the other commit there with ``git archive``.  Prints one JSON line a
case and needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

N_ROWS, N_FEATURES, PADDED_BINS, NAN_BIN = 1_000_000, 28, 256, 255
# the split: feature 0 at bin 120, NaN bin routed left
SPLIT = (0, 120, 1, 0, NAN_BIN)
CALLS = 20
PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS_S = 67e12              # f32 outside the tensor cores


def make_rows(n: int = N_ROWS, f: int = N_FEATURES, seed: int = 11):
    """Seeded row arrays (bins u8 [n, F], vals f32 [n, 3], rid i32 [n],
    score f32 [n], consts f32 [n, 2])."""
    g = np.random.default_rng(seed)
    bins = g.integers(0, NAN_BIN, size=(n, f), dtype=np.uint8)
    bins[g.random(n) < 0.05, 0] = NAN_BIN
    w = (g.random(n) < 0.9).astype(np.float32)
    vals = np.stack([g.normal(size=n).astype(np.float32) * w,
                     g.uniform(0.01, 0.25, n).astype(np.float32) * w, w], 1)
    consts = np.stack([np.where(g.random(n) < 0.5, 1.0, -1.0),
                       g.uniform(0.5, 2.0, n)], 1).astype(np.float32)
    return (bins, np.ascontiguousarray(vals),
            g.permutation(n).astype(np.int32),
            g.normal(size=n).astype(np.float32), np.ascontiguousarray(consts))


def segment_sel(cnt: int, n: int = N_ROWS) -> tuple:
    return (0 if cnt >= n else 1, int(cnt)) + SPLIT


def bound_ms(cnt: int, row_bytes: int, f: int, b: int) -> float:
    """Every row of the segment read and written once and both children's
    [F, B, 2] f32 histograms written, over the card's memory rate; or
    two f32 adds a (row, feature), over its f32 rate: the larger."""
    n_bytes = 2 * cnt * row_bytes + 2 * f * b * 8
    return max(n_bytes / PEAK_BYTES_S, 2 * cnt * f / PEAK_OPS_S) * 1e3


def _eager_graph_ms(fn) -> tuple:
    import torch

    from lightgbm_tpu_torch.tools.profile_lib import batch_ms, graph_ms

    def many():
        for _ in range(CALLS):
            fn()
    eager = batch_ms(fn, reps=CALLS, warmup=1)
    graph, g = graph_ms(many, reps=5, warmup=1)
    del g
    torch.cuda.synchronize()
    return eager, graph / CALLS


def time_segment(rows, packed, cpu_rows, cnt: int, *, plain: bool = False,
                 padded_bins: int = PADDED_BINS) -> dict:
    """One case: both packs held bitwise against the plain version on
    the CPU copies ``cpu_rows``, then timed.  ``rows`` is the pack=1
    ``Rows`` on the card, ``packed`` its ``PackedRows``."""
    import torch

    from lightgbm_tpu_torch.ops.device_data import PackedRows, Rows
    from lightgbm_tpu_torch.ops.fused_split import (fused_split,
                                                    fused_split_p2,
                                                    fused_split_ref)
    dev = rows.bins.device
    n, f = rows.bins.shape
    sel = segment_sel(cnt, n)
    s0 = sel[0]
    seg = slice(s0, s0 + cnt)
    scr_c = Rows(*(torch.zeros_like(a) for a in cpu_rows))
    nl_c = torch.zeros(1, dtype=torch.int32)
    ref = fused_split_ref(cpu_rows, scr_c, sel, nl_c, padded_bins=padded_bins)
    scr1 = Rows(*(torch.zeros_like(a) for a in rows))
    scr2 = PackedRows(torch.zeros_like(packed.buf), packed.layout)
    nl = torch.full((1,), -1, dtype=torch.int32, device=dev)
    calls = {1: lambda: fused_split(rows, scr1, sel, nl,
                                    padded_bins=padded_bins),
             2: lambda: fused_split_p2(packed, scr2, sel, nl,
                                       padded_bins=padded_bins)}
    rec = {"rows": int(cnt), "s0": s0}
    for pack, fn in calls.items():
        nl.fill_(-1)
        out = fn().cpu()
        fields = scr1 if pack == 1 else scr2.fields()
        same = (torch.equal(out, ref) and int(nl) == int(nl_c)
                and all(torch.equal(a[seg].cpu(), b[seg])
                        for a, b in zip(fields, scr_c)))
        if not same:
            raise RuntimeError(f"fused split pack={pack} at {cnt} rows "
                               "differs from its plain version")
        eager, graph = _eager_graph_ms(fn)
        row_bytes = f + 28 if pack == 1 else packed.layout.stride
        key = "" if pack == 1 else "p2_"
        rec.update({f"{key}ms": eager, f"{key}graph_ms": graph,
                    f"{key}bound_ms": bound_ms(cnt, row_bytes, f,
                                               padded_bins)})
    rec["nleft"] = int(nl_c)
    rec["bitwise_cpu_plain"] = True
    if plain:
        from lightgbm_tpu_torch.tools.profile_lib import batch_ms
        rec["plain_ms"] = batch_ms(lambda: fused_split_ref(
            rows, scr1, sel, nl, padded_bins=padded_bins), reps=3, warmup=1)
    return rec


def variant_geometries(f: int, b: int, cnt: int) -> list:
    """[(label, FusedGeometry)] of the histogram pass at ``cnt`` rows:
    the wrapper's choice ("chosen"), range mode ("range") and feature
    mode at 1, 2, 4, 7, 14 and 28 feature groups ("feature<g>"); a
    variant equal to the chosen geometry is left out."""
    from lightgbm_tpu_torch.ops.fused_split import (HIST_WARPS, RANGE_BINS,
                                                    fused_geometry,
                                                    hist_smem_bytes)
    geo = fused_geometry(f, b, cnt)
    out = [("chosen", geo)]
    parts = -(-b // RANGE_BINS)
    alt = [("range", geo._replace(groups=-(-f * parts // HIST_WARPS),
                                  feats=0, parts=parts,
                                  smem=hist_smem_bytes(0, parts, b)))]
    for g in (1, 2, 4, 7, 14, 28):
        feats = -(-f // min(g, f))
        alt.append((f"feature{-(-f // feats)}", geo._replace(
            groups=-(-f // feats), feats=feats, parts=1,
            smem=hist_smem_bytes(feats, 1, b))))
    seen = {geo}
    for label, v in alt:
        if v not in seen:
            seen.add(v)
            out.append((label, v))
    return out


def time_variants(rows, cpu_rows, cnt: int,
                  padded_bins: int = PADDED_BINS) -> list:
    """The pack=1 split of ``cnt`` rows on each of
    :func:`variant_geometries`, launched through the library as the
    wrapper launches it, held bitwise against the plain version on the
    CPU copies, then timed in a replayed graph of 20 calls: one record
    a variant."""
    import torch

    from lightgbm_tpu_torch.ops.device_data import Rows
    from lightgbm_tpu_torch.ops.fused_split import (_geometry_args, _lib,
                                                    _split_buffers,
                                                    fused_split_ref)
    from lightgbm_tpu_torch.ops.partition_kernel import (row_pointers,
                                                         split_args,
                                                         word_args)
    from lightgbm_tpu_torch.tools.profile_lib import graph_ms
    dev = rows.bins.device
    n, f = rows.bins.shape
    sel = segment_sel(cnt, n)
    s0 = sel[0]
    seg = slice(s0, s0 + cnt)
    scr_c = Rows(*(torch.zeros_like(a) for a in cpu_rows))
    nl_c = torch.zeros(1, dtype=torch.int32)
    ref = fused_split_ref(cpu_rows, scr_c, sel, nl_c, padded_bins=padded_bins)
    scr = Rows(*(torch.zeros_like(a) for a in rows))
    nl = torch.full((1,), -1, dtype=torch.int32, device=dev)
    out = []
    for label, geo in variant_geometries(f, padded_bins, cnt):
        held = {}

        def call(geo=geo):
            ws, hist, ptrs = _split_buffers(geo, f, padded_bins, cnt, dev)
            rc = _lib().fused_split(
                *row_pointers(rows), *row_pointers(scr), ptrs[0],
                nl.data_ptr(), *ptrs[1:], hist.data_ptr(), f,
                int(padded_bins), s0, cnt, *split_args(sel),
                *word_args(sel), *_geometry_args(geo),
                torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{label} geometry {geo} refused: {rc}")
            held["out"] = hist
            del ws
        nl.fill_(-1)
        call()
        same = (torch.equal(held["out"].cpu(), ref) and int(nl) == int(nl_c)
                and all(torch.equal(a[seg].cpu(), c[seg])
                        for a, c in zip(scr, scr_c)))
        if not same:
            raise RuntimeError(f"fused split at {cnt} rows on the {label} "
                               "geometry differs from its plain version")

        def many(call=call):
            for _ in range(CALLS):
                call()
        graph, g = graph_ms(many, reps=5, warmup=1)
        del g
        torch.cuda.synchronize()
        out.append({"rows": int(cnt), "variant": label,
                    "geometry": geo._asdict(), "graph_ms": graph / CALLS,
                    "bitwise_cpu_plain": True})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--segments", default=f"{N_ROWS}",
                    help="comma-separated segment sizes (rows)")
    ap.add_argument("--plain", action="store_true",
                    help="also time the plain version on the card")
    ap.add_argument("--package-root",
                    default=str(Path(__file__).resolve().parents[2]),
                    help="directory holding the lightgbm_tpu_torch "
                         "package to time")
    ap.add_argument("--variants", action="store_true",
                    help="time the histogram pass's other geometries "
                         "(pack=1) instead")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.package_root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("profile_fused needs a GPU", file=sys.stderr)
        return 1
    from lightgbm_tpu_torch.ops.device_data import Rows, pack_rows
    arrays = make_rows()
    rows = Rows(*(torch.tensor(a, device="cuda") for a in arrays))
    packed = pack_rows(rows)
    cpu_rows = Rows(*(torch.tensor(a) for a in arrays))
    import lightgbm_tpu_torch
    for cnt in (int(s) for s in args.segments.split(",")):
        if args.variants:
            for rec in time_variants(rows, cpu_rows, cnt):
                rec["gpu"] = torch.cuda.get_device_name(0)
                print(json.dumps(rec), flush=True)
            continue
        rec = time_segment(rows, packed, cpu_rows, cnt, plain=args.plain)
        rec["package"] = str(Path(lightgbm_tpu_torch.__file__).parent)
        rec["gpu"] = torch.cuda.get_device_name(0)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
