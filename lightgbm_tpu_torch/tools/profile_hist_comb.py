"""Times of the comb-direct histogram on the card: ``hist_comb``
(pack=1) and ``hist_comb_p2`` (pack=2) on seeded 1,000,000-row matrices
of 28 and 136 features (B = 256), eager (20 calls back to back, CUDA
events) and as one replay of a CUDA graph of 20 calls, beside one
``Tensor.index_add_`` over a precomputed flat (feature, bin) index of
the same rows (``chip_smoke.library_hist_ms``'s call, both ways) and
the byte bound.  Each case's histograms are held bitwise against the
plain version run on CPU copies before anything is timed, and the
kernels one call launches (with their blocks) are read from a profiler
trace.

    python lightgbm_tpu_torch/tools/profile_hist_comb.py \\
        [--features 28,136] [--children auto | NAME=COUNT:MAX_ROWS,...] \\
        [--slices 1,2,...] [--package-root DIR] [--variants]

The ranges: the 1M-row root; the smaller children's quartiles and the
largest smaller child of one tree grown on the P1 ``FUSED=0`` route
(``LGBM_TPU_FUSED=0``, 1M Higgs-like rows x 28, 255 leaves), each with
the bound ``max_rows = parent // 2 + 1`` the grower passes (``auto``
grows the tree and prints its sizes as ``children ...``; give them back
with ``--children`` to skip the training); and each slice count of
``--slices`` (a range of ``s * 4096 - 31`` rows under the bound ``s *
4096``).  Children and slice counts start at row 100,001 (odd).

``--variants`` times, instead, pack=1 on other geometries of the
current package's wrapper (``hist_kernel2.comb_geometry``): range mode
against feature mode at each slice count, and feature mode at other
feature chunks at the root, each held bitwise against the plain version
first, in a replayed graph of 20 calls.

Run by path, the script imports the package and ``chip_smoke.py`` from
``--package-root`` (default: the checkout it lies in), so one call can
time two commits in turns: unpack the other commit there with ``git
archive``.  Prints one JSON line a case and needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

N_ROWS, PADDED_BINS = 1_000_000, 256
CHILD_START = 100_001
ROWS_PER_SLICE = 4096
CALLS = 20
PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS_S = 67e12              # f32 outside the tensor cores


def make_rows(n: int, f: int, seed: int = 23):
    """Seeded rows (bins u8 [n, F] below 255, vals f32 [n, 3])."""
    g = np.random.default_rng(seed)
    bins = g.integers(0, 255, size=(n, f), dtype=np.uint8)
    w = (g.random(n) < 0.9).astype(np.float32)
    vals = np.stack([g.normal(size=n).astype(np.float32) * w,
                     g.uniform(0.01, 0.25, n).astype(np.float32) * w, w], 1)
    return bins, np.ascontiguousarray(vals)


def bound_ms(count: int, f: int, b: int = PADDED_BINS) -> float:
    """The range's bins and (g*w, h*w) read once and the [F, B, 2] f32
    histogram written once, over the card's memory rate; or one f32 add
    a (row, feature, channel), over its f32 rate: the larger."""
    n_bytes = count * (f + 8) + f * b * 8
    return max(n_bytes / PEAK_BYTES_S, 2 * count * f / PEAK_OPS_S) * 1e3


def child_sizes(cs) -> dict:
    """{name: (count, max_rows)} of the smaller children of one tree
    grown on the P1 FUSED=0 route: their quartiles and the largest."""
    import lightgbm_tpu_torch as lgt
    x_all, y_all = cs.make_higgs_like(cs.TRAIN_ROWS, cs.N_FEATURES, seed=0)
    ds = lgt.Dataset(x_all, label=y_all,
                     params={"max_bin": 255}).construct()
    with cs.route_env({"LGBM_TPU_FUSED": "0"}):
        bst = lgt.train(cs.TRAIN_PARAMS, ds, num_boost_round=1,
                        device="cuda")
    sizes = cs.split_sizes(bst._models)
    order = np.argsort(sizes[:, 1], kind="stable")
    out = {}
    for name, q in (("q25", 0.25), ("median", 0.5), ("q75", 0.75),
                    ("max", 1.0)):
        parent, child = sizes[order[int(round(q * (len(order) - 1)))]]
        out[name] = (int(child), int(parent) // 2 + 1)
    return out


def parse_children(text: str) -> dict:
    out = {}
    for item in text.split(","):
        name, sizes = item.split("=")
        count, max_rows = sizes.split(":")
        out[name] = (int(count), int(max_rows))
    return out


def cases(n: int, children: dict, slices) -> list:
    """[(label, (start, off, count), max_rows)]."""
    out = [("root", (0, 0, n), n)]
    out += [(f"child_{name}", (CHILD_START, 0, c), m)
            for name, (c, m) in children.items()]
    out += [(f"slices_{s}", (CHILD_START, 0, s * ROWS_PER_SLICE - 31),
             s * ROWS_PER_SLICE) for s in slices]
    return out


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


def time_case(cs, rows, packed, rows_cpu, rng: tuple, max_rows: int,
              timed: bool = True) -> dict:
    """Both packs bitwise the plain version on CPU copies and the
    kernels a call launches; with ``timed``, both timed beside one
    ``index_add_`` of the same rows."""
    import torch

    from lightgbm_tpu_torch.ops import hist_kernel2 as hk
    dev = rows.bins.device
    n, f = rows.bins.shape
    t = torch.tensor(rng, dtype=torch.int32, device=dev)
    kw = dict(padded_bins=PADDED_BINS, max_rows=max_rows)
    want = hk.build_histogram_comb_ref(rows_cpu, t.cpu(), **kw)
    calls = {1: lambda: hk.build_histogram_comb(rows, t, **kw),
             2: lambda: hk.build_histogram_comb_p2(packed, t, **kw)}
    lo, hi = hk._window(rng, n)
    rec = {"range": list(rng), "rows": hi - lo, "max_rows": max_rows,
           "slices": hk.hist_blocks(max_rows),
           "bound_ms": bound_ms(hi - lo, f)}
    for pack, fn in calls.items():
        if not cs.torch_equal(fn().cpu(), want):
            raise RuntimeError(f"hist_comb pack={pack} at {rng} "
                               "differs from its plain version")
        key = "" if pack == 1 else "p2_"
        if timed:
            rec[f"{key}ms"], rec[f"{key}graph_ms"] = _eager_graph_ms(fn)
        rec[f"{key}kernels_a_call"] = cs.kernels_of_call(fn)
    rec["bitwise_cpu_plain"] = True
    if timed and hi > lo:
        idx = torch.arange(lo, hi, device=dev)
        flat, upd = cs.flat_hist_inputs(rows.bins, rows.vals, PADDED_BINS,
                                        idx)
        acc = torch.zeros((f * PADDED_BINS, 2), dtype=torch.float32,
                          device=dev)
        rec["library_ms"], rec["library_graph_ms"] = _eager_graph_ms(
            lambda: acc.index_add_(0, flat, upd))
        del flat, upd, acc
    return rec


def device_rows(f: int):
    """(rows on the card, their records, CPU copies) of
    :func:`make_rows` at ``f`` features: the ``Rows`` carry only bins
    and vals, the records zeros in the other fields."""
    import torch

    from lightgbm_tpu_torch.ops.device_data import Rows, pack_rows
    bins, vals = make_rows(N_ROWS, f)
    rows = Rows(torch.tensor(bins, device="cuda"),
                torch.tensor(vals, device="cuda"), None, None, None)
    packed = pack_rows(Rows(
        rows.bins, rows.vals,
        torch.zeros(N_ROWS, dtype=torch.int32, device="cuda"),
        torch.zeros(N_ROWS, device="cuda"),
        torch.zeros((N_ROWS, 2), device="cuda")))
    return rows, packed, Rows(torch.tensor(bins), torch.tensor(vals), None,
                              None, None)


def variant_geometries(f: int, max_rows: int) -> list:
    """[(label, CombGeometry)]: the wrapper's choice, range mode and
    feature mode (where each differs from it), and feature mode at
    other chunks (7, 8, 14, 16, 17, 28, 32 features, those up to F)."""
    from lightgbm_tpu_torch.ops import hist_kernel2 as hk
    geo = hk.comb_geometry(f, PADDED_BINS, max_rows)
    fc = hk.comb_chunk(f, PADDED_BINS, geo.slices)
    alt = [(mode, hk.mode_geometry(f, PADDED_BINS, geo.slices, fc, cap))
           for mode, cap in (("range", geo.slices), ("feature", 0))]
    for fc in (7, 8, 14, 16, 17, 28, 32):
        if fc <= f:
            alt.append((f"feature_fc{fc}", geo._replace(
                ranged=False, grid=(geo.slices, -(-f // fc)), feats=fc,
                bin_parts=1, smem=hk.comb_feature_smem(fc, PADDED_BINS))))
    out, seen = [("chosen", geo)], {geo}
    for label, v in alt:
        if v not in seen:
            seen.add(v)
            out.append((label, v))
    return out


def time_variants(cs, rows, rows_cpu, rng: tuple, max_rows: int) -> list:
    """pack=1 at ``rng`` on each of :func:`variant_geometries`, launched
    through the library as the wrapper launches it, bitwise the plain
    version first, then timed in a replayed graph of 20 calls."""
    import torch

    from lightgbm_tpu_torch.ops import hist_kernel2 as hk
    from lightgbm_tpu_torch.tools.profile_lib import graph_ms
    dev = rows.bins.device
    n, f = rows.bins.shape
    t = torch.tensor(rng, dtype=torch.int32, device=dev)
    want = hk.build_histogram_comb_ref(rows_cpu, t.cpu(),
                                       padded_bins=PADDED_BINS,
                                       max_rows=max_rows)
    out = []
    for label, geo in variant_geometries(f, max_rows):
        held = {}

        def call(geo=geo):
            partials, res = hk._comb_buffers(geo, f, PADDED_BINS, dev)
            rc = hk._lib().hist_comb(
                rows.bins.data_ptr(), rows.vals.data_ptr(), t.data_ptr(),
                *hk.comb_args(geo, partials, res, n, f, PADDED_BINS),
                torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{label} geometry {geo} refused: {rc}")
            held["out"] = res
        call()
        if not cs.torch_equal(held["out"].cpu(), want):
            raise RuntimeError(f"hist_comb at {rng} on the {label} "
                               "geometry differs from its plain version")

        def many(call=call):
            for _ in range(CALLS):
                call()
        graph, g = graph_ms(many, reps=5, warmup=1)
        del g
        torch.cuda.synchronize()
        out.append({"range": list(rng), "max_rows": max_rows,
                    "features": f, "variant": label,
                    "geometry": geo._asdict(), "graph_ms": graph / CALLS,
                    "bitwise_cpu_plain": True})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--features", default="28,136",
                    help="comma-separated feature counts")
    ap.add_argument("--children", default="auto",
                    help="'auto' (grow one P1 FUSED=0 tree) or "
                         "NAME=COUNT:MAX_ROWS,...")
    ap.add_argument("--slices", default="1,2,3,4,5,6,7,8",
                    help="comma-separated slice counts")
    ap.add_argument("--package-root",
                    default=str(Path(__file__).resolve().parents[2]),
                    help="directory holding lightgbm_tpu_torch and "
                         "chip_smoke.py")
    ap.add_argument("--variants", action="store_true",
                    help="time other geometries (pack=1) instead")
    args = ap.parse_args(argv)
    root = Path(args.package_root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("profile_hist_comb needs a GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs

    import lightgbm_tpu_torch
    from lightgbm_tpu_torch.ops import _build
    _build.build()
    gpu = torch.cuda.get_device_name(0)
    children = (child_sizes(cs) if args.children == "auto"
                else parse_children(args.children))
    print("children " + ",".join(f"{k}={c}:{m}"
                                 for k, (c, m) in children.items()),
          flush=True)
    slices = [int(s) for s in args.slices.split(",") if s]
    for f in (int(x) for x in args.features.split(",")):
        rows, packed, rows_cpu = device_rows(f)
        for label, rng, max_rows in cases(N_ROWS, children, slices):
            if args.variants:
                for rec in time_variants(cs, rows, rows_cpu, rng, max_rows):
                    rec.update(case=label, gpu=gpu)
                    print(json.dumps(rec), flush=True)
                continue
            rec = time_case(cs, rows, packed, rows_cpu, rng, max_rows)
            rec.update(case=label, features=f, gpu=gpu, package=str(
                Path(lightgbm_tpu_torch.__file__).parent))
            print(json.dumps(rec), flush=True)
        del rows, packed
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
