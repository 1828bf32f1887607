"""Times of the unfused partitions on the card: ``partition_scan``
(pack=1), ``partition_scan_p2`` (pack=2 records) and ``partition_3ph``
on seeded 1,000,000-row matrices (28 features; the wide route's 136),
eager (20 calls back to back, CUDA events) and as one replay of a CUDA
graph of 20 calls, beside the byte bound (each row of the segment read
once and written once).  Each case's output is held bitwise against the
plain version on the card before anything is timed, and the kernels one
call launches (with their blocks) are read from a captured graph.

    python lightgbm_tpu_torch/tools/profile_partition.py \\
        [--routes unfused,pack2_unfused,3ph,wide] \\
        [--segments auto | ROUTE:NAME=COUNT,...] [--package-root DIR] \\
        [--variants]

The segments of each route: the 1M-row root; the split segments'
quartiles and the largest segment below a root of one tree grown on
that route (``unfused``: P1 ``LGBM_TPU_FUSED=0``; ``pack2_unfused``: P2
``LGBM_TPU_FUSED=0``; ``3ph``: ``LGBM_TPU_PART=3ph``; ``wide``: 136
features, 1M Higgs-like rows, 255 leaves; ``auto`` grows the trees and
prints their sizes as ``segments ...``; give them back with
``--segments`` to skip the training).  Segments below the root start at
row 100,001 (odd).  The split: feature 0 at bin 120, the NaN bin (254,
5 % of the rows) routed left.

Each case also gives ``host_us``, the host's time a call (the median
of five batches of 20 calls, none waited for): the wrapper's own cost,
which sets the pace where the device's work is shorter.

``--variants`` times, instead, the current package's scan on other
geometries (``partition_kernel.scan_geometry``'s tiles, 128 to 1,024
rows, with the bins or records staged where a block holds them, and
unstaged), each held bitwise against the plain version first, in a
replayed graph of 20 calls.

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

N_ROWS, SEG_START, CALLS = 1_000_000, 100_001, 20
PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3
NAN_BIN = 254
# route -> (chip_smoke's env name, features, kernel)
ROUTES = {"unfused": ("FUSED_OFF", 28, "scan"),
          "pack2_unfused": ("PACK2_UNFUSED", 28, "scan_p2"),
          "3ph": ("PART_3PH", 28, "3ph"),
          "wide": (None, 136, "scan")}
VARIANT_TILES = (128, 256, 512, 1024)


def bound_ms(cnt: int, row_bytes: int) -> float:
    """Each row of the segment read once and written once, over the
    card's memory rate (plus nleft)."""
    return (2 * cnt * row_bytes + 4) / PEAK_BYTES_S * 1e3


def route_segments(cs, routes) -> dict:
    """{route: {name: rows}}: the split segments' quartiles and the
    largest below a root of one tree grown on each route."""
    import lightgbm_tpu_torch as lgt
    out, data = {}, {}
    for route in routes:
        env_name, f, _ = ROUTES[route]
        if f not in data:
            x, y = cs.make_higgs_like(cs.TRAIN_ROWS, f, seed=0)
            data.clear()
            data[f] = lgt.Dataset(x, label=y,
                                  params={"max_bin": 255}).construct()
        env = getattr(cs, env_name) if env_name else {}
        with cs.route_env(env):
            bst = lgt.train(cs.TRAIN_PARAMS, data[f], num_boost_round=1,
                            device="cuda")
        seg = cs.segment_sizes(bst._models)
        out[route] = {k: seg[k] for k in ("q25", "median", "q75",
                                           "max_child")}
    return out


def parse_segments(text: str) -> dict:
    out = {}
    for item in text.split(","):
        route, rest = item.split(":")
        name, count = rest.split("=")
        out.setdefault(route, {})[name] = int(count)
    return out


def device_rows(cs, f: int):
    """(rows on the card, their records) of seeded rows
    (``chip_smoke.random_row_matrix``): feature 0 with 5 % of its rows in
    the NaN bin."""
    import torch

    from lightgbm_tpu_torch.ops.device_data import pack_rows
    rows = cs.rows_on(cs.random_row_matrix(N_ROWS, f, 31, nan_bin=NAN_BIN),
                      "cuda")
    packed = pack_rows(rows)
    torch.cuda.synchronize()
    return rows, packed


def _calls(kernel: str, rows, packed, sel):
    """(kernel call, plain call, output of each) at ``sel``: fresh
    scratch and nleft a side; the 3-phase partition on copies of the
    rows."""
    import torch

    from lightgbm_tpu_torch.ops import partition_kernel as pk
    from lightgbm_tpu_torch.ops.device_data import PackedRows, Rows
    dev = rows.bins.device
    nk = torch.zeros(1, dtype=torch.int32, device=dev)
    npl = torch.zeros(1, dtype=torch.int32, device=dev)
    if kernel == "scan_p2":
        sk, sp = (PackedRows(torch.zeros_like(packed.buf), packed.layout)
                  for _ in range(2))
        return ((lambda: pk.partition_scan_p2(packed, sk, sel, nk)),
                (lambda: pk.partition_scan_p2_ref(packed, sp, sel, npl)),
                (sk.fields(), nk), (sp.fields(), npl))
    sk, sp = (Rows(*(torch.zeros_like(a) for a in rows)) for _ in range(2))
    if kernel == "scan":
        return ((lambda: pk.partition_scan(rows, sk, sel, nk)),
                (lambda: pk.partition_scan_ref(rows, sp, sel, npl)),
                (sk, nk), (sp, npl))
    rk = Rows(*(a.clone() for a in rows))
    rp = Rows(*(a.clone() for a in rows))
    return ((lambda: pk.partition_3ph(rk, sk, sel, nk)),
            (lambda: pk.partition_3ph_ref(rp, sp, sel, npl)),
            (rk, nk), (rp, npl))


def _held(cs, got, want, sel, kernel) -> None:
    (a, na), (b, nb) = got, want
    s0, cnt = sel[0], sel[1]
    lo, hi = (s0, s0 + cnt) if kernel != "3ph" else (0, None)
    if int(na) != int(nb) or not all(cs.torch_equal(x[lo:hi], y[lo:hi])
                                     for x, y in zip(a, b)):
        raise RuntimeError(f"{kernel} at {sel[:2]} differs from its plain "
                           "version")


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


def host_us(fn) -> float:
    """The host's time a call of ``fn``: the median of five batches of
    ``CALLS`` calls, none waited for (the device drained before each)."""
    import statistics
    import time

    import torch
    out = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        out.append((time.perf_counter() - t0) / CALLS * 1e6)
    torch.cuda.synchronize()
    return statistics.median(out)


def time_case(cs, kernel: str, rows, packed, sel) -> dict:
    """The kernel bitwise its plain version at ``sel``, the kernels a
    call launches, then its times."""
    fn, plain, got, want = _calls(kernel, rows, packed, sel)
    fn()
    plain()
    _held(cs, got, want, sel, kernel)
    row_bytes = (packed.layout.stride if kernel == "scan_p2"
                 else rows.bins.shape[1] + 28)
    rec = {"kernel": kernel, "s0": sel[0], "rows": sel[1],
           "features": rows.bins.shape[1], "row_bytes": row_bytes,
           "bound_ms": bound_ms(sel[1], row_bytes),
           "bitwise_plain": True, "kernels_a_call": cs.kernels_of_call(fn)}
    rec["ms"], rec["graph_ms"] = _eager_graph_ms(fn)
    rec["host_us"] = host_us(fn)
    rec["bound_fraction_graph"] = rec["bound_ms"] / rec["graph_ms"]
    return rec


def time_variants(cs, kernel: str, rows, packed, sel) -> list:
    """The current package's scan at ``sel`` on each variant tile,
    staged (where a block holds it) and unstaged, bitwise the plain
    version first, timed in a replayed graph of 20 calls."""
    import torch

    from lightgbm_tpu_torch.ops import partition_kernel as pk
    from lightgbm_tpu_torch.tools.profile_lib import graph_ms
    fn, plain, got, want = _calls(kernel, rows, packed, sel)
    plain()
    target = packed if kernel == "scan_p2" else (
        pk.Rows(*(a.clone() for a in rows)) if kernel == "3ph" else rows)
    f = rows.bins.shape[1]
    stride = packed.layout.stride if kernel == "scan_p2" else None
    scratch = (pk.PackedRows(torch.zeros_like(packed.buf), packed.layout)
               if kernel == "scan_p2"
               else pk.Rows(*(torch.zeros_like(a) for a in rows)))
    nk = got[1]
    out = []
    for tile in VARIANT_TILES:
        for staged in (True, False):
            try:
                geo = pk.scan_geometry(sel[1], f, stride, tile=tile,
                                       staged=staged)
            except pk.LightGBMError:
                continue

            def call(geo=geo):
                pk.launch_scan(target, scratch, sel, nk, geo,
                               scheme="3ph" if kernel == "3ph" else "ss")
            if kernel == "3ph":
                # restore the rows, then one partition
                for a, b in zip(target, rows):
                    a.copy_(b)
            call()
            torch.cuda.synchronize()
            res = (target if kernel == "3ph" else
                   (scratch.fields() if kernel == "scan_p2" else scratch))
            _held(cs, (res, nk), want, sel, kernel)

            def many(call=call):
                for _ in range(CALLS):
                    call()
            graph, g = graph_ms(many, reps=5, warmup=1)
            del g
            torch.cuda.synchronize()
            out.append({"kernel": kernel, "rows": sel[1], "features": f,
                        "tile": tile, "staged": staged,
                        "smem": geo.smem, "blocks": geo.tiles,
                        "graph_ms": graph / CALLS, "bitwise_plain": True})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--routes", default="unfused,pack2_unfused,3ph,wide",
                    help="comma-separated: " + ", ".join(ROUTES))
    ap.add_argument("--segments", default="auto",
                    help="'auto' (grow one tree a route) or "
                         "ROUTE:NAME=COUNT,...")
    ap.add_argument("--package-root",
                    default=str(Path(__file__).resolve().parents[2]),
                    help="directory holding lightgbm_tpu_torch and "
                         "chip_smoke.py")
    ap.add_argument("--variants", action="store_true",
                    help="time the scan's other geometries instead")
    args = ap.parse_args(argv)
    root = Path(args.package_root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("profile_partition needs a GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs

    import lightgbm_tpu_torch
    from lightgbm_tpu_torch.ops import _build
    _build.build()
    gpu = torch.cuda.get_device_name(0)
    routes = [r for r in args.routes.split(",") if r]
    segments = (route_segments(cs, routes) if args.segments == "auto"
                else parse_segments(args.segments))
    print("segments " + ",".join(f"{r}:{k}={c}"
                                 for r, seg in segments.items()
                                 for k, c in seg.items()), flush=True)
    held = {}
    for route in routes:
        _, f, kernel = ROUTES[route]
        if f not in held:
            held.clear()
            torch.cuda.empty_cache()
            held[f] = device_rows(cs, f)
        rows, packed = held[f]
        cases = [("root", (0, N_ROWS))] + [
            (k, (SEG_START, c)) for k, c in segments.get(route, {}).items()]
        for label, (s0, cnt) in cases:
            sel = (s0, cnt, 0, 120, 1, 0, NAN_BIN)
            recs = (time_variants(cs, kernel, rows, packed, sel)
                    if args.variants
                    else [time_case(cs, kernel, rows, packed, sel)])
            for rec in recs:
                rec.update(route=route, case=label, gpu=gpu, package=str(
                    Path(lightgbm_tpu_torch.__file__).parent))
                print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
