"""Serving on the card, two commits in turns in one process: the
traversal kernel at the queue's 64 rows and at a 65,536-row bucket
(eager and in a graph of 20 calls), the dispatch breakdown
(``chip_smoke._dispatch_breakdown``) at both sizes, bulk
``Booster.predict`` rows/s on 1,000,000 rows and the queue's p50/p99
over 512 batches of 64 rows, on ``chip_smoke``'s main forest (100 trees
x 255 leaves over 28 features, seed 0) and rows.

    python -m lightgbm_tpu_torch.tools.profile_serve \\
        [--parent-root DIR] [--turns 2]

``--parent-root`` is a checkout of the other commit (unpack it with
``git archive`` into a git-ignored directory); its package is imported
as ``parent_lightgbm_tpu_torch`` beside this checkout's, and each
measurement runs parent, change, change, parent (``--turns`` pairs).
Without it only this checkout is timed.  The kernel line times, for
each commit, the entries it has: the bins entry (``serve_traverse`` on
``quantize_rows_kernel``'s bins), the quantizer alone and the
quantizer with the bins entry, and the raw entry
(``serve_traverse_raw``, the quantizer inside).  Prints one JSON line a
measurement and needs a GPU; run it in several processes to see the
spread between them.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
ROWS, BUCKET, QUEUE_BATCHES, QUEUE_ROWS = 1_000_000, 65_536, 512, 64


def kernel_times(cs, pkg, sm, x: np.ndarray) -> dict:
    """Each entry's eager and graph ms at 64 and 65,536 rows."""
    import importlib

    import torch
    sk = importlib.import_module(pkg.__name__ + ".ops.serve_kernel")
    pred = importlib.import_module(pkg.__name__ + ".ops.predict")
    f = sm.forest
    sargs = sk.forest_kernel_args(f)
    cols = f.used_cols.long()
    out = {}
    for n in (QUEUE_ROWS, BUCKET):
        raw = torch.from_numpy(x[:n]).cuda()
        bins = pred.quantize_rows_kernel(f, raw[:, cols]).contiguous()
        buf = torch.empty((n, 1), device="cuda")
        rec = {}
        extra = {}
        if hasattr(sk, "serve_traverse_raw"):
            pf = sm.packed()
            extra = {"packed": pf}
            rec["raw"] = cs.eager_and_graph_ms(
                lambda: sk.serve_traverse_raw(pf, raw, n, buf))
        rec["bins"] = cs.eager_and_graph_ms(
            lambda: sk.serve_traverse(sargs, bins, n, buf,
                                      n_steps=sm.n_steps, **extra))
        rec["quantizer"] = cs.eager_and_graph_ms(
            lambda: pred.quantize_rows_kernel(f, raw[:, cols]).contiguous())

        def both():
            b = pred.quantize_rows_kernel(f, raw[:, cols]).contiguous()
            sk.serve_traverse(sargs, b, n, buf, n_steps=sm.n_steps, **extra)
        rec["quantizer_and_bins"] = cs.eager_and_graph_ms(both)
        out[str(n)] = rec
    return out


def serving(pkg, bst, x: np.ndarray) -> dict:
    """Bulk rows/s and the queue's latency percentiles."""
    import torch
    bst.predict(x[:100])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst.predict(x)
    bulk_s = time.perf_counter() - t0
    q = pkg.ServingQueue(bst.serving_engine())
    for i in range(QUEUE_BATCHES):
        q.submit(x[i * QUEUE_ROWS:(i + 1) * QUEUE_ROWS])
    q.drain()
    lat = q.latency_percentiles()
    return {"bulk_rows_per_s": ROWS / bulk_s, "bulk_s": bulk_s,
            "queue_p50_ms": lat["p50_ms"], "queue_p99_ms": lat["p99_ms"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-root", default=None,
                    help="checkout of the other commit")
    ap.add_argument("--turns", type=int, default=2,
                    help="pairs of runs a measurement (parent, change, "
                         "change, parent at 2)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("profile_serve needs a GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import lightgbm_tpu_torch as change
    from lightgbm_tpu_torch.tools.profile_lib import load_package
    gpu = cs._gpu_line()
    pkgs = {"change": change}
    if args.parent_root:
        pkgs["parent"] = load_package(args.parent_root,
                                      "parent_lightgbm_tpu_torch")
    text = cs.random_model_text(n_trees=cs.MAIN_TREES,
                                num_leaves=cs.MAIN_LEAVES,
                                n_features=cs.N_FEATURES, seed=0)
    x = cs.make_rows(ROWS, cs.N_FEATURES, 0)
    bst = {k: p.Booster(model_str=text) for k, p in pkgs.items()}
    order = []
    for i in range(args.turns):
        pair = ["parent", "change"] if len(pkgs) > 1 else ["change"]
        order += pair if i % 2 == 0 else pair[::-1]
    for name in order:
        pkg, b = pkgs[name], bst[name]
        sm = b.serving_engine().model
        eng = b.serving_engine()
        rec = {"commit": name, "gpu": gpu,
               "kernel": kernel_times(cs, pkg, sm, x),
               "breakdown": [cs._dispatch_breakdown(eng, x[:n])
                             for n in (BUCKET, QUEUE_ROWS)],
               "serving": serving(pkg, b, x)}
        print("profile_serve " + json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
