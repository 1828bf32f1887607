#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``lightgbm_tpu_torch``) on one
NVIDIA GPU: ``python3 chip_smoke.py`` from the root of a checkout.

Phases, each of which raises (exit code != 0, no result line) on failure:

1. the card's name and power limit; the CUDA kernels are built from
   ``lightgbm_tpu_torch/csrc`` (one ``nvcc`` per source, all at once);
2. every kernel against its plain PyTorch version on the card: small
   seeded forests with categorical splits, NaN rows, f32 and bf16 leaf
   tables and padded buckets (``n_real < n``), then the main path's own
   forest at its 65,536-row bucket;
3. the serving main path at full width: a seeded binary forest of 100
   trees x 255 leaves over 28 f32 features, written as LightGBM model
   text by the port's writer, loaded with ``Booster(model_str=...)``,
   scoring 1,000,000 rows with ``Booster.predict`` and 512 batches of 64
   rows through ``ServingQueue``; the launch counts are zeroed just
   before and read just after, and 4,096 rows are held against the f64
   host walk;
4. one JSON line per run of ``{"kernels": [...]}`` with each kernel's
   launches, parity and times, then the device line last.

The forest is generated, not trained: the card's machine has no JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import types

import numpy as np

N_FEATURES = 28
MAIN_TREES = 100
MAIN_LEAVES = 255
MAIN_ROWS = 1_000_000
BUCKET = 65_536
QUEUE_BATCHES = 512
QUEUE_ROWS = 64
HOST_ROWS = 4096
# H100 SXM peaks: HBM bytes/s and the float32 rate outside the tensor
# cores, the nearest published rate for the walk's 32-bit integer work
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# integer operations per node visit of the walk: node index, feature
# load, meta test, NaN-bin compare, threshold compare, two selects, the
# loop test
OPS_PER_VISIT = 8


def make_higgs_like(n_rows: int, n_features: int = 28, seed: int = 0):
    """Higgs-style rows: kinematic-style continuous features and a
    nonlinear decision surface (the generator bench.py serves)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_rows, n_features)).astype(np.float32)
    w = rng.normal(size=(n_features,))
    logit = (x @ w * 0.3
             + 0.8 * x[:, 0] * x[:, 1]
             - 0.6 * np.abs(x[:, 2])
             + 0.5 * x[:, 3] ** 2)
    y = (logit + rng.logistic(size=n_rows) > 0).astype(np.float32)
    return x, y


def feature_missing_types(n_features: int, seed: int, cat_features=()):
    """One missing type per numerical feature (0 none, 1 zero, 2 NaN),
    -1 for categorical ones; the same draw the row generator uses."""
    rng = np.random.default_rng(seed + 7)
    mt = rng.choice([0, 1, 2], size=n_features, p=[0.4, 0.2, 0.4])
    mt[list(cat_features)] = -1
    return mt


def random_model_text(*, n_trees: int, num_leaves: int, n_features: int,
                      seed: int, cat_features=(), n_cat: int = 40,
                      num_class: int = 1) -> str:
    """LightGBM model text of a seeded random forest, written by the
    port's own ``Tree`` and model-text writer.  Trees grow leaf-wise by
    random splits; numerical thresholds come from a per-feature grid of
    255 values; each numerical feature has one missing type, NaN
    features get a random default direction per node, zero-as-missing
    features the direction of 0.0; categorical features split on random
    raw-value bitsets."""
    from lightgbm_tpu_torch.models.model_text import save_model_to_string
    from lightgbm_tpu_torch.models.tree import Tree

    rng = np.random.default_rng(seed)
    mt = feature_missing_types(n_features, seed, cat_features)
    grids = [np.sort(rng.normal(size=255)) for _ in range(n_features)]
    trees = []
    for _ in range(n_trees):
        nl = int(num_leaves)
        ni = nl - 1
        left = np.zeros(ni, np.int32)
        right = np.zeros(ni, np.int32)
        feat = np.zeros(ni, np.int32)
        thr = np.zeros(ni, np.float64)
        dtype = np.zeros(ni, np.uint8)
        leaf_parent = {0: (-1, 0)}
        cat_bounds, cat_words = [0], []
        for node in range(ni):
            leaf = int(rng.integers(0, node + 1))
            new_leaf = node + 1
            parent, side = leaf_parent[leaf]
            if parent >= 0:
                (left if side == 0 else right)[parent] = node
            left[node], right[node] = ~leaf, ~new_leaf
            leaf_parent[leaf] = (node, 0)
            leaf_parent[new_leaf] = (node, 1)
            f = int(rng.integers(0, n_features))
            feat[node] = f
            if mt[f] < 0:
                members = np.flatnonzero(rng.random(n_cat) < 0.5)
                if len(members) == 0:
                    members = np.array([0])
                words = np.zeros(int(members.max()) // 32 + 1, np.uint32)
                for v in members:
                    words[v // 32] |= np.uint32(1 << (int(v) % 32))
                thr[node] = len(cat_words)
                cat_words.append(words)
                cat_bounds.append(cat_bounds[-1] + len(words))
                dtype[node] = 1 | (2 << 2)
            else:
                thr[node] = grids[f][int(rng.integers(0, 255))]
                if mt[f] == 2:
                    dl = bool(rng.random() < 0.5)
                elif mt[f] == 1:
                    dl = 0.0 <= thr[node]
                else:
                    dl = False
                dtype[node] = (int(mt[f]) << 2) | (int(dl) << 1)
        t = Tree(num_leaves=nl)
        t.split_feature = feat
        t.threshold = thr
        t.threshold_bin = np.zeros(ni, np.int32)
        t.decision_type = dtype
        t.split_gain = rng.uniform(0.1, 10.0, ni)
        t.left_child, t.right_child = left, right
        t.internal_value = rng.normal(0, 0.1, ni)
        t.internal_weight = rng.uniform(1, 100, ni)
        t.internal_count = rng.integers(20, 1000, ni)
        t.leaf_value = rng.normal(0, 0.1, nl)
        t.leaf_weight = rng.uniform(1, 10, nl)
        t.leaf_count = rng.integers(20, 200, nl)
        t.num_cat = len(cat_words)
        t.cat_boundaries = np.asarray(cat_bounds, np.int32)
        t.cat_threshold = (np.concatenate(cat_words) if cat_words
                           else np.zeros(0, np.uint32))
        t.shrinkage = 0.1
        trees.append(t)
    model = types.SimpleNamespace(
        models=trees, num_class=num_class,
        num_tree_per_iteration=num_class,
        objective=("binary sigmoid:1" if num_class == 1
                   else f"multiclass num_class:{num_class}"),
        average_output=False,
        feature_names=[f"Column_{i}" for i in range(n_features)],
        feature_infos=["none" if mt[i] < 0 else "[-4:4]"
                       for i in range(n_features)],
        max_feature_idx=n_features - 1)
    return save_model_to_string(model)


def make_rows(n_rows: int, n_features: int, seed: int, cat_features=(),
              n_cat: int = 40) -> np.ndarray:
    """Higgs-style f32 rows with the missing values of the model made
    from the same seed: 5% NaN on
    NaN-missing features, 3% exact zeros on zero-missing ones, and
    categorical columns of raw values from -2 to n_cat + 9 with NaN."""
    x, _ = make_higgs_like(n_rows, n_features, seed)
    rng = np.random.default_rng(seed + 1)
    mt = feature_missing_types(n_features, seed, cat_features)
    for f in range(n_features):
        if mt[f] == 2:
            x[rng.random(n_rows) < 0.05, f] = np.nan
        elif mt[f] == 1:
            x[rng.random(n_rows) < 0.03, f] = 0.0
        elif mt[f] < 0:
            x[:, f] = rng.integers(-2, n_cat + 10, n_rows)
            x[rng.random(n_rows) < 0.05, f] = np.nan
    return x


def score_tolerance(scores: np.ndarray, n_trees: int) -> np.ndarray:
    """64 f32 ulps per tree, relative to max(|s|, 1): the f32 sums are
    taken in another order than the reference's."""
    return (64 * n_trees * np.finfo(np.float32).eps
            * np.maximum(np.abs(scores), 1.0))


# ---------------------------------------------------------------------
def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _leaf_depths(forest) -> np.ndarray:
    """[T, nl_pad] depth of each leaf (node visits to reach it)."""
    lc = forest.left_child.cpu().numpy()
    rc = forest.right_child.cpu().numpy()
    init = forest.init_node.cpu().numpy()
    depth = np.zeros((lc.shape[0], forest.leaf_value.shape[1]), np.int64)
    for t in range(lc.shape[0]):
        if init[t] < 0:
            depth[t, 0] = 1     # one step parks a single-leaf tree
            continue
        stack = [(0, 1)]
        while stack:
            node, d = stack.pop()
            for child in (int(lc[t, node]), int(rc[t, node])):
                if child < 0:
                    depth[t, ~child] = d
                else:
                    stack.append((child, d + 1))
    return depth


def _parity(sm, x: np.ndarray, n_real: int, label: str) -> dict:
    """Kernel vs plain version on the card, both forms, same inputs."""
    import torch

    from lightgbm_tpu_torch.ops.predict import quantize_rows_kernel
    from lightgbm_tpu_torch.ops.serve_kernel import (forest_kernel_args,
                                                     serve_traverse,
                                                     serve_traverse_ref)
    f = sm.forest
    dev = f.device
    raw = torch.from_numpy(x).to(dev)
    bins = quantize_rows_kernel(f, raw[:, f.used_cols.long()]).contiguous()
    n = bins.shape[0]
    k = sm.num_class
    largs = forest_kernel_args(f, leaves=True)
    sargs = forest_kernel_args(f)
    lk = torch.full((n, sm.n_trees), -7, dtype=torch.int32, device=dev)
    lp = torch.empty_like(lk)
    serve_traverse(largs, bins, n_real, lk, n_steps=sm.n_steps, leaves=True)
    serve_traverse_ref(largs, bins, n_real, lp, n_steps=sm.n_steps,
                       leaves=True)
    sk = torch.full((n, k), float("nan"), device=dev)
    sp = torch.empty_like(sk)
    serve_traverse(sargs, bins, n_real, sk, n_steps=sm.n_steps)
    serve_traverse_ref(sargs, bins, n_real, sp, n_steps=sm.n_steps)
    torch.cuda.synchronize()
    lk, lp = lk.cpu().numpy(), lp.cpu().numpy()
    sk, sp = sk.cpu().numpy(), sp.cpu().numpy()
    leaves_exact = bool(np.array_equal(lk, lp))
    err = np.abs(sk - sp)
    scores_ok = bool(np.all(np.isfinite(sk))
                     and np.all(err <= score_tolerance(sp, sm.n_trees)))
    rec = {"case": label, "n": int(n), "n_real": int(n_real),
           "trees": sm.n_trees, "num_class": k,
           "cat_words_w": sm.kernel_geometry()["cat_words_w"],
           "leaf_dtype": str(f.leaf_value.dtype).replace("torch.", ""),
           "leaves_exact": leaves_exact, "max_abs_err": float(err.max()),
           "ok": leaves_exact and scores_ok}
    print("parity " + json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise RuntimeError(f"serve_traverse disagrees with its plain "
                           f"version on the card: {rec}")
    return rec


def _dispatch_breakdown(eng, x: np.ndarray, reps: int = 20) -> dict:
    """Where one bucketed dispatch's time goes, in ms per stage: the
    host-side pad (host clock), then on the stream the host-to-device
    copy, the quantizer, the traversal kernel and the device-to-host
    copy of the live rows (CUDA events); the mean of ``reps`` runs
    after one warm-up."""
    import torch

    from lightgbm_tpu_torch.ops.predict import quantize_rows_kernel
    from lightgbm_tpu_torch.ops.serve_kernel import serve_traverse
    n = x.shape[0]
    bucket = eng.bucket_for(n)
    model = eng.model
    cols = model.forest.used_cols.long()
    buf = torch.empty((bucket, model.num_class), device=eng.device)
    stages = ("pad_host", "h2d", "quantize", "kernel", "d2h")
    sums = dict.fromkeys(stages, 0.0)
    for rep in range(reps + 1):
        t0 = time.perf_counter()
        padded = eng._pad(x, bucket)
        pad_ms = (time.perf_counter() - t0) * 1e3
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        raw = torch.from_numpy(padded).to(eng.device)
        ev[1].record()
        bins = quantize_rows_kernel(model.forest, raw[:, cols]).contiguous()
        ev[2].record()
        serve_traverse(eng._scores_args, bins, n, buf, n_steps=model.n_steps)
        ev[3].record()
        buf[:n].cpu()
        ev[4].record()
        torch.cuda.synchronize()
        if rep:
            sums["pad_host"] += pad_ms
            for i, name in enumerate(stages[1:]):
                sums[name] += ev[i].elapsed_time(ev[i + 1])
    out = {"rows": n, "bucket": bucket}
    out.update({k: v / reps for k, v in sums.items()})
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs one CUDA GPU", file=sys.stderr)
        return 2
    import dataclasses

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import _build
    from lightgbm_tpu_torch.ops.predict import quantize_rows_kernel
    from lightgbm_tpu_torch.ops.serve_kernel import (forest_kernel_args,
                                                     serve_traverse,
                                                     serve_traverse_ref)

    # 1. card and build
    gpu = _gpu_line()
    print(f"gpu: {gpu}", flush=True)
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    print(f"kernels built in {build_s:.2f} s", flush=True)
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    # 2. kernel vs plain on the card: small edge forests
    cat = (2, 5)
    small = []
    for label, k, bf16 in (("cat_f32_binary", 1, False),
                           ("cat_bf16_binary", 1, True),
                           ("cat_f32_multiclass3", 3, False)):
        text = random_model_text(n_trees=24 * k, num_leaves=63,
                                 n_features=10, seed=11 + k,
                                 cat_features=cat, num_class=k)
        sm = lgt.Booster(model_str=text).serving_engine().model
        if bf16:
            sm.forest = dataclasses.replace(
                sm.forest,
                leaf_value=sm.forest.leaf_value.to(torch.bfloat16))
        x = make_rows(1024, 10, 11 + k, cat)
        x[:7] = np.nan
        x[7:10, list(cat)] = np.array([[3e9], [np.inf], [-np.inf]],
                                      np.float32)
        small.append(_parity(sm, x, 1000, label))
        small.append(_parity(sm, x[:64], 64, label + "_n64"))

    # the main path's forest and bucket
    main_text = random_model_text(n_trees=MAIN_TREES,
                                  num_leaves=MAIN_LEAVES,
                                  n_features=N_FEATURES, seed=0)
    bst = lgt.Booster(model_str=main_text)
    x_main = make_rows(MAIN_ROWS, N_FEATURES, 0)
    sm = bst.serving_engine().model
    main_par = _parity(sm, x_main[:BUCKET], BUCKET, "main_bucket")
    small.append(_parity(sm, x_main[:BUCKET], BUCKET - 17,
                         "main_bucket_padded"))

    # 3. the serving main path, counted
    bst.predict(x_main[:100])          # warm: engine, pools, CUDA context
    torch.cuda.synchronize()
    serve_traverse.launches = 0
    t0 = time.perf_counter()
    prob = bst.predict(x_main)
    bulk_s = time.perf_counter() - t0
    q = lgt.ServingQueue(bst.serving_engine())
    for i in range(QUEUE_BATCHES):
        q.submit(x_main[i * QUEUE_ROWS:(i + 1) * QUEUE_ROWS])
    got = q.drain()
    launches = serve_traverse.launches
    lat = q.latency_percentiles()
    if launches <= 0:
        raise RuntimeError("the main path launched serve_traverse 0 times")

    # what came out
    if prob.shape != (MAIN_ROWS,) or not np.all(np.isfinite(prob)) \
            or not np.all((prob >= 0) & (prob <= 1)):
        raise RuntimeError("bulk predict gave non-finite or out-of-range "
                           "probabilities")
    queued = np.concatenate(got, axis=0)[:, 0]
    raw_head = bst.predict(x_main[:QUEUE_BATCHES * QUEUE_ROWS],
                           raw_score=True)
    if not np.array_equal(queued, raw_head):
        raise RuntimeError("ServingQueue results disagree with bulk "
                           "predict (order or values)")
    xh = x_main[:HOST_ROWS].astype(np.float64)
    host_leaves = np.stack([t.predict_leaf(xh) for t in bst._models],
                           axis=1)
    eng_leaves = bst.serving_engine().predict_leaves(x_main[:HOST_ROWS])
    host_raw = sum(t.predict(xh) for t in bst._models)
    dev_raw = bst.predict(x_main[:HOST_ROWS], raw_score=True)
    if not np.array_equal(eng_leaves, host_leaves):
        raise RuntimeError("kernel leaf indices differ from the f64 host "
                           "walk")
    if not np.all(np.abs(dev_raw - host_raw)
                  <= score_tolerance(host_raw, MAIN_TREES)):
        raise RuntimeError("kernel scores differ from the f64 host walk "
                           "beyond 64 ulps per tree")
    print(f"main path: {MAIN_TREES} trees x {MAIN_LEAVES} leaves, "
          f"depth {sm.n_steps}, {MAIN_ROWS} rows in {bulk_s:.3f} s = "
          f"{MAIN_ROWS / bulk_s:.0f} rows/s; queue {QUEUE_BATCHES}x"
          f"{QUEUE_ROWS} rows p50 {lat['p50_ms']} ms p99 "
          f"{lat['p99_ms']} ms; host walk parity ok on {HOST_ROWS} rows "
          f"[{gpu}]", flush=True)

    # timing at the main path's bucket, forest and rows hot in L2 as in
    # steady serving
    f = sm.forest
    raw = torch.from_numpy(x_main[:BUCKET]).cuda()
    bins = quantize_rows_kernel(f, raw[:, f.used_cols.long()]).contiguous()
    sargs = forest_kernel_args(f)
    buf = torch.empty((BUCKET, 1), device="cuda")
    n_steps = sm.n_steps
    launches_before = serve_traverse.launches
    ms = _time_ms(lambda: serve_traverse(sargs, bins, BUCKET, buf,
                                         n_steps=n_steps), 50)
    plain_ms = _time_ms(lambda: serve_traverse_ref(sargs, bins, BUCKET,
                                                   buf, n_steps=n_steps), 3)
    if serve_traverse.launches <= launches_before:
        raise RuntimeError("the timed calls did not launch the kernel")
    leaves = torch.empty((BUCKET, MAIN_TREES), dtype=torch.int32,
                         device="cuda")
    serve_traverse_ref(forest_kernel_args(f, leaves=True), bins, BUCKET,
                       leaves, n_steps=n_steps, leaves=True)
    depth = _leaf_depths(f)
    visits = int(depth[np.arange(MAIN_TREES)[None, :],
                       leaves.cpu().numpy()].sum())
    forest_bytes = sum(a.numel() * a.element_size() for a in sargs)
    n_bytes = bins.numel() * 4 + BUCKET * 1 * 4 + forest_bytes
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    ops_ms = visits * OPS_PER_VISIT / PEAK_OPS_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"serve_traverse @ {BUCKET} rows: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms (bytes "
          f"{n_bytes} -> {bytes_ms:.5f} ms, node visits {visits} -> "
          f"{ops_ms:.5f} ms) [{gpu}]", flush=True)

    kernels = [{
        "name": "serve_traverse",
        "route": "cuda",
        "source": "lightgbm_tpu_torch/csrc/serve_traverse.cu",
        "replaces": "lightgbm_tpu/ops/pallas/serve_kernel.py:219",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in [main_par] + small),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "parity": "ok",
        "leaves_exact": all(r["leaves_exact"] for r in [main_par] + small),
        "gpu": gpu,
        "rows_per_s": MAIN_ROWS / bulk_s,
        "queue_p50_ms": lat["p50_ms"],
        "queue_p99_ms": lat["p99_ms"],
        "build_s": build_s,
    }]
    eng = bst.serving_engine()
    for rows in (BUCKET, QUEUE_ROWS):
        print("breakdown " + json.dumps(dict(
            _dispatch_breakdown(eng, x_main[:rows]), gpu=gpu)), flush=True)
    t0 = time.perf_counter()
    np.asarray(np.asarray(x_main, np.float64), np.float32)
    print(f"breakdown booster f64 -> f32 input copies of {MAIN_ROWS} rows: "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms (host)", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
