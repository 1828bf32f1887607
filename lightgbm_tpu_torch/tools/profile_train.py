"""End-to-end training time of the default and pack=2 routes on the
card, as ``chip_smoke.py`` drives them: 1,000,000 + 100,000 Higgs-style
rows x 28 features, 255 leaves, ``max_bin`` 255, 10 iterations counted
and timed by ``chip_smoke.train_main_path`` (``row_order``: the same rows
at ``max_bin`` 1023; ``wide``: 136 features; ``unfused``: the P1
``LGBM_TPU_FUSED=0`` route; ``pack2_unfused``: the P2 one; ``3ph``:
``LGBM_TPU_PART=3ph``; launch counts held exact,
served scores held against the training scores), then one profiled
iteration (``chip_smoke.profile_iteration``): s/iteration (first, and
the mean of the rest), the stages' ms a tree, holdout AUC, the
device's busy share, kernels a split and the fused split's, the split
tail's and ``hist_comb``'s kernels' ms in the profiled iteration, and
the partitions' kernels (launches and ms) of one more profiled
iteration, read the same way from either commit.  For the
host's share it also gives the
caching allocator's device allocations, frees and retries over the
training (``torch.cuda.memory_stats``) and the host operations of one
more iteration under ``cProfile`` (the functions with the most time of
their own, and the port's with the most time in all).

    python lightgbm_tpu_torch/tools/profile_train.py \\
        [--package-root DIR] \
        [--routes default,pack2,row_order,wide,unfused,pack2_unfused,3ph]
        [--iters 10]

Run by path, the script imports the package and ``chip_smoke.py`` from
``--package-root`` (default: the checkout it lies in), so one call can
time two commits in turns: unpack the other commit there with ``git
archive``.  Prints one ``profile_train {...}`` JSON line a route (the
training records of ``chip_smoke.py`` come before it) and needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

# the fused split's and the split tail's kernels (either commit's) in a
# profiled iteration
FUSED_KERNELS = re.compile(r"count_tiles|fused_\w+|reduce_partials")
TAIL_KERNELS = re.compile(r"apply_find\w*")
# hist_comb's kernels (either commit's; on the unfused routes the only
# reduce_partials is hist_comb's)
HIST_KERNELS = re.compile(r"hist_comb\w*|reduce_partials")
# the partitions' kernels, either commit's: the scan, its state's
# memset and the copybacks (on the unfused routes count_tiles and
# copy_span are the partition's)
PART_KERNELS = re.compile(
    r"scan_tiles|Memset|copyback_3ph|partition_scatter|"
    r"partition3ph_\w+|count_tiles|copy_span|copy_records")
# the caching allocator's counters read around the training
ALLOC_STATS = ("num_device_alloc", "num_device_free", "num_alloc_retries",
               "num_sync_all_streams")


def host_top(bst, n: int = 15) -> dict:
    """The host's time in one more iteration of ``bst`` under
    ``cProfile``: {"wall_ms", "self": [[function, calls, ms of its
    own]], "port": [[function, calls, ms in all]]}, the functions with
    the most time of their own, and the port's with the most time in
    all (a foreign call's time is its caller's own)."""
    import cProfile
    import pstats
    import time

    import torch
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    bst.update()
    torch.cuda.synchronize()
    prof.disable()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stats = pstats.Stats(prof).stats

    def rows(key, keep=lambda f: True):
        got = sorted(((k, v) for k, v in stats.items() if keep(k[0])),
                     key=lambda kv: -kv[1][key])[:n]
        return [[f"{Path(f).name}:{line}:{fn}", v[1], v[key] * 1e3]
                for (f, line, fn), v in got]
    return {"wall_ms": wall_ms, "self": rows(2),
            "port": rows(3, lambda f: "lightgbm_tpu_torch" in f)}


def partition_kernels(bst) -> dict:
    """{kernel: [launches, ms]} of the partitions' kernels in one more
    iteration of ``bst`` under ``torch.profiler``, and their launches a
    split."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bst.update()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        m = (PART_KERNELS.search(e.name)
             if e.device_type == DeviceType.CUDA else None)
        if m:
            a = out.setdefault(m.group(), [0, 0.0])
            a[0] += 1
            a[1] += e.time_range.elapsed_us() / 1e3
    splits = max(bst._models[-1].num_leaves - 1, 1)
    return {"kernels": out, "ms": sum(ms for _, ms in out.values()),
            "launches_per_split": sum(c for c, _ in out.values()) / splits}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package-root",
                    default=str(Path(__file__).resolve().parents[2]),
                    help="directory holding lightgbm_tpu_torch and "
                         "chip_smoke.py")
    ap.add_argument("--routes", default="default,pack2",
                    help="comma-separated: default, pack2, row_order, "
                         "wide, unfused, pack2_unfused, 3ph")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    root = Path(args.package_root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("profile_train needs a GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import _build
    _build.build()
    # route -> (env, params, features)
    routes = {"default": ({}, cs.TRAIN_PARAMS, cs.N_FEATURES),
              "pack2": (cs.PACK2, cs.TRAIN_PARAMS, cs.N_FEATURES),
              "row_order": ({}, cs.WIDE_PARAMS, cs.N_FEATURES),
              "wide": ({}, cs.TRAIN_PARAMS, cs.WIDE_FEATURES),
              "unfused": (cs.FUSED_OFF, cs.TRAIN_PARAMS, cs.N_FEATURES),
              "pack2_unfused": (cs.PACK2_UNFUSED, cs.TRAIN_PARAMS,
                                cs.N_FEATURES),
              "3ph": (cs.PART_3PH, cs.TRAIN_PARAMS, cs.N_FEATURES)}
    gpu = torch.cuda.get_device_name(0)
    data = {}

    def dataset(params, features):
        key = (params["max_bin"], features)
        if key not in data:
            x_all, y_all = cs.make_higgs_like(
                cs.TRAIN_ROWS + cs.HOLDOUT_ROWS, features, seed=0)
            x, y = x_all[:cs.TRAIN_ROWS], y_all[:cs.TRAIN_ROWS]
            ds = lgt.Dataset(x, label=y,
                             params={"max_bin": params["max_bin"]}
                             ).construct()
            valid = lgt.Dataset(x_all[cs.TRAIN_ROWS:],
                                label=y_all[cs.TRAIN_ROWS:],
                                reference=ds).construct()
            data.clear()
            data[key] = (ds, valid, x)
        return data[key]
    for name in args.routes.split(","):
        env, params, features = routes[name]
        ds, valid, x = dataset(params, features)
        before = torch.cuda.memory_stats()
        bst, rec = cs.train_main_path(gpu, ds, valid, x, env, args.iters,
                                      f"{name} route", params=params,
                                      n_features=features)
        after = torch.cuda.memory_stats()
        alloc = {k: after.get(k, 0) - before.get(k, 0) for k in ALLOC_STATS}
        with cs.route_env(env):
            prof = cs.profile_iteration(bst, gpu)
            part = partition_kernels(bst)
            top = host_top(bst)
        fused, tail, hist = {}, {}, {}
        for k, c, ms in prof.get("top", []):
            for pattern, out in ((FUSED_KERNELS, fused), (TAIL_KERNELS, tail),
                                 (HIST_KERNELS, hist)):
                m = pattern.search(k)
                if m:
                    out[m.group()] = [c, ms]
        # every hist_comb kernel where chip_smoke counts them, else the
        # top ten's
        hist = prof.get("hist_comb_kernels", hist)
        print("profile_train " + json.dumps({
            "package": str(root), "route": rec["route"],
            "iterations": rec["iterations"],
            "s_per_iter_first": rec["s_per_iter_first"],
            "s_per_iter_rest_mean": rec["s_per_iter_rest_mean"],
            "s_per_iter": rec["s_per_iter"],
            "stage_ms_per_tree": rec["stage_ms_per_tree"],
            "holdout_auc": rec["holdout_auc"],
            "busy_share": prof.get("busy_share"),
            "wall_ms": prof.get("wall_ms"), "busy_ms": prof.get("busy_ms"),
            "kernels_per_split": prof.get("kernels_per_split"),
            "fused_split_kernels_top10": fused,
            "split_tail_kernels_top10": tail, "hist_comb_kernels": hist,
            "hist_comb_ms": sum(ms for _, ms in hist.values()),
            "partition_kernels": part, "allocator": alloc,
            "host_top": top, "gpu": gpu}), flush=True)
        del bst
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
