"""``linear_moments`` on the card, two commits in turns in one process.

    python -m lightgbm_tpu_torch.tools.profile_linear \\
        [--parent-root DIR] [--turns 2] [--shapes tree0,skewed,...]

Shapes, each over 1,000,000 rows and 255 leaves:

- ``tree0``: tree 0 of the linear main path (``chip_smoke.linear_phase``:
  the main path's 1M x 28 rows, ``linear_target``'s label,
  ``LINEAR_PARAMS``), its leaves and path features (kmax 9);
- ``skewed``: the same rows, one leaf holding 500,000 of them and the
  others even, 9 seeded path features a leaf;
- ``even``: the same rows in even leaves, 9 path features a leaf;
- ``kmax28``: tree 0's leaves, every feature on every leaf's path;
- ``kmax136``: seeded 1M x 136 rows (MSLR-WEB30K's width, 1 % NaN) in
  even leaves, every feature on every path (the analyzer's wide entry).

Each commit's output is first held bitwise against the plain version
(``linear_moments_ref``) on the card.  Then, for each shape and commit:
the wrapper's eager time (its sort included), its kernels alone on
precomputed segments eager and as one replay of a graph of 20 calls
(``chip_smoke.eager_and_graph_ms``), the change's whole wrapper in a
graph, the kernels a call and their blocks
(``chip_smoke.kernels_of_call``), the scratch, and the bound
(``chip_smoke.linear_moments_bound``: bytes once each way at 3.35 TB/s
or f64 operations at 67 TFLOP/s, the larger).  ``--parent-root`` is a
checkout of the other commit, imported as
``parent_lightgbm_tpu_torch``; the runs go parent, change, change,
parent (``--turns`` pairs).  Prints one JSON line a shape and run and
needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SHAPES = ("tree0", "skewed", "even", "kmax28", "kmax136")
WIDE = 136


def tree0_inputs(cs):
    """The linear main path's rows (f32 ``[n, 28]`` on the card) and tree
    0's leaves and path features, from one iteration of its training."""
    import lightgbm_tpu_torch as lgt
    x_all, _ = cs.make_higgs_like(cs.TRAIN_ROWS + cs.HOLDOUT_ROWS,
                                  cs.N_FEATURES, seed=0)
    x = x_all[:cs.TRAIN_ROWS]
    y = cs.linear_target(x, 11, 12)
    ds = lgt.Dataset(x, label=y, params={"max_bin": 255,
                                         "linear_tree": True})
    bst = lgt.train(cs.LINEAR_PARAMS, ds, num_boost_round=1, device="cuda")
    leaf, fi = cs.tree_leaf_inputs(bst, 0)
    return bst._inner._raw, leaf, fi


def shape_inputs(cs, name: str, base):
    """(raw, leaf_id, feat_idx) of one shape on the card."""
    import torch
    raw, leaf, fi = base
    n, leaves, dev = raw.shape[0], cs.TRAIN_LEAVES, raw.device
    if name == "tree0":
        return raw, leaf, fi
    if name == "skewed":
        return (raw, cs.skewed_leaves(n, leaves, n // 2, dev),
                cs.path_features(leaves, fi.shape[1], cs.N_FEATURES, dev))
    if name == "even":
        return (raw, cs.skewed_leaves(n, leaves, n // leaves, dev),
                cs.path_features(leaves, fi.shape[1], cs.N_FEATURES, dev))
    if name == "kmax28":
        return raw, leaf, cs.path_features(leaves, cs.N_FEATURES,
                                           cs.N_FEATURES, dev)
    g = np.random.default_rng(33)
    wide = g.normal(size=(n, WIDE)).astype(np.float32)
    wide[g.random(wide.shape) < 0.01] = np.nan
    return (torch.as_tensor(wide, device=dev),
            cs.skewed_leaves(n, leaves, n // leaves, dev),
            cs.path_features(leaves, WIDE, WIDE, dev))


def kernel_call(lk, raw, leaf, g, h, w, fi):
    """() -> one launch of the package ``lk``'s kernels alone, on
    segments (and, for the two-pass kernel, chunk starts and scratch)
    computed once, into an output it returns; and the scratch bytes."""
    import torch
    n, f = raw.shape
    L, kmax = fi.shape
    order, seg = lk.leaf_segments(leaf, L)
    _, e = lk.moment_layout(kmax)
    out = torch.empty((L, e), dtype=torch.float64, device=raw.device)
    lib = lk._lib()
    ptr = [t.data_ptr() for t in (raw, order, seg)]
    if hasattr(lk, "chunk_starts"):
        cfirst = lk.chunk_starts(seg)
        cmax = lk.scratch_chunks(n, L)
        ep, cb = lk.pass_entries(kmax), lk.chunk_batch(kmax, cmax, n)
        scratch = torch.empty((cb, ep), dtype=torch.float64,
                              device=raw.device)
        ghw = torch.empty((3, n), dtype=torch.float32, device=raw.device)
        args = (ptr[0], f, ptr[1], ptr[2], cfirst.data_ptr(), g.data_ptr(),
                h.data_ptr(), w.data_ptr(), fi.data_ptr(), L, kmax, lk.CHUNK,
                n, cmax, scratch.data_ptr(), cb,
                ghw.data_ptr() if ep < e else None, out.data_ptr())
        keep = (order, seg, cfirst, scratch, ghw)
        scratch_bytes = cb * ep * 8 + (ghw.numel() * 4 if ep < e else 0)
    else:
        args = (ptr[0], f, ptr[1], ptr[2], g.data_ptr(), h.data_ptr(),
                w.data_ptr(), fi.data_ptr(), L, kmax, lk.CHUNK,
                out.data_ptr())
        keep = (order, seg)
        scratch_bytes = 0

    def call():
        rc = lib.linear_moments(*args,
                                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"linear_moments failed with CUDA error {rc}")
        return out
    call.keep = keep
    return call, scratch_bytes


def factors(n: int, device):
    """Seeded g, h, w f32 ``[n]`` (``chip_smoke.linear_moments_case``'s)."""
    import torch
    g = np.random.default_rng(29)
    return tuple(torch.tensor(a.astype(np.float32), device=device) for a in (
        g.normal(size=n), g.uniform(0.1, 1.0, size=n), g.random(n) < 0.9))


def run_shape(cs, name: str, args, pkg: str, label: str, turn: int,
              ref, gpu: str) -> dict:
    """One commit's record of one shape (``args`` = raw, leaf_id, g, h, w,
    feat_idx), its outputs first held bitwise against ``ref``."""
    import importlib

    import torch
    lk = importlib.import_module(pkg + ".ops.linear_kernel")
    raw, leaf, fi = args[0], args[1], args[5]
    call, scratch_bytes = kernel_call(lk, *args)
    got = lk.linear_moments(*args)
    alone = call()
    torch.cuda.synchronize()
    rec = {"shape": name, "package": label, "turn": turn,
           "rows": raw.shape[0], "leaves": int(fi.shape[0]),
           "kmax": int(fi.shape[1]),
           "largest_leaf_rows": int(torch.bincount(leaf.long()).max()),
           "bitwise_plain": (cs.torch_equal(got, ref)
                             and cs.torch_equal(alone, ref))}
    if not rec["bitwise_plain"]:
        raise RuntimeError(f"{label} linear_moments differs from the plain "
                           f"version at {name}")
    rec["wrapper_ms"] = cs._time_ms(lambda: lk.linear_moments(*args), 10)
    rec["kernel_ms"], rec["kernel_graph_ms"] = cs.eager_and_graph_ms(call)
    if hasattr(lk, "chunk_starts"):
        rec["wrapper_graph_ms"] = cs.eager_and_graph_ms(
            lambda: lk.linear_moments(*args))[1]
    rec["kernels"] = cs.kernels_of_call(call)
    rec["scratch_bytes"] = scratch_bytes
    rec.update(cs.linear_moments_bound(leaf, fi))
    rec["gpu"] = gpu
    print("profile linear_moments " + json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-root", default=None,
                    help="checkout of the other commit")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--shapes", default=",".join(SHAPES))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("profile_linear needs a GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from lightgbm_tpu_torch.ops.linear_kernel import linear_moments_ref
    from lightgbm_tpu_torch.tools.profile_lib import load_package
    names = {"change": "lightgbm_tpu_torch"}
    if args.parent_root:
        load_package(args.parent_root, "parent_lightgbm_tpu_torch")
        names["parent"] = "parent_lightgbm_tpu_torch"
    gpu = cs._gpu_line()
    pair = ["parent", "change"] if len(names) > 1 else ["change"]
    base = tree0_inputs(cs)
    for name in args.shapes.split(","):
        raw, leaf, fi = shape_inputs(cs, name, base)
        call_args = (raw, leaf, *factors(raw.shape[0], raw.device), fi)
        ref = linear_moments_ref(*call_args)
        for i in range(args.turns):
            for label in (pair if i % 2 == 0 else pair[::-1]):
                run_shape(cs, name, call_args, names[label], label, i, ref,
                          gpu)
        del raw, leaf, fi, call_args, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
