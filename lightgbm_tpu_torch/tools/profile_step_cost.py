"""What a block, a shared-memory access, an asynchronous copy and a
barrier wait cost on the card: the port's counterpart of
``tools/profile_step_cost.py`` (TPU rows T10 and T9).

The TPU script times a Mosaic grid of ``n / 512`` steps over rows f32
[n, 128] in five variants.  Here one block stands for one step
(``ops/probes.py``):

- ``empty``:  the output is ``sel[0]``, written once;
- ``smemrw``: + three scalar reads and writes of shared memory a block;
- ``dma_nw``: + each block's 256 KiB tile copied into shared memory in
  four 64 KiB bulk copies, each waited for before the next;
- ``dma_bs``: ``stream_tiles``, the tile streamed with two copies in
  flight (the BlockSpec auto-pipeline's counterpart);
- ``waits``:  + one mbarrier arrive and wait a block.

For each it prints ms a call and us a block: ``eager`` is CUDA events
around ``REPS`` launches in a row, ``graph`` one replay of a graph of
``REPS`` launches over ``REPS``; ``empty`` also at one block (n = 512),
the floor of one launch.  Each output is held against its plain
version, exactly.  ``torch.sum(rows)`` reads the same bytes as
``dma_nw`` and ``dma_bs`` (not the same function).

    PN=20 REPS=30 VAR=empty,smemrw,dma_nw,dma_bs,waits \\
        python -m lightgbm_tpu_torch.tools.profile_step_cost [--device cpu]

``PN`` sets n = 2^PN, ``REPS`` the launches a timing, ``VAR`` the
variants.  ``--device cpu`` runs the plain versions, timed by the host
clock, and needs no GPU.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..ops import probes
from . import profile_lib

VARIANTS = ("empty", "smemrw", "dma_nw", "dma_bs", "waits")


def make_rows(n: int, device, seed: int = 0) -> torch.Tensor:
    """The TPU script's rows: integers in [0, 256) as f32 [n, 128],
    from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=(n, probes.TILE_COLS)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def kernel(var: str) -> Callable:
    """The wrapper of ``var``: ``fn(rows, sel=None) -> i32 [1]`` (``sel``
    i32 [2], default (0, n); ``dma_bs`` reads none)."""
    if var == "dma_bs":
        return lambda rows, sel=None: probes.stream_tiles(rows)
    return functools.partial(probes.step_cost, var)


def plain(var: str) -> Callable:
    """The plain version of ``var``, called as :func:`kernel`'s."""
    if var == "dma_bs":
        return lambda rows, sel=None: probes.stream_tiles_ref(rows)
    return functools.partial(probes.step_cost_ref, var)


def expected_launches(variants, reps: int, warmup: int = 3) -> int:
    """Launches of the kernels over :func:`run` on the card: per
    variant one checked call, ``warmup + reps`` eager calls, and a graph
    of ``reps`` launches captured after one run of them on a side
    stream; ``empty`` the same again at one block."""
    per = 1 + (warmup + reps) + 2 * reps
    return per * (len(variants) + ("empty" in variants))


def run(device="cuda", n: int = 1 << 20, reps: int = 30,
        variants=VARIANTS, warmup: int = 3,
        log: Optional[Callable] = print) -> dict:
    """Check and time each variant on ``device``; returns {"rows": [...],
    "launches": {"step_cost": .., "stream_tiles": ..}, ...}."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    rows_all = make_rows(n, dev)
    before = (probes.step_cost.launches, probes.stream_tiles.launches)
    out_rows = []
    cases = [(v, n) for v in variants]
    if "empty" in variants:
        cases.append(("empty", probes.TILE_ROWS))
    for var, m in cases:
        rows = rows_all[:m]
        # made once, as the TPU script's jit folds its constant sel
        sel = torch.tensor([0, m], dtype=torch.int32, device=dev)
        fn = functools.partial(kernel(var), rows, sel)
        case_before = probes.step_cost.launches + probes.stream_tiles.launches
        got, want = fn(), plain(var)(rows, sel)
        if not torch.equal(got, want):
            raise RuntimeError(f"{var} at n={m} gave {got.tolist()}, its "
                               f"plain version {want.tolist()}")
        nb = m // probes.TILE_ROWS
        rec = {"variant": var, "n": m, "blocks": nb,
               "out": int(got.item())}
        if cuda:
            rec["ms"] = profile_lib.batch_ms(fn, reps=reps, warmup=warmup)
            g_ms, _ = profile_lib.graph_ms(
                lambda: [fn() for _ in range(reps)], reps=5, warmup=1)
            rec["graph_ms"] = g_ms / reps
        else:
            rec["ms"] = profile_lib.median_ms(fn, reps=reps, warmup=warmup,
                                              device=dev)
        rec["us_per_block"] = rec["ms"] * 1e3 / nb
        rec["launches"] = (probes.step_cost.launches
                           + probes.stream_tiles.launches - case_before)
        out_rows.append(rec)
        if log:
            g = (f"  graph {rec['graph_ms']:8.4f} ms/call "
                 f"{rec['graph_ms'] * 1e3 / nb:7.4f} us/block"
                 if cuda else "")
            log(f"{var:7s} n={m:<8d}: {rec['ms']:8.4f} ms/call "
                f"{rec['us_per_block']:7.4f} us/block{g}")
    res = {"device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "clock": "CUDA events" if cuda else "host (perf_counter)",
           "n": n, "reps": reps, "rows": out_rows,
           "launches": {
               "step_cost": probes.step_cost.launches - before[0],
               "stream_tiles": probes.stream_tiles.launches - before[1]}}
    if cuda:
        res["torch_sum_ms"] = profile_lib.batch_ms(
            lambda: torch.sum(rows_all), reps=reps, warmup=warmup)
        if log:
            log(f"torch.sum(rows), the same {rows_all.numel() * 4} bytes "
                f"(not the same function): {res['torch_sum_ms']:8.4f} ms")
        want = {"step_cost": expected_launches(
                    [v for v in variants if v != "dma_bs"], reps, warmup),
                "stream_tiles": expected_launches(
                    [v for v in variants if v == "dma_bs"], reps, warmup)}
        if res["launches"] != want:
            raise RuntimeError(f"the probes counted {res['launches']} "
                               f"launches, expected {want}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_step_cost: no CUDA GPU (use --device cpu "
                         "for the plain versions)")
    n = 1 << int(os.environ.get("PN", 20))
    reps = int(os.environ.get("REPS", 30))
    variants = tuple(os.environ.get("VAR", ",".join(VARIANTS)).split(","))
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        raise SystemExit(f"profile_step_cost: unknown VAR {unknown}; known "
                         f"{VARIANTS}")
    print(json.dumps(run(args.device, n, reps, variants)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
