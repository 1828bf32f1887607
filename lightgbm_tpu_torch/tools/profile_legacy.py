"""The partition-bisection scenarios: the port's counterpart of
``tools/profile_legacy.py`` (TPU rows T1-T8), on the kernels of
``ops/legacy_probes.py``.

    python -m lightgbm_tpu_torch.tools.profile_legacy <scenario> [--device cpu]
        (env: PN, REPS, VAR)

- ``part2``: the three-phase dense partition, n = 2^22 (``real``);
- ``part3``: ``copy`` / ``copy3`` (``block_copy``), ``scan`` / ``scan2``
  / ``full`` (``partition_dense`` with 1, 2, 3 phases), n = 2^20;
- ``part4``: the compaction, ``base`` / ``grid2`` / ``smem`` /
  ``alias2`` / ``nsplit``, n = 2^20;
- ``part5``: ``uncond`` / ``when`` / ``dynoff`` / ``pred``, n = 2^20;
- ``part6``: ``nosmem`` / ``smem`` / ``smemuse`` / ``prefetch``, n = 2^15;
- ``part7``: ``nosmem`` / ``deadsel`` / ``scratchthr`` / ``smem`` (also
  ``noalias``, ``hbmsel`` through VAR), n = 2^15;
- ``part8``: ``nosmem`` / ``deadsel`` / ``smem`` at n = 2^20 and
  ``real``, the three-phase partition;
- ``pool`` / ``pool2``: 254 row updates of a loop-carried buffer in
  PyTorch ops (no kernel: the TPU script's are XLA ops), eager and, on the
  card, as one CUDA graph;
- ``hbm_alias``: ``hbm_alias_step`` once at offsets 12345 -> 54321, eight
  chained steps at the while-loop's offsets (100 i + 7 -> 200 i + 3),
  each checked against numpy, then timed at (0, 0).

Every kernel's output is held bitwise against its plain version on the
same device before it is timed.  A kernel variant prints ms a call,
ns a row, us a 512-row block and us a call: ``eager`` is the median of
``REPS`` calls, each on the scenario's inputs restored beforehand
(CUDA events around the call alone); ``graph`` one replay of a CUDA
graph of ``REPS`` chained calls (each on the last one's output, as the
TPU script's in-jit loops), over ``REPS``.  ``PN`` sets n = 2^PN,
``REPS`` the calls, ``VAR`` the variants.  ``--device cpu`` runs the
plain versions, timed by the host clock, and needs no GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops import legacy_probes as lp
from . import profile_lib

R, C = lp.R, lp.C
POOL_N = 254
PEAK_BYTES_S = 3.35e12        # H100 SXM HBM
# scenario -> (log2 n, rows past n, REPS, default VAR, every known VAR)
SCENARIOS = {
    "part2": (22, 2 * R, 30, ("real",), ("real",)),
    "part3": (20, 2 * R, 30, ("copy", "copy3", "scan", "scan2", "full"),
              ("copy", "copy3", "scan", "scan2", "full")),
    "part4": (20, 2 * R, 30, ("base", "grid2", "smem", "alias2", "nsplit"),
              ("base", "grid2", "smem", "alias2", "nsplit")),
    "part5": (20, 2 * R, 30, ("uncond", "when", "dynoff", "pred"),
              ("uncond", "when", "dynoff", "pred")),
    "part6": (15, 0, 100, ("nosmem", "smem", "smemuse", "prefetch"),
              ("nosmem", "smem", "smemuse", "prefetch")),
    "part7": (15, 0, 100, ("nosmem", "deadsel", "scratchthr", "smem"),
              ("nosmem", "deadsel", "scratchthr", "smem", "noalias",
               "hbmsel")),
    "part8": (20, 0, 20, ("nosmem", "deadsel", "smem", "real"),
              ("nosmem", "deadsel", "smem", "real")),
    "pool": (0, 0, 10, (), ()),
    "pool2": (0, 0, 10, (), ()),
    "hbm_alias": (0, 0, 200, (), ()),
}
# (scenario, VAR) -> (kernel, argument): block_copy's copy3,
# partition_dense's phases, compact's mechanism
CASES = {
    ("part2", "real"): ("partition_dense", 3),
    ("part3", "copy"): ("block_copy", False),
    ("part3", "copy3"): ("block_copy", True),
    ("part3", "scan"): ("partition_dense", 1),
    ("part3", "scan2"): ("partition_dense", 2),
    ("part3", "full"): ("partition_dense", 3),
    ("part4", "base"): ("compact", "nosmem"),
    ("part4", "grid2"): ("compact", "grid2"),
    ("part4", "smem"): ("compact", "smem_full"),
    ("part4", "alias2"): ("compact", "alias2"),
    ("part4", "nsplit"): ("compact", "nsplit"),
    ("part5", "uncond"): ("compact", "selread"),
    ("part5", "when"): ("compact", "when"),
    ("part5", "dynoff"): ("compact", "dynoff"),
    ("part5", "pred"): ("compact", "pred"),
    ("part6", "nosmem"): ("compact", "nosmem"),
    ("part6", "smem"): ("compact", "selread"),
    ("part6", "smemuse"): ("compact", "smemuse"),
    ("part6", "prefetch"): ("compact", "prefetch"),
    ("part7", "nosmem"): ("compact", "nosmem"),
    ("part7", "deadsel"): ("compact", "deadsel"),
    ("part7", "scratchthr"): ("compact", "scratchthr"),
    ("part7", "smem"): ("compact", "smem_thr"),
    ("part7", "noalias"): ("compact", "noalias"),
    ("part7", "hbmsel"): ("compact", "hbmsel"),
    ("part8", "nosmem"): ("compact", "nosmem"),
    ("part8", "deadsel"): ("compact", "deadsel"),
    ("part8", "smem"): ("compact", "smem_thr"),
    ("part8", "real"): ("partition_dense", 3),
}
KERNELS = tuple(f.__name__ for f in lp.COUNTED)
WARMUP = 2


_DRAWN: Dict[int, np.ndarray] = {}      # seed -> the largest rows drawn


def make_rows(n_alloc: int, device, seed: int = 0) -> torch.Tensor:
    """The TPU script's ``_rows``: integers in [0, 256) as f32
    [n_alloc, 128], from ``np.random.default_rng(seed)``, a new tensor.
    The draw is row by row, so a smaller ``n_alloc`` is a prefix of a
    larger one: the largest draw of each seed is kept and sliced."""
    x = _DRAWN.get(seed)
    if x is None or x.shape[0] < n_alloc:
        rng = np.random.default_rng(seed)
        x = _DRAWN[seed] = rng.integers(
            0, 256, size=(n_alloc, C)).astype(np.float32)
    return torch.from_numpy(x[:n_alloc]).to(device, copy=True)


ADVERSARIAL = ("late", "early", "one_per_block", "whole", "whole_plus1",
               "whole_minus1")


def adversarial_rows(kind: str, n: int, n_alloc: int, device,
                     seed: int = 0) -> torch.Tensor:
    """:func:`make_rows` with column 3 of the first n rows set so that
    ``col <= 127`` keeps: nothing in the first 512-row block and every
    row after it (``late``: every kept row moves down into blocks read
    before it), the first block only (``early``), the last row of each
    block (``one_per_block``), or T = 512 k (``whole``, k = n / 1024),
    512 k + 1 or 512 k - 1 rows at seeded places."""
    rows = make_rows(n_alloc, "cpu", seed)
    keep = torch.zeros(n, dtype=torch.bool)
    if kind == "late":
        keep[R:] = True
    elif kind == "early":
        keep[:R] = True
    elif kind == "one_per_block":
        keep[R - 1::R] = True
    else:
        t = n // 2 + {"whole": 0, "whole_plus1": 1, "whole_minus1": -1}[kind]
        perm = np.random.default_rng(seed + 1).permutation(n)[:t]
        keep[torch.from_numpy(perm)] = True
    rows[:n, 3] = torch.where(keep, 0.0, 200.0)
    return rows.to(device)


def script_sel(n: int) -> list:
    """The script's split descriptor: the first n rows, column 3 <= 127."""
    return [0, n, 3, 127, 1, 0, -1, 0]


def n_alloc_of(scenario: str, var: str, n: int) -> int:
    """Rows of the matrix: n plus the scenario's two spare blocks (part8
    gives them to ``real`` only)."""
    extra = SCENARIOS[scenario][1]
    return n + (2 * R if (scenario, var) == ("part8", "real") else extra)


class Inputs:
    """A case's inputs: the pristine rows, the working rows and scratch,
    sel on the device and on the host."""

    def __init__(self, rows: torch.Tensor, sel, n: int,
                 scratch_fill: float = 0.0):
        self.pristine = rows
        self.n = n
        self.fill = scratch_fill
        self.sel_host = [int(v) for v in sel]
        self.sel = torch.tensor(self.sel_host, dtype=torch.int32,
                                device=rows.device)
        self.rows = rows.clone()
        self.scratch = torch.full_like(rows, scratch_fill)

    def reset(self) -> None:
        self.rows.copy_(self.pristine)
        self.scratch.fill_(self.fill)


def apply(kernel: str, arg, inp: Inputs, plain: bool = False) -> dict:
    """One call of ``kernel`` (or its plain version) on ``inp``'s working
    buffers: {"rows", "scratch", "out", "nsplit", ...}."""
    nb = inp.n // R
    res = {"rows": inp.rows, "scratch": inp.scratch, "out": None,
           "nsplit": None}
    if kernel == "block_copy":
        (lp.block_copy_ref if plain else lp.block_copy)(
            inp.rows, inp.scratch, nb, arg)
    elif kernel == "partition_dense":
        res["nsplit"] = (lp.partition_dense_ref if plain
                         else lp.partition_dense)(arg, inp.rows, inp.scratch,
                                                  inp.sel_host)
    elif plain:
        out, res["nsplit"], res["written"] = lp.compact_ref(
            arg, inp.rows, nb, inp.sel_host, inp.scratch)
        res["out"] = out
    else:
        sel = inp.sel_host if arg in lp.BY_VALUE else inp.sel
        res["out"], res["nsplit"] = lp.compact(arg, inp.rows, nb, sel,
                                               inp.scratch)
    return res


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def check(kernel: str, arg, inp: Inputs) -> dict:
    """``kernel`` and its plain version, each on freshly restored inputs
    on the same device, compared bitwise: rows, scratch and nsplit, and
    for ``noalias`` the output's written rows (the rest is undefined).
    Returns {"ok", "written", "nleft", ...}; leaves the inputs restored."""
    inp.reset()
    got = apply(kernel, arg, inp)
    got = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
           for k, v in got.items()}
    inp.reset()
    want = apply(kernel, arg, inp, plain=True)
    same = {}
    for key in ("rows", "scratch", "nsplit"):
        if want[key] is not None:
            same[key] = torch.equal(_bits(got[key]), _bits(want[key]))
    if kernel == "compact" and arg == "noalias":
        w = want["written"]
        same["out"] = torch.equal(_bits(got["out"][:w]),
                                  _bits(want["out"][:w]))
    rec = {"ok": all(same.values()), "same": same}
    if "written" in want:
        rec["written"] = want["written"]
    if want["nsplit"] is not None:
        rec["nsplit"] = int(want["nsplit"][0])
    inp.reset()
    return rec


def nleft(inp: Inputs) -> int:
    """Left rows of the descriptor's segment (``go_left``)."""
    s0, cnt = inp.sel_host[0], inp.sel_host[1]
    col = lp.column(inp.pristine, s0, s0 + cnt, inp.sel_host[2])
    return int(lp.go_left(col, inp.sel_host).sum())


def bound_bytes(kernel: str, arg, inp: Inputs, rec: dict) -> int:
    """Bytes the function must move on these inputs, each input byte
    read once and each output byte written once: the copied rows; the
    split column (4 B a row of the region) and each row the function
    moves, read and written (with its zeroed flush rows and nsplit); the
    1024-row window each way."""
    row = C * 4
    n_alloc = inp.pristine.shape[0]
    if kernel == "block_copy":
        return 2 * (inp.n // R) * R * row
    if kernel == "partition_dense":
        s0, cnt = inp.sel_host[0], inp.sel_host[1]
        nl = nleft(inp)
        if arg == 1:
            moved, zero_hi = nl, lp._flush_end(s0, nl)
            zero_lo = s0 + nl
        else:
            moved, zero_lo = cnt, s0 + cnt
            zero_hi = max(lp._flush_end(s0, nl),
                          lp._flush_end(s0 + nl, cnt - nl))
        zeros = 0 if arg == 3 else max(min(zero_hi, n_alloc) - zero_lo, 0)
        return 4 * cnt + 2 * moved * row + zeros * row + 4
    if kernel == "hbm_alias_step":
        return 2 * lp.ALIAS_ROWS * row
    v = inp.sel_host
    blocks = -(-v[1] // R) if arg in lp.BOUND_LIVE else inp.n // R
    region = min(blocks * R, n_alloc)
    total = rec.get("nsplit", rec["written"])
    zeros = 0
    if arg == "nsplit":
        s0 = v[0]
        zeros = max(min(lp._flush_end(s0, total), n_alloc) - s0 - total, 0)
    return 4 * region + 2 * rec["written"] * row + zeros * row + (
        4 if arg == "nsplit" else 0)


def _timed(fn: Callable, reset: Callable, reps: int, device) -> float:
    """Median ms of ``fn`` over ``reps`` calls after ``WARMUP``, each on
    inputs ``reset`` restored outside the timing."""
    cuda = torch.device(device).type == "cuda"
    times = []
    for i in range(WARMUP + reps):
        reset()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            ms = start.elapsed_time(stop)
        else:
            t0 = time.perf_counter()
            fn()
            ms = (time.perf_counter() - t0) * 1e3
        if i >= WARMUP:
            times.append(ms)
    times.sort()
    return times[len(times) // 2]


def _graph_ms(fn: Callable, reps: int) -> float:
    """ms a call of one replay of a graph of ``reps`` chained calls."""
    ms, _ = profile_lib.graph_ms(lambda: [fn() for _ in range(reps)],
                                 reps=3, warmup=1)
    return ms / reps


def _launches() -> Dict[str, int]:
    return {f.__name__: f.launches for f in lp.COUNTED}


def _line(var: str, rec: dict, log) -> None:
    if not log:
        return
    g = (f"  graph {rec['graph_ms']:9.4f} ms {rec['graph_ms'] * 1e3:9.2f} "
         f"us/call  bound {rec['bound_ms']:.5f} ms" if "graph_ms" in rec
         else "")
    log(f"{var:10s}: {rec['ms']:9.4f} ms  {rec['ns_per_row']:7.3f} ns/row  "
        f"{rec['us_per_block']:7.3f} us/blk  {rec['us_per_call']:9.2f} "
        f"us/call{g}")


def run_variant(scenario: str, var: str, inp: Inputs, reps: int,
                log: Optional[Callable] = print) -> dict:
    """Check, then time, one variant of a kernel scenario on ``inp``."""
    kernel, arg = CASES[(scenario, var)]
    dev = inp.pristine.device
    cuda = dev.type == "cuda"
    before = _launches()
    chk = check(kernel, arg, inp)
    if not chk["ok"]:
        raise RuntimeError(f"{scenario} {var}: {kernel}<{arg}> differs from "
                           f"its plain version: {chk}")
    fn = lambda: apply(kernel, arg, inp)  # noqa: E731
    ms = _timed(fn, inp.reset, reps, dev)
    steps = (inp.n // R) * (3 if kernel == "partition_dense" and arg == 3
                            else 1)
    rec = {"scenario": scenario, "variant": var, "kernel": kernel,
           "arg": arg, "n": inp.n, "n_alloc": inp.pristine.shape[0],
           "blocks": inp.n // R, "ms": ms, "ns_per_row": ms * 1e6 / inp.n,
           "us_per_block": ms * 1e3 / steps, "us_per_call": ms * 1e3,
           **{k: chk[k] for k in ("written", "nsplit") if k in chk}}
    if cuda:
        inp.reset()
        rec["graph_ms"] = _graph_ms(fn, reps)
        inp.reset()
    rec["bound_bytes"] = bound_bytes(kernel, arg, inp, rec)
    rec["bound_ms"] = rec["bound_bytes"] / PEAK_BYTES_S * 1e3
    after = _launches()
    rec["launches"] = after[kernel] - before[kernel]
    _line(var, rec, log)
    return rec


def _kernel_scenario(scenario: str, device, n: int, reps: int, variants,
                     log) -> list:
    out = []
    for var in variants:
        inp = Inputs(make_rows(n_alloc_of(scenario, var, n), device),
                     script_sel(n), n)
        out.append(run_variant(scenario, var, inp, reps, log))
        del inp
    return out


# -- pool / pool2: PyTorch ops, no kernel ----------------------------------------
def pool_steps(kind: str, st: torch.Tensor, bb: torch.Tensor,
               L: Optional[int] = None) -> Callable:
    """254 steps of a row update of ``bb`` at the leaf ``argmax(st[:,
    0])`` (``% L`` in pool2), ``st[leaf, 0] += 1``, in place and without
    a host read.  ``dus_4d`` runs the same ops as ``read_write_4d`` (no
    separate dynamic-slice op in PyTorch); ``two_rows_4d`` writes row
    leaf + 1, which the script's state keeps inside the buffer."""
    one = torch.ones(1, dtype=st.dtype, device=st.device)
    row4 = torch.ones(bb.shape[1:], dtype=bb.dtype, device=bb.device)

    def step():
        if kind == "static_row_4d":
            bb[0].add_(1.0)
            st[0:1, 0].add_(1.0)
            return
        leaf = torch.argmax(st[:, 0]).reshape(1)
        if L is not None:
            leaf = leaf % L
        if kind == "write_only_4d":
            bb.index_copy_(0, leaf, row4[None])
        elif kind == "two_rows_4d":
            r = bb.index_select(0, leaf)
            bb.index_copy_(0, leaf, r * 0.5)
            bb.index_copy_(0, leaf + 1, r * 2.0)
        else:
            bb.index_copy_(0, leaf, bb.index_select(0, leaf) + 1.0)
        st[:, 0].index_add_(0, leaf, one)

    def run():
        for _ in range(POOL_N):
            step()
    return run


POOL = (("write-only .at[leaf].set  4D", "write_only_4d", (32, 256, 3)),
        ("read+write .at[leaf]      4D", "read_write_4d", (32, 256, 3)),
        ("read + 2 row writes       4D", "two_rows_4d", (32, 256, 3)),
        ("dynamic_slice + DUS       4D", "dus_4d", (32, 256, 3)),
        ("read+write .at[leaf]      2D", "read_write_2d", (32 * 256 * 3,)),
        ("static index 0 row        4D", "static_row_4d", (32, 256, 3)))
POOL2_SIZES = (15, 63, 255, 511)


def _state(device) -> torch.Tensor:
    st = torch.zeros((255, 10), dtype=torch.float32, device=device)
    st[0, 0] = 1.0
    return st


def _pool_time(fn: Callable, device, reps: int) -> dict:
    rec = {"ms": profile_lib.median_ms(fn, reps=reps, warmup=1,
                                       device=device)}
    if torch.device(device).type == "cuda":
        rec["graph_ms"], _ = profile_lib.graph_ms(fn, reps=reps, warmup=1)
    return rec


def pool(device, reps: int, log) -> list:
    out = []
    for label, kind, shape in POOL:
        bb = torch.zeros((255,) + shape, dtype=torch.float32, device=device)
        rec = {"label": label, "kind": kind,
               **_pool_time(pool_steps(kind, _state(device), bb), device,
                            reps)}
        rec["us_per_iter"] = rec["ms"] * 1e3 / POOL_N
        out.append(rec)
        if log:
            g = (f"  graph {rec['graph_ms']:7.2f} ms" if "graph_ms" in rec
                 else "")
            log(f"{label:40s}: {rec['ms']:7.2f} ms "
                f"({rec['us_per_iter']:6.1f} us/iter){g}")
    return out


def pool2(device, reps: int, log) -> list:
    out = []
    cuda = torch.device(device).type == "cuda"
    for L in POOL2_SIZES:
        bb = torch.zeros((L, 32, 256, 3), dtype=torch.float32, device=device)
        rec = {"L": L, "mb": bb.numel() * 4 / 1e6,
               **_pool_time(pool_steps("read_write_4d", _state(device), bb,
                                       L), device, reps)}
        rec["us_per_iter"] = rec["ms"] * 1e3 / POOL_N
        if cuda:     # one full copy of the buffer, read and written
            copy_us = 2 * rec["mb"] * 1e6 / PEAK_BYTES_S * 1e6
            rec["implied_full_copies"] = rec["us_per_iter"] / copy_us
        out.append(rec)
        if log:
            implied = (f" -> implied {rec['implied_full_copies']:5.2f}x full "
                       f"copies" if cuda else "")
            log(f"L={L:4d} ({rec['mb']:6.1f} MB): {rec['us_per_iter']:7.1f} "
                f"us/iter{implied}")
    return out


# -- hbm_alias -------------------------------------------------------------------
CHAIN = [(i * 100 + 7, i * 200 + 3) for i in range(8)]


def alias_matrix() -> np.ndarray:
    """The script's comb: arange(65536 * 128) as f32 [65536, 128]."""
    return np.arange(lp.ALIAS_N * C, dtype=np.float32).reshape(lp.ALIAS_N, C)


def alias_steps_numpy(x: np.ndarray, steps) -> np.ndarray:
    """The numpy recurrence of ``steps`` [(src, dst)] on a copy of x."""
    want = x.copy()
    for src, dst in steps:
        want[dst:dst + lp.ALIAS_ROWS] = want[src:src + lp.ALIAS_ROWS] + 1.0
    return want


def alias_check(steps, device) -> bool:
    """``hbm_alias_step`` over ``steps`` on the script's comb, bitwise the
    numpy recurrence and (on the card) the plain version."""
    x = alias_matrix()
    comb = torch.tensor(x, device=device)
    ref = comb.clone()
    for src, dst in steps:
        lp.hbm_alias_step(comb, src, dst)
        lp.hbm_alias_step_ref(ref, src, dst)
    want = torch.from_numpy(alias_steps_numpy(x, steps)).to(device)
    return torch.equal(comb, want) and torch.equal(ref, want)


def hbm_alias(device, reps: int, log) -> dict:
    ok1 = alias_check([(12345, 54321)], device)
    ok2 = alias_check(CHAIN, device)
    if log:
        log(f"single call, unaligned dynamic offsets: {'OK' if ok1 else 'FAIL'}")
        log(f"8 chained steps at the while-loop's offsets: "
            f"{'OK' if ok2 else 'FAIL'}")
    comb = torch.from_numpy(alias_matrix()).to(device)
    fn = lambda: lp.hbm_alias_step(comb, 0, 0)  # noqa: E731
    rec = {"single_ok": ok1, "chain_ok": ok2,
           "ms": profile_lib.median_ms(fn, reps=reps, warmup=WARMUP,
                                       device=device)}
    if torch.device(device).type == "cuda":
        rec["graph_ms"] = _graph_ms(fn, reps)
    rec["bound_bytes"] = 2 * lp.ALIAS_ROWS * C * 4
    rec["bound_ms"] = rec["bound_bytes"] / PEAK_BYTES_S * 1e3
    if log:
        gbs = rec["bound_bytes"] / (rec["ms"] * 1e-3) / 1e9
        g = (f"; graph {rec['graph_ms'] * 1e3:.2f} us" if "graph_ms" in rec
             else "")
        log(f"per-call {rec['ms'] * 1e3:.1f} us for {lp.ALIAS_ROWS}x{C} f32 "
            f"round trip ({gbs:.1f} GB/s incl. dispatch){g}")
    if not (ok1 and ok2):
        raise RuntimeError("hbm_alias_step differs from the numpy "
                           "recurrence")
    return rec


def expected_launches(scenario: str, variants, reps: int,
                      device="cuda") -> Dict[str, int]:
    """Each kernel's launches over :func:`run`: a kernel variant makes one
    checked call, ``WARMUP + reps`` timed calls and, on the card, a graph
    of ``reps`` chained calls captured after one run on a side stream;
    ``hbm_alias`` one call, eight chained ones, ``WARMUP + reps`` timed
    calls and the graph.  None on the CPU."""
    out = dict.fromkeys(KERNELS, 0)
    if torch.device(device).type != "cuda":
        return out
    graph = 2 * reps
    if scenario == "hbm_alias":
        out["hbm_alias_step"] = 1 + len(CHAIN) + WARMUP + reps + graph
    for var in variants:
        if (scenario, var) in CASES:
            out[CASES[(scenario, var)][0]] += 1 + WARMUP + reps + graph
    return out


def run(scenario: str, device="cuda", n: Optional[int] = None,
        reps: Optional[int] = None, variants=None,
        log: Optional[Callable] = print) -> dict:
    """Run ``scenario`` on ``device``; returns {"rows": [...],
    "launches", "expected_launches", ...}.  The launches are counted
    over the run and held against :func:`expected_launches`."""
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r}; known "
                         f"{tuple(SCENARIOS)}")
    pn, _, reps_default, var_default, known = SCENARIOS[scenario]
    n = (1 << pn) if n is None else n
    reps = reps_default if reps is None else reps
    variants = tuple(var_default if variants is None else variants)
    unknown = [v for v in variants if v not in known]
    if unknown:
        raise ValueError(f"{scenario}: unknown VAR {unknown}; known {known}")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    before = _launches()
    if scenario == "pool":
        rows = pool(dev, reps, log)
    elif scenario == "pool2":
        rows = pool2(dev, reps, log)
    elif scenario == "hbm_alias":
        rows = [hbm_alias(dev, reps, log)]
    else:
        rows = _kernel_scenario(scenario, dev, n, reps, variants, log)
    if cuda:
        torch.cuda.synchronize()
    after = _launches()
    res = {"scenario": scenario,
           "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "clock": "CUDA events" if cuda else "host (perf_counter)",
           "n": n, "reps": reps, "variants": list(variants), "rows": rows,
           "launches": {k: after[k] - before[k] for k in after},
           "expected_launches": expected_launches(scenario, variants, reps,
                                                  dev)}
    if res["launches"] != res["expected_launches"]:
        raise RuntimeError(f"{scenario} counted {res['launches']} launches, "
                           f"expected {res['expected_launches']}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenario", choices=tuple(SCENARIOS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_legacy: no CUDA GPU (use --device cpu for "
                         "the plain versions)")
    n = 1 << int(os.environ["PN"]) if "PN" in os.environ else None
    reps = int(os.environ["REPS"]) if "REPS" in os.environ else None
    variants = (tuple(os.environ["VAR"].split(","))
                if "VAR" in os.environ else None)
    try:
        res = run(args.scenario, args.device, n, reps, variants)
    except ValueError as e:
        raise SystemExit(f"profile_legacy: {e}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
