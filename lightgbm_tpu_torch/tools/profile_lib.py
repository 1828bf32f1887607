"""Timing helpers of the port's probes, the counterpart of
``tools/profile_lib.py`` (no BENCH record: the port's bench schema is
ROADMAP A7's).

- :func:`median_ms`: the median over ``reps`` timings of one call of
  ``fn``, after ``warmup`` calls: CUDA events around each call on the
  card (the host's cost of the call included when the card waits for
  it), the host clock on the CPU.
- :func:`batch_ms`: CUDA events around ``reps`` calls in a row, over
  ``reps``: the card's time a call when the host keeps ahead of it.
- :func:`capture`: ``fn`` captured into a ``torch.cuda.CUDAGraph`` after
  ``warmup`` calls on a side stream; :func:`graph_ms` times its replays
  with :func:`median_ms`.

A CPU timing is a host measurement and is labelled so by the callers.
"""
from __future__ import annotations

import time
from typing import Callable, Tuple

import torch


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def median_ms(fn: Callable, *, reps: int = 20, warmup: int = 3,
              device="cuda") -> float:
    """Median milliseconds of one call of ``fn`` over ``reps`` calls."""
    cuda = torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn()
    _sync(device)
    times = []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def batch_ms(fn: Callable, *, reps: int = 20, warmup: int = 3) -> float:
    """Milliseconds a call of ``fn`` over ``reps`` calls in a row on the
    card (CUDA events around the whole run)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def capture(fn: Callable, *, warmup: int = 3) -> torch.cuda.CUDAGraph:
    """``fn`` captured into a CUDA graph, after ``warmup`` calls on a side
    stream (PyTorch's recipe: the allocator's pool settles first)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    return graph


def graph_ms(fn: Callable, *, reps: int = 20,
             warmup: int = 3) -> Tuple[float, torch.cuda.CUDAGraph]:
    """(median milliseconds of one replay, the graph) of ``fn`` captured
    once; the replays are ``warmup + reps``."""
    graph = capture(fn, warmup=warmup)
    return median_ms(graph.replay, reps=reps, warmup=warmup), graph


def load_package(root, alias: str):
    """The ``lightgbm_tpu_torch`` package of the checkout at ``root``,
    imported under the name ``alias`` (its modules import each other
    relatively and build their kernels from their own ``csrc/`` into
    their own ``build/``), so that one process can time two commits."""
    import importlib.util
    import sys
    from pathlib import Path

    pkg_dir = Path(root).resolve() / "lightgbm_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg_dir / "__init__.py",
        submodule_search_locations=[str(pkg_dir)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod
