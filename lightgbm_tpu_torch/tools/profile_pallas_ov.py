"""The per-launch cost of a small kernel: the port's counterpart of
``tools/profile_pallas_ov.py`` (its ``_select_kernel``, TPU row T11).

The TPU script runs 254 argmax-and-row-updates of a [255, 20] leaf state
inside one ``fori_loop``, as a Pallas kernel and as XLA ops.  Here the
same 254 updates of the tool's initial state run in five modes, each
timed as one iteration of 254 (the median over ``--reps`` iterations,
CUDA events) and printed in ms and us per update:

- ``select_update`` through its Python wrapper, 254 calls from Python;
- ``select_update_loop(254)``: one ctypes call that launches 254 times;
- one CUDA graph of the 254 wrapper calls, replayed;
- the ``xla_loop`` counterpart in PyTorch ops (argmax, ``index_copy_``
  of the row plus 1), eager;
- the same PyTorch ops captured in one graph.

The first three against each other split a call's cost into the Python
wrapper, the launch and the kernel.  :func:`check` holds the three
kernel modes, from one state, bitwise against 254 calls of the plain
version.

    python -m lightgbm_tpu_torch.tools.profile_pallas_ov [--reps 20]
    python -m lightgbm_tpu_torch.tools.profile_pallas_ov --device cpu

``--device cpu`` runs the plain version and the PyTorch ops on the CPU
(no graphs), timed by the host clock; it needs no GPU.
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Optional

import torch

from ..ops import probes
from . import profile_lib

N = 254           # updates a timed iteration, as the TPU script's N
L = probes.LEAVES


def initial_state(device) -> torch.Tensor:
    """The TPU script's leaf state: zeros with ``[0, 0] = 1``."""
    lf = torch.zeros((L, probes.COLS), dtype=torch.float32, device=device)
    lf[0, 0] = 1.0
    return lf


def torch_ops_step(lf: torch.Tensor) -> None:
    """``xla_loop``'s body in PyTorch ops, in place and without a host
    read: the row of the first maximum of column 0 plus 1."""
    leaf = torch.argmax(lf[:, 0]).reshape(1)
    lf.index_copy_(0, leaf, lf.index_select(0, leaf) + 1.0)


def _updates(step: Callable, lf: torch.Tensor) -> Callable:
    def run():
        for _ in range(N):
            step(lf)
    return run


def run(device="cuda", reps: int = 20, warmup: int = 3,
        log: Optional[Callable] = print) -> dict:
    """Time the five modes on ``device`` (three on the CPU); returns
    {"rows": [{"mode", "ms", "us_per_update"}], "launches", ...}.
    ``launches`` is ``select_update``'s count over the run: a graph's
    launches count at its capture, its replays in ``graph_replays``."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    lf = initial_state(dev)
    rows = []

    def add(mode: str, ms: float):
        rows.append({"mode": mode, "ms": ms, "us_per_update": ms * 1e3 / N})
        if log:
            log(f"{mode:44s}: {ms:9.4f} ms ({ms * 1e3 / N:8.3f} us/update)")

    timer = dict(reps=reps, warmup=warmup)
    eager = _updates(probes.select_update, lf)
    ops = _updates(torch_ops_step, lf)
    before = probes.select_update.launches
    add("select_update, Python wrapper" if cuda
        else "select_update_ref (plain, CPU)",
        profile_lib.median_ms(eager, device=dev, **timer))
    replays = 0
    if cuda:
        add("select_update_loop, one call from C",
            profile_lib.median_ms(lambda: probes.select_update_loop(lf, N),
                                  **timer))
        ms, _ = profile_lib.graph_ms(eager, **timer)
        replays = warmup + reps
        add("CUDA graph of the wrapper calls, replayed", ms)
    add("PyTorch ops (xla_loop), eager",
        profile_lib.median_ms(ops, device=dev, **timer))
    if cuda:
        ms, _ = profile_lib.graph_ms(ops, **timer)
        add("PyTorch ops (xla_loop), CUDA graph", ms)
    launches = probes.select_update.launches - before
    out = {"device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "clock": "CUDA events" if cuda else "host (perf_counter)",
           "updates": N, "reps": reps, "warmup": warmup, "rows": rows,
           "launches": launches, "graph_replays": replays,
           "expected_launches": expected_launches(reps, warmup, cuda)}
    if launches != out["expected_launches"]:
        raise RuntimeError(f"select_update counted {launches} launches, "
                           f"expected {out['expected_launches']}")
    return out


def expected_launches(reps: int, warmup: int, cuda: bool = True) -> int:
    """``select_update``'s count over :func:`run`: the eager and C-loop
    modes launch N a call of ``warmup + reps`` calls; the graph mode
    ``warmup`` calls on the side stream and one capture."""
    return N * (2 * (warmup + reps) + warmup + 1) if cuda else 0


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def check(state: torch.Tensor) -> dict:
    """From ``state`` (f32 [255, 20] on the card): N wrapper calls, one
    ``select_update_loop(N)`` and one replay of a graph of N wrapper
    calls, each held bitwise against N ``select_update_ref`` calls on
    the same device (the leaf state and the last sel)."""
    ref = state.clone()
    for _ in range(N):
        sel_ref = probes.select_update_ref(ref)
    eager = state.clone()
    for _ in range(N):
        sel_e = probes.select_update(eager)
    looped = state.clone()
    sel_l = probes.select_update_loop(looped, N)
    replayed = state.clone()
    last = []

    def body():
        for _ in range(N):
            s = probes.select_update(replayed)
        last.append(s)
    graph = profile_lib.capture(body, warmup=0)
    replayed.copy_(state)
    graph.replay()
    torch.cuda.synchronize()
    rec = {mode: _same_bits(lf, ref) and _same_bits(sel, sel_ref)
           for mode, lf, sel in (("eager", eager, sel_e),
                                 ("c_loop", looped, sel_l),
                                 ("graph", replayed, last[-1]))}
    rec["sel"] = sel_ref[:2].tolist()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_pallas_ov: no CUDA GPU (use --device cpu "
                         "for the plain versions)")
    res = run(args.device, args.reps)
    if args.device == "cuda":
        res["check"] = check(initial_state("cuda"))
        if not all(res["check"][m] for m in ("eager", "c_loop", "graph")):
            raise SystemExit(f"select_update differs from its plain "
                             f"version: {res['check']}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
