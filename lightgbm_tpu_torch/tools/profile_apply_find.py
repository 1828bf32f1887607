"""Times of the split tail on the card: ``apply_find_pool`` (the pool
entry) and ``apply_find`` (the plain-pool entry) at given shapes, eager
(20 calls back to back, CUDA events) and as one replay of a CUDA graph
of 20 calls, beside the byte bound, in each mode: ``plain`` (the
unconstrained instantiation) and ``mono`` (monotone constraints, the
basic method with ``monotone_penalty`` 2.0: :func:`synthetic_split`'s
``mono``), in turns.  Each case's state rows and pool rows are held
bitwise against the plain version on CPU copies before anything is
timed.

    python lightgbm_tpu_torch/tools/profile_apply_find.py \\
        [--shapes 28x256,28x1024,136x256] [--modes plain,mono] \\
        [--package-root DIR] [--variants]

``--variants`` times, instead, the pool entry at each shape on other
cluster sizes (:func:`variant_geometries`: 1 to 16 blocks), each held
bitwise against the plain version first, in a replayed graph of 20
calls.

Inputs: :func:`synthetic_split`, a seeded split of 1,000,000 rows at
the shape (per-bin row counts drawn from a multinomial, the left child
the smaller, every feature's sums equal, 30 % of features with a NaN
bin, one categorical feature), so a tail's work is that of a real split
of that shape.  Run by path, the script imports the package from
``--package-root`` (default: the checkout it lies in), so one call can
time two commits in turns: unpack the other commit there with ``git
archive``; a shape the package does not support, or a mode it does not
have, is reported, not timed.  Prints one JSON line a case and needs a
GPU.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import NamedTuple, Optional, Sequence

import numpy as np

SHAPES = "28x256,28x1024,136x256"
MODES = "plain,mono"
MONO_PENALTY = 2.0
N_ROWS = 1_000_000
LEAVES = 255
CALLS = 20
PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3


class TailCase(NamedTuple):
    """One split's inputs to the tail, in the wrappers' argument order
    after the histograms: ``entry(h_a, h_b, *case.args())``."""
    h_a: object
    h_b: object
    nleft: object
    st: object
    fc: object
    fmask: object
    hp: object
    max_depth: int
    at: object

    def args(self) -> tuple:
        return (self.nleft, self.st, self.fc, self.fmask, self.hp,
                self.max_depth, self.at)

    def to(self, device) -> "TailCase":
        from lightgbm_tpu_torch.ops.apply_find import (FinderConsts,
                                                       TreeState)
        return self._replace(
            h_a=self.h_a.to(device), h_b=self.h_b.to(device),
            nleft=self.nleft.to(device),
            st=TreeState(*(a.to(device) for a in self.st)),
            fc=FinderConsts(*(a.to(device) for a in self.fc)),
            fmask=self.fmask.to(device))

    def clone(self) -> "TailCase":
        from lightgbm_tpu_torch.ops.apply_find import TreeState
        return self._replace(st=TreeState(*(a.clone() for a in self.st)))


def synthetic_split(f: int, b: int, *, seed: int = 0, cnt: int = N_ROWS,
                    leaves: int = LEAVES, ties: Sequence[int] = (),
                    strong: Sequence[int] = (), mono: bool = False,
                    signs: Optional[Sequence[int]] = None,
                    penalty: float = MONO_PENALTY, depth: float = 2.0,
                    bounds: tuple = (-np.inf, np.inf),
                    device="cpu") -> TailCase:
    """A seeded split of ``cnt`` rows over ``f`` features of ``b`` padded
    bins: the left child (a third of the rows, the smaller) in leaf 3,
    the right child new in leaf 7, node 6.  Each child's per-bin row
    counts are multinomial over the feature's bins; hessians 0.2 a row;
    gradients noise plus, for the ``strong`` features, a step at the
    middle bin, every feature's gradient sum made equal.  Each feature
    ``j`` of ``ties`` is copied into ``j + 1`` (bins, metadata and both
    children), so the two give equal keys.  ``h_a`` is the smaller
    child's histogram, ``h_b`` a copy (the unfused route's pair).

    ``mono``: monotone constraints, the basic method with ``penalty``:
    each feature's sign from ``signs`` (default: seeded, -1, 0 or +1,
    feature 0, the parent's winner, +1), the parent leaf at ``depth``
    (2: the children's factor 0.75 at the penalty 2.0) with the output
    ``bounds``."""
    import torch

    from lightgbm_tpu_torch.ops.apply_find import (FinderConsts, SplitAt,
                                                   TreeState,
                                                   build_finder_consts)
    from lightgbm_tpu_torch.ops.split import SplitHyperParams
    g = np.random.default_rng(seed)
    nb = g.integers(max(2, b // 2), b + 1, size=f)
    has_nan = g.random(f) < 0.3
    is_cat = np.zeros(f, bool)
    plain = [j for j in range(f) if j not in strong and j not in ties
             and j - 1 not in ties]
    if len(plain) > 1:
        cat = plain[-1]
        is_cat[cat] = True
        nb[cat] = min(nb[cat], 8)
    for j in ties:
        nb[j + 1], has_nan[j + 1], is_cat[j + 1] = nb[j], has_nan[j], is_cat[j]
    nl = cnt // 3

    def child(n: int, sign: float) -> np.ndarray:
        h = np.zeros((f, b, 2), np.float64)
        for j in range(f):
            p = g.random(nb[j]) + 0.05
            rows = g.multinomial(n, p / p.sum()).astype(np.float64)
            grad = g.normal(size=nb[j]) * np.sqrt(rows) * 0.5
            if j in strong:
                grad += np.where(np.arange(nb[j]) < nb[j] // 2, -1.0,
                                 1.0) * rows * 0.05 * sign
            h[j, :nb[j], 0] = grad
            h[j, :nb[j], 1] = rows * 0.2
        # every feature's gradient sum equal to feature 0's, the
        # difference spread over the rows
        gap = h[0, :, 0].sum() - h[:, :, 0].sum(axis=1)
        h[:, :, 0] += gap[:, None] * h[:, :, 1] / (0.2 * n)
        for j in ties:
            h[j + 1] = h[j]
        return h.astype(np.float32)

    hl, hr = child(nl, 1.0), child(cnt - nl, -1.0)
    parent = hl + hr
    leaf, right, node = 3, 7, 6
    pool = g.normal(size=(leaves, f, b, 2)).astype(np.float32)
    pool[leaf] = parent
    best = g.normal(size=(leaves, 10)).astype(np.float32)
    lstate = g.normal(size=(leaves, 8)).astype(np.float32)
    lg = np.float32(hl[0, :, 0].astype(np.float64).sum())
    lh = np.float32(hl[0, :, 1].astype(np.float64).sum())
    pg = np.float32(parent[0, :, 0].astype(np.float64).sum())
    ph = np.float32(parent[0, :, 1].astype(np.float64).sum())
    best[leaf] = [1.0, 0, 1, 0, 0, lg, lh, nl, -0.01, 0.02]
    lstate[leaf] = [pg, ph, cnt, depth, 1, bounds[0], bounds[1], 0.005]
    seg = g.integers(0, cnt, size=(leaves, 2)).astype(np.int32)
    seg[leaf] = (12_345, cnt)
    st = TreeState(
        torch.from_numpy(pool), torch.from_numpy(best),
        torch.from_numpy(lstate),
        torch.from_numpy(g.normal(size=(leaves - 1, 4)).astype(np.float32)),
        torch.from_numpy(seg))
    # a package without monotone constraints (an earlier commit timed in
    # turns) is called as it was
    hp, kw = SplitHyperParams(), {}
    if mono:
        from lightgbm_tpu_torch.ops.split import monotone_penalty_table
        sign = (np.asarray(signs, np.int32) if signs is not None
                else g.integers(-1, 2, size=f).astype(np.int32))
        if signs is None:
            sign[0] = 1
        hp = SplitHyperParams(use_monotone=True, monotone_penalty=penalty)
        kw = {"monotone": torch.from_numpy(sign),
              "penalty": torch.from_numpy(
                  monotone_penalty_table(penalty, leaves + 1))}
    fc = build_finder_consts(torch.from_numpy(nb.astype(np.int32)),
                             torch.from_numpy(has_nan),
                             torch.from_numpy(is_cat), b, **kw)
    case = TailCase(torch.from_numpy(hl), torch.from_numpy(hl.copy()),
                    torch.tensor([nl], dtype=torch.int32), st,
                    FinderConsts(*fc), torch.ones(f, dtype=torch.float32),
                    hp, -1, SplitAt(leaf, right, node, 12_345, cnt))
    return case.to(device)


def bound_ms(f: int, b: int, pool: bool) -> float:
    """The pool entry reads the parent's row and the smaller child's
    histogram and writes two rows; the plain-pool entry reads both
    children's histograms (the state rows are a few dozen bytes)."""
    return (4 if pool else 2) * f * b * 8 / PEAK_BYTES_S * 1e3


def _entries():
    from lightgbm_tpu_torch.ops import apply_find as af
    return {"apply_find_pool": (af.apply_find_pool, af.apply_find_pool_ref,
                                lambda c: (c.h_a, c.h_b)),
            "apply_find": (af.apply_find, af.apply_find_ref,
                           lambda c: (_h2(c),))}


def _h2(case: TailCase):
    """Both children's histograms [2, F, B, 2] of ``case`` (left: the
    smaller child's; right: parent minus left)."""
    import torch
    parent = case.st.pool[case.at.leaf]
    return torch.stack([case.h_a, parent - case.h_a]).contiguous()


def held_bitwise(entry, ref, hists, case: TailCase) -> bool:
    """``entry`` on the card and ``ref`` on CPU copies of the same state:
    every state tensor and both pool rows bitwise."""
    import torch
    got = case.clone()
    entry(*hists(got), *got.args())
    cpu = case.to("cpu").clone()
    ref(*hists(cpu), *cpu.args())
    torch.cuda.synchronize()
    return all(torch.equal(a.cpu(), b) for a, b in zip(got.st, cpu.st))


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


def mode_supported(mode: str) -> bool:
    """Whether the package has ``mode`` (``mono``: the split search's
    ``use_monotone``)."""
    from lightgbm_tpu_torch.ops.split import SplitHyperParams
    return mode == "plain" or "use_monotone" in SplitHyperParams._fields


def time_shape(f: int, b: int, modes: Sequence[str] = ("plain",
                                                       "mono")) -> list:
    """Both entries at ``f`` x ``b`` in each of ``modes``, in turns:
    bitwise, then eager and graph times; a shape the package does not
    support, or a mode it does not have, gives a record saying so."""
    from lightgbm_tpu_torch.ops.apply_find import apply_find_supported
    cases = {mode: synthetic_split(f, b, mono=mode == "mono", device="cuda")
             for mode in modes
             if apply_find_supported(f, b) and mode_supported(mode)}
    out = []
    for name, (entry, ref, hists) in _entries().items():
        for mode in modes:
            rec = {"entry": name, "mode": mode, "features": f, "bins": b,
                   "supported": mode in cases}
            out.append(rec)
            if mode not in cases:
                continue
            case = cases[mode]
            if not held_bitwise(entry, ref, hists, case):
                raise RuntimeError(f"{name} ({mode}) at {f} x {b} differs "
                                   "from its plain version")
            timed = case.clone()
            args = hists(timed)
            eager, graph = _eager_graph_ms(
                lambda: entry(*args, *timed.args()))
            rec.update(bitwise_cpu_plain=True, ms=eager, graph_ms=graph,
                       bound_ms=bound_ms(f, b, name == "apply_find_pool"))
    return out


def variant_geometries(f: int, b: int) -> list:
    """[(label, TailGeometry)]: the wrapper's choice ("chosen") and the
    geometries ``tail_geometry`` gives at 1, 2, 4, 8 and 16 blocks at
    most; a variant equal to the chosen one is left out."""
    from lightgbm_tpu_torch.ops.apply_find import tail_geometry
    geo = tail_geometry(f, b)
    out, seen = [("chosen", geo)], {geo}
    for m in (1, 2, 4, 8, 16):
        v = tail_geometry(f, b, m)
        if v is not None and v not in seen:
            seen.add(v)
            out.append((f"blocks{v.blocks}", v))
    return out


def time_variants(f: int, b: int) -> list:
    """The pool entry at ``f`` x ``b`` on each of
    :func:`variant_geometries`, launched through the library as the
    wrapper launches it, bitwise the plain version on CPU copies, then
    timed in a replayed graph of 20 calls: one record a variant."""
    import torch

    from lightgbm_tpu_torch.ops.apply_find import (apply_find_pool_ref,
                                                   launch_pool, max_clusters)
    from lightgbm_tpu_torch.tools.profile_lib import graph_ms
    case = synthetic_split(f, b, device="cuda")
    out = []
    for label, geo in variant_geometries(f, b):
        def call(c, geo=geo):
            launch_pool(c.h_a, c.h_b, *c.args(), geo)
        if not held_bitwise(call_entry(call), apply_find_pool_ref,
                            lambda c: (c.h_a, c.h_b), case):
            raise RuntimeError(f"apply_find_pool at {f} x {b} on {label} "
                               f"{geo} differs from its plain version")
        timed = case.clone()

        def many(call=call):
            for _ in range(CALLS):
                call(timed)
        graph, g = graph_ms(many, reps=5, warmup=1)
        del g
        torch.cuda.synchronize()
        out.append({"entry": "apply_find_pool", "features": f, "bins": b,
                    "variant": label, "geometry": geo._asdict(),
                    "max_clusters": max_clusters(geo, f, b),
                    "graph_ms": graph / CALLS, "bitwise_cpu_plain": True})
    return out


def call_entry(call):
    """A launch on a fixed geometry in an entry's signature."""
    def entry(h_a, h_b, nleft, st, fc, fmask, hp, max_depth, at):
        call(TailCase(h_a, h_b, nleft, st, fc, fmask, hp, max_depth, at))
    return entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default=SHAPES,
                    help="comma-separated FxB shapes")
    ap.add_argument("--modes", default=MODES,
                    help="comma-separated modes: plain (unconstrained), "
                         "mono (monotone constraints)")
    ap.add_argument("--package-root",
                    default=str(Path(__file__).resolve().parents[2]),
                    help="directory holding the lightgbm_tpu_torch "
                         "package to time")
    ap.add_argument("--variants", action="store_true",
                    help="time the pool entry on other cluster sizes "
                         "instead")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.package_root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("profile_apply_find needs a GPU", file=sys.stderr)
        return 1
    import lightgbm_tpu_torch
    gpu = torch.cuda.get_device_name(0)
    for shape in args.shapes.split(","):
        f, b = (int(v) for v in shape.split("x"))
        recs = (time_variants(f, b) if args.variants
                else time_shape(f, b, args.modes.split(",")))
        for rec in recs:
            rec["package"] = str(Path(lightgbm_tpu_torch.__file__).parent)
            rec["gpu"] = gpu
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
