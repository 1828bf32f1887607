"""``python -m lightgbm_tpu_torch.resilience demo`` — a small
deterministic training through ``engine.train``, honoring the
``LGBM_TPU_CKPT_*``, ``LGBM_TPU_FAULT`` and ``LGBM_TPU_NUMERICS`` knobs,
on the card unless ``--device cpu``.

Exit codes: 0 clean (recovered faults included), 1 a classified fault
that was not recovered, 2 unusable state (a corrupt checkpoint, a
refused resume, or any other error) — never a traceback.  A ``death``
drill kills the process (SIGKILL): run the same command again to resume
from the checkpoint directory.

    LGBM_TPU_CKPT_DIR=/tmp/ck LGBM_TPU_CKPT_EVERY=2 \\
        LGBM_TPU_FAULT=oom@3 python -m lightgbm_tpu_torch.resilience demo
"""
from __future__ import annotations

import argparse
import sys
from typing import Tuple

import numpy as np

from . import findings as F


def demo_problem(n: int = 384, f: int = 6, seed: int = 7
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The demo's dataset (a fixed PCG64 stream; the JAX package's)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = (x[:, 0] - 0.5 * x[:, 1] + 0.25 * x[:, 2] * x[:, 3]
         + rng.logistic(size=n) * 0.3 > 0).astype(np.float32)
    return x, y


def demo_params(num_leaves: int = 15) -> dict:
    """The demo's config: feature fraction and bagging mid-cycle, the
    state a resume must carry."""
    return {
        "objective": "binary", "num_leaves": num_leaves,
        "learning_rate": 0.2, "max_bin": 31, "min_data_in_leaf": 5,
        "min_data_in_bin": 1, "feature_fraction": 0.8,
        "bagging_fraction": 0.8, "bagging_freq": 3, "verbosity": -1,
    }


def _train(rounds: int, num_leaves: int, device: str):
    import lightgbm_tpu_torch as lgt
    x, y = demo_problem()
    p = demo_params(num_leaves)
    return lgt.train(p, lgt.Dataset(x, label=y, params=p),
                     num_boost_round=rounds, device=device)


def _cmd_demo(rounds: int, num_leaves: int, device: str) -> int:
    from . import checkpoint as C
    from . import faults
    try:
        bst = _train(rounds, num_leaves, device)
    except (C.CheckpointError, C.ResumeRefused) as e:
        for line in C.render_refusal(e):
            print(line)
        return F.EXIT_UNUSABLE
    except faults.FaultError as e:
        for line in F.render([e.report["finding"]]):
            print(line)
        return e.exit_code
    reports = faults.run_reports()
    for r in reports:
        for line in F.render([r["finding"]]):
            print(line)
    resumed = int(getattr(bst, "resumed_from", 0) or 0)
    if resumed:
        print(f"resumed from iteration {resumed}")
    recovered = sum(1 for r in reports if r.get("recovered"))
    print(f"demo: trained {bst.current_iteration()} iteration(s), "
          f"{bst.num_trees()} tree(s), {len(reports)} fault report(s) "
          f"({recovered} recovered)")
    return F.EXIT_CLEAN


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.resilience",
        description="a small training through the engine boundary under "
                    "the LGBM_TPU_CKPT_* / FAULT / NUMERICS knobs")
    sub = ap.add_subparsers(dest="cmd", required=True)
    dp = sub.add_parser("demo", help="train the demo model")
    dp.add_argument("--rounds", type=int, default=6)
    dp.add_argument("--num-leaves", type=int, default=15)
    dp.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    try:
        return _cmd_demo(args.rounds, args.num_leaves, args.device)
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as e:   # noqa: BLE001 - the exit contract
        print(f"resilience demo: {type(e).__name__}: {e}")
        return F.EXIT_UNUSABLE


if __name__ == "__main__":
    sys.exit(main())
