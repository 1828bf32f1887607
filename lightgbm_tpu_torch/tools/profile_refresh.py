"""The root-histogram refresh on the card, two commits in turns in one
process: ``chip_smoke.refresh_times`` (1,000,000 rows x 28
features, B = 256, both packs; each commit's refresh beside its plain
refresh, its init and ``hist_comb``'s root over [0, n), eager, as one
replay of a graph of 20 calls, and from device memory after an L2 flush
by a write and by a read).

    python -m lightgbm_tpu_torch.tools.profile_refresh \\
        [--parent-root DIR] [--turns 2]

``--parent-root`` is a checkout of the other commit, imported as
``parent_lightgbm_tpu_torch``; the runs go parent, change, change,
parent (``--turns`` pairs).  Prints one JSON line a run and needs a
GPU.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-root", default=None,
                    help="checkout of the other commit")
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("profile_refresh needs a GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from lightgbm_tpu_torch.tools.profile_lib import load_package
    names = {"change": "lightgbm_tpu_torch"}
    if args.parent_root:
        load_package(args.parent_root, "parent_lightgbm_tpu_torch")
        names["parent"] = "parent_lightgbm_tpu_torch"
    gpu = cs._gpu_line()
    pair = ["parent", "change"] if len(names) > 1 else ["change"]
    for i in range(args.turns):
        for name in (pair if i % 2 == 0 else pair[::-1]):
            cs.refresh_times(gpu, pkg=names[name])
    return 0


if __name__ == "__main__":
    sys.exit(main())
