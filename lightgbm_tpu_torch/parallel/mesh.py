"""The rank and world layout of the parallel learners: row blocks and
feature chunks.

Counterpart of ``lightgbm_tpu/parallel/mesh.py``.  The JAX package
builds a ``jax.sharding.Mesh`` and lets XLA place rows; the port runs
one process per rank (see the package docstring), so the layout is
plain arithmetic each rank does for itself:

- rank ``r`` of ``W`` keeps the contiguous row block ``[r * ceil(n /
  W), min(n, (r + 1) * ceil(n / W)))``, the rows
  ``pad_rows_to_shards`` gives shard ``r`` (the last block may be
  shorter, and no padding rows exist);
- the features split into ``W`` contiguous chunks, the first ``F % W``
  one feature wider than the rest (uneven where ``W`` does not divide
  ``F``: the JAX package pads the features to a multiple of the shards
  instead, ``device_data.pad_features_to_shards``, and falls back to
  the full merge where it cannot, rule ``scatter_f_log_indivisible``;
  an uneven chunking never needs that rule).
"""
from __future__ import annotations

from typing import Dict, Tuple

from ..utils.log import LightGBMError

DATA_AXIS = "data"
FEATURE_AXIS = "feature"


def row_block(n: int, rank: int, world: int) -> Tuple[int, int]:
    """Rank ``rank``'s contiguous rows: ``ceil(n / world)`` a rank, the
    last block shorter (possibly empty)."""
    per = -(-int(n) // int(world))
    lo = min(rank * per, n)
    return lo, min(lo + per, n)


def feature_chunks(f: int, world: int) -> list:
    """Every rank's ``[lo, hi)`` feature chunk, contiguous, in rank
    order; the first ``f % world`` are one feature wider.  A rank beyond
    the features gets an empty chunk."""
    base, extra = divmod(int(f), int(world))
    out, lo = [], 0
    for r in range(world):
        hi = lo + base + (1 if r < extra else 0)
        out.append((lo, hi))
        lo = hi
    return out


def parse_mesh_axes(spec: str) -> Dict[str, int]:
    """``"data:4,feature:2"`` -> ``{"data": 4, "feature": 2}`` (the JAX
    package's ``tpu_mesh_axes`` syntax)."""
    out: Dict[str, int] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, _, size = part.partition(":")
        out[name.strip()] = int(size)
    return out


def check_mesh_axes(spec: str, learner: str, world: int) -> None:
    """Refuse a ``tpu_mesh_axes`` the port does not train: the hybrid
    ``data:D,feature:F`` mesh (ROADMAP A10), and one axis whose size is
    not the world's.  One axis named after the learner, or none, is the
    learner's own layout."""
    axes = parse_mesh_axes(spec)
    if not axes:
        return
    if len(axes) > 1:
        raise LightGBMError(
            f"tpu_mesh_axes={spec!r}: the hybrid data x feature mesh is "
            "not ported to lightgbm_tpu_torch yet (see ROADMAP.md, A10); "
            "the JAX package lightgbm_tpu trains it")
    (name, size), = axes.items()
    want = FEATURE_AXIS if learner == "feature" else DATA_AXIS
    if name != want or size != world:
        raise LightGBMError(
            f"tpu_mesh_axes={spec!r} does not match tree_learner={learner} "
            f"over {world} ranks (one axis {want}:{world}, or none)")
