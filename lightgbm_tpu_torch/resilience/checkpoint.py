"""Deterministic checkpoint / resume of the boosting loop (counterpart of
``lightgbm_tpu/resilience/checkpoint.py``, schema
``lightgbm_tpu/ckpt/v1``).

Continued training from a saved model (``init_model``) re-derives the
scores through prediction, which is not bit-identical to the running f32
scores, so a killed run resumed that way would grow other trees.  A
ckpt/v1 snapshot holds the exact boosting state:

* the **forest** as model text (``models/model_text.py``; thresholds,
  leaf values and weights at ``%.17g``, an exact f64 round trip);
* the **training scores** ``[K, n]`` as raw f32 ``.npy`` bytes, with
  their sha256 in the manifest;
* the feature-fraction **RNG** state (PCG64); the bagging masks and
  GOSS draws are threefry functions of seed x iteration, so the
  mid-cycle bagging mask is drawn again at restore;
* the **iteration**, the classes' need-train flags, the shrinkage rate
  and lazy CEGB's paid mask where it is on (its sha256 in the manifest
  too);
* a **routing digest** (``ops/routing.RouteDecision.digest``), a
  **config fingerprint** and a **data digest** (bins and labels): a
  resume whose freshly built booster disagrees on any of them raises
  :class:`ResumeRefused`, because it would fork the run, not continue
  it.

Writes are atomic (a temporary directory renamed into place, then the
``LATEST`` pointer replaced last), so a kill during a write leaves the
previous snapshot in charge; every load verifies the digests again, so
a torn or altered snapshot raises :class:`CheckpointError`, never a
wrong resume.

After every save the booster re-anchors its carried row order
(``GBDT._reanchor_physical``): the surviving process and a process
resuming from the snapshot then hold the rows in the same (original)
order, and the histograms' f32 sums, hence the trees, stay the same bit
for bit.  The cadence is therefore part of the trajectory, and the
manifest records it.

Layout::

    <dir>/ckpt_000010/manifest.json   # schema, digests, rng, counters
    <dir>/ckpt_000010/model.txt       # forest (model text)
    <dir>/ckpt_000010/score.npy       # [K, n] f32 training scores
    <dir>/ckpt_000010/cegb_paid.npy   # lazy CEGB's mask, when on
    <dir>/LATEST                      # name of the newest complete one
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np

from ..config import env_knob
from ..utils import log
from . import faults
from . import findings as F

CKPT_SCHEMA = "lightgbm_tpu/ckpt/v1"
CKPT_DIR_ENV = "LGBM_TPU_CKPT_DIR"
CKPT_EVERY_ENV = "LGBM_TPU_CKPT_EVERY"
CKPT_KEEP_ENV = "LGBM_TPU_CKPT_KEEP"

# config fields that do not change the trained trees: a resume is not
# refused because the logging was changed
_FINGERPRINT_EXEMPT = ("verbosity", "metric_freq", "snapshot_freq",
                       "is_provide_training_metric", "output_model",
                       "input_model", "save_binary")

_BOOSTINGS_SUPPORTED = ("gbdt", "goss")


class CheckpointError(Exception):
    """A checkpoint exists but cannot be used (a torn manifest, a digest
    that does not match, a dangling ``LATEST``); carries a finding, and
    the command-line layers exit 2."""

    exit_code = F.EXIT_UNUSABLE

    def __init__(self, message: str, **detail: Any):
        super().__init__(message)
        self.finding = F.make_finding(
            "ckpt", "CKPT_CORRUPT", f"checkpoint corrupt: {message}",
            **detail)


class ResumeRefused(Exception):
    """The checkpoint is valid but belongs to another run: the freshly
    built booster disagrees on the config fingerprint, the data digest,
    the routing digest or the boosting type."""

    exit_code = F.EXIT_UNUSABLE

    def __init__(self, code: str, message: str, **detail: Any):
        super().__init__(message)
        self.finding = F.make_finding("ckpt", code, message, **detail)


class CkptPolicy(NamedTuple):
    dir: Optional[str]
    every: int
    keep: int


def policy_from_env(environ=None, *,
                    default_dir: Optional[str] = None) -> CkptPolicy:
    """The checkpoint policy from the knobs: ``LGBM_TPU_CKPT_DIR`` (off:
    disabled), ``_EVERY`` (iterations between saves; 0 resumes only),
    ``_KEEP`` (snapshots kept).  ``default_dir`` stands in for an unset
    or off directory knob."""
    d = env_knob(CKPT_DIR_ENV, environ).strip()
    if d.lower() in ("", "off", "0"):
        if default_dir is None:
            return CkptPolicy(None, 0, 0)
        d = default_dir
    try:
        every = int(env_knob(CKPT_EVERY_ENV, environ))
        keep = int(env_knob(CKPT_KEEP_ENV, environ))
    except ValueError as e:
        raise ValueError(
            f"{CKPT_EVERY_ENV}/{CKPT_KEEP_ENV} must be integers: {e}")
    return CkptPolicy(d, max(every, 0), max(keep, 1))


def supports(inner) -> Optional[str]:
    """None when the booster can checkpoint, else the reason it cannot
    (the engine warns once and trains unprotected)."""
    if inner.NAME not in _BOOSTINGS_SUPPORTED:
        return (f"boosting={inner.NAME} carries per-iteration state the "
                "ckpt/v1 snapshot does not capture")
    if inner.config.tree_learner != "serial":
        return (f"tree_learner={inner.config.tree_learner}: each rank holds "
                "only its own score rows")
    return None


# ---------------------------------------------------------------------
# digests
# ---------------------------------------------------------------------
def config_fingerprint(cfg) -> str:
    """Digest of every config field that shapes the trees."""
    d = dataclasses.asdict(cfg)
    for k in _FINGERPRINT_EXEMPT:
        d.pop(k, None)
    payload = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


_DATA_DIGEST_CAP = 64 << 20   # bytes of bins hashed (strided above)


def data_fingerprint(inner) -> Optional[str]:
    """Digest of the training data (bins and labels): a checkpoint
    directory reused on refreshed data of the same shape would mix two
    datasets' trees in one forest.  Bins beyond ``_DATA_DIGEST_CAP``
    bytes hash a fixed row stride and the last row; cached on the
    booster."""
    cached = getattr(inner, "_ckpt_data_digest", None)
    if cached is not None:
        return cached
    ds = getattr(inner, "train_set", None)
    bm = getattr(ds, "bin_matrix", None)
    if bm is None:
        return None
    h = hashlib.sha256()
    h.update(str(bm.shape).encode())
    h.update(str(bm.dtype).encode())
    if bm.nbytes <= _DATA_DIGEST_CAP:
        h.update(np.ascontiguousarray(bm).tobytes())
    else:
        step = max(1, bm.nbytes // _DATA_DIGEST_CAP)
        h.update(np.ascontiguousarray(bm[::step]).tobytes())
        h.update(np.ascontiguousarray(bm[-1:]).tobytes())
    label = getattr(ds.metadata, "label", None)
    if label is not None:
        lb = np.asarray(label)
        h.update(str(lb.shape).encode())
        h.update(np.ascontiguousarray(lb).tobytes())
    digest = h.hexdigest()[:16]
    inner._ckpt_data_digest = digest
    return digest


def array_digest(a: np.ndarray) -> str:
    a = np.ascontiguousarray(a)
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()[:16]


def text_digest(s: str) -> str:
    return hashlib.sha256(s.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------
# save
# ---------------------------------------------------------------------
def save_booster(booster, ckpt_dir: str, *, keep: int = 2, every: int = 0,
                 fingerprint: Optional[str] = None) -> str:
    """Write one complete snapshot of ``booster`` under ``ckpt_dir``,
    point ``LATEST`` at it and prune to ``keep``; then re-anchor the
    booster's row order.  ``every`` is recorded as the cadence;
    ``fingerprint`` overrides the config fingerprint (``engine.train``
    passes the one of the config at the start: a ``reset_parameter``
    schedule changes the live config).  Returns the snapshot's path."""
    from ..models.model_text import save_model_to_string

    inner = booster._inner
    reason = supports(inner)
    if reason is not None:
        raise ValueError(f"cannot checkpoint: {reason}")
    st = inner.checkpoint_state()
    it = st["iteration"]
    model_text = save_model_to_string(inner, 0, -1, 0)
    manifest: Dict[str, Any] = {
        "schema": CKPT_SCHEMA,
        "iteration": it,
        "boosting": inner.NAME,
        "num_tree_per_iteration": inner.num_tree_per_iteration,
        "num_trees": len(inner.models),
        "config_fingerprint": (fingerprint
                               or config_fingerprint(booster.config)),
        "data_digest": data_fingerprint(inner),
        "routing_digest": inner.route.digest(),
        "model_digest": text_digest(model_text),
        "score_digest": array_digest(st["train_score"]),
        "score_shape": list(st["train_score"].shape),
        "rng_feature": st["rng_feature"],
        "rng_bagging": None,
        "shrinkage_rate": st["shrinkage_rate"],
        "class_need_train": st["class_need_train"],
        "has_cegb": st["cegb_paid"] is not None,
        "cegb_digest": (None if st["cegb_paid"] is None
                        else array_digest(st["cegb_paid"])),
        "ckpt_every": int(every),
    }
    name = f"ckpt_{it:06d}"
    final = os.path.join(ckpt_dir, name)
    tmp = os.path.join(ckpt_dir, f".{name}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, "model.txt"), "w") as f:
        f.write(model_text)
        f.flush()
        os.fsync(f.fileno())
    np.save(os.path.join(tmp, "score.npy"), st["train_score"])
    if st["cegb_paid"] is not None:
        np.save(os.path.join(tmp, "cegb_paid.npy"), st["cegb_paid"])
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    # LATEST flips last: a kill above leaves the previous snapshot in
    # charge and the new directory unreferenced
    latest_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(name + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    _prune(ckpt_dir, keep=keep)
    # the surviving process continues from the row order a resumed
    # process rebuilds from this snapshot
    inner._reanchor_physical()
    faults.record("ckpt_save")
    log.info("checkpoint written: %s (iteration %d, %d trees)", final, it,
             manifest["num_trees"])
    return final


def _prune(ckpt_dir: str, *, keep: int) -> None:
    names = sorted(n for n in os.listdir(ckpt_dir)
                   if n.startswith("ckpt_")
                   and os.path.isdir(os.path.join(ckpt_dir, n)))
    for n in names[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, n), ignore_errors=True)


# ---------------------------------------------------------------------
# load
# ---------------------------------------------------------------------
@dataclasses.dataclass
class Checkpoint:
    path: str
    manifest: Dict[str, Any]
    model_text: str
    score: np.ndarray
    cegb_paid: Optional[np.ndarray]

    @property
    def iteration(self) -> int:
        return int(self.manifest["iteration"])


def latest(ckpt_dir: str) -> Optional[str]:
    """The newest complete snapshot under ``ckpt_dir`` (by ``LATEST``),
    or None when there is none.  A ``LATEST`` naming a missing directory
    is corruption, not absence."""
    pointer = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(pointer):
        return None
    try:
        with open(pointer) as f:
            name = f.read().strip()
    except OSError as e:
        raise CheckpointError(f"LATEST unreadable under {ckpt_dir!r}: {e}")
    if not name or os.sep in name or not name.startswith("ckpt_"):
        raise CheckpointError(
            f"LATEST under {ckpt_dir!r} holds {name!r}, not a checkpoint "
            "name")
    path = os.path.join(ckpt_dir, name)
    if not os.path.isdir(path):
        raise CheckpointError(
            f"LATEST points at {name!r} which does not exist under "
            f"{ckpt_dir!r} (torn prune or partial write)")
    return path


def load(path: str) -> Checkpoint:
    """Read one snapshot and verify every digest; raises
    :class:`CheckpointError` on anything torn, truncated or altered."""
    mpath = os.path.join(path, "manifest.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except OSError as e:
        raise CheckpointError(f"{mpath}: cannot read: {e}")
    except json.JSONDecodeError as e:
        raise CheckpointError(f"{mpath}: manifest not valid JSON ({e}) — "
                              "partial write")
    if manifest.get("schema") != CKPT_SCHEMA:
        raise CheckpointError(f"{mpath}: schema {manifest.get('schema')!r}, "
                              f"expected {CKPT_SCHEMA!r}")
    for key in ("iteration", "model_digest", "score_digest", "score_shape",
                "config_fingerprint"):
        if key not in manifest:
            raise CheckpointError(f"{mpath}: manifest missing {key!r}")
    try:
        with open(os.path.join(path, "model.txt")) as f:
            model_text = f.read()
    except OSError as e:
        raise CheckpointError(f"{path}: model.txt unreadable: {e}")
    if text_digest(model_text) != manifest["model_digest"]:
        raise CheckpointError(f"{path}: model.txt digest mismatch "
                              "(truncated or corrupt forest)")
    try:
        score = np.load(os.path.join(path, "score.npy"))
    except (OSError, ValueError) as e:
        raise CheckpointError(f"{path}: score.npy unreadable: {e}")
    if list(score.shape) != list(manifest["score_shape"]):
        raise CheckpointError(f"{path}: score shape {list(score.shape)} != "
                              f"manifest {manifest['score_shape']}")
    if array_digest(score) != manifest["score_digest"]:
        raise CheckpointError(f"{path}: score digest mismatch (torn write "
                              "or bit rot)")
    cegb = None
    if manifest.get("has_cegb"):
        try:
            cegb = np.load(os.path.join(path, "cegb_paid.npy"))
        except (OSError, ValueError) as e:
            raise CheckpointError(f"{path}: cegb_paid.npy unreadable: {e}")
        if array_digest(cegb) != manifest.get("cegb_digest"):
            raise CheckpointError(f"{path}: cegb_paid digest mismatch (torn "
                                  "write or bit rot)")
    return Checkpoint(path=path, manifest=manifest, model_text=model_text,
                      score=score, cegb_paid=cegb)


# ---------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------
def restore(booster, ck: Checkpoint, *,
            fingerprint: Optional[str] = None) -> int:
    """Install a loaded snapshot into a freshly built booster; raises
    :class:`ResumeRefused` when it was written by another config, data,
    route or boosting type.  ``fingerprint`` overrides the live config's
    (see :func:`save_booster`)."""
    from ..models.model_text import load_model_from_string

    inner = booster._inner
    m = ck.manifest
    fp = fingerprint or config_fingerprint(booster.config)
    if m["config_fingerprint"] != fp:
        raise ResumeRefused(
            "RESUME_CONFIG_MISMATCH",
            f"checkpoint {ck.path} was written under config fingerprint "
            f"{m['config_fingerprint']} but this run builds {fp} — "
            "resuming would fork the run, not continue it",
            ckpt=m["config_fingerprint"], run=fp)
    ck_data = m.get("data_digest")
    run_data = data_fingerprint(inner)
    if ck_data and run_data and ck_data != run_data:
        raise ResumeRefused(
            "RESUME_DATA_MISMATCH",
            f"checkpoint {ck.path} trained on data digest {ck_data} but "
            f"this run binned {run_data} — its trees belong to a "
            "different dataset, and resuming would mix two datasets' "
            "forests into one model", ckpt=ck_data, run=run_data)
    rd = inner.route.digest()
    if m.get("routing_digest") != rd:
        raise ResumeRefused(
            "RESUME_ROUTING_MISMATCH",
            f"checkpoint {ck.path} trained routing digest "
            f"{m.get('routing_digest')} but this run engaged {rd} — trees "
            "grown on a different path are not a continuation",
            ckpt=m.get("routing_digest"), run=rd)
    if m.get("boosting") != inner.NAME:
        raise ResumeRefused(
            "RESUME_BOOSTING_MISMATCH",
            f"checkpoint boosting={m.get('boosting')!r} but this run "
            f"builds {inner.NAME!r}")
    loaded = load_model_from_string(ck.model_text)
    if len(loaded.models) != int(m.get("num_trees", -1)):
        raise CheckpointError(
            f"{ck.path}: model.txt holds {len(loaded.models)} trees, "
            f"manifest says {m.get('num_trees')}")
    inner.restore_checkpoint_state(
        loaded.models, iteration=ck.iteration, train_score=ck.score,
        rng_feature=m.get("rng_feature"),
        shrinkage_rate=m.get("shrinkage_rate"),
        class_need_train=m.get("class_need_train"),
        cegb_paid=ck.cegb_paid)
    return ck.iteration


def maybe_resume(booster, ckpt_dir: str, *,
                 fingerprint: Optional[str] = None,
                 every: Optional[int] = None) -> int:
    """Resume ``booster`` from the newest snapshot under ``ckpt_dir``, if
    there is one.  Returns the restored iteration (0 when starting
    fresh); raises :class:`CheckpointError` / :class:`ResumeRefused`.
    ``every`` is this run's cadence, compared with the snapshot's: a
    change keeps training deterministic but not byte-identical to an
    uninterrupted run at the snapshot's cadence, and warns."""
    path = latest(ckpt_dir)
    if path is None:
        return 0
    ck = load(path)
    it = restore(booster, ck, fingerprint=fingerprint)
    saved_every = ck.manifest.get("ckpt_every")
    if saved_every:
        cur = policy_from_env().every if every is None else every
        if cur != saved_every:
            log.warning(
                "checkpoint cadence changed (snapshot wrote every=%d, this "
                "run writes every=%d): training stays deterministic, but "
                "the trees will not be byte-identical to an uninterrupted "
                "every=%d run — each save re-anchors the row order",
                saved_every, cur, saved_every)
    faults.record("ckpt_resume")
    log.info("resumed from checkpoint %s (iteration %d, %d trees)", path, it,
             ck.manifest.get("num_trees", -1))
    return it


def render_refusal(exc: Exception) -> List[str]:
    """The finding lines of a CheckpointError / ResumeRefused."""
    finding = getattr(exc, "finding", None)
    if finding is None:
        finding = F.make_finding("ckpt", "CKPT_ERROR", str(exc))
    return F.render([finding])
