"""The port's ``resilience/`` (checkpoint / resume, fault injection, the
numerical guardrails) on the CPU, against the JAX package where both
behave the same.

Held to the JAX package: the numerics policy, the fault spec parser,
the classification of the same exceptions and the fault report's keys
and class (equal); the kept and dropped trees of an l1 training with NaN
gradients injected under ``clamp``, ``raise`` (recovered from a
snapshot) and ``skip`` (structure equal, leaves within
``test_torch_train.LEAF_RTOL`` of the tree's largest, as the l1 parity
of ``tests/test_torch_objectives.py``); and the trees of a snapshot of
the same training (the same checks).  The port alone: ``off`` builds no
guard, a snapshot's round trip and its torn, altered and refused
resumes, and a run killed at iteration 3 and resumed from its snapshot
byte-identical (model text and raw f32 scores) to the uninterrupted run
on the stream route under ``LGBM_TPU_CKPT_AT_REFRESH`` 0 and 1, with
GOSS, and with bagging resumed mid-cycle (one real ``death`` in a
subprocess, the other kills simulated by stopping a run after its
snapshot).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from chip_smoke import compare_trees
from conftest import restore_env_knobs, save_env_knobs
from lightgbm_tpu_torch.models.model_text import load_model_from_string
from lightgbm_tpu_torch.ops.grow import NumericsGuard, SerialGrower
from lightgbm_tpu_torch.resilience import checkpoint as ckpt
from lightgbm_tpu_torch.resilience import faults, numerics
from test_torch_train import (LEAF_RTOL, ROUTE_KNOBS, ROW_ORDER_ROUTE, _data,
                              _purge)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RES_KNOBS = ("LGBM_TPU_CKPT_DIR", "LGBM_TPU_CKPT_EVERY", "LGBM_TPU_CKPT_KEEP",
             "LGBM_TPU_CKPT_AT_REFRESH", "LGBM_TPU_FAULT",
             "LGBM_TPU_FAULT_RETRIES", "LGBM_TPU_NUMERICS")
ALL_KNOBS = tuple(ROUTE_KNOBS) + ("LGBM_TPU_COMB_PACK",) + RES_KNOBS
BINARY = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
L1 = {"objective": "regression_l1", "num_leaves": 15, "verbosity": -1}


def _with_env(env, fn):
    saved = save_env_knobs(ALL_KNOBS)
    for k in ALL_KNOBS:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        return fn()
    finally:
        restore_env_knobs(saved)


def _port(params, x, y, rounds, env=None):
    """The port's CPU training under ``env``, the injection re-armed."""
    def run():
        faults.rearm()
        faults.reset_run()
        return lgt.train(dict(params), lgt.Dataset(x, label=y),
                         num_boost_round=rounds, device="cpu")
    return _with_env(dict(env or {}), run)


def _jax(params, x, y, rounds, env=None):
    """The JAX package's CPU training (its row-order route) under
    ``env``, its modules purged around the run."""
    def run():
        _purge()
        try:
            import lightgbm_tpu as lgb
            bst = lgb.train(dict(params), lgb.Dataset(x, label=y),
                            num_boost_round=rounds)
            from lightgbm_tpu.resilience import faults as jf
            return bst, [r["class"] for r in jf.run_reports()]
        finally:
            _purge()
    return _with_env(dict(ROW_ORDER_ROUTE, **(env or {})), run)


def _ck(d, every=2, **extra):
    return dict({"LGBM_TPU_CKPT_DIR": str(d),
                 "LGBM_TPU_CKPT_EVERY": str(every)}, **extra)


def _same_bytes(a, b):
    """Model text and raw f32 training scores byte for byte."""
    assert a.model_to_string() == b.model_to_string()
    sa = a._inner.scores.numpy()
    sb = b._inner.scores.numpy()
    assert sa.dtype == sb.dtype == np.float32
    assert sa.tobytes() == sb.tobytes()


# -- the harness's vocabulary against the JAX package -------------------
def test_policy_and_spec_match_jax():
    from lightgbm_tpu.resilience import faults as jf
    from lightgbm_tpu.resilience import numerics as jn

    def outcome(fn, *a):
        try:
            return ("ok", fn(*a))
        except ValueError:
            return ("ValueError", None)
    for val in ("off", "raise", "skip", "clamp", "RAISE", " skip ", "yes",
                ""):
        env = {"LGBM_TPU_NUMERICS": val}
        assert outcome(numerics.policy, env) == outcome(jn.policy, env), val
    for spec in ("off", "", "0", "death@3", "NaN@0", " oom@12 ", "hang@1",
                 "death", "boom@2", "nan@x", "nan@-1"):
        assert outcome(faults.parse_spec, spec) == outcome(jf.parse_spec,
                                                           spec), spec


def _exceptions(pkg):
    """The same faults as each package raises them."""
    faults_mod = pkg.faults
    return [
        pkg.numerics.NumericalFault("grad/hess", 3, 2),
        faults_mod.SimulatedResourceExhausted("RESOURCE_EXHAUSTED: out of "
                                              "memory while allocating"),
        faults_mod.SimulatedCollectiveTimeout("DEADLINE_EXCEEDED: "
                                              "collective all-reduce timed "
                                              "out"),
        RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
        RuntimeError("barrier timed out after 60 s"),
        RuntimeError("collective permute not supported"),
        ValueError("a plain bug"),
        pkg.checkpoint.CheckpointError("torn"),
        pkg.checkpoint.ResumeRefused("RESUME_CONFIG_MISMATCH", "other run"),
    ]


def test_classify_and_report_match_jax():
    import types

    from lightgbm_tpu.resilience import checkpoint as jc
    from lightgbm_tpu.resilience import faults as jf
    from lightgbm_tpu.resilience import numerics as jn
    port = types.SimpleNamespace(faults=faults, numerics=numerics,
                                 checkpoint=ckpt)
    jax = types.SimpleNamespace(faults=jf, numerics=jn, checkpoint=jc)
    got = [faults.classify(e) for e in _exceptions(port)]
    want = [jf.classify(e) for e in _exceptions(jax)]
    assert got == want
    assert got[:5] == ["nan_gradients", "resource_exhausted",
                       "collective_timeout", "resource_exhausted",
                       "collective_timeout"]
    # the card's own out-of-memory class
    assert faults.classify(torch.cuda.OutOfMemoryError("oom")) \
        == "resource_exhausted"
    for cls in ("nan_gradients", "resource_exhausted", "unclassified"):
        for rec in (True, False):
            kw = dict(iteration=4, error="x" * 300, recovered=rec,
                      attempt=2)
            assert (faults.fault_report(cls, **kw)
                    == jf.fault_report(cls, **kw))
    assert faults.FAULTREPORT_SCHEMA == jf.FAULTREPORT_SCHEMA
    assert ckpt.CKPT_SCHEMA == jc.CKPT_SCHEMA


def test_knobs_match_jax():
    from lightgbm_tpu.config import ENV_KNOBS as J
    from lightgbm_tpu_torch.config import ENV_KNOBS as T
    for k in RES_KNOBS:
        assert T[k] == J[k], k


def test_sanitize_and_count():
    g = torch.tensor([np.nan, np.inf, -np.inf, 1.0, 3e38])
    h = torch.tensor([2.0, np.nan, 3.0, -np.inf, 1.0])
    gs, hs = numerics.sanitize(g, h)
    assert gs.tolist() == [0.0, float(np.float32(1e30)),
                           -float(np.float32(1e30)), 1.0,
                           float(np.float32(1e30))]
    assert torch.isfinite(hs).all()
    assert int(numerics.count_bad(g, h)) == 5
    with pytest.raises(numerics.NumericalFault):
        numerics.host_guard(g, h, "raise", 1)
    with pytest.raises(numerics.NumericsSkip):
        numerics.host_guard(g, h, "skip", 1)


# -- the guard ------------------------------------------------------------
def test_off_builds_no_guard():
    x, y = _data(600, 6, 3)
    for env in ({}, {"LGBM_TPU_NUMERICS": "off"}):
        bst = _port(BINARY, x, y, 1, env)
        assert type(bst._inner.grow) is SerialGrower
        assert bst._inner.grow.route.stream
    bst = _port(BINARY, x, y, 1, {"LGBM_TPU_NUMERICS": "skip"})
    assert isinstance(bst._inner.grow, NumericsGuard)
    assert int(bst._inner.grow.last_numerics_bad) == 0
    with pytest.raises(ValueError, match="clamp cannot guard"):
        _port(BINARY, x, y, 1, {"LGBM_TPU_NUMERICS": "clamp"})
    with pytest.raises(ValueError, match="not a valid policy"):
        _port(BINARY, x, y, 1, {"LGBM_TPU_NUMERICS": "yes please"})


@pytest.mark.parametrize("policy", ["clamp", "raise", "skip"])
def test_l1_nan_policy_matches_jax(policy, tmp_path):
    """NaN in the gradients at iteration 1 of an l1 training (a route
    that hands the gradients in): the port keeps and drops the JAX
    package's trees."""
    x, y = _data(2000, 6, 11, "regression")
    env = {"LGBM_TPU_FAULT": "nan@1", "LGBM_TPU_NUMERICS": policy}
    if policy == "raise":
        env_t = _ck(tmp_path / "t", 1, **env)
        env_j = _ck(tmp_path / "j", 1, **env)
    else:
        env_t = env_j = env
    bt = _port(L1, x, y, 3, env_t)
    reports = [r["class"] for r in faults.run_reports()]
    bj, reports_j = _jax(L1, x, y, 3, env_j)
    assert reports == reports_j
    assert reports == (["nan_gradients"] if policy == "raise" else [])
    res = compare_trees(bt._models, bj._models, rtol=LEAF_RTOL)
    assert res["ok"], res
    leaves = [t.num_leaves for t in bt._models]
    if policy == "skip":
        assert leaves[1] == 1 and bt._models[1].leaf_value[0] == 0.0
        assert faults.EVENTS["numerics_skip"] >= 1
    assert all(n > 1 for i, n in enumerate(leaves)
               if not (policy == "skip" and i == 1))
    if policy == "raise":
        # no checkpoint: the fault is reported, not recovered
        with pytest.raises(faults.FaultError) as ei:
            _port(L1, x, y, 3, env)
        assert ei.value.report["class"] == "nan_gradients"
        assert not ei.value.report["recovered"]


def test_snapshot_trees_match_jax(tmp_path):
    x, y = _data(3000, 6, 11)
    _port(BINARY, x, y, 4, _ck(tmp_path / "t"))
    _jax(BINARY, x, y, 4, _ck(tmp_path / "j"))
    snaps = [ckpt.load(ckpt.latest(str(tmp_path / d))) for d in "tj"]
    assert [s.iteration for s in snaps] == [4, 4]
    mt, mj = (load_model_from_string(s.model_text).models for s in snaps)
    res = compare_trees(mt, mj, rtol=LEAF_RTOL)
    assert res["ok"], res
    st, sj = snaps[0].score, snaps[1].score
    assert st.shape == (1, 3000) and st.dtype == np.float32
    assert np.allclose(st, sj[:, :3000], atol=1e-5)


# -- snapshots: round trip, torn and altered, refused ---------------------
@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    d = tmp_path_factory.mktemp("ck")
    x, y = _data(600, 6, 3)
    bst = _port(BINARY, x, y, 4, _ck(d))
    return d, x, y, bst


def _copy(snapshot, tmp_path):
    import shutil
    d = tmp_path / "ck"
    shutil.copytree(snapshot[0], d)
    return d


def test_snapshot_round_trip(snapshot):
    d, x, y, bst = snapshot
    names = sorted(os.listdir(d))
    assert names == ["LATEST", "ckpt_000002", "ckpt_000004"]
    ck = ckpt.load(ckpt.latest(str(d)))
    m = ck.manifest
    assert m["schema"] == "lightgbm_tpu/ckpt/v1"
    assert m["iteration"] == 4 and m["num_trees"] == 4
    assert m["routing_digest"] == bst._inner.route.digest()
    assert m["ckpt_every"] == 2
    assert ck.score.tobytes() == bst._inner.scores.numpy().tobytes()
    assert ck.model_text == bst.model_to_string()
    # resume-only with every tree there: nothing trains, the model comes
    # back as it was
    again = _port(BINARY, x, y, 4, _ck(d, 0))
    assert again.resumed_from == 4
    _same_bytes(again, bst)


@pytest.mark.parametrize("damage", ["model", "manifest", "score",
                                    "latest_garbage", "latest_dangling"])
def test_torn_or_altered_snapshot_raises(damage, snapshot, tmp_path):
    d = _copy(snapshot, tmp_path)
    last = d / "ckpt_000004"
    if damage == "model":
        t = (last / "model.txt").read_text()
        (last / "model.txt").write_text(t.replace("leaf_value=", "leaf_value=1",
                                                  1))
    elif damage == "manifest":
        t = (last / "manifest.json").read_text()
        (last / "manifest.json").write_text(t[:len(t) // 2])
    elif damage == "score":
        s = np.load(last / "score.npy")
        s[0, 5] = np.nextafter(s[0, 5], np.float32(np.inf))
        np.save(last / "score.npy", s)
    elif damage == "latest_garbage":
        (d / "LATEST").write_text("../etc\n")
    else:
        (d / "LATEST").write_text("ckpt_000099\n")
    x, y = snapshot[1], snapshot[2]
    with pytest.raises(ckpt.CheckpointError) as ei:
        _port(BINARY, x, y, 6, _ck(d))
    assert ei.value.exit_code == 2
    assert ei.value.finding["code"] == "CKPT_CORRUPT"
    assert faults.classify(ei.value) == "checkpoint_corrupt"


def test_altered_cegb_mask_raises(tmp_path):
    """Lazy CEGB's paid mask is verified like the scores: a flipped
    entry in ``cegb_paid.npy`` that still parses is refused."""
    x, y = _data(600, 6, 3)
    params = dict(BINARY, cegb_penalty_feature_lazy=[0.01] * 6)
    d = tmp_path / "ck"
    _port(params, x, y, 2, _ck(d))
    last = d / "ckpt_000002"
    ck = ckpt.load(str(last))
    assert ck.manifest["has_cegb"]
    assert ck.manifest["cegb_digest"] == ckpt.array_digest(ck.cegb_paid)
    mask = np.load(last / "cegb_paid.npy")
    mask.flat[0] = not mask.flat[0]
    np.save(last / "cegb_paid.npy", mask)
    with pytest.raises(ckpt.CheckpointError) as ei:
        _port(params, x, y, 4, _ck(d))
    assert ei.value.finding["code"] == "CKPT_CORRUPT"
    assert "cegb_paid digest" in str(ei.value)


@pytest.mark.parametrize("change", ["config", "data", "route"])
def test_resume_refused(change, snapshot, tmp_path):
    d = _copy(snapshot, tmp_path)
    x, y = snapshot[1], snapshot[2]
    params, env = dict(BINARY), _ck(d)
    if change == "config":
        params["num_leaves"] = 7
    elif change == "data":
        y = 1.0 - y
    else:
        env["LGBM_TPU_STREAM"] = "0"
    with pytest.raises(ckpt.ResumeRefused) as ei:
        _port(params, x, y, 6, env)
    code = {"config": "RESUME_CONFIG_MISMATCH", "data": "RESUME_DATA_MISMATCH",
            "route": "RESUME_ROUTING_MISMATCH"}[change]
    assert ei.value.finding["code"] == code
    assert ei.value.exit_code == 2
    assert ckpt.render_refusal(ei.value)[0].split()[1] == f"ckpt/{code}"


def test_unsupported_trains_unprotected(tmp_path, caplog):
    x, y = _data(600, 6, 3)
    p = dict(BINARY, boosting="dart")
    bst = _port(p, x, y, 3, _ck(tmp_path))
    assert bst.num_trees() == 3 and not os.listdir(tmp_path)

    class Inner:
        NAME = "gbdt"
        config = lgt.config.Config.from_params({"tree_learner": "data"})
    assert "tree_learner=data" in ckpt.supports(Inner())


def test_policy_from_env():
    assert ckpt.policy_from_env({}) == ckpt.CkptPolicy(None, 0, 0)
    assert ckpt.policy_from_env({"LGBM_TPU_CKPT_DIR": "/x"}) \
        == ckpt.CkptPolicy("/x", 10, 2)
    assert ckpt.policy_from_env({"LGBM_TPU_CKPT_DIR": "d",
                                 "LGBM_TPU_CKPT_EVERY": "-3",
                                 "LGBM_TPU_CKPT_KEEP": "0"}) \
        == ckpt.CkptPolicy("d", 0, 1)


# -- kill and resume, byte for byte ---------------------------------------
KILL_CELLS = {
    "stream": (BINARY, {}),
    "stream_at_refresh": (BINARY, {"LGBM_TPU_CKPT_AT_REFRESH": "1"}),
    "goss": (dict(BINARY, boosting="goss", learning_rate=0.5), {}),
    "bagging_mid_cycle": (dict(BINARY, bagging_fraction=0.7, bagging_freq=3,
                               feature_fraction=0.8), {}),
}


@pytest.mark.parametrize("cell", list(KILL_CELLS))
def test_kill_resume_byte_identical(cell, tmp_path):
    """A run stopped after its snapshot at iteration 2 (a kill at 3) and
    resumed to 6 equals the uninterrupted run at the same cadence."""
    params, extra = KILL_CELLS[cell]
    x, y = _data(1500, 6, 5)
    ref = _port(params, x, y, 6, _ck(tmp_path / "ref", **extra))
    _port(params, x, y, 3, _ck(tmp_path / "ck", **extra))
    got = _port(params, x, y, 6, _ck(tmp_path / "ck", **extra))
    assert got.resumed_from == 2
    _same_bytes(got, ref)
    if cell.startswith("stream"):
        assert got._inner.route.stream
        # the in-place re-anchor builds the full rebuild's rows
        other = dict(extra)
        other["LGBM_TPU_CKPT_AT_REFRESH"] = (
            "0" if extra.get("LGBM_TPU_CKPT_AT_REFRESH") == "1" else "1")
        _same_bytes(_port(params, x, y, 6, _ck(tmp_path / "o", **other)),
                    ref)


def test_death_subprocess_then_resume(tmp_path):
    """``LGBM_TPU_FAULT=death@3`` kills a real process (SIGKILL) after
    its snapshot at 2; this process resumes from it to the
    uninterrupted run's bytes."""
    x, y = _data(1500, 6, 5)
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "y.npy", y)
    code = (
        "import numpy as np, lightgbm_tpu_torch as lgt\n"
        f"x = np.load({str(tmp_path / 'x.npy')!r})\n"
        f"y = np.load({str(tmp_path / 'y.npy')!r})\n"
        f"lgt.train({BINARY!r}, lgt.Dataset(x, label=y), 6, device='cpu')\n"
        "print('not killed')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO),
               **_ck(tmp_path / "ck", LGBM_TPU_FAULT="death@3"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == -9, proc.stdout + proc.stderr
    assert "not killed" not in proc.stdout
    m = json.loads((tmp_path / "ck" / "ckpt_000002" / "manifest.json")
                   .read_text())
    assert m["iteration"] == 2
    got = _port(BINARY, x, y, 6, _ck(tmp_path / "ck"))
    ref = _port(BINARY, x, y, 6, _ck(tmp_path / "ref"))
    assert got.resumed_from == 2
    _same_bytes(got, ref)


def test_oom_recovers_byte_identical(tmp_path):
    x, y = _data(1500, 6, 5)
    ref = _port(BINARY, x, y, 6, _ck(tmp_path / "ref"))
    got = _port(BINARY, x, y, 6, _ck(tmp_path / "ck",
                                     LGBM_TPU_FAULT="oom@3"))
    assert [r["class"] for r in faults.run_reports()] \
        == ["resource_exhausted"]
    assert faults.run_reports()[0]["recovered"]
    _same_bytes(got, ref)
    # no snapshot yet, the stream route's rows carried: not retried in
    # place
    with pytest.raises(faults.FaultError):
        _port(BINARY, x, y, 6, _ck(tmp_path / "ck1",
                                   LGBM_TPU_FAULT="oom@1"))
    # an unclassified exception propagates as it is
    def boom(env):
        raise KeyError("a callback's bug")
    with pytest.raises(KeyError):
        _with_env(_ck(tmp_path / "ck2"), lambda: lgt.train(
            BINARY, lgt.Dataset(x, label=y), 3, device="cpu",
            callbacks=[boom]))
