"""The parallel tree learners of the port (``lightgbm_tpu_torch/parallel``)
on the CPU over gloo, against the JAX package's mesh learners.

Each world size is one ``spawn`` of ranks running the module-level
:func:`_worker`, which trains several configurations in turn and sends
numpy results back; this file imports ``lightgbm_tpu`` only inside its
fixtures, so a spawned rank loads no JAX.  Every join has a timeout and
kills its ranks on failure.  The problem is ``tests/test_parallel.py``'s
(600 x 10 rows, 15 leaves, ``max_bin`` 31, 5 rounds); the JAX package
trains it on the conftest's 8-device CPU mesh, its default there.

Tolerances: against the JAX package, tree structure (leaf counts, split
features, threshold bins, decision types, leaf counts) is equal and leaf
values agree within ``LEAF_RTOL`` relative to the tree's largest leaf
(the two packages add the ranks' histograms in other orders), raw
predictions within the JAX tests' own ``rtol=1e-4, atol=5e-4``.  Within
the port: every rank's model text is the same; the full merge equals
the reduce-scatter merge bit for bit; the feature learner equals the
serial row-order (``LGBM_TPU_PHYS=0``) trees bit for bit.
"""
from __future__ import annotations

import datetime
import os
import socket
import sys
import time
import traceback
import types

import numpy as np
import pytest
import torch

LEAF_RTOL = 1e-4
PRED_TOL = dict(rtol=1e-4, atol=5e-4)
BASE_PARAMS = {"objective": "binary", "num_leaves": 15,
               "min_data_in_leaf": 5, "max_bin": 31, "learning_rate": 0.2,
               "verbosity": -1}
ROUNDS = 5
JOIN_S = 150.0
# the knobs a configuration may set; unset otherwise
KNOBS = ("LGBM_TPU_HIST_SCATTER", "LGBM_TPU_FUSED", "LGBM_TPU_PHYS")


def make_binary(n=600, f=10, seed=7):
    """``tests/test_parallel.py``'s problem."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    logit = x[:, 0] * 1.5 - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
    y = (logit + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    return x, y


def make_multiclass(n=600, f=10, seed=7):
    """Three classes by the same logit's terciles."""
    x, _ = make_binary(n, f, seed)
    logit = x[:, 0] * 1.5 - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
    y = np.digitize(logit, np.quantile(logit, [1 / 3, 2 / 3]))
    return x, y.astype(np.float32)


def one_side_data():
    """Binary rows where rank 0's block of two (rows 0-299) holds only
    large values of feature 0, so the first split on it sends every one
    of that rank's rows right."""
    x, y = make_binary()
    x[:300, 0] = 5.0 + np.abs(x[:300, 0])
    y[:300] = 1.0
    return x, y


DATA = {"binary": make_binary, "multiclass": make_multiclass,
        "one_side": one_side_data}


def _tree_arrays(t) -> dict:
    return {k: np.asarray(getattr(t, k)) for k in (
        "split_feature", "threshold_bin", "decision_type", "leaf_count",
        "leaf_value")} | {"num_leaves": int(t.num_leaves)}


def _train(lgt, name, params, rounds):
    x, y = DATA[name]()
    p = dict(BASE_PARAMS, **params)
    bst = lgt.train(p, lgt.Dataset(x, label=y, params={"max_bin": 31}),
                    rounds, device="cpu")
    text = bst.model_to_string()
    inner = bst._inner
    return {"text": text[:text.index("parameters:")],
            "trees": [_tree_arrays(t) for t in bst._models],
            "pred": np.asarray(bst.predict(x, raw_score=True)),
            "route": inner.route.describe(),
            "calls": 0 if inner.comm is None else inner.comm.calls,
            "bytes": 0 if inner.comm is None else inner.comm.bytes_sent}


def _worker(rank: int, world: int, port: int, configs, queue, mode: str):
    """One rank: join (or make) the group, train each configuration of
    ``configs`` (``(label, data, params, env, rounds)``) and put
    ``(rank, {label: result or "ERR ..."})`` on ``queue``."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.parallel import Network
    lgt.set_verbosity(-1)
    out = {}
    try:
        if mode == "machines":
            # the group from LightGBM's own parameters
            machines = ",".join(f"127.0.0.1:{port + r}" for r in range(world))
            net = {"machines": machines, "num_machines": world,
                   "local_listen_port": port + rank, "time_out": 1}
            configs = [(lb, d, dict(p, **net), e, n)
                       for lb, d, p, e, n in configs]
        else:
            dist.init_process_group(
                "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                world_size=world, timeout=datetime.timedelta(seconds=20))
        for label, data, params, env, rounds in configs:
            for k in KNOBS:
                os.environ.pop(k, None)
            os.environ.update(env)
            t0 = time.perf_counter()
            try:
                if mode == "raise" and rank == world - 1:
                    raise RuntimeError("rank fails before training")
                out[label] = _train(lgt, data, params, rounds)
            except Exception as e:   # noqa: BLE001 - reported to the test
                out[label] = f"ERR {type(e).__name__}: {e}"
                if mode != "raise":
                    traceback.print_exc()
            if mode == "raise":
                out["seconds"] = time.perf_counter() - t0
        if mode == "machines":
            out["sync"] = [Network.global_sync_up_by_min(rank + 1.0),
                           Network.global_sync_up_by_max(rank + 1.0),
                           Network.global_sync_up_by_sum(rank + 1.0),
                           Network.global_sync_up_by_mean(rank + 1.0),
                           Network.global_sum([rank, 1.0]).tolist(),
                           Network.global_array(10.0 * rank).tolist(),
                           Network.rank(), Network.num_machines()]
    finally:
        queue.put((rank, out))
        if mode != "raise" and dist.is_initialized():
            Network.dispose() if mode == "machines" else (
                dist.destroy_process_group())


def _free_port(span: int = 1) -> int:
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if port + span < 65535:
            return port
    raise RuntimeError("no free port")


def spawn(world: int, configs, mode: str = "group", timeout: float = JOIN_S):
    """Run ``configs`` on ``world`` spawned ranks; each rank's results in
    rank order.  Kills every rank that outlives ``timeout``."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port(world)
    procs = [ctx.Process(target=_worker,
                         args=(r, world, port, configs, queue, mode))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            r, res = queue.get(timeout=max(deadline - time.monotonic(), 1))
            got[r] = res
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [got[r] for r in range(world)]


def _result(ranks, label):
    """The label's result, after checking every rank trained it and
    wrote the same model text."""
    res = [r[label] for r in ranks]
    for r in res:
        assert not isinstance(r, str), r
    assert all(r["text"] == res[0]["text"] for r in res), (
        f"{label}: the ranks' model texts differ")
    return res[0]


def _ns(trees):
    return [types.SimpleNamespace(**t) for t in trees]


def _assert_close_trees(port_trees, jax_models):
    from chip_smoke import compare_trees
    got = compare_trees(_ns(port_trees),
                        _ns([_tree_arrays(t) for t in jax_models]),
                        rtol=LEAF_RTOL)
    assert got["ok"], got


# ---------------------------------------------------------------------
# the ranks' runs, one spawn a world size
# ---------------------------------------------------------------------
DATA_P = {"tree_learner": "data"}


@pytest.fixture(scope="module", autouse=True)
def _keep_log_verbosity():
    """The tests here quiet the port's log; the next file in this
    process gets the verbosity it had back."""
    from lightgbm_tpu_torch.utils import log
    verbosity = log.get_verbosity()
    yield
    log.set_verbosity(verbosity)


@pytest.fixture(scope="module")
def w2():
    return spawn(2, [
        ("data", "binary", DATA_P, {}, ROUNDS),
        ("data_unfused", "binary", DATA_P, {"LGBM_TPU_FUSED": "0"}, ROUNDS),
        ("data_row_order", "binary", DATA_P, {"LGBM_TPU_PHYS": "0"}, ROUNDS),
        ("feature", "binary", {"tree_learner": "feature"}, {}, ROUNDS),
        ("multiclass", "multiclass",
         dict(DATA_P, objective="multiclass", num_class=3), {}, 3),
        ("one_side", "one_side", DATA_P, {}, 2),
    ])


@pytest.fixture(scope="module")
def w3():
    return spawn(3, [
        ("scatter", "binary", DATA_P, {}, ROUNDS),
        ("full", "binary", DATA_P, {"LGBM_TPU_HIST_SCATTER": "0"}, ROUNDS),
        ("scatter_unfused", "binary", DATA_P, {"LGBM_TPU_FUSED": "0"}, 3),
        ("full_unfused", "binary", DATA_P,
         {"LGBM_TPU_FUSED": "0", "LGBM_TPU_HIST_SCATTER": "0"}, 3),
    ])


@pytest.fixture(scope="module")
def w4():
    return spawn(4, [
        ("data", "binary", DATA_P, {}, ROUNDS),
        ("feature", "binary", {"tree_learner": "feature"}, {}, ROUNDS),
    ])


@pytest.fixture(scope="module")
def w8():
    return spawn(8, [
        ("vote2", "binary", {"tree_learner": "voting", "top_k": 2}, {},
         ROUNDS),
        ("vote_full", "binary", {"tree_learner": "voting", "top_k": 16}, {},
         ROUNDS),
        ("data", "binary", DATA_P, {}, ROUNDS),
    ])


@pytest.fixture(scope="module")
def port_serial():
    """The port's serial trees, default and row-order routes."""
    import lightgbm_tpu_torch as lgt
    lgt.set_verbosity(-1)
    out = {"default": _train(lgt, "binary", {}, ROUNDS)}
    os.environ["LGBM_TPU_PHYS"] = "0"
    try:
        out["row_order"] = _train(lgt, "binary", {}, ROUNDS)
    finally:
        os.environ.pop("LGBM_TPU_PHYS", None)
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's mesh learners on the conftest's 8-device CPU
    mesh (its default there), and its serial learner: (models, raw
    predictions) each."""
    for m in [k for k in list(sys.modules) if k.startswith("lightgbm_tpu")
              and not k.startswith("lightgbm_tpu_torch")]:
        del sys.modules[m]
    import lightgbm_tpu as lgb
    out = {}
    for label, data, params, rounds in (
            ("data", "binary", DATA_P, ROUNDS),
            ("feature", "binary", {"tree_learner": "feature"}, ROUNDS),
            ("vote2", "binary", {"tree_learner": "voting", "top_k": 2},
             ROUNDS),
            ("vote_full", "binary", {"tree_learner": "voting", "top_k": 16},
             ROUNDS),
            ("multiclass", "multiclass",
             dict(DATA_P, objective="multiclass", num_class=3), 3)):
        x, y = DATA[data]()
        p = dict(BASE_PARAMS, **params)
        bst = lgb.train(p, lgb.Dataset(x, label=y, params={"max_bin": 31}),
                        num_boost_round=rounds)
        out[label] = (list(bst._models),
                      np.asarray(bst.predict(x, raw_score=True)))
    return out


# ---------------------------------------------------------------------
# (a) data against the JAX data-parallel learner
# ---------------------------------------------------------------------
@pytest.mark.parametrize("world", [2, 4])
def test_data_matches_jax_data_parallel(world, w2, w4, jax_runs):
    res = _result({2: w2, 4: w4}[world], "data")
    assert res["route"].startswith(
        "path=physical fused=1 tail=kernel hist_merge=scatter")
    models, pred = jax_runs["data"]
    _assert_close_trees(res["trees"], models)
    np.testing.assert_allclose(res["pred"], pred, **PRED_TOL)


@pytest.mark.parametrize("label", ["data_unfused", "data_row_order"])
def test_data_other_routes_match_the_fused_route(label, w2):
    """``LGBM_TPU_FUSED=0`` and the row-order route grow the fused
    route's trees, up to the order of f32 additions: their smaller
    child's histogram sums its rows in the geometry of the local
    segment's bound (the globally smaller child may be the locally
    larger), the fused split in that of half of it."""
    from chip_smoke import compare_trees
    res, ref = _result(w2, label), _result(w2, "data")
    assert res["route"].startswith(
        "path=row_order" if label == "data_row_order"
        else "path=physical fused=0 tail=kernel hist_merge=scatter")
    got = compare_trees(_ns(res["trees"]), _ns(ref["trees"]), rtol=LEAF_RTOL)
    assert got["ok"], got


def test_data_matches_serial(w2, port_serial):
    """Data-parallel trees are the serial trees up to the order of the
    ranks' additions."""
    from chip_smoke import compare_trees
    got = compare_trees(_ns(_result(w2, "data")["trees"]),
                        _ns(port_serial["default"]["trees"]), rtol=LEAF_RTOL)
    assert got["ok"], got


# ---------------------------------------------------------------------
# (b) the full merge is the reduce-scatter merge, bit for bit
# ---------------------------------------------------------------------
@pytest.mark.parametrize("fused", ["", "_unfused"])
def test_full_merge_equals_reduce_scatter(fused, w3):
    """At W = 3 the 10 features chunk unevenly (4, 3, 3)."""
    scatter, full = _result(w3, "scatter" + fused), _result(w3, "full" + fused)
    assert "hist_merge=scatter" in scatter["route"]
    assert "hist_merge=full" in full["route"]
    assert "hist_scatter_env_off" in full["route"]
    assert scatter["text"] == full["text"]
    # three collectives a split either way (the counts, the histogram
    # chunks, then the election or the gather of the merged chunks); the
    # gather moves the whole histogram again, the election a row
    assert scatter["calls"] == full["calls"] > 0
    assert 0 < scatter["bytes"] < full["bytes"]


# ---------------------------------------------------------------------
# (c) voting against the JAX voting learner
# ---------------------------------------------------------------------
def _auc(y, s):
    order = np.argsort(s)
    r = np.empty_like(order, dtype=np.float64)
    r[order] = np.arange(len(s))
    pos = y > 0
    return ((r[pos].sum() - pos.sum() * (pos.sum() - 1) / 2)
            / (pos.sum() * (~pos).sum()))


def test_voting_full_vote_matches_jax_voting(w8, jax_runs):
    """W = 8 ranks hold the JAX package's 8 shards' rows (75 each); every
    feature is elected."""
    res = _result(w8, "vote_full")
    assert res["route"] == ("path=row_order fused=0 tail=xla "
                            "hist_merge=vote (learner_row_order, "
                            "tail_voting)")
    models, pred = jax_runs["vote_full"]
    _assert_close_trees(res["trees"], models)
    np.testing.assert_allclose(res["pred"], pred, **PRED_TOL)


def test_voting_top2_matches_jax_voting(w8, jax_runs):
    """``top_k`` 2: the first tree is the JAX package's (structure and
    leaves), and the model's AUC is within 0.01 of its (above its own
    test's 0.90).  Later trees may differ: each rank's ballot of 75 rows
    ties its second and third features' local gains exactly in 14-22 of
    its leaves (both packages then vote the lower feature) and within
    1e-5 in as many more, where the ulps the two packages' scores differ
    by after the first tree flip a vote (ROADMAP C)."""
    res = _result(w8, "vote2")
    models, pred = jax_runs["vote2"]
    _assert_close_trees(res["trees"][:1], models[:1])
    _, y = make_binary()
    a_port, a_jax = _auc(y, res["pred"]), _auc(y, pred)
    assert a_jax > 0.90 and abs(a_port - a_jax) < 0.01, (a_port, a_jax)


def test_full_vote_grows_the_data_trees(w8):
    """Every feature elected: the voting learner's trees are the data
    learner's (the pool's local subtraction adds in another order)."""
    from chip_smoke import compare_trees
    got = compare_trees(_ns(_result(w8, "vote_full")["trees"]),
                        _ns(_result(w8, "data")["trees"]), rtol=LEAF_RTOL)
    assert got["ok"], got


# ---------------------------------------------------------------------
# (d) feature: the serial row-order trees bit for bit
# ---------------------------------------------------------------------
@pytest.mark.parametrize("world", [2, 4])
def test_feature_equals_serial_row_order(world, w2, w4, port_serial,
                                         jax_runs):
    res = _result({2: w2, 4: w4}[world], "feature")
    assert res["route"] == ("path=row_order fused=0 tail=kernel "
                            "(learner_row_order)")
    assert res["text"] == port_serial["row_order"]["text"]
    models, pred = jax_runs["feature"]
    _assert_close_trees(res["trees"], models)
    np.testing.assert_allclose(res["pred"], pred, **PRED_TOL)


# ---------------------------------------------------------------------
# (e) a rank whose rows all go to one side
# ---------------------------------------------------------------------
def test_one_rank_all_one_side(w2):
    """Rank 0's rows all go right at the root split, so its left child
    is empty there (every wrapper takes the empty segment); the trees are
    the serial trees' structure."""
    import lightgbm_tpu_torch as lgt
    from chip_smoke import compare_trees
    res = _result(w2, "one_side")
    t0 = res["trees"][0]
    x, _ = one_side_data()
    assert t0["split_feature"][0] == 0
    lgt.set_verbosity(-1)
    ser = _train(lgt, "one_side", {}, 2)
    got = compare_trees(_ns(res["trees"]), _ns(ser["trees"]), rtol=LEAF_RTOL)
    assert got["ok"], got


# ---------------------------------------------------------------------
# (f) multiclass under data
# ---------------------------------------------------------------------
def test_multiclass_data_matches_jax(w2, jax_runs):
    res = _result(w2, "multiclass")
    models, pred = jax_runs["multiclass"]
    _assert_close_trees(res["trees"], models)
    np.testing.assert_allclose(res["pred"], pred, **PRED_TOL)


# ---------------------------------------------------------------------
# (g) the network layer
# ---------------------------------------------------------------------
def test_network_from_machines():
    """The group from ``machines`` / ``num_machines`` /
    ``local_listen_port`` (every rank on this host: the port picks the
    entry), the typed helpers' values, and the trees of a group that
    already existed."""
    ranks = spawn(2, [("data", "binary", DATA_P, {}, 2)], mode="machines")
    res = _result(ranks, "data")
    assert "hist_merge=scatter" in res["route"]
    for r, out in enumerate(ranks):
        mn, mx, sm, mean, gsum, garr, rank, world = out["sync"]
        assert (mn, mx, sm, mean) == (1.0, 2.0, 3.0, 1.5)
        assert gsum == [1.0, 2.0] and garr == [0.0, 10.0]
        assert (rank, world) == (r, 2)


def test_a_failing_rank_ends_the_run():
    """A rank that raises ends every rank within the group's timeout
    (20 s here): the others' collectives raise, none hangs."""
    t0 = time.monotonic()
    ranks = spawn(2, [("data", "binary", DATA_P, {}, 2)], mode="raise",
                  timeout=60)
    assert time.monotonic() - t0 < 60
    assert ranks[1]["data"].startswith("ERR RuntimeError")
    assert ranks[0]["data"].startswith("ERR LightGBMError")
    assert "collective" in ranks[0]["data"]
    assert ranks[0]["seconds"] < 25


# ---------------------------------------------------------------------
# the refusals, in one process
# ---------------------------------------------------------------------
REFUSED = [
    {"objective": "huber"}, {"objective": "regression_l1"},
    {"objective": "quantile"}, {"objective": "mape"}, {"objective": "fair"},
    {"objective": "poisson"}, {"objective": "gamma"},
    {"objective": "tweedie"}, {"objective": "cross_entropy"},
    {"objective": "cross_entropy_lambda"}, {"objective": "lambdarank"},
    {"boosting": "dart"}, {"boosting": "goss"},
    {"boosting": "rf", "bagging_fraction": 0.5, "bagging_freq": 1},
    {"bagging_fraction": 0.5, "bagging_freq": 1},
    {"linear_tree": True}, {"gpu_use_dp": True}, {"is_unbalance": True},
    {"monotone_constraints": [1, 0, 0, 0]},
    {"monotone_constraints": [1, 0, 0, 0],
     "monotone_constraints_method": "intermediate"},
    {"cegb_penalty_split": 0.5},
    {"cegb_penalty_feature_coupled": [1.0, 0, 0, 0]},
    {"cegb_penalty_feature_lazy": [1.0, 0, 0, 0]},
    {"forcedsplits_filename": "forced.json"},
    {"interaction_constraints": "[[0, 1]]"},
    {"feature_fraction_bynode": 0.5}, {"extra_trees": True},
    {"tpu_mesh_axes": "data:2,feature:4"},
]


@pytest.mark.parametrize("learner", ["data", "voting", "feature"])
@pytest.mark.parametrize("params", REFUSED)
def test_refusals_name_a10(learner, params):
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.utils.log import LightGBMError
    rng = np.random.default_rng(1)
    x = rng.normal(size=(200, 4))
    y = (x[:, 0] > 0).astype(np.float32)
    p = dict({"objective": "binary", "verbosity": -1,
              "tree_learner": learner}, **params)
    with pytest.raises(LightGBMError, match=r"ROADMAP\.md, A10\)"):
        lgt.train(p, lgt.Dataset(x, label=y), 1, device="cpu")


@pytest.mark.parametrize("knob", [("LGBM_TPU_COMB_PACK", "2"),
                                  ("LGBM_TPU_PART", "3ph")])
def test_refused_knobs_name_a10(knob, monkeypatch):
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.utils.log import LightGBMError
    monkeypatch.setenv(*knob)
    x, y = make_binary(200, 4, 1)
    with pytest.raises(LightGBMError, match=r"ROADMAP\.md, A10\)"):
        lgt.train(dict(BASE_PARAMS, tree_learner="data"),
                  lgt.Dataset(x, label=y), 1, device="cpu")


def test_world_of_one_trains_serially():
    """No group: a parallel learner trains the serial trees (the JAX
    package with one device), its route a serial one."""
    import lightgbm_tpu_torch as lgt
    lgt.set_verbosity(-1)
    a = _train(lgt, "binary", {"tree_learner": "data"}, 2)
    b = _train(lgt, "binary", {}, 2)
    assert a["text"] == b["text"] and a["route"] == b["route"]
    assert "hist_merge" not in a["route"]
