"""Compiled serving in the PyTorch port (``lightgbm_tpu_torch``) against
the JAX package, on the CPU.

The port runs with ``device="cpu"``, where the traversal wrapper takes
its plain PyTorch version; the JAX package runs its Pallas kernel in
interpret mode (``LGBM_TPU_SERVE_INTERP=kernel``), as its own serving
tests do.  Inputs are made with numpy from a seed and handed to both.

Tolerances: quantized bins and leaf indices must match exactly.  Scores
are f32 sums taken in another order than the reference's, so they must
agree within ``64 * T * eps_f32 * max(|s|, 1)`` (the bound of
tests/test_serve_kernel.py); probabilities within 1e-6 absolute.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from chip_smoke import make_rows, random_model_text
from conftest import restore_env_knobs, save_env_knobs
from lightgbm_tpu_torch.convert import serving_forest_from_numpy
from lightgbm_tpu_torch.ops import predict as tpred
from lightgbm_tpu_torch.ops import serve_kernel as tkern
from test_serve_kernel import KNOBS, _cat_frame, _higgs, _train

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
EPS32 = float(np.finfo(np.float32).eps)


def _tol(ref, n_trees):
    return 64 * n_trees * EPS32 * np.maximum(np.abs(ref), 1.0)


@pytest.fixture
def kernel_env():
    """JAX serving on, with its Pallas kernel in interpret mode."""
    saved = save_env_knobs(KNOBS)
    os.environ["LGBM_TPU_SERVE"] = "1"
    os.environ["LGBM_TPU_SERVE_INTERP"] = "kernel"
    yield
    restore_env_knobs(saved)


@pytest.fixture(scope="module")
def trained():
    """A JAX-trained dense binary booster (8% NaN) and a categorical
    one, with query rows holding the edge values."""
    x, y = _higgs(3000, nan_frac=0.08)
    dense = _train(x, y, {"objective": "binary", "num_leaves": 31})
    xc, yc = _cat_frame(2000)
    cat = _train(xc, yc, {"objective": "binary", "num_leaves": 15,
                          "max_cat_to_onehot": 4},
                 ds_params={"max_cat_to_onehot": 4},
                 categorical_feature=[1])
    xq, _ = _higgs(300, seed=5, nan_frac=0.2)
    xq[0] = np.nan
    xcq, _ = _cat_frame(300, seed=7)
    xcq[3, 1] = 999.0
    xcq[4, 1] = np.nan
    xcq[5, 1] = -2.0
    xcq[6, 1] = 3e9
    return {"dense": (dense, xq), "cat": (cat, xcq)}


def _synthetic_model(cat: bool, k: int = 1):
    """A port ServingModel (CPU) of a seeded random forest, and rows."""
    cats = (1, 4) if cat else ()
    text = random_model_text(n_trees=12 * k, num_leaves=31, n_features=8,
                             seed=21 + k + 2 * cat, cat_features=cats,
                             num_class=k)
    x = make_rows(512, 8, 21 + k + 2 * cat, cats)
    x[:5] = np.nan
    return lgt.Booster(model_str=text, device="cpu").serving_engine().model, x


def _jax_forest(port_forest, bf16=False):
    from lightgbm_tpu.ops.predict import ServingForest
    arrs = {k: jnp.asarray(v) for k, v in port_forest.numpy().items()}
    if bf16:
        arrs["leaf_value"] = arrs["leaf_value"].astype(jnp.bfloat16)
    return ServingForest(**arrs)


def _edge_rows(n_feat: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(64, n_feat)).astype(np.float32)
    edges = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-36, -1e-36,
                      45.0, 1e9, 2.0 ** 31, 3e9, -3e9, 2147483520.0, 7.9],
                     np.float32)
    for i, v in enumerate(edges):
        x[i] = v
    return x


# ---------------------------------------------------------------------
# quantizer
# ---------------------------------------------------------------------
@pytest.mark.parametrize("cat", [False, True])
def test_quantize_rows_kernel_matches_jax(cat):
    from lightgbm_tpu.ops.predict import quantize_rows_kernel as jq
    sm, _ = _synthetic_model(cat)
    x = _edge_rows(8, seed=4)
    got = tpred.quantize_rows_kernel(sm.forest, torch.from_numpy(x))
    want = np.asarray(jq(_jax_forest(sm.forest), jnp.asarray(x)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------
# traversal: plain version vs the JAX kernel (interpret mode)
# ---------------------------------------------------------------------
@pytest.mark.parametrize("cat,k,bf16", [(False, 1, False),
                                        (False, 1, True),
                                        (True, 1, False),
                                        (True, 3, True)])
def test_traverse_ref_matches_jax_kernel(cat, k, bf16):
    from lightgbm_tpu.ops.pallas.serve_kernel import (
        forest_kernel_args as jargs, make_serve_traverse)
    from lightgbm_tpu.ops.predict import quantize_rows_kernel as jq
    sm, x = _synthetic_model(cat, k)
    f = sm.forest
    if bf16:
        f.leaf_value = f.leaf_value.to(torch.bfloat16)
    geo = sm.kernel_geometry()
    assert (geo["cat_words_w"] > 0) == cat
    jf = _jax_forest(sm.forest, bf16=bf16)
    n, n_real = x.shape[0], x.shape[0] - 37
    bins_j = jq(jf, jnp.asarray(x))
    bins = tpred.quantize_rows_kernel(f, torch.from_numpy(x))
    np.testing.assert_array_equal(bins.numpy(), np.asarray(bins_j))
    common = dict(n=n, trees=geo["trees"], ni_pad=geo["ni_pad"],
                  nl_pad=geo["nl_pad"], cat_words_w=geo["cat_words_w"],
                  n_feat=8, num_class=k, n_steps=sm.n_steps,
                  leaf_dtype=jf.leaf_value.dtype, interpret=True)
    nr = jnp.asarray([n_real], jnp.int32)

    leaf_j = np.asarray(make_serve_traverse(**common, leaves=True)(
        *jargs(jf, leaves=True), bins_j, nr))
    leaf_t = torch.empty((n, geo["trees"]), dtype=torch.int32)
    tkern.serve_traverse_ref(tkern.forest_kernel_args(f, leaves=True),
                             bins, n_real, leaf_t, n_steps=sm.n_steps,
                             leaves=True)
    np.testing.assert_array_equal(leaf_t.numpy(), leaf_j)

    score_j = np.asarray(make_serve_traverse(**common)(
        *jargs(jf), bins_j, nr, jnp.zeros((n, k), jnp.float32)))
    score_t = torch.full((n, k), np.nan)
    tkern.serve_traverse_ref(tkern.forest_kernel_args(f), bins, n_real,
                             score_t, n_steps=sm.n_steps)
    assert np.all(np.abs(score_t.numpy() - score_j)
                  <= _tol(score_j, geo["trees"]))
    assert not score_t[n_real:].any()


def test_wrapper_takes_plain_version_on_cpu_only():
    sm, x = _synthetic_model(True)
    bins = tpred.quantize_rows_kernel(sm.forest, torch.from_numpy(x))
    args = tkern.forest_kernel_args(sm.forest)
    out_w = torch.empty((x.shape[0], 1))
    out_r = torch.empty((x.shape[0], 1))
    before = tkern.serve_traverse.launches
    got = tkern.serve_traverse(args, bins, 500, out_w, n_steps=sm.n_steps)
    assert got is out_w                      # written in place
    assert tkern.serve_traverse.launches == before   # no kernel launch
    tkern.serve_traverse_ref(args, bins, 500, out_r, n_steps=sm.n_steps)
    torch.testing.assert_close(out_w, out_r, rtol=0, atol=0)
    with pytest.raises(lgt.LightGBMError, match="cuda or cpu"):
        tkern.serve_traverse(args, bins.to("meta"), 500,
                             out_w.to("meta"), n_steps=sm.n_steps)


# ---------------------------------------------------------------------
# the plain gather walk over raw rows
# ---------------------------------------------------------------------
def test_gather_walk_matches_jax():
    from lightgbm_tpu.ops.predict import forest_leaves, forest_scores
    sm, x = _synthetic_model(True, 3)
    jf = _jax_forest(sm.forest)
    raw = torch.from_numpy(x)
    leaf_t = tpred.forest_leaves(sm.forest, raw, 400, n_steps=sm.n_steps)
    leaf_j = forest_leaves(jf, jnp.asarray(x), 400, n_steps=sm.n_steps)
    np.testing.assert_array_equal(leaf_t.numpy(), np.asarray(leaf_j))
    s_t = tpred.forest_scores(sm.forest, raw, 400, 3, n_steps=sm.n_steps)
    s_j = np.asarray(forest_scores(jf, jnp.asarray(x), 400,
                                   jnp.zeros((x.shape[0], 3)),
                                   n_steps=sm.n_steps))
    assert np.all(np.abs(s_t.numpy() - s_j) <= _tol(s_j, sm.n_trees))


# ---------------------------------------------------------------------
# ServingModel from model text: the same arrays and digest as JAX
# ---------------------------------------------------------------------
@pytest.mark.parametrize("name,bf16", [("dense", False), ("cat", False),
                                       ("cat", True)])
def test_serving_model_from_text_equals_jax(trained, name, bf16):
    from lightgbm_tpu.serve import ServingModel as JaxServingModel
    bst, _ = trained[name]
    text = bst.model_to_string()
    saved = save_env_knobs(KNOBS)
    try:
        if bf16:
            os.environ["LGBM_TPU_SERVE_LEAF_BF16"] = "1"
        jm = JaxServingModel.from_booster(lgb.Booster(model_str=text))
        pm = lgt.ServingModel.from_booster(
            lgt.Booster(model_str=text, device="cpu"), device="cpu")
    finally:
        restore_env_knobs(saved)
    port = pm.forest.numpy()
    for field in jm.forest._fields:
        want = np.asarray(getattr(jm.forest, field))
        got = port[field]
        if field == "leaf_value":
            assert str(getattr(pm.forest, field).dtype) == (
                "torch.bfloat16" if bf16 else "torch.float32")
            want = want.astype(np.float32)
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    assert pm.n_steps == jm.n_steps
    assert pm.digest == jm.digest
    jj = jm.to_json()
    jj.pop("kernel_fit")
    assert pm.to_json() == jj


# ---------------------------------------------------------------------
# carry-across: a JAX-trained forest (training bin mappers) served here
# ---------------------------------------------------------------------
def test_carry_across_trained_forest(trained, kernel_env):
    from lightgbm_tpu.serve import ServingEngine as JaxEngine
    from lightgbm_tpu.serve import ServingModel as JaxServingModel
    bst, xq = trained["dense"]
    jm = JaxServingModel.from_booster(bst)
    arrays = {f: np.asarray(getattr(jm.forest, f))
              for f in jm.forest._fields}
    pm = serving_forest_from_numpy(
        arrays, n_steps=jm.n_steps, num_class=jm.num_class,
        average_output=jm.average_output, objective_str=jm.objective_str,
        n_orig_features=jm.n_orig_features, device="cpu")
    assert pm.digest == jm.digest
    peng = lgt.ServingEngine(pm, bucket_min=64, bucket_max=256,
                             device="cpu")
    jeng = JaxEngine(jm, bucket_min=64, bucket_max=256)
    assert jeng.kernel_mode == "interpret"
    xq32 = np.asarray(xq, np.float32)
    host = np.stack([t.predict_leaf(np.asarray(xq, np.float64))
                     for t in bst._models], axis=1)
    leaves = peng.predict_leaves(xq32)
    np.testing.assert_array_equal(leaves, jeng.predict_leaves(xq32))
    np.testing.assert_array_equal(leaves, host)
    sj = jeng.predict(xq32)
    sp = peng.predict(xq32)
    assert np.all(np.abs(sp - sj) <= _tol(sj, pm.n_trees))


# ---------------------------------------------------------------------
# the whole slice: Booster(model_str=...).predict
# ---------------------------------------------------------------------
@pytest.mark.parametrize("name", ["dense", "cat"])
def test_booster_predict_matches_jax(trained, name):
    bst, xq = trained[name]
    text = bst.model_to_string()
    jb = lgb.Booster(model_str=text)
    pb = lgt.Booster(model_str=text, device="cpu")
    np.testing.assert_allclose(pb.predict(xq), jb.predict(xq), rtol=0,
                               atol=1e-6)
    rj = jb.predict(xq, raw_score=True)
    assert np.all(np.abs(pb.predict(xq, raw_score=True) - rj)
                  <= _tol(rj, jb.num_trees()))
    np.testing.assert_array_equal(pb.predict(xq, pred_leaf=True),
                                  jb.predict(xq, pred_leaf=True))
    np.testing.assert_allclose(
        pb.predict(xq, start_iteration=2, num_iteration=3),
        jb.predict(xq, start_iteration=2, num_iteration=3), rtol=0,
        atol=1e-6)


def test_booster_multiclass_and_unported_options():
    text = random_model_text(n_trees=9, num_leaves=31, n_features=8,
                             seed=3, cat_features=(1,), num_class=3)
    x = make_rows(200, 8, 3, (1,))
    jb = lgb.Booster(model_str=text)
    pb = lgt.Booster(model_str=text, device="cpu")
    np.testing.assert_allclose(pb.predict(x), jb.predict(x), rtol=0,
                               atol=1e-6)
    assert pb.predict(x, raw_score=True).shape == (200, 3)
    # pred_contrib and pred_early_stop, refused before slice 28, now run
    # (their parity with the JAX package: tests/test_torch_shap.py)
    assert pb.predict(x, pred_contrib=True).shape == (200, 3 * 9)
    es = dict(raw_score=True, pred_early_stop=True, pred_early_stop_freq=1,
              pred_early_stop_margin=0.5)
    np.testing.assert_array_equal(pb.predict(x, **es), jb.predict(x, **es))
    with pytest.raises(lgt.LightGBMError, match="query information"):
        lgt.Booster(params={"objective": "lambdarank", "verbosity": -1},
                    train_set=lgt.Dataset(x, label=np.arange(200) % 3),
                    device="cpu")


# ---------------------------------------------------------------------
# engine and queue contracts
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def engine_model():
    return _synthetic_model(True)


def test_engine_buckets_chunking_and_empty(engine_model):
    sm, x = engine_model
    eng = lgt.ServingEngine(sm, bucket_min=16, bucket_max=64,
                            device="cpu")
    assert [eng.bucket_for(n) for n in (1, 16, 17, 64, 65, 1000)] == \
        [16, 16, 32, 64, 64, 64]
    whole = lgt.ServingEngine(sm, bucket_min=16, bucket_max=512,
                              device="cpu").predict(x[:150])
    got = eng.predict(x[:150])
    np.testing.assert_allclose(got, whole, rtol=0, atol=1e-6)
    st = eng.stats()
    assert st["dispatches"] == 3 and st["buckets"] == [32, 64]
    assert st["programs"] == 2 and st["rows_true"] == 150
    assert st["rows_padded"] == 64 + 64 + 32
    leaves = eng.predict_leaves(x[:150])
    np.testing.assert_array_equal(
        leaves, tpred.forest_leaves(sm.forest, torch.from_numpy(x[:150]),
                                    150, n_steps=sm.n_steps).numpy())
    assert leaves.shape == (150, sm.n_trees)
    assert eng.predict(x[:0]).shape == (0, 1)
    assert eng.predict_leaves(x[:0]).shape == (0, sm.n_trees)
    with pytest.raises(lgt.LightGBMError, match="features"):
        eng.predict(x[:10, :7])
    with pytest.raises(lgt.LightGBMError, match="bucket cap"):
        eng.dispatch(x[:65])


def test_engine_pool_reuses_buffer_and_warm_count(engine_model):
    sm, x = engine_model
    eng = lgt.ServingEngine(sm, bucket_min=16, bucket_max=64,
                            device="cpu")
    p = eng.dispatch(x[:10])
    storage = p.out.data_ptr()
    first = eng.collect(p)
    assert first.shape == (10, 1)
    eng.mark_warm()
    p2 = eng.dispatch(x[:13])               # same 16-row bucket
    assert p2.out.data_ptr() == storage
    eng.collect(p2)
    assert len(eng._pool[16]) == 1
    assert eng.stats()["retraces_after_warmup"] == 0
    eng.collect(eng.dispatch(x[:40]))       # a new bucket after warmup
    assert eng.stats()["retraces_after_warmup"] == 1


def test_queue_fifo_and_latency(engine_model):
    sm, x = engine_model
    eng = lgt.ServingEngine(sm, bucket_min=16, bucket_max=64,
                            device="cpu")
    q = lgt.ServingQueue(eng, depth=2)
    sizes = [5, 30, 64, 1, 17]
    starts = np.cumsum([0] + sizes)
    tickets = [q.submit(x[s:s + n]) for s, n in zip(starts, sizes)]
    assert tickets == list(range(len(sizes)))
    first = q.result()
    rest = q.drain()
    outs = [first] + rest
    for s, n, out in zip(starts, sizes, outs):
        np.testing.assert_allclose(out, eng.predict(x[s:s + n]), rtol=0,
                                   atol=1e-6)
    lat = q.latency_percentiles()
    assert set(lat) == {"p50_ms", "p99_ms", "p999_ms", "count"}
    assert lat["count"] == len(sizes) and lat["p99_ms"] > 0
    with pytest.raises(lgt.LightGBMError, match="nothing"):
        q.result()


def test_bucket_knob_validated():
    # the error class from the same import as bucket_policy: a test file
    # that purged the lightgbm_tpu* modules before this one leaves lgt's
    # LightGBMError a different class from a fresh import's
    from lightgbm_tpu_torch.serve.engine import LightGBMError, bucket_policy
    saved = save_env_knobs(KNOBS)
    try:
        os.environ["LGBM_TPU_SERVE_BUCKETS"] = "64:32"
        with pytest.raises(LightGBMError, match="FLOOR:CAP"):
            bucket_policy()
        os.environ["LGBM_TPU_SERVE_BUCKETS"] = "32:128"
        assert bucket_policy() == (32, 128)
    finally:
        restore_env_knobs(saved)


# ---------------------------------------------------------------------
# boundaries
# ---------------------------------------------------------------------
def test_import_pulls_in_no_jax():
    code = ("import sys, lightgbm_tpu_torch, lightgbm_tpu_torch.convert, "
            "lightgbm_tpu_torch.ops._build, chip_smoke\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'lightgbm_tpu' "
            "or m.startswith('lightgbm_tpu.')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_ast_scan_finds_no_jax_import():
    files = sorted((REPO / "lightgbm_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "lightgbm_tpu"), \
                f"{path.relative_to(REPO)} imports {mod}"


def test_default_device_is_cuda_and_raises_without_it(engine_model):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: cuda is a valid default")
    sm, _ = engine_model
    text = random_model_text(n_trees=2, num_leaves=4, n_features=3, seed=1)
    with pytest.raises(lgt.LightGBMError, match="device='cpu'"):
        lgt.Booster(model_str=text)
    with pytest.raises(lgt.LightGBMError, match="device='cpu'"):
        lgt.ServingEngine(sm)
    pb = lgt.Booster(model_str=text, device="cpu")
    with pytest.raises(lgt.LightGBMError, match="device='cpu'"):
        lgt.ServingModel.from_booster(pb)
    with pytest.raises(lgt.LightGBMError, match="device='cpu'"):
        serving_forest_from_numpy(sm.forest.numpy(), n_steps=1,
                                  num_class=1, average_output=False,
                                  objective_str="", n_orig_features=8)
