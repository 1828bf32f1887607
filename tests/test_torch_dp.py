"""``gpu_use_dp`` in the PyTorch port: the f64-accumulating mode of the
row-order histogram (``hist_kernel2.build_histogram_rows_dp``; its plain
version ``build_histogram_rows_ref(..., dp=True)``), its geometry, the
route and training against the JAX package's x64 run.

The JAX package accumulates in f64 only under ``JAX_ENABLE_X64`` (its
scatter stays f32 otherwise, ``ops/histogram.py:184``), and turning x64
on inside pytest would leak into other tests of the same worker, so the
JAX side runs in a subprocess and hands back its model text.

Tolerances: the f64 plain histogram equals a numpy f64 accumulation in
the same order rounded to f32 bit for bit; trees equal the JAX package's
x64 trees in structure (split features, thresholds, decision types,
children, leaf counts; the text's float fields other than thresholds are
not compared: the two packages' f32 gradient sums differ in order).
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
from lightgbm_tpu_torch.ops import hist_kernel2 as hk
from lightgbm_tpu_torch.ops.routing import RouteInputs, decide
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
STRUCT_KEYS = ("num_leaves", "split_feature", "threshold", "decision_type",
               "left_child", "right_child", "leaf_count", "num_cat",
               "cat_boundaries", "cat_threshold")


def _numpy_dp(bins, vals, lo, hi, nslices, b, index=None):
    """Each slice's rows added one by one in f64, the slices' sums added
    in slice order in f64, rounded to f32 once."""
    f = bins.shape[1]
    out = np.zeros((f, b, 2), np.float64)
    for s_lo, s_hi in hk.block_ranges(lo, hi, nslices):
        part = np.zeros((f, b, 2), np.float64)
        for p in range(s_lo, s_hi):
            r = p if index is None else index[p]
            for j in range(f):
                part[j, bins[r, j]] += vals[r].astype(np.float64)
        out = out + part
    return out.astype(np.float32)


@pytest.mark.parametrize("b,dtype,max_rows,indexed", [
    (256, np.uint8, 300, False), (256, np.uint8, 9000, True),
    (1024, np.uint16, 40_000, True)])
def test_f64_plain_histogram_is_numpy_f64_rounded_once(b, dtype, max_rows,
                                                       indexed):
    rng = np.random.default_rng(b + max_rows)
    n, f = 900, 3
    bins = rng.integers(0, b, size=(n, f)).astype(dtype)
    # values whose f32 sums would round: a large one and many small ones
    vals = rng.normal(size=(n, 2)).astype(np.float32)
    vals[::50] *= 3e4
    index = rng.permutation(n).astype(np.int32) if indexed else None
    lo, cnt = 37, 800
    got = hk.build_histogram_rows_dp(
        torch.tensor(bins), torch.tensor(vals),
        torch.tensor([lo, cnt], dtype=torch.int32),
        index=None if index is None else torch.tensor(index),
        padded_bins=b, max_rows=max_rows)
    want = _numpy_dp(bins, vals, lo, lo + cnt, hk.rows_blocks(max_rows, b),
                     b, index)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # and it is the f32 histogram's function, rounded differently
    f32 = hk.build_histogram_rows(
        torch.tensor(bins), torch.tensor(vals),
        torch.tensor([lo, cnt], dtype=torch.int32),
        index=None if index is None else torch.tensor(index),
        padded_bins=b, max_rows=max_rows)
    np.testing.assert_allclose(f32.numpy(), want, rtol=1e-5, atol=1e-2)


def test_f64_geometry_takes_the_accumulator_bytes():
    """The shared [fc, B, 2] histogram doubles: the partial blocks still
    fit at B = 256 and 1024, and the one-launch block's cells double."""
    for b, width in ((256, 1), (1024, 2)):
        f32, f64 = (hk.rows_geometry(28, b, width, 20, acc) for acc in (4, 8))
        assert f64.feats == hk.rows_feature_chunk(b, width, 8)
        assert f64.smem == hk.rows_smem_bytes(f64.feats, b, width, 8)
        assert f64.smem <= hk.MAX_SMEM
        assert (f64.smem - hk.rows_stage_bytes(f64.feats, width, 512)
                == 2 * (f32.smem - hk.rows_stage_bytes(f32.feats, width, 512))
                * f64.feats // f32.feats)
        d32, d64 = (hk.rows_geometry(28, b, width, 1, acc) for acc in (4, 8))
        assert d64.smem - d32.smem == hk.ROWS_WARPS * hk.ROWS_RANGE * 8
    # a width whose f64 histogram must take fewer features a block
    assert hk.rows_feature_chunk(4096, 2, 8) < hk.rows_feature_chunk(4096, 2, 4)


def test_gpu_use_dp_takes_row_order_loudly(capsys):
    d = decide(RouteInputs(gpu_use_dp=True))
    assert (d.path, d.reasons) == ("row_order", ("gpu_use_dp",))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(500, 4)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    bst = lgt.train({"objective": "binary", "num_leaves": 7,
                     "gpu_use_dp": True, "verbosity": 1},
                    lgt.Dataset(x, label=y), 2, device="cpu")
    assert bst._inner.route.describe() == (
        "path=row_order fused=0 tail=kernel (gpu_use_dp)")
    assert bst._inner.grow._hist is hk.build_histogram_rows_dp
    assert ("routing: gpu_use_dp takes the row_order path"
            in capsys.readouterr().err)


def test_gpu_use_dp_refuses_pack2(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_COMB_PACK", "2")
    x = np.random.default_rng(0).normal(size=(200, 3)).astype(np.float32)
    with pytest.raises(LightGBMError, match="gpu_use_dp"):
        lgt.train({"objective": "binary", "gpu_use_dp": True,
                   "verbosity": -1},
                  lgt.Dataset(x, label=(x[:, 0] > 0).astype(np.float32)), 1,
                  device="cpu")


JAX_X64 = r'''
import json, sys
import numpy as np
import lightgbm_tpu as lgb
args = json.loads(sys.argv[1])
out = {}
for name, case in args.items():
    d = np.load(case["data"])
    bst = lgb.train(case["params"], lgb.Dataset(d["x"], label=d["y"]),
                    case["rounds"])
    out[name] = [bst._inner._routing.path, bst.model_to_string()]
sys.stdout.write(json.dumps(out))
'''
OBJECTIVES = ("binary", "regression")


def _dp_case(objective):
    rng = np.random.default_rng(7)
    n, f = 3000, 6
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan
    z = np.nan_to_num(x)
    y_raw = z[:, 0] + 0.5 * z[:, 1] * z[:, 2] + 0.3 * rng.normal(size=n)
    y = ((y_raw > 0) if objective == "binary" else y_raw).astype(np.float32)
    params = {"objective": objective, "num_leaves": 15, "verbosity": -1,
              "gpu_use_dp": True}
    return x, y, params


@pytest.fixture(scope="module")
def jax_x64(tmp_path_factory):
    """Each objective's JAX x64 run in one subprocess: (path, model text)."""
    tmp = tmp_path_factory.mktemp("dp")
    args = {}
    for objective in OBJECTIVES:
        x, y, params = _dp_case(objective)
        data = tmp / f"{objective}.npz"
        np.savez(data, x=x, y=y)
        args[objective] = {"data": str(data), "params": params, "rounds": 3}
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LGBM_TPU_")}
    env.update(JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", JAX_X64, json.dumps(args)],
                         capture_output=True, text=True, env=env,
                         timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout)


def _tree_fields(text):
    trees, cur = [], None
    for line in text.splitlines():
        if line.startswith("end of trees"):
            break
        if line.startswith("Tree="):
            cur = {}
            trees.append(cur)
        elif cur is not None and "=" in line:
            k, v = line.split("=", 1)
            if k in STRUCT_KEYS:
                cur[k] = v
    return trees


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_gpu_use_dp_trees_match_jax_x64(jax_x64, objective):
    x, y, params = _dp_case(objective)
    path, text = jax_x64[objective]
    assert path == "row_order"
    bst = lgt.train(params, lgt.Dataset(x, label=y), 3, device="cpu")
    assert bst._inner.route.reasons == ("gpu_use_dp",)
    mine, theirs = _tree_fields(bst.model_to_string()), _tree_fields(text)
    assert len(mine) == len(theirs) == 3
    assert mine == theirs
