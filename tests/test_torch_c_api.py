"""The C-API surface of the PyTorch port (``lightgbm_tpu_torch.c_api``)
against the JAX package's, on the CPU.

The six flows of ``tests/test_c_api.py`` (train / predict / save / load,
the error convention, a custom objective, eval and importance, CSC and
streamed datasets, single-row and ``FastConfig`` prediction) run through
both packages' ``LGBM_*`` functions with one parameter string
(``device_type=cpu``: the port's booster runs on the CPU, the JAX
package reads and ignores it; the JAX package on its row-order route):
return codes equal, trees equal in structure with leaves within
``test_torch_train.LEAF_RTOL`` of the tree's largest, predictions and
metrics within 1e-5, importances equal.  ``predict_type`` 3 gives the
port's ``pred_contrib``.
"""
import contextlib
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu_torch as lgt
from chip_smoke import compare_trees
from conftest import restore_env_knobs, save_env_knobs
from lightgbm_tpu_torch import c_api as TC
from test_torch_train import (LEAF_RTOL, ROUTE_KNOBS, ROW_ORDER_ROUTE,
                              _data, _purge)

torch.set_num_threads(1)

ROWS = 3072
CPU = "device_type=cpu verbosity=-1"
BIN = f"objective=binary num_leaves=15 min_data_in_leaf=5 {CPU}"


@contextlib.contextmanager
def jax_c_api():
    saved = save_env_knobs(ROUTE_KNOBS)
    for k in ROUTE_KNOBS:
        os.environ.pop(k, None)
    os.environ.update(ROW_ORDER_ROUTE)
    try:
        _purge()
        from lightgbm_tpu import c_api
        yield c_api
    finally:
        restore_env_knobs(saved)
        _purge()


def _make(n=ROWS, seed=11):
    """``test_torch_train``'s parity rows (10 % NaN, noisy labels): the
    JAX flows' separable rows leave near-tied splits the two packages
    break differently."""
    x, y = _data(n, 6, seed)
    return x.astype(np.float64), y


def _both(flow, *args):
    """``flow(C, *args)`` through the port's and the JAX package's C API:
    (port result, JAX result)."""
    port = flow(TC, *args)
    with jax_c_api() as C:
        jax = flow(C, *args)
    return port, jax


def _same_trees(a, b):
    cmp = compare_trees(a._models, b._models, LEAF_RTOL)
    assert cmp["ok"], cmp


def _train_predict(C, tmp):
    x, y = _make()
    hd, nd, nf, hb, fin, it, nt, out = [], [], [], [], [], [], [], []
    rc = [C.LGBM_DatasetCreateFromMat(x, "max_bin=63", label=y, out=hd),
          C.LGBM_DatasetGetNumData(hd[0], nd),
          C.LGBM_DatasetGetNumFeature(hd[0], nf),
          C.LGBM_BoosterCreate(hd[0], BIN, hb)]
    rc += [C.LGBM_BoosterUpdateOneIter(hb[0], fin) for _ in range(6)]
    rc += [C.LGBM_BoosterGetCurrentIteration(hb[0], it),
           C.LGBM_BoosterNumberOfTotalModel(hb[0], nt),
           C.LGBM_BoosterPredictForMat(hb[0], x, C.C_API_PREDICT_NORMAL, 0,
                                       0, "", out)]
    mf = str(tmp / f"{C.__name__}.txt")
    h2, nit, out2 = [], [], []
    rc.append(C.LGBM_BoosterSaveModel(hb[0], 0, 0, 0, mf))
    load = ((mf, nit, h2, CPU) if C is TC else (mf, nit, h2))
    rc += [C.LGBM_BoosterCreateFromModelfile(*load),
           C.LGBM_BoosterPredictForMat(h2[0], x, C.C_API_PREDICT_NORMAL, 0,
                                       0, "", out2)]
    bst = C._handles[hb[0]]
    rc += [C.LGBM_BoosterFree(hb[0]), C.LGBM_DatasetFree(hd[0])]
    return {"rc": rc, "n": (nd[0], nf[0], it[0], nt[0]), "pred": out[0],
            "pred_loaded": out2[0], "bst": bst, "y": y}


def test_full_train_predict_flow(tmp_path):
    port, jax = _both(_train_predict, tmp_path)
    assert port["rc"] == jax["rc"] == [0] * len(port["rc"])
    assert port["n"] == jax["n"] == (ROWS, 6, 6, 6)
    _same_trees(port["bst"], jax["bst"])
    np.testing.assert_allclose(port["pred"], jax["pred"], atol=1e-5)
    assert ((port["pred"] > 0.5) == port["y"]).mean() > 0.8
    np.testing.assert_allclose(port["pred_loaded"], port["pred"], rtol=1e-6)


def _errors(C):
    out = []
    return C.LGBM_DatasetGetNumData(999999, out), C.LGBM_GetLastError()


def test_error_convention():
    port, jax = _both(_errors)
    assert port[0] == jax[0] == -1
    assert "invalid handle" in port[1] and port[1] == jax[1]


def _custom(C):
    x, y = _make()
    hd, hb, fin = [], [], []
    C.LGBM_DatasetCreateFromMat(x, "", label=y, out=hd)
    C.LGBM_BoosterCreate(hd[0], "objective=none num_leaves=7 "
                         f"min_data_in_leaf=5 {CPU}", hb)
    rcs = []
    for _ in range(4):
        out = []
        C.LGBM_BoosterPredictForMat(hb[0], x, C.C_API_PREDICT_RAW_SCORE, 0,
                                    0, "", out)
        grad = (out[0] - y).astype(np.float32)
        rcs.append(C.LGBM_BoosterUpdateOneIterCustom(
            hb[0], grad, np.ones_like(grad), fin))
    out = []
    C.LGBM_BoosterPredictForMat(hb[0], x, C.C_API_PREDICT_RAW_SCORE, 0, 0,
                                "", out)
    return rcs, out[0], C._handles[hb[0]], float(np.mean((out[0] - y) ** 2))


def test_custom_objective_update():
    port, jax = _both(_custom)
    assert port[0] == jax[0] == [0] * 4
    _same_trees(port[2], jax[2])
    np.testing.assert_allclose(port[1], jax[1], atol=1e-5)
    assert port[3] < 0.3        # from mean(y^2), about 0.5


def _eval(C):
    x, y = _make()
    xv, yv = _make(1000, seed=12)
    hd, hv, hb, fin, res, imp, names, calc = [], [], [], [], [], [], [], []
    C.LGBM_DatasetCreateFromMat(x, "", label=y, out=hd)
    C.LGBM_DatasetCreateValid(hd[0], xv, yv, "", hv)
    C.LGBM_BoosterCreate(hd[0], "objective=binary metric=auc num_leaves=15 "
                         f"min_data_in_leaf=5 {CPU}", hb)
    C.LGBM_BoosterAddValidData(hb[0], hv[0])
    for _ in range(3):
        C.LGBM_BoosterUpdateOneIter(hb[0], fin)
    rc = [C.LGBM_BoosterGetEval(hb[0], 1, res),
          C.LGBM_BoosterFeatureImportance(hb[0], 0, 0, imp),
          C.LGBM_BoosterGetEvalNames(hb[0], names),
          C.LGBM_BoosterCalcNumPredict(hb[0], 7, C.C_API_PREDICT_CONTRIB, 0,
                                       0, calc)]
    return rc, res, imp[0], names, calc[0], C._handles[hb[0]]


def test_eval_and_importance():
    port, jax = _both(_eval)
    assert port[0] == jax[0] == [0] * 4
    np.testing.assert_allclose(port[1], jax[1], atol=1e-5)
    assert port[1][0] > 0.8
    np.testing.assert_array_equal(port[2], jax[2])
    assert port[3] == jax[3] and port[4] == jax[4] == 7 * 7
    _same_trees(port[5], jax[5])


def _csc_stream(C):
    x, y = _make()
    csc = sp.csc_matrix(x)
    hd, n, hs, hb, fin = [], [], [], [], []
    rc = [C.LGBM_DatasetCreateFromCSC(csc.indptr, csc.indices, csc.data,
                                      x.shape, "", label=y, out=hd),
          C.LGBM_DatasetGetNumData(hd[0], n),
          C.LGBM_DatasetCreateByReference(hd[0], len(y), hs)]
    half = len(y) // 2
    rc += [C.LGBM_DatasetPushRows(hs[0], x[:half], half, x.shape[1], 0),
           C.LGBM_DatasetPushRows(hs[0], x[half:], len(y) - half, x.shape[1],
                                  half),
           C.LGBM_DatasetSetField(hs[0], "label", y),
           C.LGBM_BoosterCreate(hs[0], BIN, hb)]
    rc += [C.LGBM_BoosterUpdateOneIter(hb[0], fin) for _ in range(2)]
    again = C.LGBM_DatasetPushRows(hs[0], x[:1], 1, x.shape[1], 0)
    return rc, n[0], C._handles[hb[0]], again


def test_csc_and_streaming_create():
    port, jax = _both(_csc_stream)
    assert port[0] == jax[0] == [0] * len(port[0])
    assert port[1] == jax[1] == ROWS
    _same_trees(port[2], jax[2])
    assert port[3] == jax[3] == -1      # pushed after it was consumed


def _single_rows(C):
    x, y = _make()
    hd, hb, fin = [], [], []
    C.LGBM_DatasetCreateFromMat(x, "", label=y, out=hd)
    C.LGBM_BoosterCreate(hd[0], BIN, hb)
    for _ in range(3):
        C.LGBM_BoosterUpdateOneIter(hb[0], fin)
    batch, fc, fc2, csr_out, nlen, one_row = [], [], [], [], [], []
    C.LGBM_BoosterPredictForMat(hb[0], x[:5], C.C_API_PREDICT_NORMAL, 0, 0,
                                "", batch)
    C.LGBM_BoosterPredictForMatSingleRow(hb[0], x[2], C.C_API_PREDICT_NORMAL,
                                         0, 0, "", one_row)
    C.LGBM_BoosterPredictForMatSingleRowFastInit(
        hb[0], C.C_API_PREDICT_NORMAL, 0, 0, x.shape[1], "", fc)
    fast = []
    for i in range(5):
        one = []
        C.LGBM_BoosterPredictForMatSingleRowFast(fc[0], x[i], one)
        fast.append(float(one[0][0]))
    csr = sp.csr_matrix(x[:1])
    C.LGBM_BoosterPredictForCSRSingleRowFastInit(
        hb[0], C.C_API_PREDICT_NORMAL, 0, 0, x.shape[1], "", fc2)
    one = []
    C.LGBM_BoosterPredictForCSRSingleRowFast(fc2[0], csr.indptr, csr.indices,
                                             csr.data, one)
    csr_all = sp.csr_matrix(x[:5])
    C.LGBM_BoosterPredictForCSR(hb[0], csr_all.indptr, csr_all.indices,
                                csr_all.data, x.shape[1],
                                C.C_API_PREDICT_NORMAL, 0, 0, "", csr_out)
    C.LGBM_BoosterCalcNumPredict(hb[0], 5, C.C_API_PREDICT_NORMAL, 0, 0, nlen)
    contrib = []
    C.LGBM_BoosterPredictForMat(hb[0], x[:5], C.C_API_PREDICT_CONTRIB, 0, 0,
                                "", contrib)
    rc = [C.LGBM_FastConfigFree(fc[0]), C.LGBM_FastConfigFree(fc2[0])]
    return {"batch": np.asarray(batch[0]), "fast": np.array(fast),
            "one_row": float(np.ravel(one_row[0])[0]),
            "csr_one": float(one[0][0]),
            "csr": np.asarray(csr_out[0]).ravel(), "nlen": nlen[0],
            "rc": rc, "contrib": contrib[0], "bst": C._handles[hb[0]],
            "x": x}


def test_fast_single_row_predict():
    port, jax = _both(_single_rows)
    b = port["batch"]
    np.testing.assert_allclose(b, jax["batch"], atol=1e-5)
    np.testing.assert_allclose(port["fast"], b, atol=1e-6)
    assert abs(port["csr_one"] - b[0]) < 1e-6
    assert abs(port["one_row"] - b[2]) < 1e-6
    np.testing.assert_allclose(port["csr"], b, rtol=1e-6)
    assert port["nlen"] == jax["nlen"] == 5 and port["rc"] == [0, 0]
    assert np.array_equal(port["contrib"], port["bst"].predict(
        port["x"][:5], pred_contrib=True))
    assert port["contrib"].shape == (5, 7)
