"""C-API-compatible surface.

Counterpart of ``lightgbm_tpu/c_api.py`` (reference include/LightGBM/
c_api.h, src/c_api.cpp): the same ``LGBM_*`` function names, handle
discipline and error convention as thin Python wrappers, so code written
against the reference's C API ports by swapping ``ctypes.CDLL`` calls
for these functions.  Handles are integers into a process-local
registry; every call returns 0 on success and -1 on failure, the message
kept for ``LGBM_GetLastError`` (c_api.cpp API_BEGIN / API_END).

The device comes from the parameters (``utils.device.device_from_params``):
a booster made with ``device_type=cpu`` runs on the CPU, with any other
value on the card.  ``LGBM_BoosterCreateFromModelfile`` and
``LGBM_BoosterLoadModelFromString`` take an optional ``parameters``
string for that, which the reference's functions do not have.
``predict_type`` 3 (``C_API_PREDICT_CONTRIB``) gives the SHAP
contributions of ``Booster.predict(pred_contrib=True)``.
"""
from __future__ import annotations

import functools
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset
from .utils.device import device_from_params
from .utils.log import LightGBMError

__all__ = [
    "LGBM_GetLastError", "LGBM_DatasetCreateFromFile",
    "LGBM_DatasetCreateFromMat", "LGBM_DatasetCreateFromCSR",
    "LGBM_DatasetCreateFromCSC", "LGBM_DatasetCreateByReference",
    "LGBM_DatasetPushRows", "LGBM_DatasetPushRowsByCSR",
    "LGBM_DatasetCreateValid", "LGBM_DatasetFree",
    "LGBM_DatasetGetNumData", "LGBM_DatasetGetNumFeature",
    "LGBM_DatasetSetField", "LGBM_DatasetSaveBinary",
    "LGBM_BoosterPredictForCSR", "LGBM_BoosterPredictForMatSingleRow",
    "LGBM_BoosterPredictForMatSingleRowFastInit",
    "LGBM_BoosterPredictForMatSingleRowFast",
    "LGBM_BoosterPredictForCSRSingleRowFastInit",
    "LGBM_BoosterPredictForCSRSingleRowFast", "LGBM_FastConfigFree",
    "LGBM_BoosterGetNumFeature", "LGBM_BoosterCalcNumPredict",
    "LGBM_BoosterCreate", "LGBM_BoosterFree",
    "LGBM_BoosterCreateFromModelfile", "LGBM_BoosterLoadModelFromString",
    "LGBM_BoosterUpdateOneIter", "LGBM_BoosterUpdateOneIterCustom",
    "LGBM_BoosterRollbackOneIter", "LGBM_BoosterGetCurrentIteration",
    "LGBM_BoosterGetNumClasses", "LGBM_BoosterNumberOfTotalModel",
    "LGBM_BoosterAddValidData", "LGBM_BoosterGetEval",
    "LGBM_BoosterGetEvalNames", "LGBM_BoosterPredictForMat",
    "LGBM_BoosterPredictForFile", "LGBM_BoosterSaveModel",
    "LGBM_BoosterSaveModelToString", "LGBM_BoosterDumpModel",
    "LGBM_BoosterFeatureImportance", "LGBM_BoosterGetFeatureNames",
]

_lock = threading.Lock()
_handles: Dict[int, Any] = {}
_next_handle = [1]
_last_error = [""]

# prediction type constants (c_api.h C_API_PREDICT_*)
C_API_PREDICT_NORMAL = 0
C_API_PREDICT_RAW_SCORE = 1
C_API_PREDICT_LEAF_INDEX = 2
C_API_PREDICT_CONTRIB = 3


def _register(obj) -> int:
    with _lock:
        h = _next_handle[0]
        _next_handle[0] += 1
        _handles[h] = obj
    return h


def _get(handle: int):
    try:
        return _handles[handle]
    except KeyError:
        raise LightGBMError(f"invalid handle {handle}")


def _api(fn):
    """API_BEGIN/API_END: catch everything, stash the message, return -1."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - C API swallows by contract
            _last_error[0] = str(e)
            return -1
    return wrapper


def LGBM_GetLastError() -> str:
    return _last_error[0]


def _parse_params(parameters: str) -> Dict[str, str]:
    """KV2Map analog (config.cpp:230): strips comments; values coerced by
    Config.from_params downstream, matching every other entry point."""
    out = {}
    for line in str(parameters or "").splitlines() or [""]:
        line = line.split("#", 1)[0]
        for tok in line.split():
            if "=" in tok:
                k, _, v = tok.partition("=")
                out[k] = v
    return out


def _device(params: Dict[str, str]) -> str:
    """The booster's device from its parameters (``device_type`` or its
    alias ``device``)."""
    for key in ("device_type", "device"):
        if key in params:
            return device_from_params(params[key])
    return device_from_params("")


# ---------------------------------------------------------------- dataset
@_api
def LGBM_DatasetCreateFromFile(filename: str, parameters: str,
                               reference: Optional[int], out: List[int]):
    ref = _get(reference) if reference else None
    ds = Dataset(str(filename), params=_parse_params(parameters),
                 reference=ref)
    ds.construct()
    out[:] = [_register(ds)]
    return 0


@_api
def LGBM_DatasetCreateFromMat(data, parameters: str,
                              label=None, reference: Optional[int] = None,
                              out: List[int] = None):
    ref = _get(reference) if reference else None
    ds = Dataset(np.asarray(data), label=label,
                 params=_parse_params(parameters), reference=ref)
    ds.construct()
    out[:] = [_register(ds)]
    return 0


@_api
def LGBM_DatasetCreateFromCSR(indptr, indices, values, shape,
                              parameters: str, label=None,
                              reference: Optional[int] = None,
                              out: List[int] = None):
    import scipy.sparse as sp
    mat = sp.csr_matrix((np.asarray(values), np.asarray(indices),
                         np.asarray(indptr)), shape=tuple(shape))
    ds = Dataset(mat, label=label, params=_parse_params(parameters),
                 reference=_get(reference) if reference else None)
    ds.construct()
    out[:] = [_register(ds)]
    return 0


@_api
def LGBM_DatasetCreateFromCSC(col_ptr, indices, values, shape,
                              parameters: str, label=None,
                              reference: Optional[int] = None,
                              out: List[int] = None):
    """c_api.h LGBM_DatasetCreateFromCSC: column-compressed input."""
    import scipy.sparse as sp
    mat = sp.csc_matrix((np.asarray(values), np.asarray(indices),
                         np.asarray(col_ptr)), shape=tuple(shape))
    ds = Dataset(mat.tocsr(), label=label,
                 params=_parse_params(parameters),
                 reference=_get(reference) if reference else None)
    ds.construct()
    out[:] = [_register(ds)]
    return 0


class _StreamingDataset:
    """LGBM_DatasetCreateByReference + PushRows* staging buffer
    (c_api.h:175-278: per-thread streaming push; finalized on first
    consumption).  Rows may arrive out of order via start_row."""

    def __init__(self, reference, num_rows: int, num_cols: int, params):
        self.reference = reference
        self.params = params
        self.data = np.zeros((num_rows, num_cols), np.float64)
        self.label = np.zeros(num_rows, np.float32)
        self.fields: Dict[str, np.ndarray] = {}
        # actual row coverage, not a count: duplicate/overlapping pushes
        # must not let never-pushed (zero-filled) rows slip through
        self._pushed = np.zeros(num_rows, np.bool_)
        self._final = None

    def push(self, rows: np.ndarray, start_row: int):
        if self._final is not None:
            raise LightGBMError(
                "LGBM_DatasetPushRows after the dataset was consumed")
        n = rows.shape[0]
        if start_row < 0 or start_row + n > self.data.shape[0]:
            raise LightGBMError(
                f"LGBM_DatasetPushRows range [{start_row}, "
                f"{start_row + n}) outside dataset of "
                f"{self.data.shape[0]} rows")
        if self._pushed[start_row:start_row + n].any():
            raise LightGBMError(
                f"LGBM_DatasetPushRows overlapping push at row "
                f"{start_row}")
        self.data[start_row:start_row + n] = rows
        self._pushed[start_row:start_row + n] = True

    def finalize(self) -> Dataset:
        if self._final is None:
            if not self._pushed.all():
                missing = int((~self._pushed).sum())
                raise LightGBMError(
                    f"streaming dataset consumed with {missing} of "
                    f"{self.data.shape[0]} rows never pushed")
            ds = Dataset(self.data, label=self.label, params=self.params,
                         reference=self.reference)
            ds.construct()
            for name, arr in self.fields.items():
                getattr(ds, f"set_{name}")(arr)
            self._final = ds
        return self._final


def _as_dataset(obj):
    return obj.finalize() if isinstance(obj, _StreamingDataset) else obj


@_api
def LGBM_DatasetCreateByReference(reference: int, num_total_row: int,
                                  out: List[int]):
    ref: Dataset = _get(reference)
    sd = _StreamingDataset(ref, int(num_total_row), ref.num_feature(),
                           dict(ref.params or {}))
    out[:] = [_register(sd)]
    return 0


@_api
def LGBM_DatasetPushRows(handle: int, data, nrow: int, ncol: int,
                         start_row: int):
    sd = _get(handle)
    if not isinstance(sd, _StreamingDataset):
        raise LightGBMError("PushRows needs a dataset created by "
                            "LGBM_DatasetCreateByReference")
    sd.push(np.asarray(data, np.float64).reshape(int(nrow), int(ncol)),
            int(start_row))
    return 0


@_api
def LGBM_DatasetPushRowsByCSR(handle: int, indptr, indices, values,
                              ncol: int, start_row: int):
    sd = _get(handle)
    if not isinstance(sd, _StreamingDataset):
        raise LightGBMError("PushRowsByCSR needs a dataset created by "
                            "LGBM_DatasetCreateByReference")
    import scipy.sparse as sp
    indptr = np.asarray(indptr)
    mat = sp.csr_matrix((np.asarray(values), np.asarray(indices), indptr),
                        shape=(len(indptr) - 1, int(ncol)))
    sd.push(np.asarray(mat.todense(), np.float64), int(start_row))
    return 0


@_api
def LGBM_DatasetCreateValid(reference: int, data, label,
                            parameters: str, out: List[int]):
    ds = Dataset(np.asarray(data), label=label,
                 params=_parse_params(parameters),
                 reference=_get(reference))
    ds.construct()
    out[:] = [_register(ds)]
    return 0


@_api
def LGBM_DatasetFree(handle: int):
    with _lock:
        _handles.pop(handle, None)
    return 0


@_api
def LGBM_DatasetGetNumData(handle: int, out: List[int]):
    obj = _get(handle)
    if isinstance(obj, _StreamingDataset):
        out[:] = [obj.data.shape[0]]
    else:
        out[:] = [obj.num_data()]
    return 0


@_api
def LGBM_DatasetGetNumFeature(handle: int, out: List[int]):
    obj = _get(handle)
    if isinstance(obj, _StreamingDataset):
        out[:] = [obj.data.shape[1]]
    else:
        out[:] = [obj.num_feature()]
    return 0


@_api
def LGBM_DatasetSetField(handle: int, field_name: str, data):
    obj = _get(handle)
    if isinstance(obj, _StreamingDataset):
        # stage every field until the buffer is finalized — finalizing
        # here would silently drop rows pushed afterwards
        if field_name == "label":
            obj.label[:len(data)] = np.asarray(data, np.float32)
        elif field_name in ("weight", "init_score"):
            obj.fields[field_name] = np.asarray(data)
        elif field_name in ("group", "query"):
            obj.fields["group"] = np.asarray(data)
        else:
            raise LightGBMError(f"Unknown field {field_name}")
        return 0
    ds: Dataset = _as_dataset(obj)
    field = {"label": ds.set_label, "weight": ds.set_weight,
             "group": ds.set_group, "query": ds.set_group,
             "init_score": ds.set_init_score}
    if field_name not in field:
        raise LightGBMError(f"Unknown field {field_name}")
    field[field_name](np.asarray(data))
    return 0


@_api
def LGBM_DatasetSaveBinary(handle: int, filename: str):
    _get(handle).save_binary(str(filename))
    return 0


# ---------------------------------------------------------------- booster
@_api
def LGBM_BoosterCreate(train_data: int, parameters: str, out: List[int]):
    params = _parse_params(parameters)
    bst = Booster(params=params, train_set=_as_dataset(_get(train_data)),
                  device=_device(params))
    out[:] = [_register(bst)]
    return 0


@_api
def LGBM_BoosterCreateFromModelfile(filename: str, out_num_iterations,
                                    out: List[int], parameters: str = ""):
    bst = Booster(model_file=str(filename),
                  device=_device(_parse_params(parameters)))
    out_num_iterations[:] = [bst.current_iteration()]
    out[:] = [_register(bst)]
    return 0


@_api
def LGBM_BoosterLoadModelFromString(model_str: str, out_num_iterations,
                                    out: List[int], parameters: str = ""):
    bst = Booster(model_str=model_str,
                  device=_device(_parse_params(parameters)))
    out_num_iterations[:] = [bst.current_iteration()]
    out[:] = [_register(bst)]
    return 0


@_api
def LGBM_BoosterFree(handle: int):
    with _lock:
        _handles.pop(handle, None)
    return 0


@_api
def LGBM_BoosterUpdateOneIter(handle: int, is_finished: List[int]):
    is_finished[:] = [1 if _get(handle).update() else 0]
    return 0


@_api
def LGBM_BoosterUpdateOneIterCustom(handle: int, grad, hess,
                                    is_finished: List[int]):
    bst: Booster = _get(handle)
    # the serving engines cached by iteration slice predate the new trees
    bst._serve_engines.clear()
    fin = bst._inner.train_one_iter(np.asarray(grad, np.float32),
                                    np.asarray(hess, np.float32))
    is_finished[:] = [1 if fin else 0]
    return 0


@_api
def LGBM_BoosterRollbackOneIter(handle: int):
    _get(handle).rollback_one_iter()
    return 0


@_api
def LGBM_BoosterGetCurrentIteration(handle: int, out: List[int]):
    out[:] = [_get(handle).current_iteration()]
    return 0


@_api
def LGBM_BoosterGetNumClasses(handle: int, out: List[int]):
    out[:] = [_get(handle).num_model_per_iteration()]
    return 0


@_api
def LGBM_BoosterNumberOfTotalModel(handle: int, out: List[int]):
    out[:] = [_get(handle).num_trees()]
    return 0


@_api
def LGBM_BoosterAddValidData(handle: int, valid_data: int):
    bst: Booster = _get(handle)
    name = f"valid_{len(bst._name_valid_sets)}"
    bst.add_valid(_get(valid_data), name)
    return 0


@_api
def LGBM_BoosterGetEvalNames(handle: int, out_names: List[str]):
    # static: derive from the configured metric objects without running a
    # full evaluation pass
    bst: Booster = _get(handle)
    metrics = getattr(bst._inner, "_train_metrics", [])
    out_names[:] = [m.NAME for m in metrics]
    return 0


@_api
def LGBM_BoosterGetEval(handle: int, data_idx: int, out_results: List[float]):
    bst: Booster = _get(handle)
    if data_idx == 0:
        res = bst.eval_train()
    else:
        names = bst._name_valid_sets
        if data_idx - 1 >= len(names):
            raise LightGBMError(
                f"data_idx {data_idx} out of range "
                f"({len(names)} validation sets)")
        want = names[data_idx - 1]
        res = [r for r in bst.eval_valid() if r[0] == want]
    out_results[:] = [v for _, _, v, _ in res]
    return 0


@_api
def LGBM_BoosterPredictForMat(handle: int, data, predict_type: int,
                              start_iteration: int, num_iteration: int,
                              parameters: str, out_result: List):
    kw = {k: _coerce(v) for k, v in _parse_params(parameters).items()}
    pred = _get(handle).predict(
        np.asarray(data),
        start_iteration=start_iteration,
        num_iteration=num_iteration if num_iteration != 0 else None,
        raw_score=(predict_type == C_API_PREDICT_RAW_SCORE),
        pred_leaf=(predict_type == C_API_PREDICT_LEAF_INDEX),
        pred_contrib=(predict_type == C_API_PREDICT_CONTRIB),
        **kw)
    out_result[:] = [np.asarray(pred)]
    return 0


@_api
def LGBM_BoosterPredictForCSR(handle: int, indptr, indices, values,
                              num_col: int, predict_type: int,
                              start_iteration: int, num_iteration: int,
                              parameters: str, out_result: List):
    """c_api.h LGBM_BoosterPredictForCSR."""
    import scipy.sparse as sp
    indptr = np.asarray(indptr)
    mat = sp.csr_matrix((np.asarray(values), np.asarray(indices), indptr),
                        shape=(len(indptr) - 1, int(num_col)))
    return LGBM_BoosterPredictForMat(
        handle, np.asarray(mat.todense()), predict_type, start_iteration,
        num_iteration, parameters, out_result)


@_api
def LGBM_BoosterPredictForMatSingleRow(handle: int, data, predict_type: int,
                                       start_iteration: int,
                                       num_iteration: int, parameters: str,
                                       out_result: List):
    return LGBM_BoosterPredictForMat(
        handle, np.asarray(data).reshape(1, -1), predict_type,
        start_iteration, num_iteration, parameters, out_result)


class _FastConfig:
    """LGBM_BoosterPredictForMatSingleRowFastInit (c_api.h:1078): bind
    booster + parsed predict parameters once so the per-row call skips
    parameter parsing (the reference's FastConfigHandle)."""

    def __init__(self, booster, predict_type, start_iteration,
                 num_iteration, parameters, ncol):
        self.booster = booster
        self.kw = {k: _coerce(v)
                   for k, v in _parse_params(parameters).items()}
        self.predict_type = predict_type
        self.start_iteration = start_iteration
        self.num_iteration = num_iteration if num_iteration != 0 else None
        self.ncol = int(ncol)

    def predict(self, row):
        return self.booster.predict(
            np.asarray(row, np.float64).reshape(1, self.ncol),
            start_iteration=self.start_iteration,
            num_iteration=self.num_iteration,
            raw_score=(self.predict_type == C_API_PREDICT_RAW_SCORE),
            pred_leaf=(self.predict_type == C_API_PREDICT_LEAF_INDEX),
            pred_contrib=(self.predict_type == C_API_PREDICT_CONTRIB),
            **self.kw)


@_api
def LGBM_BoosterPredictForMatSingleRowFastInit(
        handle: int, predict_type: int, start_iteration: int,
        num_iteration: int, ncol: int, parameters: str,
        out_fast_config: List[int]):
    cfg = _FastConfig(_get(handle), predict_type, start_iteration,
                      num_iteration, parameters, ncol)
    out_fast_config[:] = [_register(cfg)]
    return 0


@_api
def LGBM_BoosterPredictForMatSingleRowFast(fast_config: int, data,
                                           out_result: List):
    cfg: _FastConfig = _get(fast_config)
    out_result[:] = [np.asarray(cfg.predict(data))]
    return 0


@_api
def LGBM_BoosterPredictForCSRSingleRowFastInit(
        handle: int, predict_type: int, start_iteration: int,
        num_iteration: int, num_col: int, parameters: str,
        out_fast_config: List[int]):
    return LGBM_BoosterPredictForMatSingleRowFastInit(
        handle, predict_type, start_iteration, num_iteration, num_col,
        parameters, out_fast_config)


@_api
def LGBM_BoosterPredictForCSRSingleRowFast(fast_config: int, indptr,
                                           indices, values,
                                           out_result: List):
    cfg: _FastConfig = _get(fast_config)
    row = np.zeros(cfg.ncol, np.float64)
    lo, hi = int(np.asarray(indptr)[0]), int(np.asarray(indptr)[-1])
    row[np.asarray(indices)[lo:hi]] = np.asarray(values)[lo:hi]
    out_result[:] = [np.asarray(cfg.predict(row))]
    return 0


@_api
def LGBM_FastConfigFree(fast_config: int):
    with _lock:
        _handles.pop(fast_config, None)
    return 0


@_api
def LGBM_BoosterGetNumFeature(handle: int, out: List[int]):
    out[:] = [_get(handle).num_feature()]
    return 0


@_api
def LGBM_BoosterCalcNumPredict(handle: int, num_row: int, predict_type: int,
                               start_iteration: int, num_iteration: int,
                               out_len: List[int]):
    bst: Booster = _get(handle)
    k = bst.num_model_per_iteration()
    total = bst.current_iteration()
    remain = max(total - int(start_iteration), 0)
    iters = min(num_iteration, remain) if num_iteration > 0 else remain
    if predict_type == C_API_PREDICT_LEAF_INDEX:
        per_row = iters * k
    elif predict_type == C_API_PREDICT_CONTRIB:
        per_row = (bst.num_feature() + 1) * k
    else:
        per_row = k
    out_len[:] = [int(num_row) * per_row]
    return 0


@_api
def LGBM_BoosterPredictForFile(handle: int, data_filename: str,
                               data_has_header: int, predict_type: int,
                               start_iteration: int, num_iteration: int,
                               parameters: str, result_filename: str):
    from .io.loader import load_text_file
    from .config import Config
    X, _, _, _ = load_text_file(
        str(data_filename),
        Config.from_params({"header": bool(data_has_header)}))
    out: List = []
    rc = LGBM_BoosterPredictForMat(handle, X, predict_type, start_iteration,
                                   num_iteration, parameters, out)
    if rc != 0:
        return rc
    np.savetxt(str(result_filename), np.asarray(out[0]), fmt="%.10g")
    return 0


@_api
def LGBM_BoosterSaveModel(handle: int, start_iteration: int,
                          num_iteration: int, feature_importance_type: int,
                          filename: str):
    _get(handle).save_model(str(filename),
                            num_iteration=num_iteration or None,
                            start_iteration=start_iteration)
    return 0


@_api
def LGBM_BoosterSaveModelToString(handle: int, start_iteration: int,
                                  num_iteration: int,
                                  feature_importance_type: int,
                                  out: List[str]):
    out[:] = [_get(handle).model_to_string(
        num_iteration=num_iteration or None,
        start_iteration=start_iteration)]
    return 0


@_api
def LGBM_BoosterDumpModel(handle: int, start_iteration: int,
                          num_iteration: int, feature_importance_type: int,
                          out: List[dict]):
    out[:] = [_get(handle).dump_model(
        num_iteration=num_iteration or None,
        start_iteration=start_iteration)]
    return 0


@_api
def LGBM_BoosterFeatureImportance(handle: int, num_iteration: int,
                                  importance_type: int, out: List):
    imp = _get(handle).feature_importance(
        importance_type="gain" if importance_type == 1 else "split",
        iteration=num_iteration or None)
    out[:] = [np.asarray(imp)]
    return 0


@_api
def LGBM_BoosterGetFeatureNames(handle: int, out: List[str]):
    out[:] = list(_get(handle).feature_name())
    return 0


def _coerce(v: str):
    try:
        return int(v)
    except ValueError:
        try:
            return float(v)
        except ValueError:
            return {"true": True, "false": False}.get(v.lower(), v)
