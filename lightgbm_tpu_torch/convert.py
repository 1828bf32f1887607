"""Carry state across from the JAX package, as numpy arrays.

A booster trained by ``lightgbm_tpu`` serves through its training bin
mappers; :func:`serving_forest_from_numpy` takes that build's
``ServingForest`` fields as numpy arrays, unchanged, and makes the
port's :class:`~lightgbm_tpu_torch.serve.ServingModel` from them, so
the port serves the very arrays the JAX engine serves.
:func:`dataset_from_numpy` takes a JAX ``BinnedDataset``'s bin mappers,
binned matrix and labels and makes the port's ``Dataset``, so both
packages can grow trees from identical bins.  The other way across is
the model text: ``booster.model_to_string()`` in the JAX package,
``lightgbm_tpu_torch.Booster(model_str=...)`` here.  This module takes
numpy arrays and plain values only and imports nothing of the JAX
package.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .basic import Dataset
from .io.binning import BinMapper
from .io.dataset_core import BinnedDataset
from .serve.model import (ServingModel, forest_from_numpy,
                          leaf_dtype_name, serving_digest)
from .utils.device import resolve_device


def serving_forest_from_numpy(arrays: dict, *, n_steps: int,
                              num_class: int, average_output: bool,
                              objective_str: str, n_orig_features: int,
                              device="cuda") -> ServingModel:
    """``arrays`` maps every ``ServingForest`` field name to its numpy
    array (``{f: np.asarray(getattr(forest, f)) for f in
    forest._fields}`` on the JAX side).  The digest is computed from
    the same bytes the JAX build hashes, so it equals the JAX digest
    whenever the leaf table is f32 (a bf16 table has lost the f32 bytes
    the JAX digest hashed)."""
    dev = resolve_device(device)
    t_cnt, ni_pad = arrays["split_feature"].shape
    nl_pad = arrays["leaf_value"].shape[1]
    leaf_dtype = leaf_dtype_name(arrays["leaf_value"].dtype)
    hashed = dict(arrays)
    hashed["leaf_value"] = np.asarray(arrays["leaf_value"], np.float32)
    digest = serving_digest(
        hashed, t_cnt=t_cnt, ni_pad=ni_pad, nl_pad=nl_pad,
        n_steps=n_steps, k=num_class, average_output=average_output,
        objective_str=objective_str, leaf_dtype=leaf_dtype)
    forest = forest_from_numpy(arrays, leaf_bf16=leaf_dtype == "bfloat16",
                               device=dev)
    k = max(int(num_class), 1)
    return ServingModel(forest, n_steps=n_steps, num_class=num_class,
                        average_output=average_output,
                        objective_str=objective_str,
                        n_orig_features=n_orig_features,
                        start_iteration=0, end_iteration=t_cnt // k,
                        n_trees=t_cnt, digest=digest)


# the stream comb's columns after the f bin columns
# (lightgbm_tpu/ops/pallas/stream_grad.py COL_G .. COL_CONSTS)
COMB_COL_G, COMB_COL_RID, COMB_COL_SC, COMB_COL_CONSTS = 0, 3, 6, 9


def rows_from_stream_comb(comb: np.ndarray, *, f: int, n: int, kind: str):
    """The port's row arrays ``(bins u8 [n, f], vals f32 [n, 3], rid i32
    [n], score f32 [n], consts f32 [n, 2])`` from the first ``n`` rows
    of a JAX stream comb ``[n_alloc, C]`` f32: bins from columns
    ``[0, f)``, the row id from its three bytes, the score and every
    bf16x3-split constant as ``hi + mid + lo`` in f32 (binary: sign,
    label weight; l2: target, weight)."""
    c = np.asarray(comb, np.float32)[:n]

    def col(k):
        return c[:, f + k]

    def bf16x3(k):
        return (col(k) + col(k + 1)) + col(k + 2)

    rid = (col(COMB_COL_RID).astype(np.int64) * 65536
           + col(COMB_COL_RID + 1).astype(np.int64) * 256
           + col(COMB_COL_RID + 2).astype(np.int64)).astype(np.int32)
    k0 = COMB_COL_CONSTS
    if kind == "binary":
        consts = np.stack([col(k0), bf16x3(k0 + 1)], axis=1)
    elif kind == "l2":
        consts = np.stack([bf16x3(k0), bf16x3(k0 + 3)], axis=1)
    else:
        raise ValueError(f"no stream layout for objective kind {kind!r}")
    return (np.ascontiguousarray(c[:, :f].astype(np.uint8)),
            np.ascontiguousarray(c[:, f + COMB_COL_G:f + COMB_COL_G + 3]),
            rid, np.ascontiguousarray(bf16x3(COMB_COL_SC)),
            np.ascontiguousarray(consts, np.float32))


def dataset_from_numpy(mappers: Sequence[Dict], bin_matrix: np.ndarray,
                       label, *, used_feature_map: Sequence[int],
                       num_total_features: int,
                       feature_names: Optional[List[str]] = None,
                       weight=None, init_score=None,
                       query_boundaries=None, raw_matrix=None) -> Dataset:
    """The port's constructed ``Dataset`` from a binned dataset's
    numpy state.  ``mappers`` are dicts of the ``BinMapper.to_dict``
    fields (``bin_type``, ``missing_type``, ``num_bins``,
    ``upper_bounds``, ``cat_values``, ``cat_bins``, ``default_bin``) of
    each used feature; ``bin_matrix`` is the ``[n, used_features]``
    binned matrix; ``used_feature_map`` maps used to original feature
    ids; ``init_score`` is ``[n]``, or class-major ``[K * n]`` for a
    multiclass model; ``query_boundaries`` are a ranking set's ``[Q +
    1]`` boundaries (``Metadata.query_boundaries``); ``raw_matrix`` is a
    linear-tree dataset's ``[n, used_features]`` raw values
    (``BinnedDataset.raw_matrix``)."""
    binned = BinnedDataset()
    binned.mappers = [BinMapper.from_dict(m) for m in mappers]
    binned.bin_matrix = np.ascontiguousarray(bin_matrix)
    binned.used_feature_map = np.asarray(used_feature_map, np.int32)
    binned.num_total_features = int(num_total_features)
    if raw_matrix is not None:
        binned.raw_matrix = np.ascontiguousarray(raw_matrix, np.float32)
    binned.feature_names = (list(feature_names) if feature_names is not None
                            else [f"Column_{i}"
                                  for i in range(num_total_features)])
    md = binned.metadata
    md.set_label(label)
    md.set_weight(weight)
    md.set_init_score(init_score)
    md.num_data = binned.num_data
    md.set_group(query_boundaries)
    md.check(binned.num_data)
    return Dataset.from_binned(binned)
