"""Carry a stacked forest across from the JAX package.

A booster trained by ``lightgbm_tpu`` serves through its training bin
mappers; :func:`serving_forest_from_numpy` takes that build's
``ServingForest`` fields as numpy arrays, unchanged, and makes the
port's :class:`~lightgbm_tpu_torch.serve.ServingModel` from them, so
the port serves the very arrays the JAX engine serves.  The other way
across is the model text: ``booster.model_to_string()`` in the JAX
package, ``lightgbm_tpu_torch.Booster(model_str=...)`` here.  This
module takes numpy arrays only and imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np

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
