"""Learning to rank in the PyTorch port against the JAX package, on the
CPU: query groups, the lambdarank and rank_xendcg objectives, the ndcg
and map metrics.

- Query groups: ``Metadata.set_group`` in both forms (sizes, and
  boundaries with or without the leading 0) and its sum-mismatch error
  equal the JAX ``Metadata.set_group``; ``pad_queries`` equals JAX
  ``_pad_queries``; ``Dataset(group=)`` reaches the binned metadata of
  the training set and of a validation set built with ``reference=``;
  ``convert.dataset_from_numpy`` carries a JAX binned dataset's
  boundaries, so both packages grow trees from identical bins and
  groups.
- Gradients on 40 seeded queries of 1-60 documents, grades 0-4:
  lambdarank against JAX ``LambdarankNDCG.get_gradients`` over
  ``lambdarank_norm`` on and off, truncation 3 and 30, weights on and
  off, within 1e-5 relative plus 1e-7 absolute (the JAX package sums in
  f32, the port in f64 rounded once; 0.47 of that bound was the most
  seen); the result of a query does not depend on its batch (bitwise).
  rank_xendcg's ``[Q, G]`` threefry draw equals JAX's bit for bit
  (``utils/random.uniform`` over ``Q * G``), and its gradients at
  iterations 0 and 1 match within 1e-5 relative plus 1e-6 absolute:
  each gradient is three terms of order 1 that cancel, each rounded in
  f32 by the JAX package (6.6e-7 the most seen).
- ``ndcg@k`` and ``map@k`` equal the JAX host metrics within 1e-12,
  a query whose labels are all 0 included.
- Training, 15 leaves, 3 iterations, the port on the route it picks
  against the JAX package on its row-order route: trees and raw scores
  held by ``test_torch_objectives.hold_trees``, the validation set's
  ndcg within 1e-6.
"""
import itertools
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from conftest import restore_env_knobs, save_env_knobs
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset_core import Metadata as JMetadata
from lightgbm_tpu.metric.metrics import create_metrics as j_metrics
from lightgbm_tpu.objective import create_objective as j_objective
from lightgbm_tpu.objective.rank import _pad_queries
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.convert import dataset_from_numpy
from lightgbm_tpu_torch.io.dataset_core import Metadata as TMetadata
from lightgbm_tpu_torch.metric import create_metrics as t_metrics
from lightgbm_tpu_torch.objective import create_objective as t_objective
from lightgbm_tpu_torch.objective.rank import (LambdarankNDCG, pad_queries,
                                               xendcg_grads)
from lightgbm_tpu_torch.utils.log import LightGBMError
from lightgbm_tpu_torch.utils.random import prng_key, uniform
from test_torch_objectives import hold_trees
from test_torch_train import ROUTE_KNOBS, ROW_ORDER_ROUTE, _purge

torch.set_num_threads(1)

CPU = torch.device("cpu")
RANK_BASE = {"num_leaves": 15, "verbosity": -1, "min_data_in_leaf": 5}
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7
XE_ATOL = 1e-6


def rank_data(n_queries: int, seed: int, f: int = 6, lo: int = 1,
              hi: int = 60):
    """Seeded rows in ``n_queries`` queries of ``lo``-``hi`` documents,
    10 % of the features NaN, grades 0-4 from a noisy function of the
    first three features: (x, y, sizes)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(lo, hi + 1, size=n_queries)
    n = int(sizes.sum())
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = np.nan
    t = (np.nan_to_num(x[:, 0]) + 0.5 * np.nan_to_num(x[:, 1] * x[:, 2])
         + 0.5 * rng.normal(size=n))
    y = np.digitize(t, [-0.3, 0.6, 1.3, 2.0]).astype(np.float32)
    return x, y, sizes


def jax_rank_train(params, x, y, group, rounds, valid=None, route=None,
                   record=None, init_score=None):
    """JAX training with query groups (or none) on its row-order route
    (or the knobs ``route``): the booster.  ``valid`` is (x, y, group);
    ``record(booster)`` runs after every iteration."""
    saved = save_env_knobs(ROUTE_KNOBS)
    for k in ROUTE_KNOBS:
        os.environ.pop(k, None)
    os.environ.update(ROW_ORDER_ROUTE if route is None else route)
    try:
        _purge()
        import lightgbm_tpu as lgb
        ds = lgb.Dataset(x, label=y, group=group, init_score=init_score)
        bst = lgb.Booster(params, ds)
        if valid is not None:
            bst.add_valid(lgb.Dataset(valid[0], label=valid[1],
                                      group=valid[2], reference=ds),
                          "valid_0")
        for _ in range(rounds):
            bst.update()
            if record is not None:
                record(bst)
        return bst
    finally:
        restore_env_knobs(saved)
        _purge()


def port_rank_train(params, x, y, group, rounds, valid=None, record=None,
                    env=None, init_score=None):
    """The port's training with query groups (or none), on the route it
    picks (or the knobs ``env``)."""
    knobs = tuple(set(ROUTE_KNOBS) | set(env or {}))
    saved = save_env_knobs(knobs)
    for k in knobs:
        os.environ.pop(k, None)
    os.environ.update(env or {})
    try:
        ds = lgt.Dataset(x, label=y, group=group, init_score=init_score)
        bst = lgt.Booster(params, ds, device="cpu")
        if valid is not None:
            bst.add_valid(lgt.Dataset(valid[0], label=valid[1],
                                      group=valid[2], reference=ds),
                          "valid_0")
        for _ in range(rounds):
            bst.update()
            if record is not None:
                record(bst)
        return bst
    finally:
        restore_env_knobs(saved)


def _metadata(label, sizes, weight=None):
    out = []
    for cls in (JMetadata, TMetadata):
        md = cls()
        md.num_data = len(label)
        md.set_label(label)
        md.set_weight(weight)
        md.set_group(sizes)
        out.append(md)
    return out


def _objectives(params, label, sizes, weight=None):
    mj, mt = _metadata(label, sizes, weight)
    oj = j_objective(JConfig.from_params(params))
    oj.init(mj, len(label))
    ot = t_objective(TConfig.from_params(params))
    ot.init(mt, len(label), CPU)
    return oj, ot


def _grad_case(seed: int = 21):
    """40 queries of 1-60 documents, grades 0-4, scores with ties."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 61, size=40)
    n = int(sizes.sum())
    lab = rng.integers(0, 5, size=n).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    score = (rng.normal(size=n) * 1.5).astype(np.float32)
    score[:30] = 0.25
    return sizes, lab, w, score


def _close(got, want, rtol, atol):
    err = np.abs(got - want)
    assert np.all(err <= rtol * np.abs(want) + atol), err.max()


# ---------------------------------------------------------------------
# query groups
# ---------------------------------------------------------------------
@pytest.mark.parametrize("group", [
    [3, 1, 4, 2], [0, 3, 4, 8, 10], [3, 4, 8, 10], [10], [1] * 10,
    [0, 10]], ids=["sizes", "bounds", "bounds_no_zero", "one_query",
                   "singletons", "two_bounds"])
def test_set_group_matches_jax(group):
    mj, mt = _metadata(np.zeros(10, np.float32), group)
    assert mt.query_boundaries.dtype == np.int32
    np.testing.assert_array_equal(mt.query_boundaries, mj.query_boundaries)


def test_set_group_sum_mismatch_raises():
    for cls in (JMetadata, TMetadata):
        md = cls()
        md.num_data = 10
        with pytest.raises(Exception, match="Sum of query counts"):
            md.set_group([3, 4, 4])
    md = TMetadata()
    md.set_group([3, 4])          # before num_data is known
    with pytest.raises(LightGBMError, match="Sum of query counts"):
        md.check(10)


def test_pad_queries_matches_jax():
    _, _, sizes = rank_data(30, 3)
    qb = np.concatenate([[0], np.cumsum(sizes)])
    idx_j, valid_j = _pad_queries(qb, int(qb[-1]))
    idx_t, valid_t = pad_queries(qb)
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_array_equal(valid_t, valid_j)
    assert idx_t.dtype == idx_j.dtype and valid_t.dtype == valid_j.dtype


def test_dataset_group_reaches_train_and_valid():
    x, y, sizes = rank_data(12, 4)
    ds = lgt.Dataset(x, label=y, group=sizes)
    vs = lgt.Dataset(x[:50], label=y[:50], group=[20, 30], reference=ds)
    vs.construct()
    np.testing.assert_array_equal(ds.get_group(), sizes)
    np.testing.assert_array_equal(ds.construct().get_group(), sizes)
    np.testing.assert_array_equal(vs._binned.metadata.query_boundaries,
                                  [0, 20, 50])
    ds.set_group(np.cumsum(sizes))
    np.testing.assert_array_equal(ds.get_group(), sizes)


def test_dataset_from_numpy_carries_the_groups():
    """The JAX package's binned dataset, carried across with its query
    boundaries, trains the port's trees as the port's own binning
    does."""
    x, y, sizes = rank_data(25, 5)
    saved = save_env_knobs(ROUTE_KNOBS)
    try:
        _purge()
        import lightgbm_tpu as lgb
        jb = lgb.Dataset(x, label=y, group=sizes).construct()._binned
        mappers = [m.to_dict() for m in jb.mappers]
        state = (np.asarray(jb.bin_matrix), jb.metadata.label,
                 jb.used_feature_map, jb.num_total_features,
                 jb.metadata.query_boundaries)
    finally:
        restore_env_knobs(saved)
        _purge()
    carried = dataset_from_numpy(
        mappers, state[0], state[1], used_feature_map=state[2],
        num_total_features=state[3], query_boundaries=state[4])
    np.testing.assert_array_equal(
        carried._binned.metadata.query_boundaries, state[4])
    params = dict(RANK_BASE, objective="lambdarank")
    a = lgt.train(params, carried, 2, device="cpu")
    b = lgt.train(params, lgt.Dataset(x, label=y, group=sizes), 2,
                  device="cpu")
    assert a.model_to_string() == b.model_to_string()


# ---------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------
@pytest.mark.parametrize("norm,trunc,weighted",
                         list(itertools.product([True, False], [3, 30],
                                                [False, True])))
def test_lambdarank_gradients_match_jax(norm, trunc, weighted):
    sizes, lab, w, score = _grad_case()
    params = {"objective": "lambdarank", "lambdarank_norm": norm,
              "lambdarank_truncation_level": trunc}
    oj, ot = _objectives(params, lab, sizes, w if weighted else None)
    gj, hj = (np.asarray(a) for a in oj.get_gradients(score))
    gt, ht = (a.numpy() for a in ot.get_gradients(torch.as_tensor(score)))
    assert gt.dtype == np.float32 and gt.shape == gj.shape
    assert np.any(gt != 0) and np.all(ht >= 0)
    _close(gt, gj, GRAD_RTOL, GRAD_ATOL)
    _close(ht, hj, GRAD_RTOL, GRAD_ATOL)


def test_lambdarank_query_does_not_depend_on_its_batch():
    sizes, lab, _, score = _grad_case(5)
    _, ot = _objectives({"objective": "lambdarank"}, lab, sizes)
    assert isinstance(ot, LambdarankNDCG)
    s = torch.as_tensor(score)
    ot.plan(1 << 40)
    assert len(ot.batches) == 1
    whole = ot.query_gradients(s)
    for budget in (1, 7 * 30 ** 2):
        ot.plan(budget)
        assert len(ot.batches) > 1
        got = ot.query_gradients(s)
        assert all(torch.equal(a, c) for a, c in zip(got, whole))


@pytest.mark.parametrize("seed,q,g", [(5, 40, 60), (6, 7, 3), (123, 1, 1),
                                      (0x7FFFFFFF, 33, 129)])
def test_flat_threefry_draw_is_jax_qg_draw(seed, q, g):
    """The partitionable threefry draws element (q, g) of a [Q, G] draw
    from the counter q * G + g, so the flat draw reshaped is JAX's."""
    import jax
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (q, g)))
    got = uniform(prng_key(seed), q * g, "cpu").reshape(q, g).numpy()
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("weighted", [False, True])
def test_xendcg_gradients_match_jax(weighted):
    sizes, lab, w, score = _grad_case(8)
    oj, ot = _objectives({"objective": "rank_xendcg"}, lab, sizes,
                         w if weighted else None)
    for it in range(2):
        gj, hj = (np.asarray(a) for a in oj.get_gradients(score))
        gt, ht = (a.numpy() for a in ot.get_gradients(
            torch.as_tensor(score)))
        _close(gt, gj, GRAD_RTOL, XE_ATOL)
        _close(ht, hj, GRAD_RTOL, GRAD_ATOL)
    assert ot._iteration == oj._iteration == 2


def test_xendcg_single_document_queries_get_zeros():
    s = torch.tensor([[0.5, -torch.inf], [0.1, 0.7]])
    valid = torch.tensor([[True, False], [True, True]])
    lab = torch.tensor([[3.0, 0.0], [1.0, 0.0]], dtype=torch.float64)
    lam, hes = xendcg_grads(s, lab, torch.full((2, 2), 0.5), valid)
    assert lam[0].eq(0).all() and hes[0].eq(0).all()
    assert lam[1].ne(0).all() and hes[1].gt(0).all()


@pytest.mark.parametrize("name", ["lambdarank", "rank_xendcg", "xendcg"])
def test_ranking_objective_needs_query_information(name):
    x, y, _ = rank_data(5, 1)
    with pytest.raises(LightGBMError, match="query information"):
        lgt.Booster(dict(RANK_BASE, objective=name),
                    lgt.Dataset(x, label=y), device="cpu")


# ---------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------
@pytest.mark.parametrize("metric,eval_at", [
    ("ndcg", None), ("ndcg", [1, 3, 10]), ("map", None), ("map", [2, 50]),
    ("ndcg", [5]), ("map", [1])])
def test_ranking_metrics_match_jax(metric, eval_at):
    sizes, lab, _, score = _grad_case(13)
    qb = np.concatenate([[0], np.cumsum(sizes)])
    lab[qb[3]:qb[4]] = 0.0           # a query whose labels are all 0
    params = {"metric": metric}
    if eval_at is not None:
        params["eval_at"] = eval_at
    mj, mt = _metadata(lab, sizes)
    (jm,) = j_metrics(JConfig.from_params(params))
    (tm,) = t_metrics(TConfig.from_params(params))
    jm.init(mj, len(lab))
    tm.init(mt, len(lab))
    raw = score.astype(np.float64)
    got, want = tm.eval(raw, raw), jm.eval(raw, raw)
    assert [(a, c) for a, _, c in got] == [(a, c) for a, _, c in want]
    assert len(got) == len(eval_at or [1, 2, 3, 4, 5])
    for (_, a, _), (_, b, _) in zip(got, want):
        assert abs(a - b) <= 1e-12


@pytest.mark.parametrize("metric", ["ndcg", "map"])
def test_ranking_metric_needs_query_information(metric):
    md = TMetadata()
    md.num_data = 4
    md.set_label(np.zeros(4))
    (m,) = t_metrics(TConfig.from_params({"metric": metric}))
    with pytest.raises(LightGBMError, match="query information"):
        m.init(md, 4)


# ---------------------------------------------------------------------
# training
# ---------------------------------------------------------------------
@pytest.mark.parametrize("objective", ["lambdarank", "rank_xendcg"])
def test_ranking_training_matches_jax(objective):
    x, y, sizes = rank_data(80, 11)
    xv, yv, gv = rank_data(15, 12)
    params = dict(RANK_BASE, objective=objective, metric="ndcg",
                  eval_at=[1, 3, 5])
    bj = jax_rank_train(params, x, y, sizes, 3, valid=(xv, yv, gv))
    bt = port_rank_train(params, x, y, sizes, 3, valid=(xv, yv, gv))
    assert bt._inner.grow.route.describe() == (
        "path=physical fused=1 tail=kernel (objective_not_streamable)")
    assert len(bt._models) == len(bj._models) == 3
    assert all(t.num_leaves > 1 for t in bt._models)
    assert hold_trees(bt, bj, x)[0] == []
    et, ej = bt.eval_valid(), bj.eval_valid()
    assert [r[1] for r in et] == [r[1] for r in ej] == [
        "ndcg@1", "ndcg@3", "ndcg@5"]
    for a, b in zip(et, ej):
        assert abs(a[2] - b[2]) <= 1e-6
