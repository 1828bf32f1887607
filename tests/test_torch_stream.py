"""The stream route's row matrix (``ops/stream_grad.py``) against the JAX
package's stream kernels, on the CPU, and the route's rules.

The JAX side runs ``make_init`` / ``make_refresh(..., root_hist=True)``
with ``interpret=True`` (their XLA references, exact f32 arithmetic);
its comb is read back as the port's row arrays with
``convert.rows_from_stream_comb``.  Inputs are made with numpy from a
seed: scores with at most 16 significant bits (so the TPU layout's
bf16x3 split of the score is exact and ``hi + mid + lo`` gives it
back), label weights that are powers of two.

Tolerances: bins, row ids, scores, constants and validity are equal;
g*w within 2 f32 ulps and h*w within 4 eps_f32 of its largest value
(the port takes ``exp`` in f64 rounded once and divides by a
reciprocal, the JAX package's f32 ``exp`` and division differ in the
last places; ``s - abs_r`` cancels near the top of h).  The refresh's
root histogram equals the port's ``build_histogram_comb_ref`` over
[0, n) bit for bit and the JAX one within 4 * n * eps_f32 * max|v|.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from chip_smoke import hist_tolerance, rows_on
from lightgbm_tpu.ops.pallas import stream_grad as jsg
from lightgbm_tpu_torch.convert import rows_from_stream_comb
from lightgbm_tpu_torch.ops.hist_kernel2 import build_histogram_comb_ref
from lightgbm_tpu_torch.ops.routing import (RULES, RouteInputs, decide,
                                            inputs_from_env)
from lightgbm_tpu_torch.ops.stream_grad import (stream_init, stream_init_ref,
                                                stream_refresh)

torch.set_num_threads(1)

N, F, C, R, B = 4096, 7, 128, 512, 256
N_ALLOC = N + 1024
EPS32 = float(np.finfo(np.float32).eps)
CASES = [("binary", 1.0), ("binary", 0.7), ("l2", 1.0)]


def _inputs(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, 200, size=(N, F), dtype=np.uint8)
    score = (rng.integers(-2 ** 12, 2 ** 12, N) / 2.0 ** 9).astype(np.float32)
    valid = (rng.random(N) < 0.9).astype(np.float32)
    if kind == "binary":
        c0 = np.where(rng.random(N) < 0.4, 1.0, -1.0).astype(np.float32)
        c1 = (2.0 ** rng.integers(-1, 3, N)).astype(np.float32)
    else:
        c0 = (rng.integers(-2 ** 10, 2 ** 10, N) / 2.0 ** 7).astype(
            np.float32)
        c1 = (2.0 ** rng.integers(-1, 3, N)).astype(np.float32)
    lv = (rng.integers(-2 ** 8, 2 ** 8, N) / 2.0 ** 9).astype(np.float32)
    return bins, score, valid, np.stack([c0, c1], axis=1), lv


def _jax_init(kind, sigmoid, bins, score, valid, consts):
    split = (jsg.binary_consts if kind == "binary" else jsg.l2_consts)
    aux = jsg.build_aux(kind, jnp.asarray(score), jnp.asarray(valid),
                        split(jnp.asarray(consts[:, 0]),
                              jnp.asarray(consts[:, 1])))
    init = jsg.make_init(kind=kind, sigmoid=sigmoid, f_real=F, f=F,
                         n_alloc=N_ALLOC, n_pad=N, C=C, R=R, interpret=True)
    return init(jnp.zeros((N_ALLOC, C), jnp.float32), jnp.asarray(bins), aux)


def _port_init(kind, sigmoid, bins, score, valid, consts):
    t = torch.tensor
    return stream_init(t(bins), t(score), t(valid), t(consts), kind=kind,
                       sigmoid=sigmoid)


def _assert_rows_match(port, jax_arrays, kind):
    bins, vals, rid, score, consts = jax_arrays
    np.testing.assert_array_equal(port.bins.numpy(), bins)
    np.testing.assert_array_equal(port.rid.numpy(), rid)
    np.testing.assert_array_equal(port.score.numpy(), score)
    np.testing.assert_array_equal(port.consts.numpy(), consts)
    np.testing.assert_array_equal(port.vals[:, 2].numpy(), vals[:, 2])
    g_t, g_j = port.vals[:, 0].numpy(), vals[:, 0]
    ulps = np.abs(g_t.view(np.int32).astype(np.int64)
                  - g_j.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2, ulps.max()
    h_t, h_j = port.vals[:, 1].numpy(), vals[:, 1]
    assert np.abs(h_t - h_j).max() <= 4 * EPS32 * max(np.abs(h_j).max(), 1e-30)
    if kind == "l2":
        np.testing.assert_array_equal(g_t, g_j)
        np.testing.assert_array_equal(h_t, h_j)


@pytest.mark.parametrize("kind,sigmoid", CASES)
def test_stream_init_matches_jax(kind, sigmoid):
    inp = _inputs(kind, 1)
    comb = np.asarray(_jax_init(kind, sigmoid, *inp[:4]))
    port = _port_init(kind, sigmoid, *inp[:4])
    _assert_rows_match(port, rows_from_stream_comb(comb, f=F, n=N,
                                                   kind=kind), kind)


@pytest.mark.parametrize("kind,sigmoid", CASES)
def test_stream_refresh_matches_jax(kind, sigmoid):
    inp = _inputs(kind, 2)
    lv = inp[4]
    comb0 = _jax_init(kind, sigmoid, *inp[:4])
    refresh = jsg.make_refresh(kind=kind, sigmoid=sigmoid, f=F,
                               n_alloc=N_ALLOC, n_pad=N, C=C, R=R,
                               interpret=True, root_hist=True,
                               padded_bins=B)
    comb1, hist_j = refresh(comb0, jnp.asarray(lv)[None, :])
    port = _port_init(kind, sigmoid, *inp[:4])
    hist_t = stream_refresh(port, torch.tensor(lv), kind=kind,
                            sigmoid=sigmoid, padded_bins=B)
    _assert_rows_match(port, rows_from_stream_comb(
        np.asarray(comb1), f=F, n=N, kind=kind), kind)
    # the next tree's root histogram: hist_comb's over [0, n), bitwise
    want = build_histogram_comb_ref(
        port, torch.tensor([0, 0, N], dtype=torch.int32), padded_bins=B,
        max_rows=N)
    assert torch.equal(hist_t, want)
    assert np.abs(hist_t.numpy() - np.asarray(hist_j)).max() <= \
        hist_tolerance(port, (0, 0, N))


def test_stream_init_ref_layout():
    """The plain init: bins copied, row ids 0..n-1, the inputs in their
    columns, g*w and h*w zero where the row is not valid."""
    bins, score, valid, consts, _ = _inputs("binary", 3)
    t = torch.tensor
    rows = stream_init_ref(t(bins), t(score), t(valid), t(consts),
                           kind="binary", sigmoid=1.0)
    np.testing.assert_array_equal(rows.rid.numpy(), np.arange(N))
    np.testing.assert_array_equal(rows.bins.numpy(), bins)
    assert np.all(rows.vals.numpy()[valid == 0, :2] == 0.0)
    assert np.all(rows.vals.numpy()[valid == 1, 1] > 0.0)
    rows_on(tuple(a.numpy() for a in rows), "cpu")   # five arrays


def test_refresh_of_zero_delta_keeps_scores():
    bins, score, valid, consts, _ = _inputs("l2", 4)
    t = torch.tensor
    rows = stream_init_ref(t(bins), t(score), t(valid), t(consts),
                           kind="l2", sigmoid=1.0)
    before = [a.clone() for a in rows]
    stream_refresh(rows, torch.zeros(N), kind="l2", sigmoid=1.0,
                   padded_bins=B)
    for a, b in zip(rows, before):
        assert torch.equal(a, b)


# -- the route's rules ----------------------------------------------------
def test_default_route_and_the_three_knobs():
    assert decide(inputs_from_env({})).describe() == \
        "path=stream fused=1 tail=kernel"
    env = {"LGBM_TPU_STREAM": "0", "LGBM_TPU_FUSED": "0",
           "LGBM_TPU_APPLY_IMPL": "xla"}
    d = decide(inputs_from_env(env))
    assert (d.stream, d.fused, d.tail) == (False, False, "xla")
    assert d.reasons == ("stream_env_off", "fused_env_off", "tail_env_xla")
    for k, v in env.items():
        one = decide(inputs_from_env({k: v}))
        assert len(one.reasons) == 1 and one.reasons[0] in d.reasons


@pytest.mark.parametrize("rule", [r.name for r in RULES])
def test_each_rule_blocks_its_part(rule):
    kw = {"stream_env_off": {"stream_env": "0"},
          "objective_not_streamable": {"objective_kind": "none"},
          "boosting_not_gbdt": {"boosting": "goss"},
          "multi_tree_iter": {"multi_tree": True},
          "bagging_on": {"bagging": True},
          "linear_tree": {"linear_tree": True},
          "mesh_stream_unwired": {"learner": "data"},
          "fused_env_off": {"fused_env": "0"},
          "part_3ph": {"part_env": "3ph"},
          "fused_smem": {"fused_ok": False},
          "tail_env_xla": {"apply_impl_env": "xla"},
          "tail_smem": {"tail_ok": False},
          "non_u8_bins": {"bins_u8": False},
          "phys_env_off": {"phys_env": "0"},
          "tail_cat_subset": {"cat_subset": True},
          "tail_mono_intermediate": {"mono_intermediate": True},
          "cat_overwide": {"cat_subset": True, "bins_u8": False},
          "cegb_lazy": {"cegb_lazy": True},
          "gpu_use_dp": {"gpu_use_dp": True},
          "tail_interaction": {"interaction": True},
          "tail_cegb": {"cegb": True},
          "tail_forced": {"forced_splits": True},
          "tail_bynode": {"bynode": True},
          "tail_extra_trees": {"extra_trees": True},
          "learner_row_order": {"learner": "feature"},
          "tail_voting": {"learner": "voting"},
          "hist_scatter_env_off": {"learner": "data",
                                   "hist_scatter_env": "0"},
          "scatter_features_below_world": {"learner": "data",
                                           "features_per_rank": False}}[rule]
    # cat_overwide never fires alone: its bins wider than u8 fire
    # non_u8_bins, and a subset model takes the PyTorch tail; the voting
    # learner is a row-order learner, and a data learner never streams
    also = {"cat_overwide": ("non_u8_bins", "tail_cat_subset")}.get(rule,
                                                                     ())
    lead = {"tail_voting": ("learner_row_order",),
            "hist_scatter_env_off": ("mesh_stream_unwired",),
            "scatter_features_below_world": ("mesh_stream_unwired",)}.get(
                rule, ())
    d = decide(RouteInputs(**kw))
    fired = lead + (rule,) + also
    assert d.reasons == fired
    of = {r.name: r.blocks for r in RULES}
    # off the physical path stream and fused are off too
    off = any(of[r] == "physical" for r in fired)
    assert (not d.stream, not d.fused, d.tail == "xla",
            d.path == "row_order") == (
        any(of[r] == "stream" for r in fired) or off,
        any(of[r] == "fused" for r in fired) or off,
        any(of[r] == "tail" for r in fired), off)
    # a hist_scatter rule leaves the data learner's merge full
    assert (d.hist_merge == "full") == (of[rule] == "hist_scatter")


def test_reset_stream_rebuilds_rows_on_both_routes():
    """``reset_stream`` drops the carried rows (and root histogram); the
    next tree rebuilds them from the booster's scores, in original row
    order on either route, so both routes still grow the same trees and
    the rows' scores are the training scores again."""
    import os

    import lightgbm_tpu_torch as lgt
    from conftest import restore_env_knobs, save_env_knobs
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2000, 5)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] * x[:, 2] > 0).astype(np.float32)
    slice2 = {"LGBM_TPU_STREAM": "0", "LGBM_TPU_FUSED": "0",
              "LGBM_TPU_APPLY_IMPL": "xla"}
    saved = save_env_knobs(tuple(slice2))
    boosters = []
    try:
        for env in ({}, slice2):
            for k in slice2:
                os.environ.pop(k, None)
            os.environ.update(env)
            bst = lgt.Booster({"objective": "binary", "num_leaves": 15,
                               "verbosity": -1}, lgt.Dataset(x, label=y),
                              device="cpu")
            for i in range(4):
                if i == 2:
                    bst._inner.grow.reset_stream()
                    assert bst._inner.grow.rows is None
                bst.update()
            boosters.append(bst)
    finally:
        restore_env_knobs(saved)
    a, b = boosters
    for ta, tb in zip(a._models, b._models):
        assert ta.leaf_value.tobytes() == tb.leaf_value.tobytes()
    rows = a._inner.grow.rows
    assert torch.equal(rows.score, a._inner.train_score[rows.rid.long()])
