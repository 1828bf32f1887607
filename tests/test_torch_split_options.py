"""The split options on the PyTorch split tail (interaction constraints,
forced splits, ``feature_fraction_bynode``, ``extra_trees``) in the
PyTorch port, against the JAX package on the CPU.

The port trains each option on the route it picks (``tail=xla`` with
the option's rule, the stream and the fused split kept); the JAX
package on its row-order route (its XLA tail).  Trees are equal in
structure, leaves within ``SETTING_LEAF_RTOL`` of the tree's largest and
raw scores within ``SETTING_RAW_ATOL`` (``test_torch_train``'s bounds
for a training setting).  The node draws (``utils/random.fold_in``,
``uniform_rows``) equal ``jax.random``'s bits.  Each per-feature list is
read by raw column (``models/constraints.py``); the witnesses train on a
dataset whose constant column 0 is dropped, where the JAX package reads
the lists by inner feature.  The options with other settings (monotone
constraints, the sorted-subset search, pack=2, multiclass) and the
witnesses are in ``tests/test_torch_split_combos.py``, CEGB in
``tests/test_torch_cegb.py``.
"""
import json

import numpy as np
import pytest
import torch

import jax
import lightgbm_tpu_torch as lgt
from chip_smoke import (compare_trees, forced_nodes_on_top,
                        interaction_violations, tree_paths)
from lightgbm_tpu_torch.ops import routing as troute
from lightgbm_tpu_torch.ops.apply_find import (ChildSearch, SplitAt,
                                               _no_child, _scalars,
                                               build_finder_consts,
                                               tail_geometry)
from lightgbm_tpu_torch.ops.split import SplitHyperParams
from lightgbm_tpu_torch.utils import random as trandom
from lightgbm_tpu_torch.utils.log import LightGBMError
from test_torch_train import (ROW_ORDER_ROUTE, SETTING_LEAF_RTOL,
                              SETTING_RAW_ATOL, _data, _first_divergence,
                              _jax_train, _port_train)

torch.set_num_threads(1)

BASE = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
ROUNDS = 3
STREAM_XLA = "path=stream fused=1 tail=xla ({})"


def forced_file(tmp_path, tree: dict) -> str:
    path = tmp_path / "forced_splits.json"
    path.write_text(json.dumps(tree))
    return str(path)


FORCED = {"feature": 1, "threshold": 0.2,
          "left": {"feature": 2, "threshold": -0.3, "default_left": True},
          "right": {"feature": 0, "threshold": 0.5,
                    "right": {"feature": 7, "threshold": 0.0}}}


def hold(bt, bj, x, rate: float = 0.1):
    """Structure equal, leaves and raw scores within the setting bounds."""
    assert len(bt._models) == len(bj._models)
    assert _first_divergence(bt._models, bj._models) is None
    res = compare_trees(bt._models, bj._models, rtol=SETTING_LEAF_RTOL)
    assert res["ok"], res
    np.testing.assert_allclose(
        bt.predict(x, raw_score=True),
        np.asarray(bj.predict(x, raw_score=True)), rtol=0,
        atol=SETTING_RAW_ATOL * max(rate / 0.1, 1.0))


def pair(params, x, y, env=None, rounds=ROUNDS, ds_kw=None):
    bj = _jax_train(params, x, y, rounds, route=ROW_ORDER_ROUTE,
                    ds_kw=ds_kw)[0]
    bt = _port_train(params, x, y, rounds, env or {}, ds_kw=ds_kw)
    return bt, bj


# -- (a) each option alone, and with another setting ------------------------
OPTIONS = {
    "interaction": ({"interaction_constraints": "[[0, 1, 2], [3, 4, 5], "
                                                "[1, 4]]"},
                    STREAM_XLA.format("tail_interaction")),
    "bynode": ({"feature_fraction_bynode": 0.5},
               STREAM_XLA.format("tail_bynode")),
    "bynode_bytree": ({"feature_fraction_bynode": 0.6,
                       "feature_fraction": 0.7},
                      STREAM_XLA.format("tail_bynode")),
    "extra_trees": ({"extra_trees": True},
                    STREAM_XLA.format("tail_extra_trees")),
    "extra_trees_seed": ({"extra_trees": True, "extra_seed": 17},
                         STREAM_XLA.format("tail_extra_trees")),
    "forced": (None, STREAM_XLA.format("tail_forced")),
    "all_four": ({"interaction_constraints": "[[0, 1, 2, 3], [2, 3, 4, 5]]",
                  "feature_fraction_bynode": 0.7, "extra_trees": True},
                 STREAM_XLA.format("tail_interaction, tail_forced, "
                                   "tail_bynode, tail_extra_trees")),
}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_option_matches_jax(name, tmp_path):
    extra, route = OPTIONS[name]
    extra = dict(extra or {})
    if name in ("forced", "all_four"):
        extra["forcedsplits_filename"] = forced_file(tmp_path, FORCED)
    x, y = _data(3000, 6, 11)
    params = dict(BASE, **extra)
    bt, bj = pair(params, x, y)
    assert bt._inner.grow.route.describe() == route
    assert all(t.num_leaves > 1 for t in bt._models)
    hold(bt, bj, x)


def test_interaction_sets_parse_from_a_string_or_a_list():
    x, y = _data(500, 6, 11)
    a = _port_train(dict(BASE, interaction_constraints="[[0, 2], [1, 2, 3]]"),
                    x, y, 1, {})
    b = _port_train(dict(BASE, interaction_constraints=[[0, 2], [1, 2, 3]]),
                    x, y, 1, {})
    want = [[1, 0, 1, 0, 0, 0], [0, 1, 1, 1, 0, 0]]
    assert a._inner.grow._ic.tolist() == b._inner.grow._ic.tolist() == want
    assert a._models[0].leaf_value.tobytes() == \
        b._models[0].leaf_value.tobytes()


def test_forced_nodes_top_every_tree_and_one_read_a_split(tmp_path):
    """Every tree starts with the schedule (node 0 on column 1, its
    children 1 and 2 on columns 2 and 0), whatever their gains, and the
    loop still reads the host once a split."""
    x, y = _data(3000, 6, 11)
    path = forced_file(tmp_path, FORCED)
    bt = _port_train(dict(BASE, forcedsplits_filename=path), x, y, ROUNDS,
                     {})
    ds = bt._inner.train_set
    for t in bt._models:
        assert [int(v) for v in t.split_feature[:3]] == [1, 2, 0]
        assert int(t.left_child[0]) == 1 and int(t.right_child[0]) == 2
        assert bool(t.decision_type[1] & 2)       # default_left
    b1 = int(ds.mappers[1].values_to_bins(np.array([0.2]))[0])
    assert all(int(t.threshold_bin[0]) == b1 for t in bt._models)
    splits = sum(t.num_leaves - 1 for t in bt._models)
    stops = sum(t.num_leaves < BASE["num_leaves"] for t in bt._models)
    assert bt._inner.grow.host_reads == splits + stops


def test_chip_smoke_gates_on_the_cpu(tmp_path):
    """chip_smoke.py's gates on CPU-trained boosters: no path leaves one
    interaction set; the forced nodes top every tree."""
    import chip_smoke as cs
    x, y = cs.make_higgs_like(4000, cs.N_FEATURES, seed=2)
    params = dict(BASE, interaction_constraints=cs.HIGGS_SETS)
    bt = lgt.train(params, lgt.Dataset(x, label=y), 2, device="cpu")
    assert interaction_violations(bt._models, cs.HIGGS_SETS) == 0
    assert interaction_violations(bt._models, [list(range(20))]) > 0
    assert all(len(p) >= 1 for t in bt._models for p in tree_paths(t))
    path = forced_file(tmp_path, cs.FORCED_SPLITS)
    ds = lgt.Dataset(x, label=y).construct()
    bt = lgt.train(dict(BASE, forcedsplits_filename=path), ds, 2,
                   device="cpu")
    assert forced_nodes_on_top(bt._models, ds._binned)["ok"]
    free = lgt.train(BASE, ds, 2, device="cpu")
    assert not forced_nodes_on_top(free._models, ds._binned)["ok"]


# -- (b) the draws -------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 2, 6, 12345, 2**31 - 1])
def test_fold_in_and_uniform_rows_equal_jax_bits(seed):
    salts = [0, 1, 2, 7, 509, 2**31, 2**32 - 1]
    base = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    keys = trandom.fold_in(trandom.fold_in(trandom.prng_key(seed), 3),
                           torch.tensor(salts, dtype=torch.int64))
    u = trandom.uniform_rows(keys, 37, "cpu")
    sub = trandom.uniform_rows(trandom.fold_in(keys, 1), 37, "cpu")
    for i, salt in enumerate(salts):
        kj = jax.random.fold_in(base, salt)
        assert [int(keys[0][i]), int(keys[1][i])] == np.asarray(kj).tolist()
        want = np.asarray(jax.random.uniform(kj, (37,)))
        assert u[i].numpy().view(np.int32).tolist() == \
            want.view(np.int32).tolist()
        want = np.asarray(jax.random.uniform(jax.random.fold_in(kj, 1),
                                             (37,)))
        assert sub[i].numpy().view(np.int32).tolist() == \
            want.view(np.int32).tolist()
    one = trandom.fold_in(trandom.prng_key(seed), 5)
    assert [int(w) for w in one] == np.asarray(
        jax.random.fold_in(jax.random.PRNGKey(seed), 5)).tolist()
    assert torch.equal(trandom.uniform_rows(one, 11, "cpu"),
                       trandom.uniform(tuple(int(w) for w in one), 11,
                                       "cpu"))


# -- (c) the routes and the kernel tail's refusals -------------------------
RULE_OF = {"interaction": "tail_interaction", "cegb": "tail_cegb",
           "forced_splits": "tail_forced", "bynode": "tail_bynode",
           "extra_trees": "tail_extra_trees"}


@pytest.mark.parametrize("field", list(RULE_OF))
@pytest.mark.parametrize("knobs", [{}, {"pack_env": "2"}, {"fused_env": "0"},
                                   {"part_env": "3ph"}, {"bins_u8": False}])
def test_each_option_takes_the_pytorch_tail_and_keeps_its_route(field,
                                                                knobs):
    plain = troute.decide(troute.RouteInputs(**knobs))
    got = troute.decide(troute.RouteInputs(**knobs, **{field: True}))
    assert got.tail == "xla" and RULE_OF[field] in got.reasons
    assert (got.path, got.fused, got.scheme, got.pack) == (
        plain.path, plain.fused, plain.scheme, plain.pack)
    assert [r for r in got.reasons if r != RULE_OF[field]] == list(
        plain.reasons)


def test_lazy_cegb_takes_the_row_order_path():
    d = troute.decide(troute.RouteInputs(cegb=True, cegb_lazy=True))
    assert d.describe() == ("path=row_order fused=0 tail=xla "
                            "(cegb_lazy, tail_cegb)")
    rule = next(r for r in troute.RULES if r.name == "cegb_lazy")
    assert rule.blocks == "physical" and "paid mask" in rule.reason
    enc = troute.enumerate_matrix()["cells"]
    assert any("cegb=1" in k and "why=cegb_lazy" in v
               for k, v in enc.items())


def test_the_kernel_tail_refuses_the_options():
    fc = build_finder_consts(torch.tensor([4, 4], dtype=torch.int32),
                             torch.zeros(2, dtype=torch.bool),
                             torch.zeros(2, dtype=torch.bool), 8)
    geo = tail_geometry(2, 8)
    for hp in (SplitHyperParams(use_cegb=True, cegb_penalty_split=0.1),
               SplitHyperParams(use_extra_trees=True)):
        with pytest.raises(LightGBMError, match="PyTorch tail"):
            _scalars(SplitAt(0, 1, 0, 0, 10), -1, hp, fc, 2, 8, geo)
    with pytest.raises(LightGBMError, match="per-child"):
        _no_child(ChildSearch(torch.ones(2, 2)))
    _no_child(None)
