"""Model text in the PyTorch port (``lightgbm_tpu_torch``) against the
JAX package.

A model trained by ``lightgbm_tpu`` is written to text, loaded by both
packages and written again: the port's text must be byte-identical to
the JAX package's, and a second load and write in the port must give
the same text back.  The trained booster's own text is not the
yardstick: a loaded model drops the trained booster's parameter lines
in both packages.  The port's host walk (``Tree.predict_leaf``) must
equal the JAX package's on f64 rows.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from chip_smoke import make_rows, random_model_text
from test_serve_kernel import _cat_frame, _higgs, _train

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trained_texts():
    """JAX-trained model texts: dense binary with 8% NaN, and a
    categorical model with sorted-subset bitsets."""
    x, y = _higgs(3000, nan_frac=0.08)
    dense = _train(x, y, {"objective": "binary", "num_leaves": 31})
    xc, yc = _cat_frame(2000)
    cat = _train(xc, yc, {"objective": "binary", "num_leaves": 15,
                          "max_cat_to_onehot": 4},
                 ds_params={"max_cat_to_onehot": 4},
                 categorical_feature=[1])
    assert any(t.num_cat > 0 for t in cat._models)
    xq, _ = _higgs(400, seed=5, nan_frac=0.2)
    xcq, _ = _cat_frame(400, seed=7)
    xcq[3, 1] = 999.0
    xcq[4, 1] = np.nan
    xcq[5, 1] = -2.0
    return {"dense": (dense.model_to_string(), xq),
            "cat": (cat.model_to_string(), xcq)}


def _synthetic():
    text = random_model_text(n_trees=9, num_leaves=31, n_features=8,
                             seed=3, cat_features=(1,), num_class=3)
    return text, make_rows(300, 8, 3, (1,))


def _case(trained_texts, name):
    return _synthetic() if name == "synthetic" else trained_texts[name]


CASES = ["dense", "cat", "synthetic"]


@pytest.mark.parametrize("name", CASES)
def test_text_byte_identical_to_jax(trained_texts, name):
    text, _ = _case(trained_texts, name)
    jax_text = lgb.Booster(model_str=text).model_to_string()
    port_text = lgt.Booster(model_str=text,
                            device="cpu").model_to_string()
    assert port_text == jax_text


@pytest.mark.parametrize("name", CASES)
def test_text_fixed_point(trained_texts, name):
    text, _ = _case(trained_texts, name)
    once = lgt.Booster(model_str=text, device="cpu").model_to_string()
    twice = lgt.Booster(model_str=once, device="cpu").model_to_string()
    assert twice == once


@pytest.mark.parametrize("name", CASES)
def test_host_walk_matches_jax(trained_texts, name):
    text, xq = _case(trained_texts, name)
    xq = np.asarray(xq, np.float64)
    jb = lgb.Booster(model_str=text)
    pb = lgt.Booster(model_str=text, device="cpu")
    assert len(jb._models) == len(pb._models)
    for jt, pt in zip(jb._models, pb._models):
        np.testing.assert_array_equal(pt.predict_leaf(xq),
                                      jt.predict_leaf(xq))
        np.testing.assert_array_equal(pt.predict(xq), jt.predict(xq))


def test_iteration_slice_and_gain_importance(trained_texts):
    text, _ = trained_texts["dense"]
    jb = lgb.Booster(model_str=text)
    pb = lgt.Booster(model_str=text, device="cpu")
    for kw in ({"num_iteration": 3, "start_iteration": 2},
               {"importance_type": "gain"}):
        assert pb.model_to_string(**kw) == jb.model_to_string(**kw)


def test_save_model_file(trained_texts, tmp_path):
    text, _ = trained_texts["cat"]
    pb = lgt.Booster(model_str=text, device="cpu")
    path = tmp_path / "model.txt"
    pb.save_model(path)
    again = lgt.Booster(model_file=str(path), device="cpu")
    assert again.model_to_string() == pb.model_to_string()
    assert again.num_trees() == pb.num_trees() == 8
    assert again.num_feature() == 6


def test_single_leaf_tree_round_trip():
    from lightgbm_tpu.models.tree import Tree as JaxTree
    from lightgbm_tpu_torch.models.tree import Tree
    assert (Tree.single_leaf(0.25).to_string(3)
            == JaxTree.single_leaf(0.25).to_string(3))
    t = Tree.from_string(Tree.single_leaf(-1.5).to_string(0))
    np.testing.assert_array_equal(t.predict(np.zeros((4, 2))),
                                  np.full(4, -1.5))

