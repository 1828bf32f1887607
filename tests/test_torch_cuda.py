"""The port's CUDA kernels, and training, on the card (``cuda`` marker).

These tests need an NVIDIA GPU with ``nvcc``: the CUDA kernels have no
CPU mode, so they skip elsewhere.  They import neither JAX nor the JAX
package, so they run on a GPU host without JAX:
``python -m pytest tests/test_torch_cuda.py -m cuda``.  Each kernel is
held against its plain PyTorch version on the same inputs: the
traversal's leaf indices exactly and its scores within
``64 * T * eps_f32 * max(|s|, 1)`` (f32 sums in another order); the
histogram within ``4 * n * eps_f32 * max|v|`` and bitwise equal across
two launches; the partition scan and copyback byte for byte.  Trees
grown on the card equal the CPU run's (structure, and leaf values
within 1e-5 of the tree's largest leaf).
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from chip_smoke import (compare_trees, hist_parity, make_higgs_like,
                        make_rows, partition_parity, random_model_text,
                        random_row_matrix, rows_on, score_tolerance)
from lightgbm_tpu_torch.ops import predict as tpred
from lightgbm_tpu_torch.ops import serve_kernel as tkern

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _model(cat: bool, k: int, device):
    cats = (1, 4) if cat else ()
    text = random_model_text(n_trees=12 * k, num_leaves=31, n_features=8,
                             seed=40 + k, cat_features=cats, num_class=k)
    x = make_rows(700, 8, 40 + k, cats)
    x[:5] = np.nan
    return lgt.Booster(model_str=text, device=device), x


@pytest.mark.parametrize("cat,k,bf16", [(False, 1, False), (True, 1, True),
                                        (True, 3, False)])
def test_serve_traverse_matches_plain(cuda, cat, k, bf16):
    bst, x = _model(cat, k, cuda)
    sm = bst.serving_engine().model
    f = sm.forest
    if bf16:
        f.leaf_value = f.leaf_value.to(torch.bfloat16)
    bins = tpred.quantize_rows_kernel(
        f, torch.from_numpy(x).to(cuda)[:, f.used_cols.long()]).contiguous()
    n, n_real = x.shape[0], x.shape[0] - 9
    for leaves in (True, False):
        args = tkern.forest_kernel_args(f, leaves=leaves)
        shape = (n, sm.n_trees if leaves else k)
        dt = torch.int32 if leaves else torch.float32
        got = torch.full(shape, 7, dtype=dt, device=cuda)
        want = torch.empty(shape, dtype=dt, device=cuda)
        before = tkern.serve_traverse.launches
        tkern.serve_traverse(args, bins, n_real, got, n_steps=sm.n_steps,
                             leaves=leaves)
        assert tkern.serve_traverse.launches == before + 1
        tkern.serve_traverse_ref(args, bins, n_real, want,
                                 n_steps=sm.n_steps, leaves=leaves)
        torch.cuda.synchronize()
        if leaves:
            assert torch.equal(got, want)
        else:
            ref = want.cpu().numpy()
            assert np.all(np.abs(got.cpu().numpy() - ref)
                          <= score_tolerance(ref, sm.n_trees))


def test_booster_on_card_matches_host_walk(cuda):
    bst, x = _model(True, 3, cuda)
    xh = x.astype(np.float64)
    host = np.stack([t.predict_leaf(xh) for t in bst._models], axis=1)
    np.testing.assert_array_equal(
        bst.serving_engine().predict_leaves(x), host)
    raw = bst.predict(x, raw_score=True)
    host_raw = np.stack([sum(t.predict(xh) for t in bst._models[kk::3])
                         for kk in range(3)], axis=1)
    assert np.all(np.abs(raw - host_raw)
                  <= score_tolerance(host_raw, len(bst._models)))


# -- slice 2: the training kernels and training on the card -----------
@pytest.mark.parametrize("rng", [(0, 0, 20_000), (4099, 3, 7001),
                                 (-50, 10, 300), (19_990, 0, 1000)])
def test_hist_comb_matches_plain(cuda, rng):
    """Kernel vs plain within 4 * n * eps_f32 * max|v|, two launches
    bitwise equal; ranges cut at the matrix edges contribute nothing
    outside it."""
    from lightgbm_tpu_torch.ops.hist_kernel2 import build_histogram_comb
    rows = rows_on(random_row_matrix(20_000, 7, 5), cuda)
    before = build_histogram_comb.launches
    hist_parity(rows, rng, 256, "test")
    assert build_histogram_comb.launches == before + 2


@pytest.mark.parametrize("sel", [
    (0, 20_000, 0, 100, 1, 0, 200),      # NaN bin routed left
    (333, 5001, 0, 90, 0, 0, 200),       # NaN bin routed right
    (17, 4000, 3, 7, 0, 1, -1),          # one-hot categorical
    (1, 1, 2, 50, 0, 0, -1),             # one row
    (100, 0, 1, 10, 0, 0, -1),           # dead split
])
def test_partition_matches_plain(cuda, sel):
    """Scan and copyback vs their plain versions: identical bytes and
    nleft, rows outside the segment untouched."""
    rows = rows_on(random_row_matrix(20_000, 6, 9, n_bins=201,
                                     nan_bin=200), cuda)
    partition_parity(rows, sel, "test")


def test_training_on_card_matches_cpu(cuda):
    """Trees grown on the card equal the CPU run's in structure, leaf
    values within 1e-5 relative."""
    x, y = make_higgs_like(4000, 8, seed=2)
    x[np.random.default_rng(2).random(x.shape) < 0.1] = np.nan
    p = {"objective": "binary", "num_leaves": 31, "verbosity": -1}
    a = lgt.train(p, lgt.Dataset(x, label=y), num_boost_round=3,
                  device="cuda")
    b = lgt.train(p, lgt.Dataset(x, label=y), num_boost_round=3,
                  device="cpu")
    res = compare_trees(a._models, b._models)
    assert res["ok"], res
