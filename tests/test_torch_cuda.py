"""The port's CUDA kernels, and training, on the card (``cuda`` marker).

These tests need an NVIDIA GPU with ``nvcc``: the CUDA kernels have no
CPU mode, so they skip elsewhere.  They import neither JAX nor the JAX
package, so they run on a GPU host without JAX:
``python -m pytest tests/test_torch_cuda.py -m cuda``.  Each kernel is
held against its plain PyTorch version on the same inputs: the
traversal's leaf indices exactly and its scores within
``64 * T * eps_f32 * max(|s|, 1)`` (f32 sums in another order); the
histogram within ``4 * n * eps_f32 * max|v|`` and bitwise equal across
two launches; the partition scan and copyback byte for byte.  The
stream init and refresh, the fused split and the split tail (slice 3)
bitwise: rows, nleft and state rows equal their plain versions', the
refresh's root histogram and the fused split's two histograms equal
hist_comb's of the same ranges.  The row-indexed histogram (slice 4)
bitwise its plain version run on CPU copies of the inputs.  The 3-phase
partition and the plain refresh (slice 5) bitwise their plain versions.
The pack=2 record kernels (slices 6 and 7) bitwise their plain versions
and their pack=1 kernels on the same logical rows.  The analyzer's
fixture kernels (slice 8) bitwise their plain versions at their legal
geometries, their seeded geometries refused before a launch, the
resource report read fresh from the built libraries equal to the
checked-in ``analysis/resources_sm90a.txt``, and the analyzer clean
under ``--strict`` with the fixtures flagged.  The launch-cost probes
(slice 9) bitwise or exactly their plain versions (``select_update``
also through a replayed CUDA graph); ``hist_comb`` at 79, 80 and 136
features bitwise its plain version, one feature chunk against several,
and 136-feature training bit-identical to the CPU run.  The row-indexed
histogram in one launch and through partials (slice 11) bitwise its
plain version at counts 0 to 32,769, and a geometry that misses a cell
refused; the pack=2 copyback's canary records; both in replayed graphs.
The fused split's two passes (slice 12), both packs, bitwise their plain
version run on CPU copies on adversarial splits (all rows to one side,
one row, an odd start, NaN and one-hot descriptors, counts at the slice
and mode edges and at 16 and 17 slices; F = 27, 28, 71, B = 64, 256),
in a replayed graph,
and a geometry that misses a row or a cell refused.  The split tail as
one cluster over the features (slice 13) bitwise its plain version at
28 and 136 features, B = 256 and 1024, on seeded splits with equal keys
across every block boundary and the winner in the last block, on other
cluster sizes, in a replayed graph, and a geometry that misses a
feature refused.  The comb-direct histogram in two modes (slice 14),
both packs, bitwise its plain version run on CPU copies at every slice
count 1 to 9 (range mode up to the limit, feature mode above) at F = 27,
28 and 136, on adversarial ranges, with every row in one bin (B = 64,
256, 1024), in either mode on the same call, in a replayed graph, and a
geometry that misses a cell refused.
The membership-word modes (slice 17) of the partitions and the fused
split, both packs, bitwise their plain versions on adversarial words at
28, 36 and 136 features, on staged and unstaged scan tiles, eager and
replayed in a graph, more than 8 words refused, and sorted-subset
training on the card bit-identical to the CPU run on four routes.
The threefry draws (slice 20) give the CPU's bits on the card, GOSS's
sample at 1M rows too, and bagged, GOSS and RF training grows the CPU
run's trees on four routes.  The lambdarank gradients (slice 21) give
the CPU's bits on the card, and lambdarank DART grows the CPU run's
trees, drop sets and scores on four routes.
The split options (slice 22: interaction constraints, CEGB, forced
splits, by-node sampling, extra trees) grow the CPU run's trees on four
routes (lazy CEGB's paid mask too), the node draws give the CPU's bits,
and the kernel tail refuses what it has no mode for.
The linear-leaf moments (slice 26) bitwise their plain version on the
card and the CPU at geometric, skewed and even leaf sizes, an empty
leaf and kmax 1 to 800, and replayed in a graph; refit's leaves on f64
rows that flip under f32 rounding are the host walk's, its leaf values
the CPU refit's bit for bit.
The pack=1 stream init and plain refresh (slice 27) bitwise their plain
versions at 1, 3, 4,097 and 1,000,003 rows, 5, 28, 36 and 136 features,
both objectives and a pointer off a 16-byte boundary; a stream-route run
killed after its snapshot and resumed on the card byte for byte the
uninterrupted run, with the in-place re-anchor and without.
Trees grown on the card equal the CPU run's (structure, and leaf values
within 1e-5 of the tree's largest leaf; bit for bit on the default,
row-order and 3ph routes), and the default route's equal slice 2's
route's and the ``LGBM_TPU_POOL_TAIL=0`` route's bit for bit.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from chip_smoke import (apply_find_parity, compare_trees,
                        expected_launches, fused_parity, hist_parity,
                        hist_rows_case, leaves_bitwise, make_higgs_like,
                        make_rows, pack2_cases, partition_3ph_parity,
                        partition_parity, random_model_text,
                        random_row_matrix, refresh_plain_parity, rows_on,
                        score_tolerance, stream_parity, stream_shape_cases,
                        tail_parity)
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


# -- slice 3: the default route's kernels ------------------------------
SLICE2_ROUTE = {"LGBM_TPU_STREAM": "0", "LGBM_TPU_FUSED": "0",
                "LGBM_TPU_APPLY_IMPL": "xla"}


@pytest.mark.parametrize("kind,sigmoid", [("binary", 1.0), ("binary", 0.7),
                                          ("l2", 1.0)])
def test_stream_kernels_match_plain(cuda, kind, sigmoid):
    from lightgbm_tpu_torch.ops.stream_grad import (stream_init,
                                                    stream_refresh)
    rows = rows_on(random_row_matrix(20_011, 7, 13), cuda)
    before = (stream_init.launches, stream_refresh.launches)
    stream_parity(rows.bins, kind, 256, "test", sigmoid=sigmoid)
    assert (stream_init.launches, stream_refresh.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("sel", [
    (0, 20_000, 0, 100, 1, 0, 200),      # NaN bin routed left
    (333, 5001, 0, 90, 0, 0, 200),       # NaN bin routed right
    (17, 4000, 3, 7, 0, 1, -1),          # one-hot categorical
    (5, 19_990, 2, 199, 0, 0, -1),       # nearly all rows left
    (7, 3000, 4, 0, 0, 0, -1),           # nearly all rows right
    (1, 1, 2, 50, 0, 0, -1),             # one row
    (100, 0, 1, 10, 0, 0, -1),           # dead split: no launch
])
def test_fused_split_matches_plain(cuda, sel):
    rows = rows_on(random_row_matrix(20_000, 6, 9, n_bins=201,
                                     nan_bin=200), cuda)
    fused_parity(rows, sel, 256, "test")


def _grower(device, **hp_kw):
    from lightgbm_tpu_torch.ops.device_data import init_rows, to_device
    from lightgbm_tpu_torch.ops.grow import SerialGrower, StreamSpec
    from lightgbm_tpu_torch.ops.routing import RouteInputs, decide
    from lightgbm_tpu_torch.ops.split import SplitHyperParams
    x, y = make_higgs_like(20_000, 8, seed=4)
    x[np.random.default_rng(4).random(x.shape) < 0.1] = np.nan
    ds = lgt.Dataset(x, label=y).construct()
    dd = to_device(ds._binned, device)
    grower = SerialGrower(SplitHyperParams(**hp_kw), num_leaves=31,
                          max_depth=-1, dd=dd, route=decide(RouteInputs()),
                          stream=StreamSpec("binary", 1.0))
    rows = init_rows(dd.bins)
    rows.vals.copy_(torch.as_tensor(random_row_matrix(20_000, 1, 6)[1],
                                    device=device))
    return grower, rows


@pytest.mark.parametrize("hp_kw", [
    {},
    {"lambda_l1": 0.5, "lambda_l2": 1.0, "max_delta_step": 0.3},
    {"path_smooth": 2.0, "use_smoothing": True, "min_data_in_leaf": 5},
])
def test_apply_find_matches_plain(cuda, hp_kw):
    from lightgbm_tpu_torch.ops.apply_find import apply_find, apply_find_pool
    grower, rows = _grower(cuda, **hp_kw)
    before = (apply_find_pool.launches, apply_find.launches)
    apply_find_parity(grower, rows, "test")
    assert (apply_find_pool.launches, apply_find.launches) == (
        before[0] + 2, before[1] + 1)


def _tail_case(f, b, kind):
    """A seeded split at f x b and the features its winners must lie in:
    "plain", "ties" (at every block boundary the two features equal and
    strong: the winner is a boundary's first) or "last" (the last
    feature strongest)."""
    from lightgbm_tpu_torch.ops.apply_find import tail_geometry
    from lightgbm_tpu_torch.tools.profile_apply_find import synthetic_split
    geo = tail_geometry(f, b)
    if kind == "ties":
        js = tuple(k * geo.feats - 1 for k in range(1, geo.blocks))
        return synthetic_split(f, b, cnt=200_000, ties=js, strong=js,
                               device="cuda"), js
    if kind == "last":
        return synthetic_split(f, b, cnt=200_000, strong=(f - 1,),
                               device="cuda"), (f - 1,)
    return synthetic_split(f, b, cnt=200_000, seed=f + b,
                           device="cuda"), None


@pytest.mark.parametrize("f,b,kind", [
    (28, 256, "plain"), (28, 1024, "plain"), (136, 256, "plain"),
    (136, 1024, "plain"), (1, 16, "plain"), (17, 64, "plain"),
    (28, 256, "ties"), (28, 1024, "ties"), (136, 256, "ties"),
    (28, 256, "last"), (136, 256, "last"), (136, 1024, "last"),
])
def test_apply_find_cluster_matches_plain(cuda, f, b, kind):
    """Both entries bitwise their plain versions (on the card and on CPU
    copies), done untouched, at the routes' shapes and on adversarial
    ties across the cluster's blocks."""
    from lightgbm_tpu_torch.ops.apply_find import apply_find, apply_find_pool
    case, want = _tail_case(f, b, kind)
    before = (apply_find_pool.launches, apply_find.launches)
    tail_parity(case, f"{f}x{b}_{kind}", want_features=want)
    assert (apply_find_pool.launches, apply_find.launches) == (
        before[0] + 2, before[1] + 1)


@pytest.mark.parametrize("max_blocks", [1, 2, 4, 8, 16])
def test_apply_find_on_other_cluster_sizes(cuda, max_blocks):
    """The pool entry on every cluster size the geometry can give, with
    ties across every boundary of the 16-block geometry: bitwise the
    plain version on CPU copies."""
    from lightgbm_tpu_torch.ops.apply_find import (apply_find_pool_ref,
                                                   launch_pool, max_clusters,
                                                   tail_geometry)
    from lightgbm_tpu_torch.tools.profile_apply_find import (call_entry,
                                                             held_bitwise)
    case, _ = _tail_case(28, 256, "ties")
    geo = tail_geometry(28, 256, max_blocks)
    assert max_clusters(geo, 28, 256) >= 1
    entry = call_entry(lambda c: launch_pool(c.h_a, c.h_b, *c.args(), geo))
    assert held_bitwise(entry, apply_find_pool_ref,
                        lambda c: (c.h_a, c.h_b), case)


def test_apply_find_in_a_graph(cuda):
    """The pool entry captured in a CUDA graph and replayed once leaves
    the state one eager launch leaves."""
    from lightgbm_tpu_torch.ops.apply_find import apply_find_pool
    from lightgbm_tpu_torch.tools.profile_lib import capture
    case, _ = _tail_case(28, 1024, "plain")
    eager, graphed = case.clone(), case.clone()
    apply_find_pool(eager.h_a, eager.h_b, *eager.args())
    g = capture(lambda: apply_find_pool(graphed.h_a, graphed.h_b,
                                        *graphed.args()), warmup=0)
    g.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(eager.st, graphed.st))


def test_apply_find_library_refuses_a_short_geometry(cuda):
    """A geometry that misses a feature, has an empty block or more than
    16 blocks is refused before a launch (cudaErrorInvalidValue)."""
    from lightgbm_tpu_torch.ops.apply_find import (TailGeometry, _lib,
                                                   launch_pool,
                                                   tail_smem_bytes)
    from lightgbm_tpu_torch.utils.log import LightGBMError
    case, _ = _tail_case(28, 256, "plain")
    for blocks, feats in ((7, 3), (15, 2), (28, 1), (1, 27)):
        geo = TailGeometry(blocks, feats, tail_smem_bytes(feats, 256))
        st = case.clone()
        with pytest.raises(LightGBMError, match="CUDA error 1"):
            launch_pool(st.h_a, st.h_b, *st.args(), geo)
        assert all(torch.equal(a, b) for a, b in zip(st.st, case.st))
    assert _lib().apply_find_smem_bytes(9, 1024) == tail_smem_bytes(9, 1024)


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_default_route_on_card_matches_cpu_and_slice2(cuda, objective,
                                                      monkeypatch):
    """The default route on the card grows the CPU run's trees and, on
    the card, slice 2's route's trees, leaf values bit for bit."""
    from lightgbm_tpu_torch.ops.apply_find import apply_find_pool
    from lightgbm_tpu_torch.ops.fused_split import fused_split
    from lightgbm_tpu_torch.ops.stream_grad import stream_refresh
    x, y = make_higgs_like(6000, 8, seed=5)
    x[np.random.default_rng(5).random(x.shape) < 0.1] = np.nan
    if objective == "regression":
        y = np.nan_to_num(x[:, 1]) + y
    p = {"objective": objective, "num_leaves": 31, "verbosity": -1}
    counts = (fused_split.launches, apply_find_pool.launches,
              stream_refresh.launches)
    card = lgt.train(p, lgt.Dataset(x, label=y), num_boost_round=3,
                     device="cuda")
    assert card._inner.grow.route.describe().startswith(
        "path=stream fused=1 tail=kernel")
    splits = sum(t.num_leaves - 1 for t in card._models)
    assert (fused_split.launches - counts[0],
            apply_find_pool.launches - counts[1],
            stream_refresh.launches - counts[2]) == (splits, splits, 3)
    cpu = lgt.train(p, lgt.Dataset(x, label=y), num_boost_round=3,
                    device="cpu")
    for k, v in SLICE2_ROUTE.items():
        monkeypatch.setenv(k, v)
    slice2 = lgt.train(p, lgt.Dataset(x, label=y), num_boost_round=3,
                       device="cuda")
    assert slice2._inner.grow.route.tail == "xla"
    for other in (cpu, slice2):
        res = compare_trees(card._models, other._models)
        assert res["ok"], res
    for a, b in zip(card._models, slice2._models):
        assert a.leaf_value.tobytes() == b.leaf_value.tobytes()


# -- slice 4: the row-indexed histogram and the row-order route ---------
@pytest.mark.parametrize("b,f,indexed,rng", [
    (256, 7, True, (1001, 9000)),        # u8 through an index
    (1024, 28, False, (0, 20_000)),      # u16, the whole matrix
    (1024, 28, True, (3, 3000)),         # u16 child at an odd offset
    (1040, 5, True, (19_000, 5000)),     # B = 1040, cut at the end
    (1024, 13, True, (0, 1)),            # F not a multiple of 8, one row
    (1024, 9, True, (50, 0)),            # an empty range
])
def test_hist_rows_matches_plain(cuda, b, f, indexed, rng):
    """hist_rows bitwise against its plain version on CPU copies, two
    launches bitwise, within 4 * n * eps * max|v| of the plain version on
    the card."""
    g = np.random.default_rng(b + f)
    dt = np.uint8 if b <= 256 else np.uint16
    bins = torch.tensor(g.integers(0, b, size=(20_000, f)).astype(dt),
                        device=cuda)
    vals = torch.tensor(g.normal(size=(20_000, 2)).astype(np.float32),
                        device=cuda)
    index = (torch.tensor(g.permutation(20_000).astype(np.int32),
                          device=cuda) if indexed else None)
    hist_rows_case(bins, vals, rng, index, b, max(rng[1], 1), "test",
                   timed=False)


HIST_ROWS_COUNTS = [0, 1, 31, 33, 255, 257, 3000, 16_384, 16_385, 32_769]


@pytest.mark.parametrize("count", HIST_ROWS_COUNTS)
@pytest.mark.parametrize("b", [256, 1024, 1040])
@pytest.mark.parametrize("f", [28, 136])
def test_hist_rows_one_and_more_slices(cuda, f, b, count):
    """hist_rows at counts on both sides of a warp, a stage, the
    one-slice edge (16,384 at B = 1024: one slice; 16,385: two, both one
    launch of the direct kernel) and the direct kernel's edge (32,769:
    three slices, the partial kernel and the reduction), from an odd
    start through a permutation, with ``max_rows = count``: bitwise its
    plain version on CPU copies, two launches bitwise."""
    g = np.random.default_rng(f * b + count)
    dt = np.uint8 if b <= 256 else np.uint16
    n = 40_000
    bins = torch.tensor(g.integers(0, b, size=(n, f)).astype(dt),
                        device=cuda)
    vals = torch.tensor(g.normal(size=(n, 2)).astype(np.float32),
                        device=cuda)
    index = torch.tensor(g.permutation(n).astype(np.int32), device=cuda)
    hist_rows_case(bins, vals, (1001, count), index, b, max(count, 1),
                   "test", timed=False)


def test_hist_rows_in_a_graph(cuda):
    """hist_rows captured in a CUDA graph (one slice and several) and
    replayed on new values: bitwise the eager call on them."""
    from lightgbm_tpu_torch.ops.hist_kernel2 import build_histogram_rows
    from lightgbm_tpu_torch.tools.profile_lib import capture
    g = np.random.default_rng(5)
    n = 40_000
    bins = torch.tensor(g.integers(0, 1024, size=(n, 28)).astype(np.uint16),
                        device=cuda)
    vals = torch.tensor(g.normal(size=(n, 2)).astype(np.float32),
                        device=cuda)
    index = torch.tensor(g.permutation(n).astype(np.int32), device=cuda)
    for count in (3000, 30_000):
        rng = torch.tensor([7, count], dtype=torch.int32, device=cuda)
        held = {}

        def call():
            held["out"] = build_histogram_rows(
                bins, vals, rng, index=index, padded_bins=1024,
                max_rows=count)
        graph = capture(call)
        vals.copy_(torch.tensor(g.normal(size=(n, 2)).astype(np.float32)))
        graph.replay()
        want = build_histogram_rows(bins, vals, rng, index=index,
                                    padded_bins=1024, max_rows=count)
        torch.cuda.synchronize()
        assert torch.equal(held["out"], want)


def _records(cuda, n, f, seed):
    from lightgbm_tpu_torch.ops.device_data import PackedRows, RecordLayout
    lay = RecordLayout(f)
    g = np.random.default_rng(seed)

    def buf():
        return PackedRows(torch.tensor(
            g.integers(0, 256, size=(n, lay.stride)).astype(np.uint8),
            device=cuda), lay)
    return buf(), buf()


@pytest.mark.parametrize("f", [28, 40])
@pytest.mark.parametrize("where", ["one", "odd", "to_end", "stage-1",
                                   "stage", "stage+1", "many"])
def test_copyback_p2_span_and_canaries(cuda, f, where):
    """copyback_p2 copies exactly records [s0, s0 + cnt) from scratch
    (one record; an odd s0 and cnt; a segment ending at the buffer's last
    record; the 16 KiB one step of a block moves, and one record either
    side; 19 MB, every block taking several steps) and
    leaves the records on both sides, random canaries, untouched: the
    whole buffer equals its plain version's byte for byte."""
    from lightgbm_tpu_torch.ops.partition_kernel import (copyback_p2,
                                                         copyback_p2_ref)
    n = 300_000
    rows, scratch = _records(cuda, n, f, f)
    per_step = 16 * 1024 // rows.layout.stride
    s0, cnt = {"one": (777, 1), "odd": (1, 10_001),
               "to_end": (n - 40_003, 40_003),
               "stage-1": (3, per_step - 1), "stage": (5, per_step),
               "stage+1": (11, per_step + 1), "many": (7, n - 8)}[where]
    orig = rows.buf.clone()
    want = orig.clone()
    want[s0:s0 + cnt] = scratch.buf[s0:s0 + cnt]
    before = copyback_p2.launches
    copyback_p2(rows, scratch, s0, cnt)
    torch.cuda.synchronize()
    assert copyback_p2.launches - before == 1
    assert torch.equal(rows.buf, want)
    # the plain version moves the records' fields (not their pad
    # bytes); random bytes hold NaNs, so the fields compare as integers
    ref = type(rows)(orig.cpu(), rows.layout)
    copyback_p2_ref(ref, type(rows)(scratch.buf.cpu(), rows.layout), s0,
                    cnt)
    for a, b in zip(ref.fields(), type(rows)(rows.buf.cpu(),
                                             rows.layout).fields()):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def test_copyback_p2_in_a_graph(cuda):
    """copyback_p2 captured in a CUDA graph and replayed on new scratch
    bytes copies them, bitwise, and leaves the other records as they
    were."""
    from lightgbm_tpu_torch.ops.partition_kernel import copyback_p2
    from lightgbm_tpu_torch.tools.profile_lib import capture
    rows, scratch = _records(cuda, 200_000, 28, 3)
    s0, cnt = 999, 150_001
    graph = capture(lambda: copyback_p2(rows, scratch, s0, cnt))
    scratch.buf.copy_(torch.randint(0, 256, scratch.buf.shape,
                                    dtype=torch.uint8, device=cuda))
    keep = rows.buf.clone()
    graph.replay()
    torch.cuda.synchronize()
    keep[s0:s0 + cnt] = scratch.buf[s0:s0 + cnt]
    assert torch.equal(rows.buf, keep)


def test_hist_rows_library_refuses_a_short_geometry(cuda):
    """The library launches the geometry the wrapper passes and refuses
    one that misses a cell: the one-launch kernel at three slices, too
    few blocks or bin ranges, and the partial kernel without partials."""
    from lightgbm_tpu_torch.ops.hist_kernel2 import _rows_lib, rows_geometry
    n, f, b = 1000, 28, 1024
    bins = torch.zeros((n, f), dtype=torch.uint16, device=cuda)
    vals = torch.zeros((n, 2), dtype=torch.float32, device=cuda)
    rng = torch.tensor([0, n], dtype=torch.int32, device=cuda)
    out = torch.empty((f, b, 2), dtype=torch.float32, device=cuda)
    partials = torch.empty((3, f, b, 2), dtype=torch.float32, device=cuda)
    one, three = rows_geometry(f, b, 2, 1), rows_geometry(f, b, 2, 3)

    def launch(geo, slices, direct, grid, parts, part_ptr):
        return _rows_lib().hist_rows(
            bins.data_ptr(), 2, vals.data_ptr(), None, rng.data_ptr(),
            part_ptr, out.data_ptr(), n, f, b, slices, direct, grid[0],
            grid[1], geo.feats, parts, torch.cuda.current_stream().cuda_stream)
    assert launch(one, 1, 1, one.grid, one.bin_parts, None) == 0
    assert launch(three, 3, 0, three.grid, 1, partials.data_ptr()) == 0
    for bad in ((one, 3, 1, one.grid, one.bin_parts, None),
                (one, 1, 1, (one.grid[0] - 1, 1), one.bin_parts, None),
                (one, 1, 1, one.grid, one.bin_parts - 1, None),
                (three, 3, 0, three.grid, 1, None),
                (three, 3, 0, (2, three.grid[1]), 1, partials.data_ptr())):
        assert launch(*bad) != 0
    torch.cuda.synchronize()


# -- slice 12: the fused split's two passes ----------------------------------
# (s0, cnt, feat, sbin, default_left, is_cat, nan_bin) on rows of F
# features, bins below n_bins (feature 0's NaN bin n_bins - 1)
FUSED_CASES = {
    "all_left": (3, 20_000, 1, 300, 0, 0, -1),
    "all_right": (5, 20_000, 2, -1, 0, 0, -1),
    "one_row": (7, 1, 0, 10, 1, 0, -1),
    "odd_s0_nan_left": (1, 13_129, 0, 50, 1, 0, "nan"),
    "nan_right": (2, 13_128, 0, 50, 0, 0, "nan"),
    "one_hot": (9, 30_001, 3, 17, 0, 1, -1),
    "slice_edge_8190": (11, 8190, 1, 30, 0, 0, -1),
    "slice_edge_8192": (11, 8192, 1, 30, 0, 0, -1),
    "slice_edge_8194": (11, 8194, 1, 30, 0, 0, -1),
    # the last count in range mode, and the first in feature mode
    "mode_edge_57342": (13, 57_342, 2, 40, 0, 0, -1),
    "mode_edge_57344": (13, 57_344, 2, 40, 0, 0, -1),
    # 16 and 17 slices a side, the partials added by the reduction
    "slices_16_131070": (1, 131_070, 0, 60, 1, 0, "nan"),
    "slices_17_131072": (1, 131_072, 0, 60, 1, 0, "nan"),
}
FUSED_SHAPES = [(28, 256), (27, 256), (71, 256), (28, 64)]


def _fused_rows(cuda, f, b, seed):
    from lightgbm_tpu_torch.ops.device_data import pack_rows
    arrays = random_row_matrix(140_000, f, seed, n_bins=b - 1,
                               nan_bin=b - 1)
    rows = rows_on(arrays, cuda)
    return rows, pack_rows(rows), rows_on(arrays, "cpu")


@pytest.mark.parametrize("f,b", FUSED_SHAPES)
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_split_both_packs_bitwise(cuda, f, b, case):
    """fused_split and fused_split_p2 bitwise their plain version run on
    CPU copies (both histograms, the scratch segment, nleft) on
    adversarial splits, one counted launch each."""
    from lightgbm_tpu_torch.ops.device_data import PackedRows, Rows
    from lightgbm_tpu_torch.ops.fused_split import (fused_split,
                                                    fused_split_p2,
                                                    fused_split_ref)
    rows, packed, cpu_rows = _fused_rows(cuda, f, b, f + b)
    sel = list(FUSED_CASES[case])
    sel[6] = b - 1 if sel[6] == "nan" else sel[6]
    s0, cnt = sel[0], sel[1]
    seg = slice(s0, s0 + cnt)
    scr_c = Rows(*(torch.zeros_like(a) for a in cpu_rows))
    nl_c = torch.zeros(1, dtype=torch.int32)
    ref = fused_split_ref(cpu_rows, scr_c, sel, nl_c, padded_bins=b)
    nl = torch.full((1,), -1, dtype=torch.int32, device=cuda)
    scr1 = Rows(*(torch.zeros_like(a) for a in rows))
    before = fused_split.launches
    h1 = fused_split(rows, scr1, sel, nl, padded_bins=b)
    torch.cuda.synchronize()
    assert fused_split.launches - before == 1
    assert int(nl) == int(nl_c)
    assert torch.equal(h1.cpu(), ref)
    for a, c in zip(scr1, scr_c):
        assert torch.equal(a[seg].cpu(), c[seg])
    nl.fill_(-1)
    scr2 = PackedRows(torch.zeros_like(packed.buf), packed.layout)
    before = fused_split_p2.launches
    h2 = fused_split_p2(packed, scr2, sel, nl, padded_bins=b)
    torch.cuda.synchronize()
    assert fused_split_p2.launches - before == 1
    assert int(nl) == int(nl_c)
    assert torch.equal(h2.cpu(), ref)
    for a, c in zip(scr2.fields(), scr_c):
        assert torch.equal(a[seg].cpu(), c[seg])


@pytest.mark.parametrize("pack", [1, 2])
def test_fused_split_in_a_graph(cuda, pack):
    """The fused split captured in a CUDA graph (range mode and feature
    mode, each with the reduction) and replayed on new gradients:
    bitwise the eager call on them."""
    from lightgbm_tpu_torch.ops.device_data import (PackedRows, Rows,
                                                    pack_rows)
    from lightgbm_tpu_torch.ops.fused_split import (fused_split,
                                                    fused_split_p2)
    from lightgbm_tpu_torch.tools.profile_lib import capture
    rows, packed, _ = _fused_rows(cuda, 28, 256, 3)
    g = np.random.default_rng(8)
    for cnt in (13_128, 139_000):
        sel = (1, cnt, 0, 100, 1, 0, 255)
        nl = torch.zeros(1, dtype=torch.int32, device=cuda)
        held = {}
        if pack == 1:
            scr = Rows(*(torch.zeros_like(a) for a in rows))

            def call():
                held["out"] = fused_split(rows, scr, sel, nl,
                                          padded_bins=256)
        else:
            scr = PackedRows(torch.zeros_like(packed.buf), packed.layout)

            def call():
                held["out"] = fused_split_p2(packed, scr, sel, nl,
                                             padded_bins=256)
        graph = capture(call)
        rows.vals.copy_(torch.tensor(g.normal(size=(rows.vals.shape[0], 3))
                                     .astype(np.float32), device=cuda))
        if pack == 2:
            packed.buf.copy_(pack_rows(rows).buf)
        graph.replay()
        got = held["out"].clone()
        call()
        torch.cuda.synchronize()
        assert torch.equal(got, held["out"])


def test_fused_split_library_refuses_a_short_geometry(cuda):
    """The library launches the geometry the wrapper passes and refuses
    one that misses a row or a cell: too few count tiles, too few
    feature groups or range blocks, bin ranges that miss bins, and
    several slices without partials."""
    from lightgbm_tpu_torch.ops.device_data import Rows
    from lightgbm_tpu_torch.ops.fused_split import (_lib, _split_buffers,
                                                    fused_geometry)
    from lightgbm_tpu_torch.ops.partition_kernel import row_pointers
    rows, _, _ = _fused_rows(cuda, 28, 256, 4)
    scr = Rows(*(torch.zeros_like(a) for a in rows))
    nl = torch.zeros(1, dtype=torch.int32, device=cuda)

    def launch(cnt, tiles, slices, groups, feats, parts, partials=True):
        geo = fused_geometry(28, 256, cnt)
        ws, out, ptrs = _split_buffers(geo, 28, 256, cnt, cuda)
        pa = torch.empty((2, slices, 28, 256, 2), device=cuda)
        rc = _lib().fused_split(
            *row_pointers(rows), *row_pointers(scr), ptrs[0], nl.data_ptr(),
            ptrs[1], ptrs[2], pa.data_ptr() if partials else None,
            out.data_ptr(), 28, 256, 0, cnt, 0, 100, 0, 0, -1, 0, None,
            tiles, slices, groups, feats, parts,
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        return rc
    # the wrapper's geometries launch
    assert launch(13_128, 13, 2, 28, 0, 8) == 0
    assert launch(139_000, 136, 17, 7, 4, 1) == 0
    invalid = 1   # cudaErrorInvalidValue
    for bad in ((13_128, 12, 2, 28, 0, 8),     # a row's tile missing
                (13_128, 13, 2, 27, 0, 8),     # a range block missing
                (13_128, 13, 2, 28, 0, 7),     # bins 224-255 missing
                (139_000, 136, 17, 7, 3, 1)):  # a feature missing
        assert launch(*bad) == invalid, bad
    assert launch(13_128, 13, 2, 28, 0, 8, partials=False) == invalid


@pytest.mark.parametrize("max_bin,env", [(1023, {}),
                                         (255, {"LGBM_TPU_PHYS": "0"})])
def test_row_order_on_card_matches_cpu(cuda, max_bin, env, monkeypatch):
    """The row-order route on the card grows the CPU run's trees bit for
    bit, launching hist_rows once per tree and once per split, and
    apply_find_pool once per split where the tail is the kernel."""
    from lightgbm_tpu_torch.ops.apply_find import apply_find_pool
    from lightgbm_tpu_torch.ops.hist_kernel2 import build_histogram_rows
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    x, y = make_higgs_like(6000, 8, seed=6)
    x[np.random.default_rng(6).random(x.shape) < 0.1] = np.nan
    p = {"objective": "binary", "num_leaves": 31, "max_bin": max_bin,
         "min_data_in_bin": 1, "verbosity": -1}
    counts = (build_histogram_rows.launches, apply_find_pool.launches)
    card = lgt.train(p, lgt.Dataset(x, label=y), num_boost_round=3,
                     device="cuda")
    route = card._inner.grow.route
    assert route.path == "row_order"
    splits = sum(t.num_leaves - 1 for t in card._models)
    assert (build_histogram_rows.launches - counts[0],
            apply_find_pool.launches - counts[1]) == (
        3 + splits, splits if route.tail == "kernel" else 0)
    cpu = lgt.train(p, lgt.Dataset(x, label=y), num_boost_round=3,
                    device="cpu")
    res = compare_trees(card._models, cpu._models)
    assert res["ok"], res
    assert leaves_bitwise(card._models, cpu._models)


# -- slice 5: the 3-phase partition, the plain refresh, the pool tail ---
WORDS = [0x0F0F0F0F, 0x12345678, -0x7FFF0000, 0, 0x7FFFFFFF, 0x55555555,
         0x00010001, -0x80000000]


@pytest.mark.parametrize("sel", [
    (0, 20_000, 0, 100, 1, 0, 200),      # NaN bin routed left
    (333, 5001, 0, 90, 0, 0, 200),       # NaN bin routed right
    (17, 4000, 3, 7, 0, 1, -1),          # one-hot categorical
    (2047, 3001, 5, 0, 0, 1, -1, 0, *WORDS),   # bitset, bit 31 words
    (5, 19_990, 2, 199, 0, 0, -1),       # nearly all rows left
    (1, 1, 2, 50, 0, 0, -1),             # one row
    (100, 0, 1, 10, 0, 0, -1),           # dead split: no launch
])
def test_partition_3ph_matches_plain(cuda, sel):
    """partition_3ph vs its plain version on the card and on CPU copies:
    identical bytes of the whole matrix and nleft, one launch."""
    r = random_row_matrix(20_000, 6, 9, n_bins=201, nan_bin=200)
    r[0][:, 5] = np.random.default_rng(10).integers(0, 256, 20_000)
    partition_3ph_parity(rows_on(r, cuda), sel, "test")


# -- slice 15: the one-launch scan of both partitions ---------------------------
EDGE_ROWS = 20_000
# rows of the scan's unstaged kernels (too wide to stage)
MANY_ROWS = 6_000


def _edge_rows(f: int, device, n: int = EDGE_ROWS):
    """Seeded rows: feature 0 with 5 % in the NaN bin 254, feature 5
    over the whole u8 range (the bitset's), the rest below 255."""
    r = random_row_matrix(n, f, 40 + f, nan_bin=254)
    r[0][:, 5] = np.random.default_rng(41 + f).integers(0, 256, n)
    return rows_on(r, device)


@pytest.mark.parametrize("kind", ["scan", "3ph", "scan_p2"])
@pytest.mark.parametrize("f", [27, 28, 136, 8_000, 20_000])
def test_partitions_on_adversarial_segments(cuda, f, kind):
    """partition_scan + copyback, partition_3ph and partition_scan_p2 +
    copyback_p2 bitwise their plain versions (3ph also on CPU copies) on
    every adversarial segment at the tile the wrapper's geometry gives:
    every row left or right, one row, one row past a tile boundary, an
    odd s0 with the NaN bin routed either way, one-hot categorical, 8
    membership words (3ph); staged at 27-136 features, unstaged at
    8,000 and 20,000."""
    from chip_smoke import pack2_scan_case, partition_edge_cases
    from lightgbm_tpu_torch.ops import partition_kernel as pk
    from lightgbm_tpu_torch.ops.device_data import pack_rows
    n = EDGE_ROWS if f < 1_000 else MANY_ROWS
    rows = _edge_rows(f, cuda, n)
    packed = pack_rows(rows)
    stride = packed.layout.stride if kind == "scan_p2" else None
    geo = pk.scan_geometry(n, f, stride)
    assert geo.staged == (f < 1_000)
    for label, sel in partition_edge_cases(geo.tile, 254, n,
                                           bitset=kind == "3ph"):
        if kind == "scan":
            partition_parity(rows, sel, label)
        elif kind == "3ph":
            partition_3ph_parity(rows, sel, label)
        else:
            pack2_scan_case(rows, packed, sel, label)


def _scan_case(kind: str, f: int, device, sel=(1_001, 9_999, 0, 120, 1, 0,
                                                254)):
    """(rows, scratch, the plain version's rows / scratch and nleft,
    the split) of one segment (by default across several tiles, at an
    odd start)."""
    from lightgbm_tpu_torch.ops import partition_kernel as pk
    from lightgbm_tpu_torch.ops.device_data import (empty_packed_like,
                                                    empty_rows_like,
                                                    pack_rows)
    rows = _edge_rows(f, device)
    nl = torch.full((1,), -1, dtype=torch.int32, device=device)
    if kind == "scan_p2":
        rows = pack_rows(rows)
        want = empty_packed_like(rows)
        pk.partition_scan_p2_ref(rows, want, sel, nl)
        return rows, empty_packed_like(rows), (want.fields(), nl), sel
    if kind == "3ph":
        want = pk.Rows(*(a.clone() for a in rows))
        pk.partition_3ph_ref(want, empty_rows_like(rows), sel, nl)
        return rows, empty_rows_like(rows), (want, nl), sel
    want = empty_rows_like(rows)
    pk.partition_scan_ref(rows, want, sel, nl)
    return rows, empty_rows_like(rows), (want, nl), sel


def _scan_equal(kind, rows, scratch, sel, want) -> bool:
    """The segment the scan wrote (3ph: the rows) bitwise ``want``'s."""
    from chip_smoke import torch_equal
    s0, cnt = sel[:2]
    out = (rows if kind == "3ph" else scratch.fields() if kind == "scan_p2"
           else scratch)
    return all(torch_equal(a[s0:s0 + cnt], b[s0:s0 + cnt])
               for a, b in zip(out, want))


@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("tile", [32, 128, 256, 512, 1024])
@pytest.mark.parametrize("kind", ["scan", "3ph", "scan_p2"])
def test_scan_every_tile_staged_and_unstaged(cuda, kind, tile, staged):
    """The scan on every tile the kernel takes, with the rows staged in
    shared memory and read in place, bitwise the plain version on three
    launches in a row (each zeroes its own look-back state)."""
    from lightgbm_tpu_torch.ops import partition_kernel as pk
    f = 28
    rows, scratch, (want, nl_want), sel = _scan_case(kind, f, cuda)
    stride = rows.layout.stride if kind == "scan_p2" else None
    geo = pk.scan_geometry(sel[1], f, stride, tile=tile, staged=staged)
    assert geo.staged == staged
    nl = torch.full((1,), -1, dtype=torch.int32, device=cuda)
    base = [a.clone() for a in (rows if kind == "3ph" else ())]
    for _ in range(3):
        for a, b in zip(rows if kind == "3ph" else (), base):
            a.copy_(b)
        pk.launch_scan(rows, scratch, sel, nl, geo,
                       scheme="3ph" if kind == "3ph" else "ss")
        torch.cuda.synchronize()
        assert int(nl) == int(nl_want)
        assert _scan_equal(kind, rows, scratch, sel, want)


@pytest.mark.parametrize("kind", ["scan", "3ph", "scan_p2"])
def test_partitions_in_a_graph(cuda, kind):
    """Each partition captured in a CUDA graph (after an eager call on a
    smaller segment) and replayed three times gives the plain version's
    bytes every time, and counts its launch at the capture, not at the
    replays."""
    from lightgbm_tpu_torch.ops import partition_kernel as pk
    from lightgbm_tpu_torch.tools.profile_lib import capture
    rows, scratch, (want, nl_want), sel = _scan_case(kind, 28, cuda)
    base = [a.clone() for a in (rows if kind == "3ph" else ())]
    nl = torch.full((1,), -1, dtype=torch.int32, device=cuda)
    fn = {"scan": pk.partition_scan, "3ph": pk.partition_3ph,
          "scan_p2": pk.partition_scan_p2}[kind]
    fn(rows, scratch, (7, 40, 0, 120, 1, 0, 254), nl)
    for a, b in zip(rows if kind == "3ph" else (), base):
        a.copy_(b)
    graph = capture(lambda: fn(rows, scratch, sel, nl), warmup=1)
    launches = fn.launches
    for _ in range(3):
        for a, b in zip(rows if kind == "3ph" else (), base):
            a.copy_(b)
        nl.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        assert int(nl) == int(nl_want)
        assert _scan_equal(kind, rows, scratch, sel, want)
    assert fn.launches == launches


@pytest.mark.parametrize("kind", ["scan", "3ph", "scan_p2"])
def test_partitions_on_two_streams_at_once(cuda, kind):
    """Scans of two matrices, each queued ten times on a stream of its
    own with neither waiting for the other, give each its plain
    version's bytes (3ph: ten plain partitions): their look-back states
    are their own."""
    from lightgbm_tpu_torch.ops import partition_kernel as pk
    from lightgbm_tpu_torch.ops.device_data import empty_rows_like
    fn = {"scan": pk.partition_scan, "3ph": pk.partition_3ph,
          "scan_p2": pk.partition_scan_p2}[kind]
    cases = [_scan_case(kind, 28, cuda, sel)
             for sel in ((1_001, 9_999, 0, 120, 1, 0, 254),
                         (3, 19_000, 0, 90, 0, 0, 254))]
    start = [[a.clone() for a in rows] if kind == "3ph" else None
             for rows, *_ in cases]
    streams = [torch.cuda.Stream(cuda) for _ in cases]
    nls = [torch.full((1,), -1, dtype=torch.int32, device=cuda)
           for _ in cases]
    torch.cuda.synchronize()
    for _ in range(10):
        for (rows, scratch, _, sel), st, nl in zip(cases, streams, nls):
            with torch.cuda.stream(st):
                fn(rows, scratch, sel, nl)
    torch.cuda.synchronize()
    for (rows, scratch, (want, nl_want), sel), nl, a0 in zip(cases, nls,
                                                             start):
        if kind == "3ph":
            want = pk.Rows(*a0)
            for _ in range(10):
                pk.partition_3ph_ref(want, empty_rows_like(want), sel,
                                     nl_want)
        assert int(nl) == int(nl_want)
        assert _scan_equal(kind, rows, scratch, sel, want)


@pytest.mark.parametrize("kind,sigmoid", [("binary", 1.0), ("binary", 0.7),
                                          ("l2", 1.0)])
def test_stream_refresh_plain_matches_plain(cuda, kind, sigmoid):
    rows = rows_on(random_row_matrix(20_011, 7, 14), cuda)
    rec = refresh_plain_parity(rows.bins, kind, 256, "test", sigmoid=sigmoid)
    assert rec["cpu_plain_identical"]


@pytest.mark.parametrize("env", [{"LGBM_TPU_PART": "3ph"},
                                 {"LGBM_TPU_POOL_TAIL": "0"},
                                 {"LGBM_TPU_FUSED": "0"}])
def test_slice5_routes_on_card_match_cpu(cuda, env, monkeypatch):
    """The 3ph route, LGBM_TPU_POOL_TAIL=0 and the stream route without
    the fused split on the card grow the CPU run's trees bit for bit,
    launching each kernel as many times as the route says; the latter
    two grow the default route's trees bit for bit."""
    from chip_smoke import ROUTE_KNOBS
    from lightgbm_tpu_torch.ops import (apply_find, fused_split,
                                        hist_kernel2, partition_kernel,
                                        stream_grad)
    for k in ROUTE_KNOBS:
        monkeypatch.delenv(k, raising=False)
    x, y = make_higgs_like(6000, 8, seed=7)
    x[np.random.default_rng(7).random(x.shape) < 0.1] = np.nan
    p = {"objective": "binary", "num_leaves": 31, "verbosity": -1}
    default = lgt.train(p, lgt.Dataset(x, label=y), num_boost_round=3,
                        device="cuda")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    fns = {"stream_init": stream_grad.stream_init,
           "stream_refresh": stream_grad.stream_refresh,
           "stream_refresh_plain": stream_grad.stream_refresh_plain,
           "build_histogram_comb": hist_kernel2.build_histogram_comb,
           "partition_scan": partition_kernel.partition_scan,
           "partition_3ph": partition_kernel.partition_3ph,
           "fused_split": fused_split.fused_split,
           "copyback": partition_kernel.copyback,
           "apply_find_pool": apply_find.apply_find_pool,
           "apply_find": apply_find.apply_find,
           "build_histogram_rows": hist_kernel2.build_histogram_rows,
           **_pack2_fns(), **_mode_fns()}
    before = {k: f.launches for k, f in fns.items()}
    card = lgt.train(p, lgt.Dataset(x, label=y), num_boost_round=3,
                     device="cuda")
    got = {k: f.launches - before[k] for k, f in fns.items()}
    splits = sum(t.num_leaves - 1 for t in card._models)
    assert got == expected_launches(card._inner.grow.route, 3, splits)
    cpu = lgt.train(p, lgt.Dataset(x, label=y), num_boost_round=3,
                    device="cpu")
    res = compare_trees(card._models, cpu._models)
    assert res["ok"], res
    assert leaves_bitwise(card._models, cpu._models)
    if "LGBM_TPU_PART" not in env:
        assert leaves_bitwise(card._models, default._models)


# -- slice 6: pack=2, one record per row ---------------------------------
def _mode_fns() -> dict:
    """The kernels of slice 23's modes, which ``expected_launches``
    counts on every route (zero off the gpu_use_dp and linear routes)."""
    from lightgbm_tpu_torch.ops import hist_kernel2, linear_kernel
    return {"build_histogram_rows_dp": hist_kernel2.build_histogram_rows_dp,
            "linear_moments": linear_kernel.linear_moments}


def _pack2_fns() -> dict:
    from lightgbm_tpu_torch.ops import (fused_split, hist_kernel2,
                                        partition_kernel, stream_grad)
    return {"stream_init_p2": stream_grad.stream_init_p2,
            "stream_refresh_p2": stream_grad.stream_refresh_p2,
            "build_histogram_comb_p2": hist_kernel2.build_histogram_comb_p2,
            "fused_split_p2": fused_split.fused_split_p2,
            "copyback_p2": partition_kernel.copyback_p2,
            "partition_scan_p2": partition_kernel.partition_scan_p2,
            "stream_refresh_plain_p2": stream_grad.stream_refresh_plain_p2}


@pytest.mark.parametrize("f", [6, 13, 28, 40])
def test_pack2_kernels_match_plain_and_pack1(cuda, f):
    """The seven record kernels against their plain versions and their
    pack=1 kernels on the same logical rows, bitwise (histograms within
    4 * n * eps * max|v| of the plain versions on the card): the root, a
    range and a segment at odd offsets of odd lengths, a dead split (the
    fused and the unfused split), both refreshes, strides 48, 64 and
    80."""
    rows = rows_on(random_row_matrix(20_011, f, 20 + f, nan_bin=254), cuda)
    pack2_cases(rows.bins, rows, 256, f"test_F{f}")


@pytest.mark.parametrize("env", [
    {}, {"LGBM_TPU_STREAM": "0"}, {"LGBM_TPU_FUSED": "0"},
    {"LGBM_TPU_STREAM": "0", "LGBM_TPU_FUSED": "0"},
    {"LGBM_TPU_STREAM": "0", "LGBM_TPU_FUSED": "0",
     "LGBM_TPU_APPLY_IMPL": "xla"}])
def test_pack2_route_on_card_matches_cpu_and_pack1(cuda, env, monkeypatch):
    """LGBM_TPU_COMB_PACK=2 on the card, with and without the fused
    split, grows the CPU run's trees and the pack=1 route's trees bit
    for bit, launching each record kernel as many times as the route
    says and no pack=1 row kernel."""
    from chip_smoke import ROUTE_KNOBS
    from lightgbm_tpu_torch.ops import (apply_find, fused_split,
                                        hist_kernel2, partition_kernel,
                                        stream_grad)
    for k in ROUTE_KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    x, y = make_higgs_like(6000, 8, seed=8)
    x[np.random.default_rng(8).random(x.shape) < 0.1] = np.nan
    p = {"objective": "binary", "num_leaves": 31, "verbosity": -1}
    pack1 = lgt.train(p, lgt.Dataset(x, label=y), num_boost_round=3,
                      device="cuda")
    monkeypatch.setenv("LGBM_TPU_COMB_PACK", "2")
    fns = {"stream_init": stream_grad.stream_init,
           "stream_refresh": stream_grad.stream_refresh,
           "stream_refresh_plain": stream_grad.stream_refresh_plain,
           "build_histogram_comb": hist_kernel2.build_histogram_comb,
           "partition_scan": partition_kernel.partition_scan,
           "partition_3ph": partition_kernel.partition_3ph,
           "fused_split": fused_split.fused_split,
           "copyback": partition_kernel.copyback,
           "apply_find_pool": apply_find.apply_find_pool,
           "apply_find": apply_find.apply_find,
           "build_histogram_rows": hist_kernel2.build_histogram_rows,
           **_pack2_fns(), **_mode_fns()}
    before = {k: fn.launches for k, fn in fns.items()}
    card = lgt.train(p, lgt.Dataset(x, label=y), num_boost_round=3,
                     device="cuda")
    got = {k: fn.launches - before[k] for k, fn in fns.items()}
    route = card._inner.grow.route
    assert route.pack == 2 and " pack=2" in route.describe()
    splits = sum(t.num_leaves - 1 for t in card._models)
    assert got == expected_launches(route, 3, splits)
    cpu = lgt.train(p, lgt.Dataset(x, label=y), num_boost_round=3,
                    device="cpu")
    for other in (cpu, pack1):
        res = compare_trees(card._models, other._models)
        assert res["ok"], res
        assert leaves_bitwise(card._models, other._models)


# -- slice 8: the analyzer's fixture kernels and the resource report ----------
@pytest.mark.parametrize("index", range(7))
def test_fixture_kernel_bitwise_at_legal_geometry(cuda, index):
    from chip_smoke import _bits, _on, fixture_cases
    kernel, label, fn, plain, args, kw = fixture_cases(seed=index)[index]
    before = fn.launches
    out = fn(*_on(args, cuda), **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(_bits(out.cpu()), _bits(plain(*args, **kw))), label


@pytest.mark.parametrize("name", ["bad_lane", "bad_cat", "bad_serve_kernel",
                                  "bad_mc_batch"])
def test_seeded_stage_geometry_never_launches(cuda, name):
    from lightgbm_tpu_torch.analysis.fixtures import STAGE_SEEDED
    from lightgbm_tpu_torch.ops import analysis_fixtures as af
    from lightgbm_tpu_torch.utils.log import LightGBMError
    _, dtype, classes, rows, cols, copied, _ = STAGE_SEEDED[name]
    shape = (classes, rows, cols) if classes > 1 else (rows, cols)
    before = af.stage_copy.launches
    with pytest.raises(LightGBMError):
        af.stage_copy(torch.zeros(shape, dtype=getattr(torch, dtype),
                                  device=cuda), copied)
    assert af.stage_copy.launches == before


def test_resource_report_read_fresh_equals_the_checked_in_one(cuda):
    from chip_smoke import same_resources
    from lightgbm_tpu_torch.analysis import resources as res
    from lightgbm_tpu_torch.ops import _build
    _build.build()
    assert same_resources(res.load_report(), res.read_built())


def test_analyzer_strict_on_the_card(cuda):
    from lightgbm_tpu_torch.analysis import fixtures as fx
    from lightgbm_tpu_torch.analysis.run import run_analysis
    from lightgbm_tpu_torch.ops import _build
    _build.build()
    report = run_analysis(passes=["align", "smem"], strict=True,
                          resources="built")
    assert report.failing() == []
    seeded = run_analysis(passes=["align", "smem"], strict=True,
                          resources="built",
                          fixtures=["bad_lane", "bad_vmem"])
    assert {f.code for f in seeded.findings if f.fixture} == (
        fx.EXPECTED["bad_lane"] | fx.EXPECTED["bad_vmem"])


# -- slice 9: wide datasets and the launch-cost probes ------------------------
@pytest.mark.parametrize("state", ["tool", "normal", "ties", "big"])
def test_select_update_bitwise_eager_c_loop_and_graph(cuda, state):
    """254 select_updates from one seeded state: through the wrapper,
    from C and as a replayed CUDA graph, each bitwise 254 plain calls."""
    from chip_smoke import probe_states
    from lightgbm_tpu_torch.ops import probes
    from lightgbm_tpu_torch.tools import profile_pallas_ov as ov
    before = probes.select_update.launches
    rec = ov.check(torch.from_numpy(probe_states()[state]).to(cuda))
    assert rec["eager"] and rec["c_loop"] and rec["graph"], rec
    # eager and C loop launch N each, the graph counts at its capture
    assert probes.select_update.launches == before + 3 * ov.N


@pytest.mark.parametrize("var", ["empty", "smemrw", "dma_nw", "dma_bs",
                                 "waits"])
@pytest.mark.parametrize("blocks", [1, 37, 2048])
def test_step_cost_and_stream_tiles_exact(cuda, var, blocks):
    from lightgbm_tpu_torch.ops import probes
    from lightgbm_tpu_torch.tools import profile_step_cost as sc
    rows = sc.make_rows(probes.TILE_ROWS * blocks, cuda, seed=blocks)
    got = sc.kernel(var)(rows)
    again = sc.kernel(var)(rows)
    torch.cuda.synchronize()
    assert torch.equal(got, sc.plain(var)(rows))
    assert torch.equal(got.cpu(), sc.plain(var)(rows.cpu()))
    assert torch.equal(got, again)


def test_step_cost_wraps_on_the_card(cuda):
    from lightgbm_tpu_torch.ops import probes
    rows = torch.zeros((probes.TILE_ROWS * 3, probes.TILE_COLS),
                       device=cuda)
    rows[::probes.TILE_ROWS, 0] = 2.0 ** 30
    sel = torch.tensor([2 ** 31 - 2, -7], dtype=torch.int32, device=cuda)
    for got, want in ((probes.stream_tiles(rows), probes.stream_tiles_ref(
            rows)), (probes.step_cost("smemrw", rows, sel),
                     probes.step_cost_ref("smemrw", rows, sel)),
            (probes.step_cost("waits", rows, sel),
             probes.step_cost_ref("waits", rows, sel))):
        assert torch.equal(got, want), (got, want)


def _comb_case(cuda, f: int, fc=None, monkeypatch=None, n: int = 30_000):
    from lightgbm_tpu_torch.ops import hist_kernel2 as hk
    arrays = random_row_matrix(n, f, 13)
    rows, rows_cpu = rows_on(arrays, cuda), rows_on(arrays, "cpu")
    rng = (17, 5, n - 100)
    if fc is not None:
        monkeypatch.setattr(hk, "comb_chunk", lambda f_, b_, s_: fc)
    got = hk.build_histogram_comb(
        rows, torch.tensor(rng, dtype=torch.int32, device=cuda),
        padded_bins=256, max_rows=n)
    want = hk.build_histogram_comb_ref(
        rows_cpu, torch.tensor(rng, dtype=torch.int32), padded_bins=256,
        max_rows=n)
    torch.cuda.synchronize()
    return got.cpu(), want


@pytest.mark.parametrize("f", [79, 80, 136])
def test_hist_comb_wide_bitwise_plain(cuda, f):
    from chip_smoke import torch_equal
    got, want = _comb_case(cuda, f)
    assert torch_equal(got, want)


@pytest.mark.parametrize("f,fc_a,fc_b", [(80, 32, 20), (79, 27, 13),
                                         (136, 17, 8), (28, 14, 8)])
def test_hist_comb_chunks_give_the_same_bits(cuda, monkeypatch, f, fc_a,
                                             fc_b):
    """Two chunk widths against each other and the plain version (a
    feature-mode block stages at most 32 features)."""
    from chip_smoke import torch_equal
    a, _ = _comb_case(cuda, f, fc_a, monkeypatch)
    b, want = _comb_case(cuda, f, fc_b, monkeypatch)
    assert torch_equal(a, b) and torch_equal(a, want)


def test_hist_comb_p2_chunked_bitwise_pack1(cuda, monkeypatch):
    """The record instantiation over feature chunks (every pack=2 layout
    above 19 features, F = 28 included): the pack=1 kernel's bits."""
    from chip_smoke import torch_equal
    from lightgbm_tpu_torch.ops import hist_kernel2 as hk
    from lightgbm_tpu_torch.ops.device_data import pack_rows
    f, n = 40, 20_000
    rows = rows_on(random_row_matrix(n, f, 21), cuda)
    packed = pack_rows(rows)
    rng = torch.tensor([0, 3, n - 3], dtype=torch.int32, device=cuda)
    one = hk.build_histogram_comb(rows, rng, padded_bins=256, max_rows=n)
    monkeypatch.setattr(hk, "comb_chunk", lambda f_, b_, s_: 13)
    chunked = hk.build_histogram_comb_p2(packed, rng, padded_bins=256,
                                         max_rows=n)
    torch.cuda.synchronize()
    assert torch_equal(one, chunked)


# -- slice 14: hist_comb in range mode and feature mode ------------------
def _comb_modes_case(cuda, f, n, rng, max_rows, *, b=256, n_bins=255,
                     one_bin=None, seed=31):
    """hist_comb and hist_comb_p2 on the same seeded rows, each bitwise
    the plain version run on CPU copies; returns the geometry."""
    from chip_smoke import torch_equal
    from lightgbm_tpu_torch.ops import hist_kernel2 as hk
    from lightgbm_tpu_torch.ops.device_data import pack_rows
    arrays = list(random_row_matrix(n, f, seed, n_bins=n_bins))
    if one_bin is not None:
        arrays[0][:] = one_bin
    rows, rows_cpu = rows_on(arrays, cuda), rows_on(arrays, "cpu")
    packed = pack_rows(rows)
    t = torch.tensor(rng, dtype=torch.int32, device=cuda)
    want = hk.build_histogram_comb_ref(rows_cpu, t.cpu(), padded_bins=b,
                                       max_rows=max_rows)
    one = hk.build_histogram_comb(rows, t, padded_bins=b, max_rows=max_rows)
    two = hk.build_histogram_comb_p2(packed, t, padded_bins=b,
                                     max_rows=max_rows)
    torch.cuda.synchronize()
    assert torch_equal(one.cpu(), want)
    assert torch_equal(two.cpu(), want)
    return hk.comb_geometry(f, b, max_rows)


@pytest.mark.parametrize("f", [28, 27, 136])
@pytest.mark.parametrize("slices", range(1, 10))
def test_hist_comb_modes_bitwise_plain(cuda, f, slices):
    """Every slice count from 1 to past the range-mode limit, from an
    odd start: range mode up to ``COMB_RANGE_SLICES``, feature mode
    above, both bitwise the plain version, both packs."""
    from lightgbm_tpu_torch.ops.hist_kernel2 import (COMB_RANGE_SLICES,
                                                     ROWS_PER_BLOCK)
    max_rows = slices * ROWS_PER_BLOCK
    geo = _comb_modes_case(cuda, f, max_rows + 100, (17, 3, max_rows - 20),
                           max_rows)
    assert geo.ranged == (slices <= COMB_RANGE_SLICES)


@pytest.mark.parametrize("rng,max_rows", [
    ((0, 0, 0), 5000), ((70, 0, -3), 5000), ((9990, 0, 500), 6000),
    ((-30, 5, 200), 200), ((1, 0, 33), 28_672), ((3, 1, 9990), 9999),
    ((5, 0, 9995), 40_000)])
def test_hist_comb_adversarial_ranges(cuda, rng, max_rows):
    """Empty and negative counts, ranges past either end of the matrix,
    33 rows cut into seven 32-row slices, and a range of nearly every
    row, in either mode."""
    _comb_modes_case(cuda, 28, 10_000, rng, max_rows)


@pytest.mark.parametrize("b,n_bins", [(256, 255), (64, 64), (1024, 255)])
@pytest.mark.parametrize("max_rows", [3000, 28_672, 40_000])
def test_hist_comb_ties_of_one_bin(cuda, b, n_bins, max_rows):
    """Every row in one bin: one cell a feature sums every row of each
    slice in order (one warp lists every row, the others none)."""
    _comb_modes_case(cuda, 28, max_rows + 10, (5, 0, max_rows), max_rows,
                     b=b, n_bins=n_bins, one_bin=n_bins // 2)


def test_hist_comb_modes_agree(cuda, monkeypatch):
    """The same call in range mode and in feature mode (the limit moved
    either way) gives the same bits, at 2 and at 9 slices."""
    from chip_smoke import torch_equal
    from lightgbm_tpu_torch.ops import hist_kernel2 as hk
    n = 40_000
    rows = rows_on(random_row_matrix(n, 28, 8), cuda)
    for max_rows in (6000, 9 * hk.ROWS_PER_BLOCK):
        rng = torch.tensor([11, 0, max_rows - 7], dtype=torch.int32,
                           device=cuda)
        got = {}
        for limit in (0, 16):
            monkeypatch.setattr(hk, "COMB_RANGE_SLICES", limit)
            got[limit] = hk.build_histogram_comb(rows, rng, padded_bins=256,
                                                 max_rows=max_rows)
        assert hk.comb_geometry(28, 256, max_rows).ranged
        torch.cuda.synchronize()
        assert torch_equal(got[0], got[16])


def test_hist_comb_in_a_graph(cuda):
    """hist_comb captured in a CUDA graph (range mode and feature mode)
    and replayed on new values: bitwise the eager call on them."""
    from lightgbm_tpu_torch.ops.hist_kernel2 import build_histogram_comb
    from lightgbm_tpu_torch.tools.profile_lib import capture
    n = 80_000
    rows = rows_on(random_row_matrix(n, 28, 14), cuda)
    g = np.random.default_rng(14)
    for count in (3000, 70_000):
        rng = torch.tensor([7, 1, count], dtype=torch.int32, device=cuda)
        held = {}

        def call():
            held["out"] = build_histogram_comb(rows, rng, padded_bins=256,
                                               max_rows=count)
        graph = capture(call)
        rows.vals.copy_(torch.tensor(
            g.normal(size=(n, 3)).astype(np.float32)))
        graph.replay()
        want = build_histogram_comb(rows, rng, padded_bins=256,
                                    max_rows=count)
        torch.cuda.synchronize()
        assert torch.equal(held["out"], want)


def test_hist_comb_library_refuses_a_short_geometry(cuda):
    """The library launches the geometry the wrapper passes and refuses
    one that misses a cell or that its kernels cannot stage."""
    from lightgbm_tpu_torch.ops import hist_kernel2 as hk
    n, f, b = 1000, 28, 256
    rows = rows_on(random_row_matrix(n, f, 3), cuda)
    rng = torch.tensor([0, 0, n], dtype=torch.int32, device=cuda)
    out = torch.empty((f, b, 2), dtype=torch.float32, device=cuda)
    partials = torch.empty((9, f, b, 2), dtype=torch.float32, device=cuda)
    rng_g, feat_g = hk.comb_geometry(f, b, 2000), hk.comb_geometry(
        f, b, 9 * hk.ROWS_PER_BLOCK)

    def launch(geo, part_ptr):
        return hk._lib().hist_comb(
            rows.bins.data_ptr(), rows.vals.data_ptr(), rng.data_ptr(),
            part_ptr, out.data_ptr(), n, f, b, geo.slices, int(geo.ranged),
            geo.grid[0], geo.grid[1], geo.feats, geo.bin_parts,
            torch.cuda.current_stream().cuda_stream)
    assert launch(rng_g, None) == 0
    assert launch(feat_g, partials.data_ptr()) == 0
    for bad in (rng_g._replace(grid=(rng_g.grid[0] - 1, 1)),
                rng_g._replace(bin_parts=rng_g.bin_parts - 1),
                rng_g._replace(feats=9),
                feat_g._replace(grid=(8, feat_g.grid[1])),
                feat_g._replace(feats=33, grid=(9, 1)),
                feat_g._replace(grid=(9, 1))):
        assert launch(bad, partials.data_ptr()) != 0, bad
    assert launch(feat_g, None) != 0
    torch.cuda.synchronize()


def test_wide_training_on_card_matches_cpu(cuda):
    """3,000 x 136, 15 leaves, 3 trees on the route the rules give (the
    unfused stream route with the cluster kernel tail): bit-identical to the
    CPU run."""
    x = make_rows(3000, 136, 5)
    _, y = make_higgs_like(3000, 136, 5)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
    a = lgt.train(p, lgt.Dataset(x, label=y), num_boost_round=3,
                  device="cuda")
    b = lgt.train(p, lgt.Dataset(x, label=y), num_boost_round=3,
                  device="cpu")
    assert a._inner.grow.route.describe() == (
        "path=stream fused=0 tail=kernel (fused_smem)")
    res = compare_trees(a._models, b._models)
    assert res["ok"], res
    assert leaves_bitwise(a._models, b._models)


# -- slice 10: the partition-bisection probes -----------------------------------
LEGACY_N = 1 << 14


def _legacy_cases():
    from lightgbm_tpu_torch.tools import profile_legacy as tl
    return sorted(tl.CASES)


@pytest.mark.parametrize("scenario,var", _legacy_cases())
def test_legacy_kernels_bitwise_plain(cuda, scenario, var):
    """Every case of the tool at 2^14 rows, on the script's descriptor
    and on an odd s0 and cnt, bitwise its plain version on the card and
    on CPU copies."""
    from lightgbm_tpu_torch.tools import profile_legacy as tl
    n = LEGACY_N
    n_alloc = tl.n_alloc_of(scenario, var, n)
    kernel, arg = tl.CASES[(scenario, var)]
    odd = [37, n - 1001] + tl.script_sel(n)[2:]
    for sel in (tl.script_sel(n), odd):
        if sel is odd and n_alloc == n:
            sel = [0, n - 1001, 3, 100, 1, 0, -1, 0]
        rows = tl.make_rows(n_alloc, cuda, seed=3)
        inp = tl.Inputs(rows, sel, n, scratch_fill=-1.0)
        assert tl.check(kernel, arg, inp)["ok"]
        got = tl.apply(kernel, arg, inp)
        cpu = tl.Inputs(rows.cpu(), sel, n, scratch_fill=-1.0)
        want = tl.apply(kernel, arg, cpu, plain=True)
        torch.cuda.synchronize()
        for key in ("rows", "scratch"):
            if not (kernel == "compact" and arg == "noalias"
                    and key == "scratch"):
                assert torch.equal(got[key].cpu(), want[key]), key


@pytest.mark.parametrize("kind", ["late", "early", "one_per_block", "whole",
                                  "whole_plus1", "whole_minus1"])
@pytest.mark.parametrize("kernel,arg", [
    ("compact", "nosmem"), ("compact", "grid2"), ("compact", "dynoff"),
    ("compact", "pred"), ("compact", "hbmsel"), ("compact", "nsplit"),
    ("compact", "noalias"), ("partition_dense", 1),
    ("partition_dense", 3)])
def test_legacy_adversarial_in_place(cuda, kind, kernel, arg):
    """Adversarial inputs at 2^19 rows (4,096 tiles racing): a first
    block keeping nothing and the rest everything, the reverse, one kept
    row a block, T = 512 k and 512 k +- 1, bitwise the plain version."""
    from lightgbm_tpu_torch.tools import profile_legacy as tl
    n = 1 << 19
    rows = tl.adversarial_rows(kind, n, n + 2 * tl.R, cuda)
    for sel in (tl.script_sel(n), [37, n - 1001] + tl.script_sel(n)[2:]):
        inp = tl.Inputs(rows, sel, n, scratch_fill=-1.0)
        assert tl.check(kernel, arg, inp)["ok"], (kind, sel[:2])


@pytest.mark.parametrize("src,dst", [(100, 612), (612, 100), (3, 1026),
                                     (64512, 64000), (12345, 54321),
                                     (0, 0)])
def test_hbm_alias_step_overlaps(cuda, src, dst):
    from lightgbm_tpu_torch.tools import profile_legacy as tl
    assert tl.alias_check([(src, dst)], cuda)


def test_hbm_alias_chain_and_graph(cuda):
    """The while-loop's 8 chained steps eagerly and as a replayed CUDA
    graph, bitwise the numpy recurrence; the graph counts its launches at
    capture."""
    from lightgbm_tpu_torch.ops import legacy_probes as lp
    from lightgbm_tpu_torch.tools import profile_legacy as tl
    from lightgbm_tpu_torch.tools import profile_lib
    assert tl.alias_check(tl.CHAIN, cuda)
    x = tl.alias_matrix()
    comb = torch.tensor(x, device=cuda)
    before = lp.hbm_alias_step.launches
    graph = profile_lib.capture(
        lambda: [lp.hbm_alias_step(comb, s, d) for s, d in tl.CHAIN],
        warmup=0)
    assert lp.hbm_alias_step.launches == before + len(tl.CHAIN)
    comb.copy_(torch.from_numpy(x))
    graph.replay()
    torch.cuda.synchronize()
    want = tl.alias_steps_numpy(x, tl.CHAIN)
    assert torch.equal(comb.cpu(), torch.from_numpy(want))
    assert lp.hbm_alias_step.launches == before + len(tl.CHAIN)


@pytest.mark.parametrize("mech", ["nosmem", "nsplit", "prefetch"])
def test_compact_in_a_graph(cuda, mech):
    """A captured compaction replays bitwise the eager one."""
    from lightgbm_tpu_torch.ops import legacy_probes as lp
    from lightgbm_tpu_torch.tools import profile_legacy as tl
    from lightgbm_tpu_torch.tools import profile_lib
    n = LEGACY_N
    inp = tl.Inputs(tl.make_rows(n + 1024, cuda, seed=5), tl.script_sel(n),
                    n)
    eager = tl.apply("compact", mech, inp)
    eager = {k: v.clone() for k, v in eager.items()
             if isinstance(v, torch.Tensor)}
    inp.reset()
    out = {}
    graph = profile_lib.capture(
        lambda: out.update(tl.apply("compact", mech, inp)), warmup=0)
    inp.reset()
    graph.replay()
    torch.cuda.synchronize()
    for k, v in eager.items():
        assert torch.equal(out[k], v), k
    assert lp.compact.launches > 0


# -- slice 16: the packed traversal, its raw entry, the refresh designs ------
def _packed_model(device, *, trees=12, leaves=31, k=1, cat=True,
                  n_features=8, seed=60):
    cats = (1, 4) if cat else ()
    text = random_model_text(n_trees=trees * k, num_leaves=leaves,
                             n_features=n_features, seed=seed,
                             cat_features=cats, num_class=k)
    return lgt.Booster(model_str=text,
                       device=device).serving_engine().model, cats


def _raw_vs_plain(sm, x, n_real, *, wide=None):
    """Both entries, both forms, against their plain versions on the same
    card tensors; the raw entry's bins bitwise quantize_rows_kernel's."""
    f = sm.forest
    dev = f.device
    pf = tkern.pack_forest(f, sm.n_steps, wide=wide)
    raw = torch.from_numpy(x).to(dev)
    n, nf = x.shape[0], int(f.used_cols.shape[0])
    k = sm.num_class
    bins = tpred.quantize_rows_kernel(f, raw[:, f.used_cols.long()])
    for leaves in (True, False):
        shape = (n, sm.n_trees if leaves else k)
        dt = torch.int32 if leaves else torch.float32
        want = torch.empty(shape, dtype=dt, device=dev)
        tkern.serve_traverse_raw_ref(pf, raw, n_real, want, leaves=leaves)
        got_raw = torch.full(shape, 7, dtype=dt, device=dev)
        got_bins = torch.full(shape, 7, dtype=dt, device=dev)
        bins_o = torch.full((n, nf), -9, dtype=torch.int32, device=dev)
        before = tkern.serve_traverse.launches
        tkern.serve_traverse_raw(pf, raw, n_real, got_raw, leaves=leaves,
                                 bins_out=bins_o)
        tkern.serve_traverse(tkern.forest_kernel_args(f, leaves=leaves),
                             bins.contiguous(), n_real, got_bins,
                             n_steps=sm.n_steps, leaves=leaves, packed=pf)
        assert tkern.serve_traverse.launches == before + 2
        torch.cuda.synchronize()
        assert torch.equal(bins_o, bins)
        # the order of additions is the plain version's: bitwise
        assert torch.equal(got_raw, want), leaves
        assert torch.equal(got_bins, want), leaves
    return pf


@pytest.mark.parametrize("cat,k,bf16", [(False, 1, False), (True, 1, True),
                                        (True, 3, False)])
@pytest.mark.parametrize("wide", [None, True])
def test_serve_packed_entries_match_plain(cuda, cat, k, bf16, wide):
    sm, cats = _packed_model(cuda, trees=40, k=k, cat=cat)
    if bf16:
        sm.forest.leaf_value = sm.forest.leaf_value.to(torch.bfloat16)
    x = make_rows(700, 8, 41, cats)
    x[:5] = np.nan
    for n, n_real in ((700, 691), (64, 64), (1, 1), (3, 0)):
        pf = _raw_vs_plain(sm, x[:n], n_real, wide=wide)
    assert pf.n_tiles > 1


@pytest.mark.parametrize("cat", [False, True])
def test_serve_raw_entry_bins_on_adversarial_rows(cuda, cat):
    from chip_smoke import adversarial_rows
    sm, _ = _packed_model(cuda, trees=30, leaves=63, cat=cat)
    x = adversarial_rows(sm.forest, 8, seed=2)
    _raw_vs_plain(sm, x, x.shape[0] - 3)


def test_serve_forest_larger_than_shared_memory(cuda):
    """2,000 trees x 255 leaves (10 MB packed, 223 tiles) and one tree of
    4,000 leaves (a tile past the staged region, walked from global
    memory)."""
    sm, _ = _packed_model(cuda, trees=2000, leaves=255, cat=False, seed=61)
    x = make_rows(300, 8, 61)
    pf = _raw_vs_plain(sm, x, 290)
    assert pf.blob.numel() * 4 > 227 * 1024 and pf.n_tiles == 223
    big, _ = _packed_model(cuda, trees=1, leaves=4000, cat=True, seed=62)
    pf = _raw_vs_plain(big, make_rows(300, 8, 62, (1, 4)), 300)
    assert pf.stage_units == 0


def test_serve_rows_too_wide_to_stage(cuda):
    """20,000 features: the rows are read from global memory and the
    quantizer tables are not staged."""
    sm, _ = _packed_model(cuda, trees=6, leaves=31, cat=False,
                          n_features=20_000, seed=63)
    x = np.random.default_rng(63).normal(size=(200, 20_000)).astype(
        np.float32)
    geo = tkern.serve_geometry(sm.packed(), 200, 20_000, raw=True,
                               leaves=False)
    assert geo.row_stride == 0 and not geo.quant_staged
    _raw_vs_plain(sm, x, 200)


def test_serve_queue_equals_bulk_and_graph_replay(cuda):
    sm, cats = _packed_model(cuda, trees=40, k=3)
    x = make_rows(4096, 8, 64, cats)
    eng = lgt.ServingEngine(sm, bucket_min=64, bucket_max=4096,
                            device=cuda)
    bulk = eng.predict(x)
    q = lgt.ServingQueue(eng)
    for i in range(0, 4096, 64):
        q.submit(x[i:i + 64])
    np.testing.assert_array_equal(np.concatenate(q.drain(), axis=0), bulk)
    pf = sm.packed()
    raw = torch.from_numpy(x[:64]).to(cuda)
    out = torch.empty((64, 3), device=cuda)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        tkern.serve_traverse_raw(pf, raw, 64, out)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        tkern.serve_traverse_raw(pf, raw, 64, out)
    out.zero_()
    g.replay()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(out.cpu().numpy(), bulk[:64])


@pytest.mark.parametrize("kind,sigmoid", [("binary", 1.0), ("binary", 0.7),
                                          ("l2", 1.0)])
def test_refresh_both_packs_match_plain_at_28_features(cuda, kind, sigmoid):
    """The root-histogram refresh (the plain refresh's kernel, then
    hist_comb's root in its feature chunks) at the main path's 28
    features, both packs: rows bitwise the plain version's, the
    histogram bitwise hist_comb's over the refreshed rows, one counted
    call."""
    from chip_smoke import pack2_stream_case
    from lightgbm_tpu_torch.ops.stream_grad import (stream_refresh,
                                                    stream_refresh_p2)
    rows = rows_on(random_row_matrix(20_011, 28, 17), cuda)
    before = (stream_refresh.launches, stream_refresh_p2.launches)
    stream_parity(rows.bins, kind, 256, "test", sigmoid=sigmoid)
    pack2_stream_case(rows.bins, kind, 256, "test")
    assert (stream_refresh.launches, stream_refresh_p2.launches) == (
        before[0] + 2, before[1] + 1)


# -- slice 17: the membership-word modes ----------------------------------------
# (kind, features): the fused split serves up to 71 features at B = 256
CAT_SHAPES = [(k, f) for k in ("scan", "3ph", "scan_p2") for f in
              (28, 36, 136)] + [(k, f) for k in ("fused", "fused_p2")
                                for f in (28, 36)]
CAT_ROWS_CARD = 60_000


def _cat_check(kind, rows, packed, sel, label):
    from chip_smoke import (fused_parity, pack2_scan_case, pack2_split_case,
                            partition_3ph_parity, partition_parity)
    if kind == "scan":
        return partition_parity(rows, sel, label)
    if kind == "3ph":
        return partition_3ph_parity(rows, sel, label)
    if kind == "scan_p2":
        return pack2_scan_case(rows, packed, sel, label)
    if kind == "fused":
        return fused_parity(rows, sel, 256, label)
    return pack2_split_case(rows, packed, sel, 256, label)


@pytest.mark.parametrize("kind,f", CAT_SHAPES)
def test_cat_word_modes_bitwise(cuda, kind, f):
    """Each word mode bitwise its plain version on the adversarial
    descriptors (every word zero, every bit set, bit 31 of every word, a
    single bit, bins of the last word only, mixed words; numerical
    splits with zero words and with the NaN bin, and one ignoring set
    words) at 28, 36 and 136 features, each call one launch."""
    from chip_smoke import cat_rows, cat_word_cases
    from lightgbm_tpu_torch.ops import fused_split as fs
    from lightgbm_tpu_torch.ops import partition_kernel as pk
    from lightgbm_tpu_torch.ops.device_data import pack_rows
    rows = cat_rows(CAT_ROWS_CARD, f, f, cuda)
    packed = pack_rows(rows)
    fn = {"scan": pk.partition_scan, "3ph": pk.partition_3ph,
          "scan_p2": pk.partition_scan_p2, "fused": fs.fused_split,
          "fused_p2": fs.fused_split_p2}[kind]
    tile = pk.scan_geometry(CAT_ROWS_CARD, f).tile
    for label, sel in cat_word_cases(tile, f - 1, 254):
        before = fn.launches
        _cat_check(kind, rows, packed, sel, label)
        assert fn.launches - before == 1


@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("tile", [32, 256, 1024])
@pytest.mark.parametrize("kind", ["scan", "3ph", "scan_p2"])
def test_cat_scan_staged_and_unstaged(cuda, kind, tile, staged):
    """The scan's word mode on staged and unstaged tiles, bitwise the
    plain version."""
    from lightgbm_tpu_torch.ops import partition_kernel as pk
    sel = (1_001, 9_999, 5, 0, 0, 1, -1, 0, 0x0F0F0F0F, -1, 0, 1 << 31,
           0x00010001, 0x7FFFFFFF, 0, -0x7FFF0000)
    rows, scratch, (want, nl_want), sel = _scan_case(kind, 28, cuda, sel)
    stride = rows.layout.stride if kind == "scan_p2" else None
    geo = pk.scan_geometry(sel[1], 28, stride, tile=tile, staged=staged)
    nl = torch.full((1,), -1, dtype=torch.int32, device=cuda)
    pk.launch_scan(rows, scratch, sel, nl, geo,
                   scheme="3ph" if kind == "3ph" else "ss")
    torch.cuda.synchronize()
    assert int(nl) == int(nl_want)
    assert _scan_equal(kind, rows, scratch, sel, want)


@pytest.mark.parametrize("kind", ["scan", "3ph", "scan_p2", "fused",
                                  "fused_p2"])
def test_cat_word_modes_eager_and_in_a_graph(cuda, kind):
    """Each word mode captured in a CUDA graph and replayed three times
    writes the eager call's bytes and nleft every time (the words are
    kernel arguments, copied at the capture)."""
    from chip_smoke import cat_rows, torch_equal
    from lightgbm_tpu_torch.ops import fused_split as fs
    from lightgbm_tpu_torch.ops import partition_kernel as pk
    from lightgbm_tpu_torch.ops.device_data import (empty_packed_like,
                                                    empty_rows_like,
                                                    pack_rows)
    from lightgbm_tpu_torch.tools.profile_lib import capture
    rows = cat_rows(CAT_ROWS_CARD, 36, 3, cuda)
    packed = pack_rows(rows)
    src = packed if kind.endswith("p2") else rows
    scratch = (empty_packed_like(packed) if kind.endswith("p2")
               else empty_rows_like(rows))
    sel = (7, 50_001, 35, 0, 0, 1, -1, 0, 0x55555555, 0, -1, 1 << 31, 0,
           0x12345678, 0, -0x7FFF0000)
    nl = torch.full((1,), -1, dtype=torch.int32, device=cuda)
    held = {}
    fn = {"scan": pk.partition_scan, "3ph": pk.partition_3ph,
          "scan_p2": pk.partition_scan_p2}.get(kind)
    base = (src.buf.clone() if kind.endswith("p2")
            else [a.clone() for a in src])

    def reset():
        if kind.endswith("p2"):
            src.buf.copy_(base)
        else:
            for a, b in zip(src, base):
                a.copy_(b)

    def call():
        if kind == "fused":
            held["h"] = fs.fused_split(src, scratch, sel, nl,
                                       padded_bins=256)
        elif kind == "fused_p2":
            held["h"] = fs.fused_split_p2(src, scratch, sel, nl,
                                          padded_bins=256)
        else:
            fn(src, scratch, sel, nl)

    def state():
        out = src if kind == "3ph" else scratch
        bufs = [out.buf] if kind.endswith("p2") else list(out)
        return [b.clone() for b in bufs] + [nl.clone()] + (
            [held["h"].clone()] if "h" in held else [])
    reset()
    call()
    torch.cuda.synchronize()
    want = state()
    reset()
    graph = capture(call, warmup=1)
    for _ in range(3):
        reset()
        nl.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        got = state()
        assert all(torch_equal(a, b) for a, b in zip(got, want))


def test_cat_library_refuses_more_than_eight_words(cuda):
    """The libraries refuse a word count above 8 with
    cudaErrorInvalidValue (1) before any launch; the wrappers refuse the
    descriptor first."""
    import ctypes

    from lightgbm_tpu_torch.ops import fused_split as fs
    from lightgbm_tpu_torch.ops import partition_kernel as pk
    from lightgbm_tpu_torch.ops.device_data import empty_rows_like
    from lightgbm_tpu_torch.utils.log import LightGBMError
    rows = _edge_rows(28, cuda)
    scratch = empty_rows_like(rows)
    nl = torch.zeros(1, dtype=torch.int32, device=cuda)
    sel = (0, 100, 5, 0, 0, 1, -1, 0) + (1,) * 9
    for fn in (pk.partition_scan, pk.partition_3ph):
        with pytest.raises(LightGBMError, match="membership words"):
            fn(rows, scratch, sel, nl)
    with pytest.raises(LightGBMError, match="membership words"):
        fs.fused_split(rows, scratch, sel, nl, padded_bins=256)
    state = torch.zeros(2, dtype=torch.int64, device=cuda)
    words = (ctypes.c_uint32 * 9)(*([1] * 9))
    rc = pk._lib().partition_scan(
        *pk.row_pointers(rows), *pk.row_pointers(scratch), state.data_ptr(),
        nl.data_ptr(), 28, 0, 100, 5, 0, 0, 1, -1, 9, words, 256, 1,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 1


@pytest.mark.parametrize("env", [{}, {"LGBM_TPU_COMB_PACK": "2"},
                                 {"LGBM_TPU_FUSED": "0"},
                                 {"LGBM_TPU_PART": "3ph"}])
def test_cat_training_on_card_matches_cpu(cuda, env, monkeypatch):
    """Sorted-subset training on the card grows the CPU run's trees bit
    for bit, with splits of more than one category."""
    from chip_smoke import make_categorical_like, multi_category_splits
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    x, y, cats = make_categorical_like(20_000, 200, 3, n_features=6, seed=4)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 255,
              "min_data_per_group": 5, "verbosity": -1}
    bsts = [lgt.train(params, lgt.Dataset(x, label=y,
                                          categorical_feature=cats,
                                          params={"min_data_in_bin": 1}),
                      num_boost_round=3, device=d) for d in ("cuda", "cpu")]
    assert bsts[0]._inner.route.tail == "xla"
    res = compare_trees(bsts[0]._models, bsts[1]._models)
    assert res["ok"], res
    assert leaves_bitwise(bsts[0]._models, bsts[1]._models)
    assert multi_category_splits(bsts[0]._models) > 0


# -- slice 18: the constrained mode of the split tail ---------------------
@pytest.mark.parametrize("f,b", [(28, 256), (28, 1024), (136, 256)])
@pytest.mark.parametrize("penalty", [0.0, 2.0])
def test_apply_find_mono_matches_plain(cuda, f, b, penalty):
    """The constrained instantiation of both entries bitwise its plain
    version (on the card and on CPU copies), done untouched, at the
    routes' shapes, without and with the depth penalty; each call one
    launch of its entry."""
    from lightgbm_tpu_torch.ops.apply_find import apply_find, apply_find_pool
    from lightgbm_tpu_torch.tools.profile_apply_find import synthetic_split
    case = synthetic_split(f, b, cnt=200_000, seed=f + b, mono=True,
                           penalty=penalty, device="cuda")
    before = (apply_find_pool.launches, apply_find.launches)
    tail_parity(case, f"{f}x{b}_mono_penalty_{penalty}")
    assert (apply_find_pool.launches, apply_find.launches) == (
        before[0] + 2, before[1] + 1)


@pytest.mark.parametrize("f", [28, 136])
def test_apply_find_mono_adversarial_cases(cuda, f):
    """The constrained tail's adversarial cases (a winner the violation
    mask removes, bounds that clip every candidate, equal keys across
    the last two blocks with one constrained, the penalty's floor, the
    done guard) bitwise the plain version."""
    from chip_smoke import mono_tail_edge_cases
    assert len(mono_tail_edge_cases(f)) == 4


def test_apply_find_mono_in_a_graph(cuda):
    """The constrained pool entry captured in a CUDA graph and replayed
    once leaves the eager launch's state."""
    from lightgbm_tpu_torch.ops.apply_find import apply_find_pool
    from lightgbm_tpu_torch.tools.profile_apply_find import synthetic_split
    from lightgbm_tpu_torch.tools.profile_lib import capture
    case = synthetic_split(28, 256, cnt=200_000, mono=True, device="cuda")
    eager, graphed = case.clone(), case.clone()
    apply_find_pool(eager.h_a, eager.h_b, *eager.args())
    g = capture(lambda: apply_find_pool(graphed.h_a, graphed.h_b,
                                        *graphed.args()), warmup=0)
    g.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(eager.st, graphed.st))


@pytest.mark.parametrize("env,extra", [
    ({}, {}), ({"LGBM_TPU_COMB_PACK": "2"}, {}),
    ({"LGBM_TPU_FUSED": "0"}, {}), ({"LGBM_TPU_PART": "3ph"}, {}),
    ({"LGBM_TPU_POOL_TAIL": "0"}, {}), ({}, {"max_bin": 1023}),
    ({}, {"monotone_penalty": 2.0}),
    ({}, {"monotone_constraints_method": "intermediate"})])
def test_monotone_training_on_card_matches_cpu(cuda, env, extra,
                                               monkeypatch):
    """Monotone training on the card grows the CPU run's trees bit for
    bit on every route, through the constrained tail on the kernel
    routes (launched once a split)."""
    from lightgbm_tpu_torch.ops.apply_find import apply_find, apply_find_pool
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    x, y = make_higgs_like(8000, 10, seed=6)
    params = dict({"objective": "binary", "num_leaves": 31, "verbosity": -1,
                   "monotone_constraints": [1, 1, -1, -1, 1, 0, 0, -1]},
                  **extra)
    ds_params = {"max_bin": extra.get("max_bin", 255), "min_data_in_bin": 1}
    before = apply_find_pool.launches + apply_find.launches
    bsts = [lgt.train(params, lgt.Dataset(x, label=y, params=ds_params),
                      num_boost_round=3, device=d) for d in ("cuda", "cpu")]
    route = bsts[0]._inner.route
    splits = sum(t.num_leaves - 1 for t in bsts[0]._models)
    launched = apply_find_pool.launches + apply_find.launches - before
    assert launched == (0 if route.tail == "xla" else splits)
    assert (route.tail == "xla") == ("monotone_constraints_method" in extra)
    res = compare_trees(bsts[0]._models, bsts[1]._models)
    assert res["ok"], res
    assert leaves_bitwise(bsts[0]._models, bsts[1]._models)


# -- slice 19: multiclass and the regression and cross-entropy objectives --
SLICE19 = {
    "multiclass": {"objective": "multiclass", "num_class": 5},
    "multiclassova": {"objective": "multiclassova", "num_class": 3},
    "regression_l1": {"objective": "regression_l1"},
    "huber": {"objective": "huber"}, "fair": {"objective": "fair"},
    "poisson": {"objective": "poisson"},
    "quantile": {"objective": "quantile", "alpha": 0.9},
    "mape": {"objective": "mape"}, "gamma": {"objective": "gamma"},
    "tweedie": {"objective": "tweedie"},
    "cross_entropy": {"objective": "cross_entropy"},
    "cross_entropy_lambda": {"objective": "cross_entropy_lambda"},
}


@pytest.mark.parametrize("env", [{}, {"LGBM_TPU_COMB_PACK": "2"},
                                  {"LGBM_TPU_PHYS": "0"}])
@pytest.mark.parametrize("name", list(SLICE19))
def test_objective_training_on_card_matches_cpu(cuda, name, env,
                                                monkeypatch):
    """Multiclass (K trees an iteration) and every regression and
    cross-entropy objective grow the CPU run's trees bit for bit on the
    card, on the kernel-tail physical route (both packs) and the
    row-order route, the percentile objectives' leaves renewed on the
    card; the training kernels launch as ``expected_launches`` counts."""
    from chip_smoke import counted_training_kernels, objective_label
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    x = make_rows(6000, 12, 9)
    y = objective_label(name, x, 4)
    params = dict({"num_leaves": 31, "verbosity": -1}, **SLICE19[name])
    if name == "cross_entropy_lambda":
        # the weighted lambda link
        w = np.random.default_rng(4).uniform(0.2, 2.0, len(y))
    else:
        w = None
    counted = counted_training_kernels()
    before = {fn.__name__: fn.launches for fn in counted}
    bsts = [lgt.train(params, lgt.Dataset(x, label=y, weight=w),
                      num_boost_round=2, device=d) for d in ("cuda", "cpu")]
    launched = {fn.__name__: fn.launches - before[fn.__name__]
                for fn in counted}
    bt = bsts[0]
    k = bt._inner.num_tree_per_iteration
    assert len(bt._models) == 2 * k
    assert all(t.num_leaves > 1 for t in bt._models)
    route = bt._inner.grow.route
    assert not route.stream and route.tail == "kernel"
    splits = sum(t.num_leaves - 1 for t in bt._models)
    for kname, want in expected_launches(route, len(bt._models),
                                         splits).items():
        assert launched[kname] == want, kname
    res = compare_trees(bsts[0]._models, bsts[1]._models)
    assert res["ok"], res
    assert leaves_bitwise(bsts[0]._models, bsts[1]._models)
    assert torch.equal(bt._inner.scores.cpu(), bsts[1]._inner.scores)


@pytest.mark.parametrize("n", [1, 16, 17, 4097, 1_000_003])
def test_blocked_cumsum_and_segment_sums_on_card(cuda, n):
    """The weighted refit's sums in XLA:CPU's order give the CPU's bits
    on the card."""
    from lightgbm_tpu_torch.objective.regression import (blocked_cumsum,
                                                         segment_sums_seq)
    x = torch.from_numpy(np.random.default_rng(n).uniform(
        0.0, 3.0, n).astype(np.float32))
    assert torch.equal(blocked_cumsum(x.to(cuda)).cpu(), blocked_cumsum(x))
    cnt = torch.tensor([0, min(n, 5), max(n - 5, 0)])
    start = torch.cumsum(cnt, 0) - cnt
    assert torch.equal(
        segment_sums_seq(x.to(cuda), start.to(cuda), cnt.to(cuda)).cpu(),
        segment_sums_seq(x, start, cnt))


def test_renew_leaf_values_on_card(cuda):
    """The percentile refit on the card equals its CPU run, both schemes,
    with ties, an empty leaf and zero weights."""
    from lightgbm_tpu_torch.objective.regression import renew_leaf_values
    rng = np.random.default_rng(3)
    n, L = 200_000, 255
    lid = torch.from_numpy(rng.integers(0, L - 1, n))
    resid = torch.from_numpy(np.round(rng.normal(size=n), 2).astype(
        np.float32))
    w = torch.from_numpy(rng.uniform(0.0, 2.0, n).astype(np.float32))
    w[::7] = 0.0
    valid = torch.from_numpy(rng.random(n) > 0.05)
    lv0 = torch.from_numpy(rng.normal(size=L).astype(np.float32))
    for alpha in (0.1, 0.5, 0.9):
        for weighted in (False, True):
            args = (resid, w, lid, valid, lv0)
            got = renew_leaf_values(*(a.to(cuda) for a in args), L=L,
                                    alpha=alpha, weighted=weighted)
            want = renew_leaf_values(*args, L=L, alpha=alpha,
                                     weighted=weighted)
            assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("n", [1, 4097, 1_000_000])
def test_threefry_uniform_on_card(cuda, n):
    """The threefry draws (integer operations on int64) give the CPU's
    bits on the card."""
    from lightgbm_tpu_torch.utils.random import prng_key, uniform
    for seed in (0, 1520856339):
        assert torch.equal(uniform(prng_key(seed), n, cuda).cpu(),
                           uniform(prng_key(seed), n, "cpu"))


def test_goss_sample_on_card(cuda):
    """GOSS's sample at 1M rows and K = 3 (sort, threshold, draw,
    amplification) on the card equals its CPU run bit for bit."""
    import types

    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.models.goss import GOSS
    n = 1_000_000
    rng = np.random.default_rng(8)
    g = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
    h = torch.from_numpy(rng.uniform(0.05, 0.3, (3, n)).astype(np.float32))
    g[:, ::5] = g[:, :1]
    cfg = Config.from_params({"boosting": "goss", "learning_rate": 0.5})
    outs = [GOSS._sample(types.SimpleNamespace(
        config=cfg, _valid_rows=torch.ones(n, device=d)),
        g.to(d), h.to(d), 2) for d in (cuda, torch.device("cpu"))]
    for a, b in zip(*outs):
        assert torch.equal(a.cpu(), b)


SLICE20 = {
    "bagging": {"bagging_fraction": 0.8, "bagging_freq": 2},
    "pos_neg_bagging": {"pos_bagging_fraction": 0.5,
                        "neg_bagging_fraction": 0.8, "bagging_freq": 1},
    "goss": {"boosting": "goss", "learning_rate": 0.5},
    "rf": {"boosting": "rf", "bagging_fraction": 0.7, "bagging_freq": 1},
}


@pytest.mark.parametrize("env", [{}, {"LGBM_TPU_COMB_PACK": "2"},
                                  {"LGBM_TPU_FUSED": "0"},
                                  {"LGBM_TPU_PHYS": "0"}])
@pytest.mark.parametrize("name", list(SLICE20))
def test_sampling_training_on_card_matches_cpu(cuda, name, env,
                                               monkeypatch):
    """Bagging, GOSS and RF grow the CPU run's trees bit for bit on the
    card on the kernel-tail physical routes and the row-order route, the
    training kernels launching as ``expected_launches`` counts."""
    from chip_smoke import counted_training_kernels
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    x = make_rows(6000, 12, 10)
    _, y = make_higgs_like(6000, 12, 10)
    params = dict({"objective": "binary", "num_leaves": 31,
                   "verbosity": -1}, **SLICE20[name])
    counted = counted_training_kernels()
    before = {fn.__name__: fn.launches for fn in counted}
    bsts = [lgt.train(params, lgt.Dataset(x, label=y), num_boost_round=3,
                      device=d) for d in ("cuda", "cpu")]
    launched = {fn.__name__: fn.launches - before[fn.__name__]
                for fn in counted}
    bt = bsts[0]
    assert len(bt._models) == 3
    assert all(t.num_leaves > 1 for t in bt._models)
    route = bt._inner.grow.route
    assert not route.stream and route.tail == "kernel"
    splits = sum(t.num_leaves - 1 for t in bt._models)
    for kname, want in expected_launches(route, len(bt._models),
                                         splits).items():
        assert launched[kname] == want, kname
    res = compare_trees(bsts[0]._models, bsts[1]._models)
    assert res["ok"], res
    assert leaves_bitwise(bsts[0]._models, bsts[1]._models)
    assert torch.equal(bt._inner.scores.cpu(), bsts[1]._inner.scores)


def _ranking_case(n: int, f: int, seed: int):
    from chip_smoke import rank_groups, rank_labels
    x = make_rows(n, f, seed)
    return x, rank_labels(x, seed + 1), rank_groups(n, seed + 2)


@pytest.mark.parametrize("norm", [True, False])
def test_lambdarank_gradients_on_card(cuda, norm):
    """The lambdarank gradients at 200,000 rows (about 1,600 queries of
    20-236 documents, several batches) on the card equal the CPU run's
    bit for bit, at tied (zero) and at seeded scores."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset_core import Metadata
    from lightgbm_tpu_torch.objective import create_objective
    from lightgbm_tpu_torch.objective.rank import PAIR_BUDGET
    n = 200_000
    _, y, group = _ranking_case(n, 4, 31)
    md = Metadata()
    md.num_data = n
    md.set_label(y)
    md.set_group(group)
    objs = []
    for d in (cuda, torch.device("cpu")):
        o = create_objective(Config.from_params(
            {"objective": "lambdarank", "lambdarank_norm": norm}))
        o.init(md, n, d)
        o.plan(PAIR_BUDGET // 8)
        objs.append(o)
    assert len(objs[0].batches) > 2
    rng = np.random.default_rng(32)
    for score in (np.zeros(n, np.float32),
                  rng.normal(size=n).astype(np.float32)):
        s = torch.from_numpy(score)
        got = objs[0].get_gradients(s.to(cuda))
        want = objs[1].get_gradients(s)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("env", [{}, {"LGBM_TPU_COMB_PACK": "2"},
                                  {"LGBM_TPU_FUSED": "0"},
                                  {"LGBM_TPU_PHYS": "0"}])
def test_dart_lambdarank_on_card_matches_cpu(cuda, env, monkeypatch):
    """3 iterations of lambdarank DART (drop sets [], [], [1]) grow the CPU
    run's trees bit for bit on the card, with its training scores, the
    training kernels launching as ``expected_launches`` counts."""
    from chip_smoke import counted_training_kernels
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    x, y, group = _ranking_case(8000, 12, 40)
    params = {"objective": "lambdarank", "boosting": "dart",
              "num_leaves": 31, "drop_rate": 0.5, "skip_drop": 0.0,
              "verbosity": -1}
    counted = counted_training_kernels()
    before = {fn.__name__: fn.launches for fn in counted}
    bsts = [lgt.train(params, lgt.Dataset(x, label=y, group=group),
                      num_boost_round=3, device=d) for d in ("cuda", "cpu")]
    launched = {fn.__name__: fn.launches - before[fn.__name__]
                for fn in counted}
    bt = bsts[0]
    assert bt._inner.drop_index == bsts[1]._inner.drop_index == [1]
    assert all(t.num_leaves > 1 for t in bt._models)
    route = bt._inner.grow.route
    assert not route.stream and route.tail == "kernel"
    splits = sum(t.num_leaves - 1 for t in bt._models)
    for kname, want in expected_launches(route, len(bt._models),
                                         splits).items():
        assert launched[kname] == want, kname
    res = compare_trees(bsts[0]._models, bsts[1]._models)
    assert res["ok"], res
    assert leaves_bitwise(bsts[0]._models, bsts[1]._models)
    assert torch.equal(bt._inner.scores.cpu(), bsts[1]._inner.scores)


def _split_option_params(name: str, tmp_path) -> dict:
    import json

    from chip_smoke import CEGB_COSTS, HIGGS_SETS
    path = tmp_path / "forced_splits.json"
    path.write_text(json.dumps({"feature": 3, "threshold": 0.4,
                                "left": {"feature": 5, "threshold": -0.2},
                                "right": {"feature": 5, "threshold": 0.1}}))
    small = [c / 100.0 for c in CEGB_COSTS]
    return {"interaction": {"interaction_constraints": HIGGS_SETS},
            "cegb_coupled": {"cegb_penalty_split": 5e-4,
                             "cegb_penalty_feature_coupled": small},
            "cegb_lazy": {"cegb_penalty_split": 5e-4,
                          "cegb_penalty_feature_lazy": [
                              c / 1e4 for c in CEGB_COSTS],
                          "bagging_fraction": 0.8, "bagging_freq": 1},
            "forced": {"forcedsplits_filename": str(path)},
            "bynode": {"feature_fraction_bynode": 0.5,
                       "feature_fraction": 0.8},
            "extra_trees": {"extra_trees": True, "extra_seed": 6}}[name]


@pytest.mark.parametrize("env", [{}, {"LGBM_TPU_COMB_PACK": "2"},
                                  {"LGBM_TPU_FUSED": "0"},
                                  {"LGBM_TPU_PHYS": "0"}])
@pytest.mark.parametrize("name", ["interaction", "cegb_coupled",
                                  "cegb_lazy", "forced", "bynode",
                                  "extra_trees"])
def test_split_options_on_card_match_cpu(cuda, name, env, monkeypatch,
                                         tmp_path):
    """Each split option (slice 22) grows the CPU run's trees bit for bit
    on the card at 28 features, on the PyTorch split tail (lazy CEGB on
    the row-order path), the training kernels launching as
    ``expected_launches`` counts; lazy CEGB's paid mask equals the
    CPU's."""
    from chip_smoke import N_FEATURES, counted_training_kernels
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    x = make_rows(6000, N_FEATURES, 11)
    _, y = make_higgs_like(6000, N_FEATURES, 11)
    params = dict({"objective": "binary", "num_leaves": 31,
                   "verbosity": -1}, **_split_option_params(name, tmp_path))
    counted = counted_training_kernels()
    before = {fn.__name__: fn.launches for fn in counted}
    bsts = [lgt.train(params, lgt.Dataset(x, label=y), num_boost_round=3,
                      device=d) for d in ("cuda", "cpu")]
    launched = {fn.__name__: fn.launches - before[fn.__name__]
                for fn in counted}
    bt = bsts[0]
    route = bt._inner.grow.route
    assert route.tail == "xla"
    assert (route.path == "row_order") == (name == "cegb_lazy" or
                                           env == {"LGBM_TPU_PHYS": "0"})
    assert all(t.num_leaves > 1 for t in bt._models)
    splits = sum(t.num_leaves - 1 for t in bt._models)
    for kname, want in expected_launches(route, len(bt._models),
                                         splits).items():
        assert launched[kname] == want, kname
    res = compare_trees(bsts[0]._models, bsts[1]._models)
    assert res["ok"], res
    assert leaves_bitwise(bsts[0]._models, bsts[1]._models)
    assert torch.equal(bt._inner.scores.cpu(), bsts[1]._inner.scores)
    if name == "cegb_lazy":
        assert torch.equal(bt._inner._cegb_paid.cpu(),
                           bsts[1]._inner._cegb_paid)


@pytest.mark.parametrize("seed", [0, 6, 2**31 - 1])
def test_node_draws_on_card(cuda, seed):
    """A tree's node draws (fold_in keys over 509 salts, a uniform row
    of 28 a node, and the subset stream's fold_in(key, 1)) give the
    CPU's bits on the card."""
    from lightgbm_tpu_torch.utils.random import (fold_in, prng_key,
                                                 uniform_rows)

    def draw(dev):
        salts = torch.arange(509, dtype=torch.int64, device=dev)
        keys = fold_in(fold_in(prng_key(seed), 41, dev), salts)
        return (uniform_rows(keys, 28, dev),
                uniform_rows(fold_in(keys, 1), 28, dev))
    for a, b in zip(draw(cuda), draw("cpu")):
        assert torch.equal(a.cpu(), b)


def test_kernel_tail_refuses_per_child_inputs_on_card(cuda):
    """The kernel entries raise, before a launch, for the per-child
    inputs and the CEGB and extra-trees modes they do not have."""
    from lightgbm_tpu_torch.ops.apply_find import (ChildSearch, SplitAt,
                                                   apply_find_pool,
                                                   build_finder_consts)
    from lightgbm_tpu_torch.ops.split import SplitHyperParams
    from lightgbm_tpu_torch.utils.log import LightGBMError
    f, b, L = 4, 16, 4
    fc = build_finder_consts(torch.full((f,), 8, dtype=torch.int32,
                                        device=cuda),
                             torch.zeros(f, dtype=torch.bool, device=cuda),
                             torch.zeros(f, dtype=torch.bool, device=cuda), b)
    from lightgbm_tpu_torch.ops.apply_find import TreeState
    st = TreeState(torch.zeros((L, f, b, 2), device=cuda),
                   torch.zeros((L, 10), device=cuda),
                   torch.zeros((L, 8), device=cuda),
                   torch.zeros((L - 1, 4), device=cuda),
                   torch.zeros((L, 2), dtype=torch.int32, device=cuda))
    h = torch.zeros((f, b, 2), device=cuda)
    nl = torch.zeros(1, dtype=torch.int32, device=cuda)
    mask = torch.ones(f, device=cuda)
    with pytest.raises(LightGBMError, match="per-child"):
        apply_find_pool(h, h, nl, st, fc, mask, SplitHyperParams(), -1,
                        SplitAt(0, 1, 0, 0, 10),
                        ChildSearch(mask[None].expand(2, f)))
    for hp in (SplitHyperParams(use_cegb=True),
               SplitHyperParams(use_extra_trees=True)):
        with pytest.raises(LightGBMError, match="PyTorch tail"):
            apply_find_pool(h, h, nl, st, fc, mask, hp, -1,
                            SplitAt(0, 1, 0, 0, 10))


# -- slice 23: the gpu_use_dp histogram, the linear-leaf moments -------------
@pytest.mark.parametrize("b,count", [(256, 0), (256, 1), (256, 3000),
                                     (256, 16_385), (256, 40_000),
                                     (1024, 31), (1024, 16_385),
                                     (1024, 32_769), (1040, 5000)])
def test_hist_rows_f64_matches_plain(cuda, b, count):
    """The gpu_use_dp mode bitwise its plain version, on the card and on
    CPU copies, in one launch and through the f64 partials."""
    from chip_smoke import dp_hist_case
    g = np.random.default_rng(b + count)
    dt = np.uint8 if b <= 256 else np.uint16
    n = 50_000
    bins = torch.tensor(g.integers(0, b, size=(n, 28)).astype(dt),
                        device=cuda)
    vals = torch.tensor(g.normal(size=(n, 2)).astype(np.float32),
                        device=cuda)
    index = torch.tensor(g.permutation(n).astype(np.int32), device=cuda)
    dp_hist_case(bins, vals, (7, count), index, b, max(count, 1), "test")


@pytest.mark.parametrize("kmax,leaves,spread,n", [
    (1, 3, "geometric", 20_000), (5, 31, "geometric", 20_000),
    (28, 255, "geometric", 20_000), (136, 7, "geometric", 20_000),
    (200, 3, "geometric", 20_000), (9, 255, "skewed", 200_000),
    (9, 255, "even", 200_000), (136, 31, "even", 20_000),
    (800, 3, "skewed", 300)])
def test_linear_moments_matches_plain(cuda, kmax, leaves, spread, n):
    """linear_moments bitwise its plain version on the card and on CPU
    copies, NaN rows, padded features and an empty leaf included, eager
    and replayed in a CUDA graph: leaf sizes geometric, skewed (one leaf
    of half the rows) or even; kmax 136, 200 and 800 take several entry
    tiles and fewer rows a stage."""
    from lightgbm_tpu_torch.ops.linear_kernel import (linear_moments,
                                                      linear_moments_ref)
    from lightgbm_tpu_torch.tools.profile_lib import capture
    from chip_smoke import torch_equal
    g = np.random.default_rng(kmax + n)
    f = max(kmax, 8)
    raw = g.normal(size=(n, f)).astype(np.float32)
    raw[g.random(raw.shape) < 0.01] = np.nan
    if spread == "geometric":
        leaf = np.minimum(g.geometric(0.05, n) - 1, leaves - 1)
    else:
        leaf = g.integers(0, leaves, n)
        if spread == "skewed":
            leaf[g.random(n) < 0.5] = 0
        leaf[leaf == 1] = 2          # an empty leaf
    fi = np.full((leaves, kmax), -1, np.int32)
    for lf in range(leaves):
        k = g.integers(0, kmax + 1)
        fi[lf, :k] = g.choice(f, size=k, replace=False)
    args = [torch.tensor(a, device=cuda) for a in (
        raw, leaf, g.normal(size=n).astype(np.float32),
        g.uniform(0.1, 1, n).astype(np.float32),
        (g.random(n) < 0.9).astype(np.float32), fi)]
    got = linear_moments(*args)
    assert torch_equal(got, linear_moments(*args))
    assert torch_equal(got, linear_moments_ref(*args))
    assert torch_equal(got.cpu(), linear_moments_ref(*(a.cpu()
                                                       for a in args)))
    static = {}

    def run():
        static["out"] = linear_moments(*args)
    graph = capture(run)
    static["out"].zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch_equal(static["out"], got)


def test_refit_takes_the_host_walk_on_the_card(cuda):
    """Refit rows whose f64 value lies at a threshold that rounds up in
    f32: on the card their leaves are the f64 host walk's, and the refit
    leaves are the CPU refit's bit for bit."""
    from lightgbm_tpu_torch.basic import refit_leaves
    x = make_rows(2500, 6, 15)
    y = (np.nan_to_num(x[:, 0]) > 0).astype(np.float32)
    bst = lgt.train({"objective": "binary", "num_leaves": 15,
                     "verbosity": -1}, lgt.Dataset(x[:1500], label=y[:1500]),
                    num_boost_round=3, device="cpu")
    text = bst.model_to_string()
    boosters = [lgt.Booster(model_str=text, device=d) for d in (cuda, "cpu")]
    for b in boosters:
        b._models[0].threshold[0] = 0.1
    xr = x[1500:].astype(np.float64)
    xr[::3, int(boosters[0]._models[0].split_feature[0])] = 0.1
    host = np.stack([t.predict_leaf(xr) for t in boosters[0]._models],
                    axis=1)
    assert np.array_equal(refit_leaves(boosters[0], xr), host)
    card, cpu = (b.refit(xr, y[1500:], decay_rate=0.9) for b in boosters)
    assert leaves_bitwise(card._models, cpu._models)


@pytest.mark.parametrize("params", [
    {"objective": "regression", "linear_tree": True},
    {"objective": "regression", "linear_tree": True, "linear_lambda": 1.0,
     "bagging_fraction": 0.7, "bagging_freq": 1},
    {"objective": "binary", "linear_tree": True, "max_bin": 1023},
    {"objective": "binary", "gpu_use_dp": True},
    {"objective": "binary", "gpu_use_dp": True, "max_bin": 1023}])
def test_linear_and_dp_training_match_the_cpu(cuda, params):
    """Linear trees and gpu_use_dp grow the CPU run's trees, leaf values
    and leaf models bit for bit; rollback_one_iter gives the scores
    back bit for bit."""
    from chip_smoke import linear_fields_bitwise, linear_target
    x = make_rows(5000, 12, 9)
    y = (linear_target(x, 3, 4) if params["objective"] == "regression"
         else make_higgs_like(5000, 12, 9)[1])
    p = dict(params, num_leaves=31, verbosity=-1)

    def train(dev):
        bst = lgt.Booster(p, lgt.Dataset(x, label=y), device=dev)
        for _ in range(3):
            bst.update()
        return bst
    bc, bp = train("cuda"), train("cpu")
    assert compare_trees(bc._models, bp._models)["ok"]
    assert leaves_bitwise(bc._models, bp._models)
    assert linear_fields_bitwise(bc._models, bp._models)
    before = bc._inner.scores.clone()
    bc.update()
    bc.rollback_one_iter()
    assert torch.equal(bc._inner.scores, before)
    xq = x.astype(np.float32).astype(np.float64)
    np.testing.assert_allclose(bc.predict(xq, raw_score=True),
                               bp.predict(xq, raw_score=True),
                               rtol=1e-12, atol=1e-9)


# -- slice 24: the parallel learners' tail side and empty segments ---------
@pytest.mark.parametrize("f,b", [(28, 256), (28, 1024), (136, 256)])
def test_apply_find_side_matches_plain(cuda, f, b):
    """The pool entry's global side bitwise its plain version on the
    card and on CPU copies, agreeing with the local counts (then equal to
    the call without it) and flipping them."""
    from chip_smoke import side_tail_parity
    from lightgbm_tpu_torch.tools.profile_apply_find import synthetic_split
    side_tail_parity(synthetic_split(f, b, seed=f + b, device="cuda"),
                     f"{f}x{b}")


def test_apply_find_side_on_a_real_split(cuda):
    from chip_smoke import side_tail_parity, split_state_case
    side_tail_parity(split_state_case(), "root split")


def test_empty_segment_wrappers(cuda):
    """fused_split, the scan, copyback, hist_comb and hist_rows on a
    segment empty on a rank: zeros, nleft = 0, no launch."""
    from chip_smoke import empty_segment_cases
    empty_segment_cases(cuda)


def test_parallel_learners_card_equal_cpu(cuda):
    """Two ranks on the card over gloo grow the same 2-rank CPU run's
    trees for each learner, every rank the same model text."""
    from chip_smoke import (PARALLEL_LEARNERS, PARITY_CUT_LEAVES,
                            TRAIN_PARAMS, run_ranks)
    jobs = []
    for name, lp in PARALLEL_LEARNERS.items():
        for dev in ("cuda", "cpu"):
            jobs.append(dict(label=f"{name}_{dev}", rows=5_000, iters=2,
                             device=dev, count=False, env={},
                             params=dict(TRAIN_PARAMS, verbosity=-1,
                                         num_leaves=PARITY_CUT_LEAVES, **lp)))
    ranks = run_ranks(2, jobs, timeout=300)
    for j in jobs:
        assert ranks[0][j["label"]]["text"] == ranks[1][j["label"]]["text"]
    for name in PARALLEL_LEARNERS:
        assert (ranks[0][f"{name}_cuda"]["text"]
                == ranks[0][f"{name}_cpu"]["text"]), name


# -- slice 27: the init and plain refresh redesigned; resilience ----------
@pytest.mark.parametrize("n,f,kind,offset", stream_shape_cases())
def test_stream_init_and_plain_refresh_at_odd_shapes(cuda, n, f, kind,
                                                     offset):
    """Both kernels bitwise their plain versions at row counts off a
    group of 4 rows and a block of 256, at 5, 28, 36 and 136 features,
    and on pointers 4 bytes past a 16-byte boundary (the init's 4-byte
    path)."""
    from chip_smoke import stream_shape_parity
    rec = stream_shape_parity(n, f, kind, cuda, offset=offset)
    torch.cuda.synchronize()
    assert rec["ok"], rec


@pytest.mark.parametrize("at_refresh", ["0", "1"])
def test_kill_resume_on_the_card(cuda, at_refresh, tmp_path):
    """A stream-route run stopped after its snapshot at iteration 2 and
    resumed to 6 on the card: model text and raw f32 scores byte for
    byte the uninterrupted run's."""
    from chip_smoke import (RES_PARAMS, ckpt_env, resilience_data,
                            resilience_train, same_run)
    rows = 20_000
    x, y = resilience_data(rows)
    ds = lgt.Dataset(x, label=y)
    extra = {"LGBM_TPU_CKPT_AT_REFRESH": at_refresh}
    ref = resilience_train(RES_PARAMS, rows, 6,
                           ckpt_env(tmp_path / "ref", **extra), "cuda", ds)
    resilience_train(RES_PARAMS, rows, 3, ckpt_env(tmp_path / "ck", **extra),
                     "cuda", ds)
    got = resilience_train(RES_PARAMS, rows, 6,
                           ckpt_env(tmp_path / "ck", **extra), "cuda", ds)
    assert got._inner.route.stream and got.resumed_from == 2
    rec = same_run(got, ref)
    assert rec["model_text_identical"] and rec["raw_scores_identical"], rec


# -- slice 28: TreeSHAP on the card, pred_early_stop ----------------------
def _shap_model(case: str):
    """(model text, rows) of a ``test_tree_shap_matches_plain`` case."""
    from chip_smoke import chain_model_text
    if case == "chain":
        return chain_model_text(45, 50, seed=3), make_rows(3000, 50, 3)
    cats = (1, 4) if case in ("categorical", "multiclass") else ()
    k = 3 if case == "multiclass" else 1
    text = random_model_text(n_trees=4 * k, num_leaves=255, n_features=8,
                             seed=60 + k, cat_features=cats, num_class=k)
    x = make_rows(3000, 8, 60 + k, cats)
    x[:5] = np.nan
    return text, x


@pytest.mark.parametrize("case,scratch", [
    ("binary", None), ("categorical", None), ("multiclass", None),
    ("chain", None), ("categorical", 1 << 20)])
def test_tree_shap_matches_plain(cuda, case, scratch, monkeypatch):
    """tree_shap bitwise its plain version on the card and on the CPU,
    through ``Booster.predict(pred_contrib=True)`` (which launches it),
    on random 255-leaf forests with NaN, zero-as-missing and categorical
    splits, three classes, a 45-deep chain, and a scratch budget that
    cuts the rows into several launches."""
    from chip_smoke import torch_equal
    from lightgbm_tpu_torch.models.shap import tree_shap_ref
    from lightgbm_tpu_torch.ops import shap_kernel as sk
    if scratch:
        monkeypatch.setattr(sk, "SCRATCH_BYTES", scratch)
    text, x = _shap_model(case)
    bst = lgt.Booster(model_str=text, device=cuda)
    before = sk.tree_shap.launches
    got = bst.predict(x, pred_contrib=True)
    launched = sk.tree_shap.launches - before
    forest = sk.pack_shap_forest(bst._models, bst._k, bst.num_feature(),
                                 bst.current_iteration(), False, cuda)
    want = tree_shap_ref(forest.trees, forest.k, forest.nf, forest.ev,
                         torch.as_tensor(x, dtype=torch.float64,
                                         device=cuda),
                         forest.iters, False)
    cpu = lgt.Booster(model_str=text, device="cpu").predict(
        x, pred_contrib=True)
    assert torch_equal(torch.as_tensor(got), want.cpu())
    assert np.array_equal(got, cpu)
    rows = -(-len(x) // sk.chunk_rows(forest.max_depth, forest.nf, len(x)))
    assert launched == rows and (scratch is None or rows > 1)


def test_pred_contrib_sums_to_the_raw_scores_on_the_card(cuda):
    """A model trained on the card (a categorical feature, 63 leaves):
    each row's contributions sum to its f64 raw score within 1e-9 of the
    largest, and equal the CPU booster's bit for bit.  (The random
    forests' data counts are not their children's sums, so their rows do
    not sum to their scores.)"""
    from chip_smoke import host_raw
    x, y = make_higgs_like(20_000, 8, seed=9)
    x[:, 3] = np.floor(np.abs(x[:, 3]) * 5)
    bst = lgt.train({"objective": "binary", "num_leaves": 63,
                     "verbosity": -1},
                    lgt.Dataset(x, label=y, categorical_feature=[3]), 5,
                    device="cuda")
    xr = np.asarray(x[:3000], np.float64)
    got = bst.predict(xr, pred_contrib=True)
    raw = host_raw(bst, xr)
    assert np.abs(got.sum(axis=1) - raw).max() <= 1e-9 * np.abs(raw).max()
    cpu = lgt.Booster(model_str=bst.model_to_string(), device="cpu")
    assert np.array_equal(got, cpu.predict(xr, pred_contrib=True))


def test_tree_shap_in_a_graph_and_its_layout(cuda):
    """A replayed graph of tree_shap equals the eager call; the
    library's scratch size a row is the wrapper's; a forest packed on
    the card refuses CPU rows and f32 rows, a CPU forest CUDA rows."""
    from chip_smoke import torch_equal
    from lightgbm_tpu_torch.ops import shap_kernel as sk
    from lightgbm_tpu_torch.tools.profile_lib import capture
    from lightgbm_tpu_torch.utils.log import LightGBMError
    text, x = _shap_model("categorical")
    bst = lgt.Booster(model_str=text, device=cuda)
    forest = sk.pack_shap_forest(bst._models, 1, bst.num_feature(),
                                 bst.current_iteration(), False, cuda)
    xd = torch.as_tensor(x, dtype=torch.float64, device=cuda)
    eager = sk.tree_shap(forest, xd)
    out = {}
    graph = capture(lambda: out.update(v=sk.tree_shap(forest, xd)),
                    warmup=1)
    graph.replay()
    torch.cuda.synchronize()
    assert torch_equal(out["v"], eager)
    for d in (0, 7, 45, 254):
        for nf in (8, 28, 136):
            assert sk._lib().tree_shap_row_bytes(d, nf) == sk.row_bytes(d, nf)
    assert sk._lib().tree_shap_threads() == sk.THREADS
    with pytest.raises(LightGBMError):
        sk.tree_shap(forest, xd.cpu())
    with pytest.raises(LightGBMError):
        sk.tree_shap(forest, xd.float())
    host = sk.pack_shap_forest(bst._models, 1, bst.num_feature(),
                               bst.current_iteration(), False, "cpu")
    with pytest.raises(LightGBMError):
        sk.tree_shap(host, xd)


@pytest.mark.parametrize("k", [1, 3])
def test_pred_early_stop_equals_the_cpu(cuda, k):
    """pred_early_stop on the card bit for bit the CPU booster's (the
    f64 leaves, the tree-order sums, the margins), and it stops rows."""
    text = random_model_text(n_trees=12 * k, num_leaves=31, n_features=8,
                             seed=70 + k, num_class=k)
    x = make_rows(2000, 8, 70 + k)
    kw = dict(raw_score=True, pred_early_stop=True, pred_early_stop_freq=2,
              pred_early_stop_margin=0.3)
    got = lgt.Booster(model_str=text, device=cuda).predict(x, **kw)
    cpu = lgt.Booster(model_str=text, device="cpu").predict(x, **kw)
    full = lgt.Booster(model_str=text, device="cpu").predict(
        x, raw_score=True)
    assert np.array_equal(got, cpu)
    assert not np.allclose(got, full)
