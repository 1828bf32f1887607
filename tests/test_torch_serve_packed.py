"""The traversal kernel's packed forest, its raw entry (the quantizer
inside the kernel) and its one order of additions, on the CPU, against
the JAX package.

The port runs with ``device="cpu"``: the wrappers take their plain
versions.  A numpy walk over the packed layout (:func:`packed_walk`, the
kernel's reads and its order of additions, block for block) stands in
for the kernel.  The JAX package runs ``make_serve_traverse`` in
interpret mode and its own ``quantize_rows_kernel``.  Inputs are made
with numpy from a seed.

Tolerances: bins, leaf indices and the packed fields exactly; the
packed walk's scores bitwise the plain version's (the same order of
additions); scores against the JAX kernel within ``64 * T * eps_f32 *
max(|s|, 1)`` (another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightgbm_tpu_torch as lgt
from chip_smoke import adversarial_rows, make_rows, random_model_text
from lightgbm_tpu_torch.ops import predict as tpred
from lightgbm_tpu_torch.ops import serve_kernel as tkern
from test_torch_serve import _jax_forest, _tol

torch.set_num_threads(1)


def _model(cat: bool, k: int = 1, bf16: bool = False, trees: int = 12,
           leaves: int = 31, seed: int = 0):
    cats = (1, 4) if cat else ()
    text = random_model_text(n_trees=trees * k, num_leaves=leaves,
                             n_features=8, seed=seed + 31 + k + 2 * cat,
                             cat_features=cats, num_class=k)
    sm = lgt.Booster(model_str=text, device="cpu").serving_engine().model
    if bf16:
        sm.forest.leaf_value = sm.forest.leaf_value.to(torch.bfloat16)
    x = make_rows(300, 8, seed + 31 + k, cats)
    x[:5] = np.nan
    return sm, x


def packed_walk(pf: tkern.PackedForest, bins: np.ndarray, n_real: int,
                num_class: int, row_tile: int = 128):
    """numpy model of the kernel over the packed layout: each tree tile
    and tile of ``row_tile`` rows as one block walks it (records,
    row bins, bitset words, the leaf value after the nodes), the tile's
    class sums in tree order from +0, the tile sums in tile order from
    +0.  Returns (leaves [n, T] i32, scores [n, K] f32)."""
    blob = pf.blob.numpy().reshape(-1, 4)
    words = pf.blob.numpy().view(np.float32)
    cw = pf.forest.cat_words.numpy()
    w, ru = pf.cat_words_w, pf.rec_units
    tree_rec, tree_leaf = pf.tree_rec.numpy(), pf.tree_leaf.numpy()
    n, t_cnt, k = bins.shape[0], pf.trees, num_class
    leaves = np.zeros((n, t_cnt), np.int32)
    total = np.zeros((n, k), np.float32)
    for j in range(pf.n_tiles):
        t0 = j * pf.tile_trees
        part = np.zeros((n, k), np.float32)
        for r0 in range(0, n, row_tile):
            rows = np.arange(r0, min(r0 + row_tile, n, max(n_real, 0)))
            for t in range(t0, min(t0 + pf.tile_trees, t_cnt)):
                node = np.zeros(len(rows), np.int64)
                for _ in range(pf.n_steps):
                    act = node >= 0
                    if not act.any():
                        break
                    u = tree_rec[t] + ru * np.maximum(node, 0)
                    rec = blob[u]
                    x, meta, feat = rec[:, 0], rec[:, 1], rec[:, 2]
                    if pf.wide:
                        left, right = blob[u + 1, 0], blob[u + 1, 1]
                    else:
                        left, right = (rec[:, 3] << 16) >> 16, rec[:, 3] >> 16
                    b = bins[rows, feat]
                    at_nan = ((meta & 2) > 0) & (b == (meta >> 3))
                    go = np.where(at_nan, (meta & 1) > 0, b <= x)
                    if w > 0:
                        ivc = np.clip(b, 0, 32 * w - 1)
                        word = cw[t, np.maximum(node, 0) * w + (ivc >> 5)]
                        bit = (word.view(np.uint32) >> (ivc & 31)) & 1
                        go_cat = (b >= 0) & (b < x) & (bit > 0)
                        go = np.where((meta & 4) > 0, go_cat, go)
                    node = np.where(act, np.where(go, left, right), node)
                leaf = (~np.minimum(node, -1)).astype(np.int32)
                leaves[rows, t] = leaf
                part[rows, t % k] += words[tree_leaf[t] + leaf]
        total = total + part
    return leaves, total


FORESTS = [(False, 1, False), (True, 1, False), (True, 3, False),
           (False, 1, True)]


@pytest.mark.parametrize("cat,k,bf16", FORESTS + [(True, 3, True)])
@pytest.mark.parametrize("wide", [False, True])
def test_packed_arrays_unpack_to_forest_fields(cat, k, bf16, wide):
    sm, _ = _model(cat, k, bf16)
    pf = tkern.pack_forest(sm.forest, sm.n_steps, wide=wide)
    assert pf.wide == wide and pf.rec_units == (2 if wide else 1)
    got = pf.unpack()
    want = sm.forest.numpy()
    for t in range(pf.trees):
        ni, nl = int(pf.tree_nodes[t]), int(pf.tree_leaves[t])
        assert ni == 30 and nl == 31           # every node is reachable
        for name in ("split_feature", "threshold_bin", "left_child",
                     "right_child", "node_meta", "cat_nbits"):
            np.testing.assert_array_equal(got[name][t, :ni],
                                          want[name][t, :ni], err_msg=name)
        np.testing.assert_array_equal(got["leaf_value"][t, :nl],
                                      want["leaf_value"][t, :nl])
    # the tiles: tile_trees padded trees, contiguous units
    tt = tkern.tile_trees(pf.trees, pf.ni_pad, pf.nl_pad)
    assert pf.n_tiles == -(-pf.trees // tt)
    np.testing.assert_array_equal(
        pf.tile_units, np.append(pf.tree_rec.numpy()[::tt], len(
            pf.blob) // 4))
    assert np.all(np.diff(pf.tile_units) * 16
                  <= tkern.TILE_BYTES * pf.rec_units)


@pytest.mark.parametrize("cat,k,bf16", FORESTS)
def test_packed_walk_matches_ref_and_jax_kernel(cat, k, bf16):
    from lightgbm_tpu.ops.pallas.serve_kernel import (
        forest_kernel_args as jargs, make_serve_traverse)
    from lightgbm_tpu.ops.predict import quantize_rows_kernel as jq
    sm, x = _model(cat, k, bf16, trees=40)
    f = sm.forest
    pf = tkern.pack_forest(f, sm.n_steps)
    assert pf.n_tiles > 1              # several tiles: the order shows
    jf = _jax_forest(f, bf16=bf16)
    n, n_real = x.shape[0], x.shape[0] - 37
    bins_j = jq(jf, jnp.asarray(x))
    bins = tpred.quantize_rows_kernel(f, torch.from_numpy(x))
    np.testing.assert_array_equal(bins.numpy(), np.asarray(bins_j))
    leaves, scores = packed_walk(pf, bins.numpy(), n_real, k)

    lt = torch.empty((n, pf.trees), dtype=torch.int32)
    tkern.serve_traverse_ref(tkern.forest_kernel_args(f, leaves=True), bins,
                             n_real, lt, n_steps=sm.n_steps, leaves=True)
    np.testing.assert_array_equal(leaves, lt.numpy())
    st = torch.full((n, k), np.nan)
    tkern.serve_traverse_ref(tkern.forest_kernel_args(f), bins, n_real, st,
                             n_steps=sm.n_steps)
    np.testing.assert_array_equal(scores, st.numpy())     # bitwise

    common = dict(n=n, trees=pf.trees, ni_pad=pf.ni_pad, nl_pad=pf.nl_pad,
                  cat_words_w=pf.cat_words_w, n_feat=8, num_class=k,
                  n_steps=sm.n_steps, leaf_dtype=jf.leaf_value.dtype,
                  interpret=True)
    nr = jnp.asarray([n_real], jnp.int32)
    leaf_j = np.asarray(make_serve_traverse(**common, leaves=True)(
        *jargs(jf, leaves=True), bins_j, nr))
    np.testing.assert_array_equal(leaves, leaf_j)
    score_j = np.asarray(make_serve_traverse(**common)(
        *jargs(jf), bins_j, nr, jnp.zeros((n, k), jnp.float32)))
    assert np.all(np.abs(scores - score_j) <= _tol(score_j, pf.trees))


@pytest.mark.parametrize("cat,k", [(False, 1), (True, 1), (True, 3)])
def test_raw_entry_matches_jax_quantizer_and_kernel(cat, k):
    from lightgbm_tpu.ops.pallas.serve_kernel import (
        forest_kernel_args as jargs, make_serve_traverse)
    from lightgbm_tpu.ops.predict import quantize_rows_kernel as jq
    sm, _ = _model(cat, k)
    f = sm.forest
    pf = sm.packed()
    x = adversarial_rows(f, 8, seed=3)
    n = x.shape[0]
    n_real = n - 5
    jf = _jax_forest(f)
    bins_j = np.asarray(jq(jf, jnp.asarray(x)))
    bins_o = torch.full((n, 8), -9, dtype=torch.int32)
    lt = torch.empty((n, pf.trees), dtype=torch.int32)
    before = tkern.serve_traverse.launches
    got = tkern.serve_traverse_raw(pf, torch.from_numpy(x), n_real, lt,
                                   leaves=True, bins_out=bins_o)
    assert got is lt and tkern.serve_traverse.launches == before
    np.testing.assert_array_equal(bins_o.numpy(), bins_j)
    # every edge value reached the quantizer
    assert np.isnan(x).any() and np.isinf(x).any()
    assert (bins_j == 1 << 24).any()
    if cat:
        assert (bins_j[:, 1] == 2147483647).any()
        assert (bins_j[:, 1] == -1).any()
    st = torch.empty((n, k))
    tkern.serve_traverse_raw(pf, torch.from_numpy(x), n_real, st)
    common = dict(n=n, trees=pf.trees, ni_pad=pf.ni_pad, nl_pad=pf.nl_pad,
                  cat_words_w=pf.cat_words_w, n_feat=8, num_class=k,
                  n_steps=sm.n_steps, leaf_dtype=jf.leaf_value.dtype,
                  interpret=True)
    nr = jnp.asarray([n_real], jnp.int32)
    leaf_j = np.asarray(make_serve_traverse(**common, leaves=True)(
        *jargs(jf, leaves=True), jnp.asarray(bins_j), nr))
    np.testing.assert_array_equal(lt.numpy(), leaf_j)
    score_j = np.asarray(make_serve_traverse(**common)(
        *jargs(jf), jnp.asarray(bins_j), nr, jnp.zeros((n, k), jnp.float32)))
    assert np.all(np.abs(st.numpy() - score_j) <= _tol(score_j, pf.trees))
    leaves, scores = packed_walk(pf, bins_j, n_real, k)
    np.testing.assert_array_equal(leaves, lt.numpy())
    np.testing.assert_array_equal(scores, st.numpy())


@pytest.mark.parametrize("k", [1, 3])
def test_one_order_at_every_batch_size(k):
    """The same rows served as one bucket and as 64-row chunks (the
    queue's batches) give the same bits, through the engine's plain
    path and through the packed walk at either row tile."""
    sm, _ = _model(True, k, trees=40)
    x = make_rows(1024, 8, 5, (1, 4))
    x[::17] = np.nan
    eng = lgt.ServingEngine(sm, bucket_min=64, bucket_max=1024,
                            device="cpu")
    bulk = eng.predict(x)
    q = lgt.ServingQueue(eng)
    for i in range(0, 1024, 64):
        q.submit(x[i:i + 64])
    queued = np.concatenate(q.drain(), axis=0)
    np.testing.assert_array_equal(queued, bulk)
    pf = sm.packed()
    bins = tpred.quantize_rows_kernel(sm.forest, torch.from_numpy(x)).numpy()
    _, one = packed_walk(pf, bins, 1024, k, row_tile=128)
    _, small = packed_walk(pf, bins[:64], 64, k, row_tile=8)
    np.testing.assert_array_equal(one, bulk)
    np.testing.assert_array_equal(small, bulk[:64])


def test_geometry_covers_rows_and_fits():
    """The main path's forest (100 trees x 255 leaves over 28 features:
    9 trees a tile, 12 tiles of at most 2,880 units): the queue's 64
    rows split into 8-row blocks, one a tree tile (96 blocks, the tile
    sums by a second launch); a 65,536-row bucket resident, 128 blocks
    of 512 rows each walking every tile through two staged buffers with
    running totals; every geometry covers its rows and tiles once and
    takes at most 80 % of a block's shared memory."""
    ni = nl = 256
    assert tkern.tile_trees(100, ni, nl) == 9
    assert not tkern.forest_is_wide(ni, nl)
    assert tkern.forest_is_wide(32768, 32769)
    main = dict(n_tiles=12, per_tile=9, stage_units=9 * (256 + 64), bq=255,
                k=1)
    g = tkern.geometry_for(64, 28, raw=True, leaves=False, **main)
    assert (g.rows, g.grid_x, g.grid_y, g.tiles_per_block, g.nbuf,
            g.totals) == (8, 8, 12, 1, 1, False)
    g = tkern.geometry_for(65_536, 28, raw=True, leaves=False, **main)
    assert (g.rows, g.grid_x, g.grid_y, g.tiles_per_block, g.nbuf,
            g.totals) == (512, 128, 1, 12, 2, True)
    assert g.quant_staged and g.row_stride == 29
    # the quantizer tables lie in the second staged buffer
    assert g.smem == 16 * 2 * 2880 + 4 * 512 * 29 + 4 * 512 * 9 + 4 * 512
    assert g.smem <= tkern.SMEM_TARGET
    sm, _ = _model(False, 1, trees=40)
    pf = sm.packed()
    for n in (1, 7, 64, 300, 4096, 32_768, 65_536):
        for raw in (False, True):
            for leaves in (False, True):
                for k in (1, 3):
                    g = tkern.serve_geometry(pf, n, 8, raw=raw,
                                             leaves=leaves, k=k)
                    assert g.rows * g.grid_x >= n > g.rows * (g.grid_x - 1)
                    assert g.tiles_per_block * g.grid_y >= pf.n_tiles \
                        > g.tiles_per_block * (g.grid_y - 1)
                    assert g.smem <= tkern.SMEM_TARGET
                    assert g.quant_staged == raw
    # rows too wide to stage: read from global memory
    g = tkern.serve_geometry(pf, 64, 20_000, raw=False, leaves=True)
    assert g.row_stride == 0


def test_wrappers_refuse_other_devices():
    sm, x = _model(False)
    pf = sm.packed()
    raw = torch.from_numpy(x)
    out = torch.empty((x.shape[0], 1))
    with pytest.raises(lgt.LightGBMError, match="cuda or cpu"):
        tkern.serve_traverse_raw(pf, raw.to("meta"), 10, out.to("meta"))
    ref = torch.empty_like(out)
    tkern.serve_traverse_raw(pf, raw, 250, out)
    tkern.serve_traverse_raw_ref(pf, raw, 250, ref)
    assert torch.equal(out, ref) and not out[250:].any()
