"""Slice 9 on the CPU: the launch-cost probes against the JAX scripts
under ``tools/``, and wide datasets (136 features at B = 256, in
feature chunks) against the JAX package.

The JAX scripts' Pallas kernels run in interpret mode: ``monkeypatch``
wraps ``jax.experimental.pallas.pallas_call`` with ``interpret=True``
for each test (the scripts are not edited) and their modules are
imported fresh under it.  The port runs its plain versions
(``ops/probes.py``), which its CUDA kernels equal bit for bit on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Tolerances:
none but the trees'.  T11's leaf state and last sel are compared bit
for bit (NaN positions compared as positions), T10's and T9's i32
outputs exactly, the wide histogram exactly (both sides add the same
bf16-rounded values and the sums come out equal), and trees in
structure with leaf values within 1e-4 of the tree's largest leaf
(``tests/test_torch_train.py``'s tolerance: the two packages sum in
other orders).
"""
import functools
import importlib
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import lightgbm_tpu_torch as lgt
from chip_smoke import compare_trees, random_row_matrix, rows_on
from conftest import restore_env_knobs, save_env_knobs
from lightgbm_tpu_torch.analysis import entries, resources
from lightgbm_tpu_torch.analysis.passes import smem as smem_pass
from lightgbm_tpu_torch.ops import hist_kernel2 as hk
from lightgbm_tpu_torch.ops import probes
from lightgbm_tpu_torch.tools import profile_pallas_ov as t_ov
from lightgbm_tpu_torch.tools import profile_step_cost as t_sc

torch.set_num_threads(1)

TOOLS = Path(__file__).resolve().parent.parent / "tools"
L, COLS = probes.LEAVES, probes.COLS


@pytest.fixture
def jax_tools(monkeypatch):
    """``tools/profile_pallas_ov`` and ``tools/profile_step_cost``
    imported fresh with every ``pallas_call`` interpreted."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.syspath_prepend(str(TOOLS))
    for name in ("profile_pallas_ov", "profile_step_cost"):
        sys.modules.pop(name, None)
    ov = importlib.import_module("profile_pallas_ov")
    sc = importlib.import_module("profile_step_cost")
    yield ov, sc
    for name in ("profile_pallas_ov", "profile_step_cost"):
        sys.modules.pop(name, None)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


# -- T11: select_update ---------------------------------------------------------
def _state(kind: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    if kind == "tool":           # the script's own: zeros, [0, 0] = 1
        st = np.zeros((L, COLS), np.float32)
        st[0, 0] = 1.0
    elif kind == "normal":
        st = rng.normal(size=(L, COLS)).astype(np.float32)
    elif kind == "ties":         # column 0 in {0, 1, 2}: ties everywhere
        st = rng.normal(size=(L, COLS)).astype(np.float32)
        st[:, 0] = rng.integers(0, 3, size=L)
    else:                        # "big": (row + 1) - row != 1 at 1e8
        st = rng.normal(size=(L, COLS)).astype(np.float32)
        st[37] = 1e8 + rng.integers(0, 64, size=COLS) * 8
    return st


def _jax_select(ov):
    """One ``_select_kernel`` call as ``pallas_loop`` makes it, jitted:
    (leafs, sel)."""
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)

    @jax.jit
    def step(lf):
        return pl.pallas_call(
            ov._select_kernel, in_specs=[vmem], out_specs=[vmem, vmem],
            out_shape=[jax.ShapeDtypeStruct((L, COLS), jnp.float32),
                       jax.ShapeDtypeStruct((8,), jnp.float32)],
            input_output_aliases={0: 0})(lf)
    return step


@pytest.mark.parametrize("kind", ["tool", "normal", "ties", "big"])
def test_select_update_matches_pallas_loop(jax_tools, kind):
    ov, _ = jax_tools
    st = _state(kind)
    want = np.asarray(ov.pallas_loop(jnp.asarray(st)))
    step = _jax_select(ov)
    lf_j = jnp.asarray(st)
    for _ in range(ov.N):
        lf_j, sel_j = step(lf_j)
    lf = torch.from_numpy(st.copy())
    sel = probes.select_update_loop(lf, t_ov.N)
    np.testing.assert_array_equal(_bits(lf.numpy()), _bits(want))
    np.testing.assert_array_equal(_bits(lf_j), _bits(want))
    np.testing.assert_array_equal(_bits(sel.numpy()), _bits(sel_j))
    if kind == "big":            # the kernel's formula, not row + 1
        assert (lf.numpy()[37] == st[37]).all()


@pytest.mark.parametrize("case", ["nan_mid", "nan_twice", "all_nan",
                                  "neg_inf", "ties_first"])
def test_argmax_matches_jnp_argmax(case):
    col = np.random.default_rng(5).normal(size=L).astype(np.float32)
    if case == "nan_mid":
        col[100] = np.nan
    elif case == "nan_twice":
        col[[30, 9]] = np.nan
        col[0] = np.inf
    elif case == "all_nan":
        col[:] = np.nan
    elif case == "neg_inf":
        col[:] = -np.inf
    else:
        col[[4, 200]] = 9.0
    want = int(jnp.argmax(jnp.asarray(col)))
    assert int(probes.argmax_first(torch.from_numpy(col))) == want


@pytest.mark.parametrize("where", ["chosen_row", "other_row", "signed_zero"])
def test_select_update_non_finite_like_the_tpu_kernel(jax_tools, where):
    """One call where the masked sum matters: an inf in the chosen row
    reaches every row, one elsewhere makes the row NaN, a -0 in the
    chosen row comes out +0."""
    ov, _ = jax_tools
    st = _state("normal")
    leaf = int(np.argmax(st[:, 0]))
    if where == "chosen_row":
        st[leaf, 5] = np.inf
    elif where == "other_row":
        st[(leaf + 1) % L, 7] = -np.inf
    else:
        st[leaf, 3] = -0.0
    lf_j, sel_j = _jax_select(ov)(jnp.asarray(st))
    lf = torch.from_numpy(st.copy())
    sel = probes.select_update(lf)
    for got, want in ((lf.numpy(), np.asarray(lf_j)),
                      (sel.numpy(), np.asarray(sel_j))):
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan)
        np.testing.assert_array_equal(_bits(got[~nan]), _bits(want[~nan]))


# -- T10 and T9: step_cost, stream_tiles --------------------------------------
@pytest.mark.parametrize("var", t_sc.VARIANTS)
@pytest.mark.parametrize("blocks", [8, 37])
def test_step_cost_matches_the_tpu_script(jax_tools, var, blocks):
    _, sc = jax_tools
    n = probes.TILE_ROWS * blocks
    rows = t_sc.make_rows(n, "cpu", seed=blocks)
    want = np.asarray(sc.build(var, n)(jnp.asarray(rows.numpy())))
    got = t_sc.kernel(var)(rows)
    assert got.dtype == torch.int32 and got.shape == (1,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_step_cost_wraps_like_int32():
    rows = torch.zeros((probes.TILE_ROWS * 3, probes.TILE_COLS))
    rows[::probes.TILE_ROWS, 0] = 2.0 ** 30
    assert probes.stream_tiles(rows).item() == 3 * 2 ** 30 - 2 ** 32
    sel = torch.tensor([2 ** 31 - 2, -7], dtype=torch.int32)
    assert probes.step_cost("dma_nw", rows, sel).item() == 1 - 2 ** 31
    # floor division of a negative sel[1], as jnp's //: -7, -3, -1
    assert probes.step_cost("smemrw", rows, sel).item() == 2 ** 31 - 13
    sel = torch.tensor([2 ** 31 - 1, 2 ** 31 - 1], dtype=torch.int32)
    total = 2 ** 31 - 1 + sum(b + (2 ** 31 - 1) // (b + 1) for b in range(3))
    assert probes.step_cost("smemrw", rows, sel).item() == (
        (total + 2 ** 31) % 2 ** 32 - 2 ** 31)


def test_probe_tools_run_on_the_cpu(capsys):
    ov = t_ov.run("cpu", reps=1, warmup=0)
    assert [r["mode"] for r in ov["rows"]] == [
        "select_update_ref (plain, CPU)", "PyTorch ops (xla_loop), eager"]
    assert ov["launches"] == 0 and ov["clock"] == "host (perf_counter)"
    sc = t_sc.run("cpu", n=probes.TILE_ROWS * 4, reps=1, warmup=0)
    assert [r["variant"] for r in sc["rows"]] == [*t_sc.VARIANTS, "empty"]
    assert sc["rows"][-1]["blocks"] == 1
    assert sc["launches"] == {"step_cost": 0, "stream_tiles": 0}
    out = capsys.readouterr().out
    assert "us/update" in out and "us/block" in out
    assert t_ov.expected_launches(20, 3) == 254 * 50
    assert t_sc.expected_launches(["empty", "smemrw"], 30, 3) == 3 * 94


def test_probe_tools_cli_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("PN", "11")
    monkeypatch.setenv("REPS", "1")
    monkeypatch.setenv("VAR", "smemrw,dma_bs")
    assert t_sc.main(["--device", "cpu"]) == 0
    assert t_ov.main(["--device", "cpu", "--reps", "1"]) == 0
    monkeypatch.setenv("VAR", "dma")
    with pytest.raises(SystemExit):
        t_sc.main(["--device", "cpu"])


# -- wide datasets -------------------------------------------------------------
def test_comb_feature_chunk():
    """Five blocks share an SM, each within the analyzer's warning line;
    balanced over the chunks."""
    def per_sm(fc, b=256):
        return hk.SM_SMEM // (hk.comb_smem_bytes(fc, b)
                              + hk.BLOCK_RESERVED_SMEM)
    assert hk.MAX_SMEM == smem_pass.MAX_SMEM
    assert hk.BLOCK_RESERVED_SMEM == resources.RESERVED_SMEM
    most = hk.comb_feature_chunk(10_000, 256)
    assert most == 18 == hk.comb_feature_chunk(18, 256)
    assert per_sm(18) == hk.COMB_BLOCKS_PER_SM == 5 > per_sm(19)
    assert hk.comb_smem_bytes(18, 256) <= \
        smem_pass.WARN_FRACTION * smem_pass.MAX_SMEM
    assert hk.comb_feature_chunk(28, 256) == 14        # 2 x 14
    assert hk.comb_feature_chunk(80, 256) == 16
    assert hk.comb_feature_chunk(136, 256) == 17       # 8 x 17
    assert hk.comb_smem_bytes(17, 256) == 41_216
    assert hk.comb_feature_chunk(2000, 256) == 18      # 112 chunks
    for f in (1, 57, 100, 137, 2000):
        for b in (16, 64, 256):
            fc = hk.comb_feature_chunk(f, b)
            chunks = -(-f // fc)
            assert per_sm(fc, b) >= 5 and fc <= f
            assert chunks == -(-f // hk.comb_feature_chunk(10 ** 6, b))


def test_wide_entry_smem_pass():
    """The registered F = 136 entry (the root, feature mode) is clean;
    the same launch with one chunk of all 136 features is over the
    budget."""
    from lightgbm_tpu_torch.analysis import registry
    from lightgbm_tpu_torch.analysis.run import build_context
    ctx = build_context()
    wide = entries.hist_comb_wide_entry()
    assert wide.dyn_smem == 24_576 and wide.export[1] == (8, 256, 0)
    assert registry.collect()["hist_comb_wide"] == wide
    for entry, codes in ((wide, set()),
                         (entries.hist_comb_wide_entry(fc=136),
                          {"SMEM_OVER_BUDGET"})):
        ctx.entries = [entry]
        assert {f.code for f in smem_pass.run(ctx)
                if not f.code.startswith("RESOURCES")} == codes


def test_wide_comb_histogram_matches_jax():
    from lightgbm_tpu.ops.pallas.hist_kernel2 import \
        build_histogram_comb as jax_comb_histogram
    f, n, b = 136, 3000, 256
    arrays = list(random_row_matrix(n + 4096, f, 4))
    vals = torch.tensor(arrays[1]).bfloat16().float().numpy()
    vals[n:] = 0.0
    arrays[1] = vals
    comb = np.zeros((n + 4096, 256), np.float32)
    comb[:, :f] = arrays[0]
    comb[:, f:f + 3] = vals
    want = np.asarray(jax_comb_histogram(
        jnp.asarray(comb), jnp.int32(0), jnp.int32(0), jnp.int32(n),
        f_pad=f, size=n, padded_bins=b, rows_per_block=512,
        interpret=True))
    rows = rows_on(arrays, "cpu")
    got = hk.build_histogram_comb(
        rows, torch.tensor([0, 0, n], dtype=torch.int32), padded_bins=b,
        max_rows=n).numpy()
    assert got.shape == want.shape == (f, b, 2)
    assert np.array_equal(got, want)


WIDE_ROUTE = "path=stream fused=0 tail=kernel (fused_smem)"
JAX_ROUTE = {"LGBM_TPU_PHYS": "interpret", "LGBM_TPU_STREAM": "0",
             "LGBM_TPU_FUSED": "0"}
ROUTE_KNOBS = ("LGBM_TPU_PHYS", "LGBM_TPU_STREAM", "LGBM_TPU_FUSED",
               "LGBM_TPU_APPLY_IMPL", "LGBM_TPU_COMB_PACK", "LGBM_TPU_PART")


def _purge():
    for m in [k for k in list(sys.modules) if k.startswith("lightgbm_tpu")
              and not k.startswith("lightgbm_tpu_torch")]:
        del sys.modules[m]


def test_wide_training_matches_jax():
    """3,000 x 136, 15 leaves, 2 trees: the port's route is the unfused
    stream route with the kernel tail (no new rule; nothing raises) and
    its trees equal the JAX package's physical route's in structure."""
    rng = np.random.default_rng(136)
    x = rng.normal(size=(3000, 136)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    y = ((np.nan_to_num(x[:, 0]) + 0.5 * np.nan_to_num(x[:, 70])
          + 0.3 * np.nan_to_num(x[:, 135]) + 0.3 * rng.normal(size=3000))
         > 0).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 255,
              "min_data_in_leaf": 20}
    saved = save_env_knobs(ROUTE_KNOBS)
    try:
        for k in ROUTE_KNOBS:
            os.environ.pop(k, None)
        port = lgt.train(params, lgt.Dataset(x, label=y), 2, device="cpu")
        os.environ.update(JAX_ROUTE)
        _purge()
        import lightgbm_tpu as lgb
        ref = lgb.train(params, lgb.Dataset(x, label=y), num_boost_round=2)
        assert ref._inner._routing.path == "physical"
    finally:
        restore_env_knobs(saved)
        _purge()
    assert port._inner.grow.route.describe() == WIDE_ROUTE
    assert port._inner.dd.padded_bins == 256
    res = compare_trees(port._models, ref._models, rtol=1e-4)
    assert res["ok"], res
    assert all(t.num_leaves == 15 for t in port._models)
