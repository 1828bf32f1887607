"""The analyzer's fixture kernels (``ops/analysis_fixtures.py``) on the CPU.

Each plain version computes what the JAX fixture's Pallas kernel body
writes, checked with numpy on the JAX fixture's own argument shapes (from
its ``builder()``; nothing executes on the JAX side): rows [0, 8) copied
for F1 (``_bad_lane``) and F3 (``_bad_cat``), the whole array for F4
(``_bad_serve_kernel``), each class slice for F5 (``_bad_mc_batch``), the
blocks for F2 (``_bad_vmem``), exactly; x * scale + bias for F6
(``bad_host_ast.py``) with 0 ulps at f32, the product rounded before the
sum as numpy does.  The wrappers take the plain versions for CPU tensors,
and the 16-byte rule that decides a legal geometry is pinned.  The kernels
themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``cuda`` marker).
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.analysis import fixtures as fx
from lightgbm_tpu_torch.analysis.entries import FIXTURE_STAGE_LEGAL
from lightgbm_tpu_torch.ops import analysis_fixtures as taf


def _jax_args(name):
    from lightgbm_tpu.analysis import fixtures as jfx
    _, args = jfx.load(name).entries[0].builder()
    return [(tuple(a.shape), np.dtype(a.dtype)) for a in args]


def _data(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-2**31, 2**31 - 1, size=shape, dtype=dtype)
    return rng.normal(size=shape).astype(dtype)


# (JAX fixture, rows its kernel body writes per class slice)
STAGE = {"bad_lane": 8, "bad_cat": 8, "bad_serve_kernel": None,
         "bad_mc_batch": None}


@pytest.mark.parametrize("name", sorted(STAGE))
def test_stage_copy_writes_what_the_jax_kernel_writes(name):
    (shape, dtype), = _jax_args(name)
    x = _data(shape, dtype, seed=len(name))
    rows = STAGE[name] or shape[-2]
    out = taf.stage_copy_ref(torch.from_numpy(x), rows).numpy()
    assert out.dtype == dtype and out.shape == shape
    # the rows the JAX body writes (the rest of its output is unwritten)
    np.testing.assert_array_equal(out[..., :rows, :], x[..., :rows, :])
    np.testing.assert_array_equal(out[..., rows:, :], 0)


def test_smem_acc_copies_the_blocks():
    (shape, dtype), = _jax_args("bad_vmem")
    x = _data(shape, dtype, seed=2)
    out = taf.smem_acc_ref(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, x)


def test_scale_bias_is_the_jax_body_to_zero_ulps():
    from lightgbm_tpu.analysis import fixtures as jfx
    _, args = jfx.load("bad_host").entries[0].builder()
    x = _data(tuple(args[0].shape), np.float32, seed=6)
    # bad_host_ast.py: scale = x[0, 0].item(); bias = np.asarray(x).sum()
    scale, bias = x[0, 0], np.asarray(x).sum(dtype=np.float32)
    want = x * scale + bias
    got = taf.scale_bias_ref(torch.from_numpy(x), torch.tensor([scale]),
                             torch.tensor([bias])).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("fn,args", [
    (taf.stage_copy, (4,)),
    (taf.smem_acc, ()),
])
def test_wrappers_take_the_plain_version_on_cpu(fn, args):
    x = torch.arange(32 * 128, dtype=torch.float32).reshape(32, 128)
    before = fn.launches
    ref = getattr(taf, fn.__name__ + "_ref")(x, *args)
    assert torch.equal(fn(x, *args), ref)
    assert fn.launches == before


def test_scale_bias_wrapper_takes_the_plain_version_on_cpu():
    x = torch.randn(8, 128)
    s, b = torch.tensor([1.5]), torch.tensor([-0.25])
    assert torch.equal(taf.scale_bias(x, s, b), taf.scale_bias_ref(x, s, b))
    assert taf.scale_bias.launches == 0


@pytest.mark.parametrize("row_bytes,offset,broken", [
    (64, 0, False), (56, 0, True), (252, 0, True), (60, 0, True),
    (256, 0, False), (64, 8, True), (16, 16, False),
])
def test_stage_rule(row_bytes, offset, broken):
    assert taf.stage_rule_broken(row_bytes, offset) is broken


def test_legal_geometries_keep_the_rule_and_seeded_ones_break_it():
    for name, dtype, classes, rows, cols, copied, _ in FIXTURE_STAGE_LEGAL:
        assert not taf.stage_rule_broken(cols * 4), name
        assert copied * cols * 4 <= taf.MAX_SMEM
    for name, row in fx.STAGE_SEEDED.items():
        assert taf.stage_rule_broken(row[4] * 4), name
    assert fx.SMEM_ACC_SEEDED > taf.MAX_SMEM


def test_a_seeded_geometry_is_refused_on_a_cuda_tensor_only():
    # on the CPU the plain version copies any geometry
    x = torch.zeros(256, 14)
    assert torch.equal(taf.stage_copy(x, 8), x)
    with pytest.raises(Exception):
        taf.smem_acc(torch.zeros(32, 128, device="meta"))
