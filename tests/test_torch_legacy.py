"""The partition-bisection probes (TPU rows T1-T8) on the CPU against the
builders of ``tools/profile_legacy.py``.

The script's Pallas kernels run in interpret mode: ``monkeypatch`` wraps
``jax.experimental.pallas.pallas_call`` with ``interpret=True`` and the
script is imported fresh under it (it is not edited).  ``part3 full``,
``part2`` and ``part8 real`` call the production ``make_partition``,
whose own ``interpret`` keyword overrides the wrapper: they are held
against ``make_partition(..., interpret=True)``, its plain XLA
emulation, which returns its scratch untouched, so there only the rows
and nleft are compared.  Where a builder reads its split descriptor,
the descriptor is replaced in the built call's closure (s0 != 0, an odd
cnt, other predicates).  Scratch starts filled with -1, a sentinel.

The port runs its wrappers on CPU tensors, that is its plain versions
(``ops/legacy_probes.py``), which its CUDA kernels equal bit for bit on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Rows hold
integers, so every comparison is bitwise with no tolerance; ``part7
noalias`` leaves the rows it does not write undefined (the interpreter
gives NaN), so only its written rows are compared.
"""
import functools
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from lightgbm_tpu_torch.ops import legacy_probes as lp
from lightgbm_tpu_torch.tools import profile_legacy as tl

torch.set_num_threads(1)

TOOLS = Path(__file__).resolve().parent.parent / "tools"
R, C = lp.R, lp.C
SENTINEL = -1.0
# descriptors beside the script's: an odd start and length; a NaN bin
# routed right on another feature; a one-hot categorical split
ODD = (37, 2001, 3, 127, 1, 0, -1, 0)
NAN_RIGHT = (37, 2001, 5, 100, 0, 0, 100, 0)
CAT = (512, 1501, 7, 50, 0, 1, -1, 0)


@pytest.fixture
def jax_legacy(monkeypatch):
    """``tools/profile_legacy`` imported fresh with every ``pallas_call``
    interpreted."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.syspath_prepend(str(TOOLS))
    sys.modules.pop("profile_legacy", None)
    yield importlib.import_module("profile_legacy")
    sys.modules.pop("profile_legacy", None)


def with_sel(call, sel):
    """``call`` with the descriptor its builder closed over replaced."""
    cell = call.__closure__[call.__code__.co_freevars.index("sel")]
    cell.cell_contents = jnp.asarray(sel, jnp.int32)
    return call


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy().view(np.int32), _np(want))


def _inputs(n: int, n_alloc: int, sel, seed: int = 0):
    rows = tl.make_rows(n_alloc, "cpu", seed)
    return rows.numpy().copy(), tl.Inputs(rows, sel, n,
                                          scratch_fill=SENTINEL)


def _port(kernel: str, arg, inp) -> dict:
    inp.reset()
    return tl.apply(kernel, arg, inp)


# -- T1, T2: part3 -------------------------------------------------------------
@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("var", ["copy", "copy3"])
def test_block_copy_matches_part3(jax_legacy, n, var):
    n_alloc = n + 2 * R
    x, inp = _inputs(n, n_alloc, tl.script_sel(n))
    scratch = np.full_like(x, SENTINEL)
    r, s, _ = jax_legacy._build_part3(var, n_alloc, n)(
        jnp.asarray(x), jnp.asarray(scratch))
    got = _port(*tl.CASES[("part3", var)], inp)
    _same(got["rows"], r)
    _same(got["scratch"], s)


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("var", ["scan", "scan2"])
@pytest.mark.parametrize("sel", [None, ODD, NAN_RIGHT, CAT])
def test_partition_scan_matches_part3(jax_legacy, n, var, sel):
    n_alloc = n + 2 * R
    sel = tl.script_sel(n) if sel is None else sel
    x, inp = _inputs(n, n_alloc, sel)
    call = with_sel(jax_legacy._build_part3(var, n_alloc, n), sel)
    r, s, nsp = call(jnp.asarray(x), jnp.asarray(np.full_like(x, SENTINEL)))
    got = _port(*tl.CASES[("part3", var)], inp)
    _same(got["rows"], r)
    _same(got["scratch"], s)
    assert int(got["nsplit"][0]) == int(nsp)
    if var == "scan":
        assert int(nsp) == 0


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("sel", [None, ODD, NAN_RIGHT, CAT])
def test_full_partition_matches_make_partition(n, sel):
    """``part3 full``, ``part2`` and ``part8 real``: the three phases
    against the production emulation (rows and nleft; its scratch is
    returned untouched)."""
    from lightgbm_tpu.ops.pallas.partition_kernel import make_partition
    n_alloc = n + 2 * R
    sel = tl.script_sel(n) if sel is None else sel
    x, inp = _inputs(n, n_alloc, sel)
    part = make_partition(n_alloc, C, R=R, dtype=jnp.float32, dynamic=True,
                          interpret=True)
    r, _, nl = part(jnp.asarray(sel, jnp.int32), jnp.asarray(x),
                    jnp.zeros_like(jnp.asarray(x)), jnp.int32(-(-n // R)))
    for scenario, var in (("part3", "full"), ("part2", "real"),
                          ("part8", "real")):
        got = _port(*tl.CASES[(scenario, var)], inp)
        _same(got["rows"], r)
        assert int(got["nsplit"][0]) == int(nl)


def test_partition_dense_dead_call():
    x, inp = _inputs(2048, 3072, (100, 0, 3, 127, 1, 0, -1, 0))
    got = _port("partition_dense", 3, inp)
    assert int(got["nsplit"][0]) == 0
    assert torch.equal(got["rows"], torch.from_numpy(x))
    assert bool((got["scratch"] == SENTINEL).all())


# -- T3-T7: the compaction ----------------------------------------------------------
# the variants that read s0 or cnt from their descriptor
READS_S0_CNT = {("part4", "smem"), ("part4", "alias2"), ("part4", "nsplit"),
                ("part5", "when"), ("part5", "dynoff"), ("part5", "pred")}


def _compact_case(jax_legacy, scenario, var, n, sel):
    """(JAX outputs, port outputs) of one compaction variant."""
    narrow = scenario in ("part6", "part7")
    n_alloc = n if narrow else n + 2 * R
    x, inp = _inputs(n, n_alloc, sel)
    build = getattr(jax_legacy, f"_build_{scenario}")(var, n_alloc, n)
    if var not in ("base", "grid2", "nosmem", "scratchthr"):
        build = with_sel(build, sel)
    if narrow:
        want = {"out": build(jnp.asarray(x))}
    else:
        r, s, v = build(jnp.asarray(x), jnp.asarray(np.full_like(
            x, SENTINEL)))
        want = {"out": r, "scratch": s, "value": v}
    return want, _port(*tl.CASES[(scenario, var)], inp)


PART45 = [("part4", v) for v in ("base", "grid2", "smem", "alias2",
                                  "nsplit")] + [
    ("part5", v) for v in ("uncond", "when", "dynoff", "pred")]
CASES45 = [(sc, v, sel) for sc, v in PART45 for sel in (
    (None, ODD, NAN_RIGHT) if (sc, v) in READS_S0_CNT else (None,))]


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("scenario,var,sel", CASES45)
def test_compaction_matches_part4_part5(jax_legacy, n, scenario, var, sel):
    sel = tl.script_sel(n) if sel is None else sel
    want, got = _compact_case(jax_legacy, scenario, var, n, sel)
    _same(got["rows"], want["out"])
    if var in ("alias2", "nsplit"):
        _same(got["scratch"], want["scratch"])
    nsplit = int(got["nsplit"][0]) if got["nsplit"] is not None else 0
    assert float(got["rows"][0, 0]) + nsplit == float(want["value"])


# part6 and part7 run with n_alloc = n; the descriptors that differ from
# the script's: a cnt that takes smemuse's dead branch, and a threshold
# of 100 for the variants that read sel[3]
THR100 = (0, 2048, 3, 100, 1, 0, -1, 0)
SHORT = (0, 700, 3, 127, 1, 0, -1, 0)
CASES67 = ([("part6", v, None) for v in ("nosmem", "smem", "smemuse",
                                         "prefetch")]
           + [("part6", "smemuse", SHORT)]
           + [("part7", v, None) for v in ("nosmem", "deadsel", "scratchthr",
                                           "smem", "noalias", "hbmsel")]
           + [("part7", v, THR100) for v in ("smem", "noalias", "hbmsel")])


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("scenario,var,sel", CASES67)
def test_compaction_matches_part6_part7(jax_legacy, n, scenario, var, sel):
    sel = tl.script_sel(n) if sel is None else sel
    want, got = _compact_case(jax_legacy, scenario, var, n, sel)
    if var == "noalias":
        w = lp.compact_ref("noalias", got["rows"], n // R, sel)[2]
        _same(got["out"][:w], np.asarray(want["out"])[:w])
        assert np.isnan(np.asarray(want["out"])[w:]).all()
    else:
        _same(got["out"], want["out"])


@pytest.mark.parametrize("var", ["nosmem", "deadsel", "smem"])
def test_part8_variants_are_part7s(jax_legacy, var):
    """part8 re-times part7's builders: the same outputs through its
    case table."""
    n = 2048
    want, got = _compact_case(jax_legacy, "part7", var, n, tl.script_sel(n))
    _, inp = _inputs(n, n, tl.script_sel(n))
    _same(_port(*tl.CASES[("part8", var)], inp)["out"], want["out"])


@pytest.mark.parametrize("kind", tl.ADVERSARIAL)
@pytest.mark.parametrize("scenario,var", [("part4", "base"),
                                          ("part4", "nsplit"),
                                          ("part5", "pred")])
def test_compaction_adversarial_inputs(jax_legacy, kind, scenario, var):
    """Tile 0 keeping nothing and the rest everything, the reverse, one
    kept row a block, T a whole number of blocks and one off it."""
    n, n_alloc = 4096, 4096 + 2 * R
    rows = tl.adversarial_rows(kind, n, n_alloc, "cpu")
    x = rows.numpy().copy()
    inp = tl.Inputs(rows, tl.script_sel(n), n, scratch_fill=SENTINEL)
    r, s, v = getattr(jax_legacy, f"_build_{scenario}")(var, n_alloc, n)(
        jnp.asarray(x), jnp.asarray(np.full_like(x, SENTINEL)))
    got = _port(*tl.CASES[(scenario, var)], inp)
    _same(got["rows"], r)
    _same(got["scratch"], s)


def test_compact_keeps_whole_groups_and_flushes():
    """The closed form on a hand-made case: 700 kept rows write one
    group in place; nsplit writes all 700 and zeros to 1024."""
    n = 2048
    rows = torch.full((n, C), 200.0)
    rows[:, 0] = torch.arange(n, dtype=torch.float32)
    kept = torch.arange(1, 1401, 2)
    rows[kept, 3] = 5.0
    out, _, w = lp.compact_ref("nosmem", rows.clone(), n // R)
    assert w == 512 and torch.equal(out[:512, 0], kept[:512].float())
    assert torch.equal(out[512:], rows[512:])
    scratch = torch.full_like(rows, SENTINEL)
    out, nsplit, w = lp.compact_ref("nsplit", rows, n // R,
                                    tl.script_sel(n), scratch)
    assert w == 700 and int(nsplit[0]) == 700
    assert torch.equal(out[:700, 0], kept.float())
    assert bool((out[700:1024] == 0).all())
    assert bool((out[1024:] == SENTINEL).all())


# -- T8: hbm_alias -------------------------------------------------------------
def test_hbm_alias_script_and_port(jax_legacy, monkeypatch, capsys):
    monkeypatch.setenv("REPS", "2")
    jax_legacy.hbm_alias()
    out = capsys.readouterr().out
    assert "single call, unaligned dynamic offsets: OK" in out
    assert "while_loop carried aliased buffer: OK" in out
    assert tl.alias_check([(12345, 54321)], "cpu")
    assert tl.alias_check(tl.CHAIN, "cpu")


@pytest.mark.parametrize("src,dst", [(100, 612), (612, 100), (0, 0),
                                     (64512, 0), (3, 1026)])
def test_hbm_alias_overlapping_windows(src, dst):
    """dst > src and dst < src inside one window read the old rows."""
    assert tl.alias_check([(src, dst)], "cpu")
    with pytest.raises(Exception):
        lp.hbm_alias_step(torch.zeros((lp.ALIAS_N, C)), 64513, 0)


# -- the tool on the CPU ---------------------------------------------------------
@pytest.mark.parametrize("scenario", list(tl.SCENARIOS))
def test_tool_runs_every_scenario_on_the_cpu(monkeypatch, capsys, scenario):
    monkeypatch.setenv("PN", "11")
    monkeypatch.setenv("REPS", "1")
    if scenario == "part7":
        monkeypatch.setenv("VAR", ",".join(tl.SCENARIOS["part7"][4]))
    assert tl.main([scenario, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    res = __import__("json").loads(out.strip().splitlines()[-1])
    assert res["launches"] == res["expected_launches"] == dict.fromkeys(
        tl.KERNELS, 0)
    assert res["clock"] == "host (perf_counter)"
    if scenario.startswith("part"):
        assert [r["variant"] for r in res["rows"]] == res["variants"]
        assert "us/blk" in out and "us/call" in out and "ns/row" in out


def test_tool_rejects_unknown_variants(monkeypatch):
    monkeypatch.setenv("VAR", "copy,dma")
    with pytest.raises(SystemExit):
        tl.main(["part3", "--device", "cpu"])


def test_expected_launches_on_the_card():
    got = tl.expected_launches("part3", ("copy", "scan", "full"), 30)
    per = 1 + tl.WARMUP + 30 + 60
    assert got == {"block_copy": per, "partition_dense": 2 * per,
                   "compact": 0, "hbm_alias_step": 0}
    assert tl.expected_launches("hbm_alias", (), 200)["hbm_alias_step"] \
        == 9 + tl.WARMUP + 600
