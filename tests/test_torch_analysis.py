"""The port's static analyzer (``lightgbm_tpu_torch/analysis``) on the CPU.

Each red-team fixture is flagged by its pass with exactly its codes; the
clean run exits 0 against the checked-in resource report; the allowlist,
the JSON schema and the CLI's exit codes are pinned; the analyzer builds
and launches nothing; the resource parsers read real ``cuobjdump
-res-usage`` and ``ptxas -v`` output of this package's libraries
(``tests/data/torch_analysis``, from an H100 build) and name its mangled
symbols as ``cu++filt`` spells them; and the
analyzer agrees with the JAX package's: the fixtures' geometry, the
routing matrix on every key both can express (the shape gates, shared
memory here and VMEM there, are the documented exception), and the host
passes on their two fixtures.  The JAX side only builds, traces or parses
its fixtures: its lane pass is not asked to flag anything.
"""
import ast
import json
import os
import re
from pathlib import Path

import jax
import numpy as np
import pytest

from lightgbm_tpu_torch.analysis import allowlist as al
from lightgbm_tpu_torch.analysis import fixtures as fx
from lightgbm_tpu_torch.analysis import registry
from lightgbm_tpu_torch.analysis import resources as res
from lightgbm_tpu_torch.analysis.__main__ import main as cli
from lightgbm_tpu_torch.analysis.astutil import (PyModule, cuda_kernels,
                                                 strip_cuda)
from lightgbm_tpu_torch.analysis.entries import FIXTURE_STAGE_LEGAL
from lightgbm_tpu_torch.analysis.findings import SCHEMA, Finding
from lightgbm_tpu_torch.analysis.passes import async_copy
from lightgbm_tpu_torch.analysis.registry import KernelEntry, TensorArg
from lightgbm_tpu_torch.analysis.run import (PASS_NAMES, build_context,
                                             run_analysis)
from lightgbm_tpu_torch.ops import analysis_fixtures as taf
from lightgbm_tpu_torch.ops import routing as troute

DATA = Path(__file__).parent / "data" / "torch_analysis"
REPO = Path(__file__).resolve().parent.parent
# every pass but purity, whose pins train on the CPU
FAST = [p for p in PASS_NAMES if p != "purity"]


def _codes(report, fixture: bool):
    return {f.code for f in report.findings
            if f.fixture == fixture and not f.allowlisted}


# -- fixtures -----------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(fx.FIXTURES))
def test_fixture_flagged_with_exactly_its_codes(name):
    passes = PASS_NAMES if name == "bad_purity" else FAST
    report = run_analysis(passes=passes, fixtures=[name])
    assert _codes(report, fixture=True) == fx.EXPECTED[name]
    assert report.failing()


def test_every_pass_has_a_fixture():
    bundles = {name: fx.load(name) for name in fx.FIXTURES}
    by_pass = {
        "align": [n for n, b in bundles.items() if b.entries],
        "smem": ["bad_vmem"],
        "async-copy": [n for n, b in bundles.items() if b.cuda_files],
        "host": [n for n, b in bundles.items() if b.py_modules],
        "purity": [n for n, b in bundles.items() if b.pins],
        "routing": [n for n, b in bundles.items() if b.routing_cells],
    }
    assert set(by_pass) == set(PASS_NAMES)
    assert all(by_pass.values())


def test_clean_run_exits_zero(capsys):
    assert cli([]) == 0
    out = capsys.readouterr().out
    assert " 0 error(s), 0 warning(s)" in out


def test_analyzer_builds_and_launches_nothing(monkeypatch):
    from lightgbm_tpu_torch.ops import _build

    def refuse(*a, **k):
        raise AssertionError("the analyzer built or loaded a kernel")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    report = run_analysis(fixtures=sorted(fx.FIXTURES))
    assert {f.code for f in report.findings if f.fixture} == set().union(
        *fx.EXPECTED.values())
    assert not [f for f in report.findings
                if not f.fixture and not f.allowlisted]


def test_no_module_of_the_port_imports_jax():
    pkg = REPO / "lightgbm_tpu_torch"
    for path in pkg.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "lightgbm_tpu"), \
                    (path, n)


# -- allowlist ----------------------------------------------------------------
def test_allowlist_round_trips(tmp_path):
    entries = al.load()
    assert entries and all(e.justification for e in entries)
    path = tmp_path / "allow.json"
    al.dump(entries, str(path))
    again = al.load(str(path))
    assert [(e.pass_name, e.code, e.match, e.justification)
            for e in again] == [(e.pass_name, e.code, e.match,
                                 e.justification) for e in entries]


def test_allowlist_justifications_name_a_roadmap_item():
    for e in al.load():
        assert "ROADMAP A" in e.justification, e.match


@pytest.mark.parametrize("just", ["", "   "])
def test_allowlist_requires_a_justification(tmp_path, just):
    path = tmp_path / "allow.json"
    path.write_text(json.dumps({
        "schema": al.ALLOWLIST_SCHEMA,
        "entries": [{"pass": "host", "code": "HOST_PULL_IN_LOOP",
                     "match": "x", "justification": just}]}))
    with pytest.raises(al.AllowlistError):
        al.load(str(path))
    assert cli(["--allowlist", str(path), "--passes", "host"]) == 2


def test_allowlist_unused_entry_is_reported(tmp_path):
    entries = al.load() + [al.AllowEntry("align", "ALIGN_ROW_STRIDE",
                                         "entry:nothing", "kept for a test")]
    path = tmp_path / "allow.json"
    al.dump(entries, str(path))
    report = run_analysis(passes=None, allowlist_path=str(path))
    unused = [f for f in report.findings if f.code == "ALLOWLIST_UNUSED"]
    assert [f.where for f in unused] == [
        "align:ALIGN_ROW_STRIDE:entry:nothing"]


def test_allowlist_never_covers_fixtures(tmp_path):
    path = tmp_path / "allow.json"
    al.dump(al.load() + [al.AllowEntry("align", "ALIGN_ROW_STRIDE",
                                       "entry:fixture_bad_lane",
                                       "tries to hide the red team")],
            str(path))
    report = run_analysis(passes=FAST, fixtures=["bad_lane"],
                          allowlist_path=str(path))
    seeded = [f for f in report.findings if f.fixture]
    assert seeded and not any(f.allowlisted for f in seeded)


# -- JSON schema and CLI ------------------------------------------------------
def test_json_schema_key_set_is_pinned(capsys):
    assert cli(["--json", "--passes", "align,host", "--fixture",
                "bad_lane"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["schema"] == SCHEMA == "lightgbm_tpu_torch/analysis/v1"
    assert set(doc) == {"schema", "strict", "passes", "entries",
                        "findings", "summary"}
    assert set(doc["summary"]) == {"errors", "warnings", "allowlisted"}
    assert set(doc["findings"][0]) == {
        "pass_name", "code", "severity", "where", "message", "file",
        "line", "entry", "fixture", "allowlisted", "justification"}
    assert set(Finding("p", "C", "error", "w", "m").to_json()) == set(
        doc["findings"][0])


@pytest.mark.parametrize("argv,rc", [
    (["--passes", "align,smem,async-copy,host,routing"], 0),
    (["--passes", "align", "--fixture", "bad_lane"], 1),
    (["--passes", "host", "--fixture", "bad_lane"], 0),   # blind: gate fails
    (["--passes", "nosuchpass"], 2),
    (["--fixture", "nosuchfixture"], 2),
    (["--passes", "smem", "--strict", "--resources", "MISSING"], 2),
])
def test_cli_exit_codes(argv, rc, tmp_path, monkeypatch):
    argv = [str(tmp_path / a) if a == "MISSING" else a for a in argv]
    assert cli(argv) == rc


def test_strict_fails_on_a_stale_report(tmp_path):
    text = res.DEFAULT_REPORT.read_text().replace(
        f"\t{res.library_digest('hist_comb')}", "\t000000000000")
    path = tmp_path / "res.txt"
    path.write_text(text)
    report = run_analysis(passes=["smem"], resources=str(path))
    stale = [f for f in report.findings if f.code == "RESOURCES_STALE"]
    assert [f.where for f in stale] == ["resources:hist_comb"]
    assert stale[0].severity == "warning"
    assert cli(["--passes", "smem", "--resources", str(path)]) == 0
    assert cli(["--passes", "smem", "--strict", "--resources",
                str(path)]) == 1


def test_list_names_every_entry(capsys):
    assert cli(["--list"]) == 0
    out = capsys.readouterr().out
    for name in registry.collect():
        assert name in out
    assert "purity pin" in out


# -- the passes on synthetic entries ---------------------------------------
def _entry(**kw):
    base = dict(name="synthetic", source="serve_traverse",
                symbol="sum_tiles", grid=(1, 1, 1), block=(256, 1, 1),
                dyn_smem=0)
    base.update(kw)
    return KernelEntry(**base)


def _run_on(entries, passes, resources=None):
    from lightgbm_tpu_torch.analysis.passes import PASSES
    ctx = build_context()
    ctx.entries = entries
    if resources is not None:
        ctx.resources = resources
    out = []
    for p in passes:
        out += PASSES[p].run(ctx)
    return {f.code for f in out}


@pytest.mark.parametrize("arg,codes", [
    (TensorArg("x", "uint8", (10, 64), 64, 16), set()),
    (TensorArg("x", "uint8", (10, 56), 56, 16), {"ALIGN_ROW_STRIDE"}),
    (TensorArg("x", "uint8", (10, 64), 64, 16, base_offset=8),
     {"ALIGN_BASE_OFFSET"}),
    (TensorArg("x", "uint8", (10, 30), 30, 4, base_offset=2),
     {"ALIGN_ROW_STRIDE", "ALIGN_BASE_OFFSET"}),
    (TensorArg("x", "uint8", (10, 28), 28, 1), set()),
])
def test_align_rule(arg, codes):
    assert _run_on([_entry(args=(arg,))], ["align"]) == codes


def test_smem_rules():
    # sum_tiles has no opt-in: 64 KB dynamic is refused at launch
    assert _run_on([_entry(dyn_smem=64 * 1024)], ["smem"]) == {
        "SMEM_OPTIN_MISSING"}
    # hist_comb opts in; 200 KB is past 80 % of the budget
    near = _entry(source="hist_comb", symbol="hist_comb_partial<CombRows>",
                  dyn_smem=200 * 1024)
    assert _run_on([near], ["smem"]) == {"SMEM_NEAR_BUDGET"}
    full = _entry(source="hist_comb", symbol="hist_comb_partial<CombRows>",
                  dyn_smem=232448)        # + 0 B static: exactly fits
    assert _run_on([full], ["smem"]) == {"SMEM_NEAR_BUDGET"}
    over = _entry(source="hist_comb", symbol="hist_comb_partial<CombRows>",
                  dyn_smem=232449)
    assert _run_on([over], ["smem"]) == {"SMEM_OVER_BUDGET"}
    missing = _entry(symbol="no_such_kernel")
    assert _run_on([missing], ["smem"]) == {"RESOURCES_NO_SYMBOL"}


@pytest.mark.parametrize("source,symbol,grid,cluster,codes", [
    # the split tail's cluster of 16 opts in to non-portable sizes
    ("apply_find", "apply_find_kernel<true>", (16, 1, 1), 16, set()),
    ("apply_find", "apply_find_kernel<false>", (14, 1, 1), 14, set()),
    # sum_tiles sets no cudaFuncAttributeNonPortableClusterSizeAllowed
    ("serve_traverse", "sum_tiles", (16, 1, 1), 16,
     {"CLUSTER_OPTIN_MISSING"}),
    ("serve_traverse", "sum_tiles", (8, 1, 1), 8, set()),
    ("apply_find", "apply_find_kernel<true>", (17, 1, 1), 17,
     {"CLUSTER_OVER_LIMIT"}),
    ("legacy_probes", "hbm_alias_step", (12, 1, 1), 8, {"CLUSTER_GRID"}),
])
def test_cluster_rules(source, symbol, grid, cluster, codes):
    """A cluster launch: at most 16 blocks, above 8 only with the
    kernel's non-portable opt-in in its source, and whole clusters."""
    e = _entry(source=source, symbol=symbol, grid=grid, cluster=cluster)
    assert _run_on([e], ["smem"]) == codes


def test_cluster_opt_in_is_read_from_the_source():
    from lightgbm_tpu_torch.analysis.passes.smem import (_CLUSTER_OPTIN,
                                                         opted_in)
    assert opted_in("apply_find", _CLUSTER_OPTIN) == {
        "apply_find_kernel", "apply_find_mono_kernel"}
    assert opted_in("legacy_probes", _CLUSTER_OPTIN) == set()
    assert "apply_find_kernel" in opted_in("apply_find")


def test_register_rules():
    report = res.load_report()
    su = report["serve_traverse"]
    heavy = dict(su.kernels, sum_tiles=res.Usage(
        regs=255, spill_stores=8, spill_loads=8))
    resources = dict(report, serve_traverse=res.SourceUsage(
        "serve_traverse", su.digest, heavy))
    assert _run_on([_entry(block=(1024, 1, 1))], ["smem"], resources) == {
        "REGS_OVER_BUDGET", "REGS_SPILL"}


def test_registered_entries_are_clean_and_cover_every_kernel():
    kernels = registry.collect()
    report = res.load_report()
    assert _run_on(list(kernels.values()), ["align", "smem"]) == set()
    registered = {(e.source, e.symbol) for e in kernels.values()}
    built = {(s, sym) for s, su in report.items() for sym in su.kernels}
    assert registered <= built
    # header kernels compiled into a library that never launches them
    assert built - registered == {("fused_split", "part::copy_span"),
                                  ("partition", "part::count_tiles"),
                                  ("partition_3ph", "part::count_tiles"),
                                  ("partition_3ph", "part::copy_span")}


# -- resources ----------------------------------------------------------------
# mangled symbols of the samples and cu++filt's spelling of them (H100
# build, CUDA 12)
_PART = "_ZN45_GLOBAL__N__8ae9b614_12_partition_cu_5803b2f7"
_AF = "_ZN46_GLOBAL__N__c2ba4d7c_13_apply_find_cu_0002d5dd"
FILT = {
    f"{_PART}17partition_scatterIN4part6RecPtrEEEvT_S3_iNS1_5SplitEPKiPi":
        "void <unnamed>::partition_scatter<part::RecPtr>(T1, T1, int, "
        "part::Split, const int *, int *)",
    f"{_PART}17partition_scatterIN4part7RowPtrsEEEvT_S3_iNS1_5SplitEPKiPi":
        "void <unnamed>::partition_scatter<part::RowPtrs>(T1, T1, int, "
        "part::Split, const int *, int *)",
    f"{_PART}12copy_recordsEN4part6RecPtrES1_ii":
        "<unnamed>::copy_records(part::RecPtr, part::RecPtr, int, int)",
    "_ZN4part9copy_spanENS_7RowPtrsES0_iii":
        "part::copy_span(part::RowPtrs, part::RowPtrs, int, int, int)",
    "_ZN4part11count_tilesEPKhiNS_5SplitEPi":
        "part::count_tiles(const unsigned char *, int, part::Split, int *)",
    f"{_AF}17apply_find_kernelILb0EEEvNS_4ArgsE":
        "void <unnamed>::apply_find_kernel<(bool)0>(<unnamed>::Args)",
    f"{_AF}17apply_find_kernelILb1EEEvNS_4ArgsE":
        "void <unnamed>::apply_find_kernel<(bool)1>(<unnamed>::Args)",
}
(_SCATTER_REC, _SCATTER_ROWS, _COPY_REC, _COPY_SPAN, _COUNT, _AF0,
 _AF1) = FILT


def test_parse_res_usage_sample():
    usages = res.parse_res_usage(
        (DATA / "res_usage_partition.txt").read_text())
    assert set(usages) == set(list(FILT)[:5])
    assert usages[_SCATTER_REC] == res.Usage(
        regs=38, smem=1056, stack=0, local=0)
    assert usages[_SCATTER_ROWS].regs == 32
    assert usages[_COPY_REC].smem == 0
    assert usages[_COUNT].smem == 32      # SHARED:1056 - 1 KB
    af = res.parse_res_usage(
        (DATA / "res_usage_apply_find.txt").read_text())
    assert af[_AF1] == res.Usage(regs=50, smem=528, stack=56, local=0)
    assert af[_AF0].regs == 60


def test_by_symbol_keys_by_the_normalised_cu_filt_name(monkeypatch):
    monkeypatch.setattr(res, "demangle_with_filt",
                        lambda names: {m: FILT[m] for m in names})
    by = res.by_symbol(res.parse_res_usage(
        (DATA / "res_usage_partition.txt").read_text())
        | res.parse_res_usage(
            (DATA / "res_usage_apply_find.txt").read_text()))
    assert set(by) == {
        "partition_scatter<part::RecPtr>", "partition_scatter<part::RowPtrs>",
        "copy_records", "part::copy_span", "part::count_tiles",
        "apply_find_kernel<false>", "apply_find_kernel<true>"}
    assert by["partition_scatter<part::RecPtr>"].regs == 38
    assert by["apply_find_kernel<true>"].stack == 56


def test_by_symbol_needs_cu_filt(monkeypatch):
    monkeypatch.setattr(res, "cuda_tool", lambda name: None)
    with pytest.raises(FileNotFoundError, match="cu\\+\\+filt"):
        res.by_symbol({_COUNT: res.Usage()})


@pytest.mark.parametrize("filt,name", [
    (FILT[_SCATTER_REC], "partition_scatter<part::RecPtr>"),
    (FILT[_COPY_REC], "copy_records"),
    (FILT[_COUNT], "part::count_tiles"),
    (FILT[_AF0], "apply_find_kernel<false>"),
    (FILT[_AF1], "apply_find_kernel<true>"),
    ("void <unnamed>::hist_comb_partial<<unnamed>::CombRows>(T1, const "
     "int *, int, int, int, float *)", "hist_comb_partial<CombRows>"),
    ("void <unnamed>::hist_rows_partial<unsigned short>(const T1 *, const "
     "float *, const int *, const int *, int, int, int, int, float *)",
     "hist_rows_partial<unsigned short>"),
    ("histblock::reduce_partials(const float *, int, int, int, float *)",
     "histblock::reduce_partials"),
])
def test_normalise_cu_filt_spelling(filt, name):
    assert res.normalise(filt) == name


def test_parse_ptxas_sample_agrees_with_cuobjdump():
    for name in ("partition", "apply_find"):
        ptx = res.parse_ptxas((DATA / f"ptxas_{name}.txt").read_text())
        cub = res.parse_res_usage(
            (DATA / f"res_usage_{name}.txt").read_text())
        assert set(ptx) == set(cub)
        for sym, u in ptx.items():
            assert (u.regs, u.smem, u.stack) == (
                cub[sym].regs, cub[sym].smem, cub[sym].stack), sym
            assert u.spill_stores == u.spill_loads == 0


def test_parse_ptxas_counts_spills():
    text = ("ptxas info    : Compiling entry function '_Z1kPf' for "
            "'sm_90a'\nptxas info    : Function properties for _Z1kPf\n"
            "    24 bytes stack frame, 16 bytes spill stores, 12 bytes "
            "spill loads\nptxas info    : Used 255 registers, used 1 "
            "barriers, 4096 bytes smem, 368 bytes cmem[0]\n")
    assert res.parse_ptxas(text) == {"_Z1kPf": res.Usage(
        regs=255, smem=4096, stack=24, local=0, spill_stores=16,
        spill_loads=12)}


def test_report_round_trips():
    text = res.DEFAULT_REPORT.read_text()
    rep = res.parse_report(text)
    assert set(rep) == set(__import__(
        "lightgbm_tpu_torch.ops._build", fromlist=["SOURCES"]).SOURCES)
    again = res.parse_report(res.format_report(rep))
    assert again == rep


def test_checked_in_report_is_current():
    stale, missing = res.stale_sources(res.load_report())
    assert stale == [] and missing == []


# -- the CUDA scanner ------------------------------------------------------
SCAN_SRC = '''// cp.async.commit_group in a comment
/* __pipeline_commit(); cp.async.wait_all */
__global__ void __launch_bounds__(128) k(const float* x, float* o) {
  printf("cp.async.commit_group %d", 1);
  const char c = '"';
  o[0] = x[0];
}
__global__ void a(float* o) {
  asm volatile("cp.async.commit_group;\\n" ::);
}
'''


def test_cuda_scanner_ignores_comments_and_strings():
    stripped = strip_cuda(SCAN_SRC)
    assert len(stripped) == len(SCAN_SRC)
    assert stripped.count("\n") == SCAN_SRC.count("\n")
    kernels = cuda_kernels(stripped)
    assert [k.name for k in kernels] == ["k", "a"]
    assert async_copy.check_kernel(kernels[0].body, 3) == []
    # the asm string stays: a commit with no wait
    assert [c for c, _, _ in async_copy.check_kernel(kernels[1].body, 8)] \
        == ["ASYNC_UNPAIRED_COMMIT"]


def test_async_copy_is_clean_on_the_port():
    assert _run_on([], ["async-copy"]) == set()


FUSED_SRC = REPO / "lightgbm_tpu_torch" / "csrc" / "fused_split.cu"


def _fused_hist_findings(text: str):
    stripped = strip_cuda(text)
    helpers = async_copy.device_helpers(stripped)
    kernel = next(k for k in cuda_kernels(stripped) if k.name == "fused_hist")
    return helpers, async_copy.check_kernel(kernel.body, kernel.body_line,
                                            helpers)


def test_async_copy_follows_the_fused_splits_helpers():
    """fused_hist starts, commits and waits for its cp.async copies only
    through helpers: the pass sees each, and where a helper's copy
    lands."""
    helpers, found = _fused_hist_findings(FUSED_SRC.read_text())
    assert helpers["cp_async16"].events == (("start", 0),)
    assert helpers["copy_bytes"].events == (("start", 2),)
    assert helpers["issue_stage"].events == (("start", 8),)
    assert helpers["issue_stage"].params[8] == "s"
    assert helpers["cp_async_commit"].events == (("commit", None),)
    assert helpers["cp_async_wait"].events == (("wait", None),)
    assert found == []


def test_async_copy_catches_fused_hist_reading_its_refill():
    """The ring's stage taken after the refill starts (the pass reads
    names, so this reads the refill's destination in flight) is caught
    in fused_hist; without the ring's wait, so is the commit."""
    text = FUSED_SRC.read_text()
    take = "    const uint8_t* s = ring + (k % kStages) * sb;\n"
    commit = ("                  ring + (kn % kStages) * sb);\n"
              "    cp_async_commit();\n")
    assert text.count(take) == 1 and text.count(commit) == 1
    moved = text.replace(take, "").replace(commit, commit + take)
    _, found = _fused_hist_findings(moved)
    assert [c for c, _, _ in found] == ["ASYNC_READ_BEFORE_WAIT"]
    assert "'ring'" in found[0][2]
    unwaited = re.sub(r"cp_async_wait<[^>]*>\(\);", ";", text)
    _, found = _fused_hist_findings(unwaited)
    assert "ASYNC_UNPAIRED_COMMIT" in [c for c, _, _ in found]


def test_bad_async_fixture_catches_a_ring_refill_through_helpers():
    report = run_analysis(passes=["async-copy"], fixtures=["bad_async"])
    flagged = {(f.where.split(":")[1], f.code) for f in report.findings
               if f.fixture}
    assert ("refill_before_wait_kernel", "ASYNC_READ_BEFORE_WAIT") in flagged
    assert len(flagged) == 4


def test_host_pass_scopes():
    ctx = build_context()
    roles = {m.rel: m.role for m in ctx.py_modules}
    assert roles["lightgbm_tpu_torch/ops/grow.py"] == "loop"
    assert roles["lightgbm_tpu_torch/ops/hist_kernel2.py"] == "wrappers"
    wrappers = {fn for m in ctx.py_modules if m.role == "wrappers"
                for fn, _, _ in PyModule(m.path, "wrappers").hits()}
    assert wrappers == set()         # no kernel wrapper reads the card


# -- parity with the JAX package -------------------------------------------
JAX_FIXTURE = {"F1": "bad_lane", "F3": "bad_cat", "F4": "bad_serve_kernel",
               "F5": "bad_mc_batch"}


def _jax_pallas(name):
    """(arg shape, dtype, grid, staged rows) of a JAX fixture's kernel,
    from its own builder, traced (nothing executes)."""
    from lightgbm_tpu.analysis import fixtures as jfx
    fn, args = jfx.load(name).entries[0].builder()
    jaxpr = jax.make_jaxpr(fn)(*args)
    eqn = next(e for e in jaxpr.eqns if e.primitive.name == "pallas_call")
    scratch = [v.aval.shape for v in eqn.params["jaxpr"].invars][2]
    return (tuple(args[0].shape), np.dtype(args[0].dtype),
            tuple(eqn.params["grid_mapping"].grid), scratch)


@pytest.mark.parametrize("fid", sorted(JAX_FIXTURE))
def test_seeded_stage_geometry_matches_the_jax_fixture(fid):
    name = JAX_FIXTURE[fid]
    shape, dtype, grid, scratch = _jax_pallas(name)
    seeded = fx.load(name).entries[0]
    legal = registry.collect()[{
        "F1": "fixture_lane", "F3": "fixture_cat", "F4": "fixture_serve",
        "F5": "fixture_mc_batch"}[fid]]
    for e in (seeded, legal):
        src = e.args[0]
        assert np.dtype(src.dtype) == dtype
        assert src.shape[:-1] == shape[:-1]
        assert e.grid[0] == (grid[0] if grid else 1)
        # rows staged a block: the JAX kernel's VMEM staging rows
        assert e.dyn_smem == scratch[-2] * src.row_stride
    assert taf.stage_rule_broken(seeded.args[0].row_stride)
    assert not taf.stage_rule_broken(legal.args[0].row_stride)


def test_seeded_smem_matches_the_jax_vmem_fixture():
    from lightgbm_tpu.analysis import fixtures as jfx
    fn, args = jfx.load("bad_vmem").entries[0].builder()
    eqn = next(e for e in jax.make_jaxpr(fn)(*args).eqns
               if e.primitive.name == "pallas_call")
    acc = [v.aval for v in eqn.params["jaxpr"].invars][2]
    seeded = fx.load("bad_vmem").entries[0]
    assert seeded.dyn_smem == int(np.prod(acc.shape)) * 4
    assert seeded.grid[0] == eqn.params["grid_mapping"].grid[0] == 4
    assert tuple(seeded.args[0].shape) == tuple(args[0].shape)


def test_legal_geometries_are_the_table():
    names = {row[0] for row in FIXTURE_STAGE_LEGAL}
    assert names == {"fixture_lane", "fixture_cat", "fixture_serve",
                     "fixture_mc_batch"}


# the JAX key fields the port's RouteInputs cannot express, at the value
# under which the port's rules apply
_JAX_ONLY = {"learner": "serial", "shards": "1", "efb": "0", "over": "0",
             "ew": "0", "fdiv": "1", "cat": "0", "mono": "0",
             "cegbc": "0", "part": "permute", "ob": "0", "pg": "auto",
             "mcb": "auto"}


def _port_inputs(key: str):
    """The port's RouteInputs of a JAX golden key, or None when the key
    holds a fact the port cannot express."""
    kf = dict(p.split("=", 1) for p in key.split(";"))
    if any(kf.get(k, v) != v for k, v in _JAX_ONLY.items()):
        return None
    if (kf["be"], kf["phys"]) not in (("tpu", "auto"), ("tpu", "0"),
                                      ("cpu", "0"), ("cpu", "interpret")):
        return None
    return troute.RouteInputs(
        objective_kind=kf["obj"], boosting=kf["boost"],
        multi_tree=kf["k"] == "multi", bagging=kf["bag"] == "1",
        linear_tree=kf["lin"] == "1", gpu_use_dp=kf["dp"] == "1",
        bins_u8=kf["u8"] == "1",
        phys_env=kf["phys"], stream_env=kf["stream"],
        fused_env="1" if kf["fused"] == "1" else "0",
        part_env=kf["impl"], pack_env=kf["pack"],
        wide_layout=kf["wide"] == "1", cegb=kf["cegb"] == "1",
        cegb_lazy=kf["cegb"] == "1", forced_splits=kf["forced"] == "1")


def test_routing_matrix_matches_the_jax_golden():
    golden = json.loads((REPO / "lightgbm_tpu" / "analysis" /
                         "routing_matrix.json").read_text())["cells"]
    port = troute.enumerate_matrix()["cells"]
    fields = ("path", "pack", "scheme", "fused", "why")
    compared = in_port_matrix = 0
    for key, enc in golden.items():
        i = _port_inputs(key)
        if i is None:
            continue
        want = troute.decode_cell(enc)
        got = troute.decode_cell(troute.encode_cell(troute.decide(i)))
        assert {f: got[f] for f in fields} == {f: want[f] for f in fields}, \
            key
        if want["pack"] == "1" and i.pack_env == "2":
            assert got["pack_why"] == want["pack_why"], key
        compared += 1
        if i.key() in port:
            assert troute.decode_cell(port[i.key()]) == got
            in_port_matrix += 1
    assert compared >= 150 and in_port_matrix >= 60


def test_routing_matrix_dp_cells_take_row_order():
    """Every golden cell's key carries the ``dp`` fact; a ``dp=1`` cell
    takes the row-order path and names the ``gpu_use_dp`` rule, and the
    JAX golden's ``dp=1`` cells the port can express are compared by
    ``test_routing_matrix_matches_the_jax_golden``."""
    cells = json.loads(Path(troute.default_matrix_path()).read_text())[
        "cells"]
    assert all(";dp=0;" in k or ";dp=1;" in k for k in cells)
    dp = {k: troute.decode_cell(v) for k, v in cells.items()
          if ";dp=1;" in k}
    assert len(dp) >= 10
    for key, c in dp.items():
        assert c["path"] == "row_order" and "gpu_use_dp" in c["why"], key
    golden = json.loads((REPO / "lightgbm_tpu" / "analysis" /
                         "routing_matrix.json").read_text())["cells"]
    assert any("dp=1" in k.split(";") and _port_inputs(k) is not None
               for k in golden)


def test_port_matrix_golden_is_fresh():
    path = troute.default_matrix_path()
    assert Path(path).read_bytes() == troute.canonical_bytes(
        troute.enumerate_matrix())


def test_host_passes_flag_their_fixtures_in_both_packages():
    report = run_analysis(passes=["host"], fixtures=["bad_host"])
    ours = [f for f in report.findings if f.fixture]
    assert {f.code for f in ours} == {"HOST_PULL_IN_WRAPPER"}
    assert {f.message.split(" calls ")[1].split(":")[0] for f in ours} >= {
        ".item()", "np.asarray"}
    # the JAX package's host-sync pass on its own fixture file, parsed
    from lightgbm_tpu.analysis.astutil import rel_path
    from lightgbm_tpu.analysis.passes import host as jax_host
    from lightgbm_tpu.analysis.run import Context
    path = str(REPO / "lightgbm_tpu" / "analysis" / "fixtures" /
               "bad_host_ast.py")
    theirs = jax_host.run(Context(ast_files=[path],
                                  fixture_files={rel_path(path)}))
    assert {f.code for f in theirs} == {"HOST_PULL_IN_KERNEL"}
    assert all(f.fixture for f in theirs) and len(theirs) >= 2


def test_purity_pins_hold_and_the_leak_is_seen():
    from lightgbm_tpu_torch.analysis.passes import purity
    registry.collect()
    assert set(registry.PURITY_PINS) == {"pool-tail-explicit",
                                         "pack2-too-wide"}
    for name, variants in registry.PURITY_PINS.items():
        assert purity.check_pin(name, variants) == []
    before = os.environ.get("LGBM_TPU_COMB_PACK")
    program = purity.record(registry.PURITY_PINS["pack2-too-wide"]()[1][1])
    assert any(e.startswith("wrapper fused_split.fused_split ")
               for e in program)
    assert any(e.startswith("aten ") for e in program)
    assert os.environ.get("LGBM_TPU_COMB_PACK") == before


def test_cli_imports_neither_jax_nor_the_jax_package():
    import subprocess
    import sys
    code = ("import sys\n"
            "from lightgbm_tpu_torch.analysis.__main__ import main\n"
            "rc = main(['--passes', 'align,smem,async-copy,host,routing'])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lightgbm_tpu')]\n"
            "assert rc == 0 and not bad, (rc, bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def test_a_changed_routing_golden_is_stale(tmp_path):
    doc = troute.enumerate_matrix()
    key = next(iter(doc["cells"]))
    doc["cells"][key] = doc["cells"][key].replace("tail=kernel", "tail=xla")
    path = tmp_path / "matrix.json"
    path.write_bytes(troute.canonical_bytes(doc))
    report = run_analysis(passes=["routing"], routing_matrix_path=str(path))
    assert {f.code for f in report.findings} == {"ROUTING_MATRIX_STALE"}
    path.unlink()
    report = run_analysis(passes=["routing"], routing_matrix_path=str(path))
    assert {f.code for f in report.findings} == {"ROUTING_MATRIX_MISSING"}
