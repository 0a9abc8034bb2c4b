"""The port's analysis gate (``src/repro_torch/analysis``), on the CPU.

Fixture modules in ``tests/fixtures_torch_analysis/`` hold known
violations (they are parsed, never imported); each rule must fire on its
fixture and stay quiet on the compliant variants.  The ptxas parser reads
the committed record of the card's build and a synthetic report with
spills, too many registers and too much shared memory.  The clean tree
must pass its own gate: lint, capture and budget with no finding outside
``repro_torch/analysis/baseline.json``, every entry with a reason.  The
baseline, the report and the audit's coverage list are held against the
reference's (``repro.analysis``) on the same inputs.

The capture audit runs once, in a module-scope fixture (~70 s).
"""
import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import baseline as ref_baseline
from repro.analysis import report as ref_report
from repro.analysis.findings import Finding as RefFinding
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import capture_audit as ca
from repro_torch.analysis import kernel_budget as kb
from repro_torch.analysis.baseline import (apply_baseline, load_baseline,
                                           write_baseline)
from repro_torch.analysis.findings import RULES, Finding
from repro_torch.analysis.lint import CAPTURE_SEEDS, RepoLint, run_lint
from repro_torch.analysis.report import build_report
from repro_torch.kernels import _build
from repro_torch.kernels.shard_group import MAX_GROUP_SHARDS

REPO = Path(__file__).resolve().parents[1]
FIXTURES = "tests/fixtures_torch_analysis"
BASELINE = REPO / "src/repro_torch/analysis/baseline.json"


def lint_fixtures():
    return run_lint(REPO, src_dirs=(FIXTURES,), seeds=(), extra_files=())


def by_rule(findings, rule, suppressed=False):
    return [f for f in findings
            if f.rule == rule and f.suppressed == suppressed]


# ---------------------------------------------------------------------------
# findings model
# ---------------------------------------------------------------------------

def test_finding_key_is_line_independent():
    a = Finding("HOST-SYNC", "p.py", 10, "f", "m")
    b = Finding("HOST-SYNC", "p.py", 99, "f", "other")
    assert a.key == b.key == "HOST-SYNC|p.py|f"


def test_every_emitted_rule_is_registered():
    fs = lint_fixtures()
    fs += kb.check_kernels(kb.parse_ptxas(SYNTHETIC))[0]
    assert fs and {f.rule for f in fs} <= set(RULES)
    assert set(RULES) == {r for rules in cli.PASS_RULES.values()
                          for r in rules}
    assert all(isinstance(m, str) and m for m in RULES.values())


# ---------------------------------------------------------------------------
# the lint's rules on their fixtures
# ---------------------------------------------------------------------------

def test_host_sync_fires_on_every_kind_and_spares_eager_code():
    fs = [f for f in by_rule(lint_fixtures(), "HOST-SYNC")
          if f.path.endswith("bad_host_sync.py")]
    lines = {f.line for f in fs if f.symbol == "captured"}
    assert lines == set(range(15, 25))          # ten kinds, not the literal
    helper = [f for f in fs if f.symbol == "helper"]
    assert len(helper) == 1 and "called from" in helper[0].message
    assert not [f for f in fs if f.symbol in ("eager_only", "later")]
    kinds = " ".join(f.message for f in fs)
    for what in ("int()", "float()", "bool()", ".cpu()", "np.asarray",
                 ".tolist()", ".numpy()", ".nonzero()", "torch.nonzero",
                 "synchronize", ".item()"):
        assert what in kinds, what


def test_lint_seeds_torch_compile_references(tmp_path):
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "m.py").write_text(
        "import torch\n\n"
        "def f(x):\n    return x.item()\n\n"
        "g = torch.compile(f)\n")
    fs = run_lint(tmp_path, src_dirs=("pkg",), seeds=(), extra_files=())
    assert [(f.rule, f.symbol) for f in fs] == [("HOST-SYNC", "f")]


def test_silent_degrade_fires_and_spares_loud_handlers():
    fs = by_rule(lint_fixtures(), "SILENT-DEGRADE")
    names = {f.symbol for f in fs if f.path.endswith("bad_silent_degrade.py")}
    assert names == {"quiet_cuda", "quiet_launch", "quiet_library",
                     "quiet_handler"}


def test_kernel_route_fires_on_flag_env_error_and_no_test():
    fs = by_rule(lint_fixtures(), "KERNEL-ROUTE")
    why = {f.symbol: f.message for f in fs}
    assert set(why) == {"walk_by_flag", "walk_by_env", "walk_by_error",
                        "walk_unguarded"}
    assert "environment variable" in why["walk_by_env"]
    assert "except handler" in why["walk_by_error"]
    assert "`USE_PLAIN`" in why["walk_by_flag"]
    assert "no test" in why["walk_unguarded"]


def test_trace_ok_suppression_line_and_def_level():
    fs = [f for f in lint_fixtures() if f.path.endswith("suppressed_ok.py")]
    assert len(fs) == 3 and all(f.suppressed for f in fs)
    assert {f.reason for f in fs} == {
        "fixture line-level suppression",
        "fixture def-level suppression (covers the whole body)"}


def test_capture_seeds_name_functions_of_the_port():
    lint = RepoLint(REPO)
    missing = [q for q in CAPTURE_SEEDS if q not in lint.by_qual]
    assert not missing
    reach = set(lint.reachable())
    assert "repro_torch.core.skiplist:_search_loop" in reach
    assert "repro_torch.kernels._build:launch" in reach
    # eager-only tooling is not capture-reachable
    assert not [q for q in reach if q.startswith("repro_torch.analysis")]


def test_the_port_has_no_silent_degrade_or_kernel_route():
    fs = run_lint(REPO)
    bad = [f for f in fs if f.rule in ("SILENT-DEGRADE", "KERNEL-ROUTE")]
    assert not bad, "\n".join(f.render() for f in bad)


# ---------------------------------------------------------------------------
# the kernel budget: the ptxas record, a synthetic report, the estimator
# ---------------------------------------------------------------------------

def _sym(name, template=""):
    """An nvcc-style symbol in an anonymous namespace."""
    ns = "_GLOBAL__N__1a2b3c4d_11_synthetic_cu_5e6f7a8b"
    return f"_ZN{len(ns)}{ns}{len(name)}{name}{template}EPKi"


def _entry(symbol, regs, stack=0, st=0, ld=0, smem=""):
    return (f"ptxas info    : Compiling entry function '{symbol}' for "
            f"'sm_90a'\n"
            f"ptxas info    : Function properties for {symbol}\n"
            f"    {stack} bytes stack frame, {st} bytes spill stores, "
            f"{ld} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 1 barriers"
            f"{', ' + smem + ' bytes smem' if smem else ''}, 400 bytes "
            f"cmem[0]\n"
            f"ptxas info    : Compile time = 12.5 ms\n")


SYNTHETIC = (
    "# tag 000000000000: synthetic\n## traverse.cu\n"
    + _entry(_sym("foresight_kernel"), 255, 48, 40, 44)
    + _entry(_sym("clustered_tile_kernel", "ILb1EE"), 72, smem="16776")
    + "## shard_group.cu\n"
    + _entry(_sym("group_scan_kernel"), 40, smem="20000")
    + _entry(_sym("group_scatter_kernel", "ILb0EE"), 48, smem="150000"))


def test_ptxas_parser_reads_the_synthetic_report():
    usage = kb.parse_ptxas(SYNTHETIC)
    assert set(usage) == {"foresight_kernel", "clustered_tile_kernel<true>",
                          "group_scan_kernel", "group_scatter_kernel<false>"}
    k = usage["foresight_kernel"]
    assert (k.registers, k.spill_stores, k.spill_loads, k.stack,
            k.smem_static, k.source) == (255, 40, 44, 48, 0, "traverse.cu")
    assert usage["clustered_tile_kernel<true>"].smem_static == 16776
    assert kb.record_tag(SYNTHETIC) == "000000000000"


def test_budget_rules_fire_on_the_synthetic_report():
    fs, rows = kb.check_kernels(kb.parse_ptxas(SYNTHETIC))
    got = {(f.rule, f.symbol) for f in fs}
    # spills; 72 x 1024 threads > 65,536; 20,000 static + the scan's
    # 32,772 dynamic > 48 KiB; 150,000 + 90,120 > 227 KiB
    assert ("REG-SPILL", "foresight_kernel") in got
    assert ("REG-BUDGET", "clustered_tile_kernel<true>") in got
    assert ("SMEM-BUDGET", "group_scan_kernel") in got
    assert ("SMEM-BUDGET", "group_scatter_kernel<false>") in got
    assert ("REG-BUDGET", "foresight_kernel") not in got   # 255 x 256 fits
    # the kernels of csrc/ the report lacks are stale
    stale = {f.symbol for f in fs if f.rule == "BUDGET-STALE"}
    assert "validated_kernel" in stale and "foresight_kernel" not in stale
    row = {r["kernel"]: r for r in rows}["group_scatter_kernel<false>"]
    assert row["smem_dynamic_max"] == 90120 and row["threads"] == 256


def test_the_committed_record_is_todays_build_and_names_every_kernel():
    text = kb.RECORD_PATH.read_text()
    assert kb.record_tag(text) == _build.source_tag()
    assert "-Xptxas=-v" in _build.NVCC_FLAGS
    usage = kb.parse_ptxas(text)
    sources = kb.kernel_sources(REPO / "src/repro_torch/csrc")
    assert {k.base for k in usage.values()} == set(sources)
    assert len(usage) == 27         # two instances of four templates,
    #                                 four each of the update kernel's
    #                                 and the rebalance kernel's, three
    #                                 of the search walk's
    for k in usage.values():
        assert 0 < k.registers <= 255 and k.source.endswith(".cu")
    fs, _, rows = kb.run_budget(live=False)
    assert {f.rule for f in fs} <= {"REG-SPILL"}
    assert len(rows) == 27 and all(r["blocks_per_sm"] >= 1 for r in rows)


def test_budget_stale_fires_on_another_hash_and_a_missing_record(
        monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "source_tag", lambda: "f" * 12)
    fs, _, _ = kb.run_budget(live=False)
    assert [f.symbol for f in fs if f.rule == "BUDGET-STALE"] == ["record"]
    monkeypatch.setattr(kb, "RECORD_PATH", tmp_path / "none.txt")
    fs, _, _ = kb.run_budget(live=False)
    assert any(f.rule == "BUDGET-STALE" and "no ptxas record" in f.message
               for f in fs)


def test_launch_bounds_and_block_sizes_come_from_the_source():
    src = kb.kernel_sources(REPO / "src/repro_torch/csrc")
    assert (src["clustered_tile_kernel"].max_threads,
            src["clustered_tile_kernel"].min_blocks) == (1024, 2)
    assert src["group_scan_kernel"].block_dims == (1024,)
    for ks in src.values():   # every launch at its bound's block size
        assert set(ks.block_dims) == {ks.max_threads}, ks


def test_constants_of_included_headers_are_read(tmp_path):
    """A launch bound or block size may name a constant of a csrc header
    the source includes (``level_walk.cuh``'s ``kLanes``, say)."""
    (tmp_path / "walk.cuh").write_text("constexpr int kLanesX = 32;\n")
    (tmp_path / "k.cu").write_text(
        '#include "walk.cuh"\nconstexpr int kPer = 4;\n'
        "__global__ void __launch_bounds__(kLanesX * kPer, 1) k_kernel(int a)"
        " {}\nvoid go() { k_kernel<<<1, kLanesX * kPer>>>(0); }\n")
    src = kb.kernel_sources(tmp_path)
    assert (src["k_kernel"].max_threads, src["k_kernel"].min_blocks,
            src["k_kernel"].block_dims) == (128, 1, (128,))
    assert "kLanes = 32" in kb.included_headers(
        REPO / "src/repro_torch/csrc/range_scan.cu")


def test_max_shards_under_smem_covers_the_documented_8192():
    usage = kb.load_record()[1]
    s = kb.max_shards_under_smem(usage)
    assert s >= MAX_GROUP_SHARDS == 8192
    dyn = kb.dynamic_smem(REPO / "src/repro_torch/csrc", shards=s)
    assert all(usage[k].smem_static + b <=
               (kb.SMEM_OPTIN_BYTES if opt else kb.SMEM_DEFAULT_BYTES)
               for k, (b, opt, _) in dyn.items())
    over = kb.dynamic_smem(REPO / "src/repro_torch/csrc", shards=s + 1)
    assert any(usage[k].smem_static + b >
               (kb.SMEM_OPTIN_BYTES if opt else kb.SMEM_DEFAULT_BYTES)
               for k, (b, opt, _) in over.items())
    # the launcher's formula (shard_group.cu, sort_pass) at 8192 shards
    d = kb.dynamic_smem(REPO / "src/repro_torch/csrc")
    assert d["group_scatter_kernel<false>"][:2] == (2 * 8193 * 4 + 3 * 2048
                                                    * 4, True)
    assert d["group_histogram_kernel<false>"][:2] == (8193 * 4, False)
    assert d["group_scatter_kernel<true>"][0] == 2 * 129 * 4 + 3 * 2048 * 4


@pytest.mark.parametrize("symbol,name", [
    ("_ZN12_GLOBAL__N_116foresight_kernelEPK4int2", "foresight_kernel"),
    ("_ZN47_GLOBAL__N__0ef7559d_14_shard_group_cu_f9c1a52022"
     "group_histogram_kernelILb0EEEvPKi", "group_histogram_kernel<false>"),
    ("_Z3fooILi7ELin2EEvv", "foo<7, -2>"),
    ("validated_kernel", "validated_kernel"),
])
def test_demangle(symbol, name):
    assert kb.demangle(symbol) == name


def test_occupancy_model():
    assert kb.occupancy(32, 256, 0) == (8, 64)      # 2048 threads a SM
    assert kb.occupancy(32, 1024, 16776) == (2, 64)
    assert kb.occupancy(64, 1024, 32900) == (1, 32)  # registers bind
    assert kb.occupancy(48, 256, 90152) == (2, 16)   # shared memory binds


# ---------------------------------------------------------------------------
# baseline and report, held against the reference's
# ---------------------------------------------------------------------------

def _pairs():
    rows = [("HOST-SYNC", "k", 3, "a", "m"), ("HOST-SYNC", "k", 9, "a", "n"),
            ("REG-SPILL", "c", 0, "b", "m"), ("AUDIT-GAP", "d", 1, "e", "m")]
    sup = ("HOST-SYNC", "k", 4, "a", "s")
    mine = [Finding(*r) for r in rows] + [Finding(*sup, suppressed=True,
                                                  reason="why")]
    ref = [RefFinding(*r) for r in rows] + [RefFinding(*sup, suppressed=True,
                                                       reason="why")]
    return mine, ref


def test_baseline_roundtrip_and_apply_match_the_reference(tmp_path):
    mine, ref = _pairs()
    reasons = {mine[0].key: "known"}
    write_baseline(tmp_path / "p.json", mine[:3], reasons)
    ref_baseline.write_baseline(tmp_path / "r.json", ref[:3], reasons)
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "r.json").read_bytes()
    base = load_baseline(tmp_path / "p.json")
    assert base == ref_baseline.load_baseline(tmp_path / "r.json")
    assert base[mine[0].key] == {"count": 2, "reason": "known"}
    for fs, rs in ((mine, ref), (mine[:1], ref[:1]), ([], []),
                   (mine + mine[:2], ref + ref[:2])):
        b, n, s = apply_baseline(fs, base)
        rb, rn, rs_ = ref_baseline.apply_baseline(rs, base)
        assert [f.key for f in b] == [f.key for f in rb]
        assert [f.key for f in n] == [f.key for f in rn]
        assert s == rs_
    (tmp_path / "v2.json").write_text('{"version": 2, "entries": {}}')
    with pytest.raises(ValueError):
        load_baseline(tmp_path / "v2.json")


def test_update_keeps_the_entries_of_passes_that_did_not_run(tmp_path):
    mine, _ = _pairs()
    keep = {"CAPTURE-SYNC|p|e <- f": {"count": 3, "reason": "card"}}
    entries = write_baseline(tmp_path / "b.json", mine[:1], {}, keep)
    assert entries["CAPTURE-SYNC|p|e <- f"] == keep["CAPTURE-SYNC|p|e <- f"]
    assert load_baseline(tmp_path / "b.json")[mine[0].key] == {"count": 1}


def test_report_matches_the_reference_schema():
    mine, ref = _pairs()
    base = {mine[0].key: {"count": 1}}
    b, n, s = apply_baseline(mine, base)
    rb, rn, rs = ref_baseline.apply_baseline(ref, base)
    got = build_report(mine, b, n, s, ["ep"], ["k1", "k1"])
    want = ref_report.build_report(ref, rb, rn, rs, ["ep"], ["k1", "k1"])
    assert set(want) <= set(got) and set(got) - set(want) == {"syncs"}
    assert got["suite"] == "repro_torch.analysis"
    assert set(got["rules"]) == set(RULES)
    for key in ("totals", "audited_entry_points", "checked_kernels",
                "suppressed", "baselined", "new", "stale_baseline_keys"):
        assert got[key] == want[key], key


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_exit_codes_and_report(tmp_path, capsys):
    rep = tmp_path / "rep.json"
    assert cli.main(["--passes", "lint,budget", "--report", str(rep)]) == 0
    r = json.loads(rep.read_text())
    assert r["suite"] == "repro_torch.analysis" and r["totals"]["new"] == 0
    assert set(r["rules"]) == set(RULES) and r["syncs"] == {}
    assert len(r["checked_kernels"]) == 27
    # the fixtures added to the scan: exit 1, each rule named
    capsys.readouterr()
    assert cli.main(["--passes", "lint", "--scan",
                     str(REPO / FIXTURES)]) == 1
    out = capsys.readouterr()
    for rule in ("HOST-SYNC", "SILENT-DEGRADE", "KERNEL-ROUTE"):
        assert f" NEW  {rule}" in out.out
        assert rule in out.err


def _tiny_repo(root):
    """A repository of one port module with one host sync."""
    pkg = root / "src" / "repro_torch"
    pkg.mkdir(parents=True)
    (pkg / "bad.py").write_text(
        "import torch\n\n"
        "@torch.compile\ndef f(x):\n    return x + int(x.max())\n")
    return root


def test_cli_update_baseline_then_clean(tmp_path):
    root = _tiny_repo(tmp_path)
    b = tmp_path / "b.json"
    b.write_text(json.dumps({"version": 1, "entries": {
        "CAPTURE-SYNC|x|y <- z": {"count": 1, "reason": "card"}}}))
    args = ["--passes", "lint", "--root", str(root), "--baseline", str(b),
            "-q"]
    assert cli.main(args) == 1
    assert cli.main(args + ["--update-baseline"]) == 0
    assert cli.main(args) == 0
    base = load_baseline(b)
    assert base["HOST-SYNC|src/repro_torch/bad.py|f"] == {"count": 1}
    assert base["CAPTURE-SYNC|x|y <- z"]["count"] == 1


def test_cli_sync_pass_needs_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        cli.main(["--passes", "sync"])
    with pytest.raises(SystemExit):
        cli.main(["--passes", "nope"])


def test_cli_runs_as_a_module(tmp_path):
    root = _tiny_repo(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                        "--passes", "lint", "--root", str(root),
                        "--baseline", str(tmp_path / "none.json")],
                       capture_output=True, text=True, env=env, cwd=REPO)
    assert r.returncode == 1, r.stdout + r.stderr
    assert " NEW  HOST-SYNC" in r.stdout and "HOST-SYNC" in r.stderr


# ---------------------------------------------------------------------------
# audit coverage, held against the reference's jitted names
# ---------------------------------------------------------------------------

def _reference_jitted():
    """``repro.analysis.trace_audit.audit_coverage``'s criterion: public
    functions of src/repro/{core,kernels} whose decorator names jax.jit."""
    out = {}
    for scope in ("core", "kernels"):
        base = REPO / "src/repro" / scope
        for path in sorted(base.glob("*.py")):
            for node in ast.walk(ast.parse(path.read_text())):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and not node.name.startswith("_") and any(
                            "jax.jit" in ast.unparse(d)
                            for d in node.decorator_list):
                    out.setdefault(f"{scope}/{path.name}", []).append(
                        node.name)
    return {k: tuple(v) for k, v in out.items()}


def test_reference_jitted_copy_equals_the_reference():
    got = {k: tuple(sorted(v)) for k, v in ca.REFERENCE_JITTED.items()}
    want = {k: tuple(sorted(v)) for k, v in _reference_jitted().items()}
    assert got == want
    from repro.analysis.trace_audit import AUDIT_EXEMPT as REF_EXEMPT
    assert set(ca.AUDIT_EXEMPT) == set(REF_EXEMPT)
    assert all(isinstance(r, str) and r for r in ca.AUDIT_EXEMPT.values())


def test_audit_gap_clean_tree_and_fires_on_an_unlisted_name(
        tmp_path, monkeypatch):
    assert not ca.audit_coverage(str(REPO))
    pkg = tmp_path / "src/repro_torch/core"
    pkg.mkdir(parents=True)
    (pkg / "newapi.py").write_text(
        "def shiny_public_path(x):\n    return x\n\n"
        "def build(x):\n    return x\n")
    monkeypatch.setitem(ca.REFERENCE_JITTED, "core/newapi.py",
                        ("shiny_public_path",))
    gaps = ca.audit_coverage(str(tmp_path))
    assert [(f.rule, f.symbol) for f in gaps] == [("AUDIT-GAP",
                                                   "shiny_public_path")]


def test_entry_points_are_the_references_thirteen():
    from repro.analysis.trace_audit import audited_symbols as ref_symbols
    eps = ca.default_entry_points()
    assert len(eps) == 13 and len({ep.name for ep in eps}) == 13
    assert ca.audited_symbols() == ref_symbols()
    for ep in eps:
        assert (REPO / ep.path).is_file(), ep.path


def test_the_port_imports_neither_repro_nor_jax():
    bad = []
    for path in sorted((REPO / "src/repro_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and not node.level else [])
            bad += [f"{path}: {n}" for n in names
                    if re.match(r"(repro|jax|jaxlib)(\.|$)", n)]
    assert not bad


# ---------------------------------------------------------------------------
# the clean tree: lint, capture and budget inside the baseline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def capture():
    return ca.run_capture_audit()


def test_capture_audit_reports_every_entry_point(capture):
    fs, audited, stats = capture
    assert audited == [ep.name for ep in ca.default_entry_points()]
    assert [s.name for s in stats] == audited
    assert all(s.graphs >= 1 for s in stats)
    # dynamo breaks on the update path's host loop (ROADMAP item 7b)
    by = {s.name: s for s in stats}
    assert by["VersionedIndex.update"].breaks > 0
    assert {f.rule for f in fs} <= {"CAPTURE-BREAK", "CAPTURE-RECOMPILE"}
    for f in fs:
        assert f.symbol in by and f.path.startswith("src/repro_torch/")


def test_clean_tree_has_no_finding_outside_the_baseline(capture):
    from repro_torch.analysis.capture_audit import audit_coverage
    findings = run_lint(REPO) + audit_coverage(str(REPO)) + capture[0] + \
        kb.run_budget(live=False)[0]
    base = load_baseline(BASELINE)
    _, new, stale = apply_baseline(findings, base)
    assert not new, "\n".join(f.render() for f in new)
    ran = {r for p in ("lint", "capture", "budget")
           for r in cli.PASS_RULES[p]}
    assert not [k for k in stale if k.split("|")[0] in ran], stale
    for key, entry in base.items():
        assert entry.get("reason"), key
        assert key.split("|")[0] in RULES


def test_capture_recompile_fires_on_a_value_specialised_bucket():
    import torch

    def build(dev):
        def fn(x):
            n = int(x.sum())                 # a break, then an int argument
            return x + n
        return fn, {"b4": [(torch.ones(4),), (torch.ones(4) * 2,),
                           (torch.ones(4) * 3,)]}

    ep = ca.EntryPoint("toy", "toy.py", build)
    fs, st = ca.capture_entry(ep)
    assert st.breaks >= 1
    assert any(f.rule == "CAPTURE-BREAK" for f in fs)
    # the constant n after the break is specialised: each new value
    # compiles the rest of the frame again
    assert st.recompiles >= 1
    assert any(f.rule == "CAPTURE-RECOMPILE" for f in fs)
