"""CLI: ``python -m repro_torch.analysis`` — run the passes, gate on new
findings (port of ``repro.analysis.__main__``).

    PYTHONPATH=src python -m repro_torch.analysis \\
        [--passes lint,capture,budget,sync] [--baseline FILE] \\
        [--report FILE] [--update-baseline] [--scan DIR ...]
    PYTHONPATH=src python -m repro_torch.analysis --print-record \
        > src/repro_torch/analysis/ptxas_sm90a.txt     # on the card

The default passes are ``lint,capture,budget``.  ``sync`` counts the
synchronising CUDA calls of the entry points and needs a card (it raises
without one); ``budget`` checks the committed ptxas record on the CPU and
the live report on a card.  Exit status 0 iff no finding exceeds the
baseline.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.baseline import (apply_baseline, load_baseline,
                                           write_baseline)
from repro_torch.analysis.findings import sort_findings
from repro_torch.analysis.report import build_report, write_report

ALL_PASSES = ("lint", "capture", "budget", "sync")
DEFAULT_PASSES = ("lint", "capture", "budget")
#: the rules each pass reports (a stale key counts only if its pass ran)
PASS_RULES = {
    "lint": ("HOST-SYNC", "SILENT-DEGRADE", "KERNEL-ROUTE", "AUDIT-GAP"),
    "capture": ("CAPTURE-BREAK", "CAPTURE-RECOMPILE"),
    "budget": ("REG-SPILL", "REG-BUDGET", "SMEM-BUDGET", "BUDGET-STALE"),
    "sync": ("CAPTURE-SYNC",),
}
BASELINE = Path("src/repro_torch/analysis/baseline.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Host-sync lint, capture audit and kernel budget of "
                    "the PyTorch/CUDA port")
    ap.add_argument("--root", type=Path, default=None,
                    help="repo root (default: from this file)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help=f"baseline JSON (default: <root>/{BASELINE})")
    ap.add_argument("--passes", default=",".join(DEFAULT_PASSES),
                    help=f"comma list of {ALL_PASSES}")
    ap.add_argument("--report", type=Path, default=None,
                    help="write the machine-readable report here")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline's entries of the passes run "
                         "from the current tree (keeps reasons) and exit 0")
    ap.add_argument("--scan", type=Path, action="append", default=[],
                    help="another directory for the lint to read (repeat)")
    ap.add_argument("--print-record", action="store_true",
                    help="print the card build's ptxas report as a record "
                         "(for ptxas_sm90a.txt) and exit; needs the card")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.print_record:
        from repro_torch.analysis.kernel_budget import live_record_text
        sys.stdout.write(live_record_text())
        return 0
    root = (args.root or Path(__file__).resolve().parents[3]).resolve()
    baseline_path = args.baseline or root / BASELINE
    passes = [p.strip() for p in args.passes.split(",") if p.strip()]
    unknown = set(passes) - set(ALL_PASSES)
    if unknown:
        ap.error(f"unknown passes: {sorted(unknown)}")

    findings, audited, checked, syncs = [], [], [], {}
    if "lint" in passes:
        from repro_torch.analysis.capture_audit import audit_coverage
        from repro_torch.analysis.lint import run_lint
        dirs = ("src/repro_torch",) + tuple(
            str(d.resolve().relative_to(root)) for d in args.scan)
        findings.extend(run_lint(root, dirs))
        findings.extend(audit_coverage(str(root)))
    if "capture" in passes:
        from repro_torch.analysis.capture_audit import run_capture_audit
        fs, audited, stats = run_capture_audit()
        findings.extend(fs)
        if not args.quiet:
            for st in stats:
                print(f"capture  {st.name}: {st.graphs} graphs, {st.breaks} "
                      f"breaks, {st.recompiles} recompiles "
                      f"({st.seconds:.1f} s)")
    if "budget" in passes:
        from repro_torch.analysis.kernel_budget import run_budget
        fs, checked, rows = run_budget()
        findings.extend(fs)
        if not args.quiet:
            for r in rows:
                print(f"budget   {r['kernel']}: {r['registers']} regs, "
                      f"{r['spill_bytes']} B spilled, {r['smem_static']} + "
                      f"{r['smem_dynamic_max']} B smem, {r['threads']} "
                      f"threads, {r['blocks_per_sm']} blocks/SM")
    if "sync" in passes:
        from repro_torch.analysis.capture_audit import run_sync_audit
        fs, syncs = run_sync_audit()
        findings.extend(fs)
        if not args.quiet:
            for name, row in syncs.items():
                print(f"sync     {name}: {row['syncs']} a call"
                      + (f", {row['per_op']:g} a op" if "per_op" in row
                         else ""))
    ran = {r for p in passes for r in PASS_RULES[p]}

    def rule_of(key: str) -> str:
        return key.split("|", 1)[0]

    if args.update_baseline:
        old = {}
        try:
            old = load_baseline(baseline_path)
        except ValueError:
            pass
        reasons = {k: v.get("reason") for k, v in old.items()
                   if v.get("reason")}
        keep = {k: v for k, v in old.items() if rule_of(k) not in ran}
        entries = write_baseline(baseline_path, findings, reasons, keep)
        print(f"baseline rewritten: {len(entries)} keys -> {baseline_path}")
        return 0

    baseline = load_baseline(baseline_path)
    baselined, new, stale = apply_baseline(findings, baseline)
    stale = [k for k in stale if rule_of(k) in ran]

    if not args.quiet:
        suppressed = [f for f in findings if f.suppressed]
        for f in sort_findings(suppressed):
            print(f"  ok  {f.render()}")
        for f in sort_findings(baselined):
            print(f"BASE  {f.render()}")
        for f in sort_findings(new):
            print(f" NEW  {f.render()}")
        for k in sorted(stale):
            print(f"STALE baseline entry no longer matched: {k}")
        print(f"\n{len(suppressed)} suppressed (trace-ok), "
              f"{len(baselined)} baselined, {len(new)} new, "
              f"{len(stale)} stale baseline key(s); "
              f"passes={','.join(passes)}"
              + (f"; audited={len(audited)} entry points" if audited
                 else "")
              + (f"; kernels={len(set(checked))}" if checked else ""))

    if args.report:
        write_report(args.report,
                     build_report(findings, baselined, new, stale,
                                  audited, checked, syncs))
        if not args.quiet:
            print(f"report -> {args.report}")

    if new:
        print(f"FAIL: {len(new)} new finding(s) not covered by "
              f"{baseline_path.name}: "
              + json.dumps(sorted({f.rule for f in new})), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
