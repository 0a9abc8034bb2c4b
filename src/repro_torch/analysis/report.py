"""Machine-readable report of the port's analysis gate (port of
``repro.analysis.report``): per-rule counts split into suppressed
(``# trace-ok``), baselined and new, the audited entry points and the
checked kernels, and the rows of each finding; ``syncs`` holds the
``sync`` pass's count a call of each entry point when it ran."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.findings import RULES, Finding, sort_findings


def build_report(findings: List[Finding], baselined: List[Finding],
                 new: List[Finding], stale: Sequence[str],
                 audited_entry_points: Sequence[str],
                 checked_kernels: Sequence[str],
                 syncs: Optional[Dict[str, dict]] = None) -> Dict:
    suppressed = [f for f in findings if f.suppressed]
    per_rule = {}
    for rule in RULES:
        per_rule[rule] = {
            "suppressed": sum(1 for f in suppressed if f.rule == rule),
            "baselined": sum(1 for f in baselined if f.rule == rule),
            "new": sum(1 for f in new if f.rule == rule),
        }

    def rows(fs):
        return [{"rule": f.rule, "path": f.path, "line": f.line,
                 "symbol": f.symbol, "message": f.message,
                 **({"reason": f.reason} if f.reason else {})}
                for f in sort_findings(fs)]

    return {
        "suite": "repro_torch.analysis",
        "rules": per_rule,
        "totals": {
            "suppressed": len(suppressed),
            "baselined": len(baselined),
            "new": len(new),
            "stale_baseline_keys": len(stale),
        },
        "audited_entry_points": list(audited_entry_points),
        "checked_kernels": sorted(set(checked_kernels)),
        "suppressed": rows(suppressed),
        "baselined": rows(baselined),
        "new": rows(new),
        "stale_baseline_keys": sorted(stale),
        "syncs": dict(syncs or {}),
    }


def write_report(path: Path, report: Dict) -> None:
    path.write_text(json.dumps(report, indent=2) + "\n")
