"""Baseline ratchet of the port's analysis gate (port of
``repro.analysis.baseline``).

The baseline (``repro_torch/analysis/baseline.json``) lists known
findings by count under the key ``RULE|path|symbol``.  The gate:

* an unsuppressed finding whose key has budget left is *baselined*
  (reported, not fatal);
* anything beyond the budget is *new* and fails the run;
* baseline entries no longer matched are *stale*, reported so the file
  can be ratcheted down (``--update-baseline`` rewrites it from the
  current tree, keeping the reasons).

Format::

    {
      "version": 1,
      "entries": {
        "HOST-SYNC|src/repro_torch/core/sharded.py|apply_ops_sharded": {
          "count": 2,
          "reason": "..."
        }
      }
    }
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.analysis.findings import Finding

VERSION = 1


def load_baseline(path: Path) -> Dict[str, dict]:
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    if data.get("version") != VERSION:
        raise ValueError(
            f"baseline {path} has version {data.get('version')!r}; "
            f"this tool writes version {VERSION}")
    return dict(data.get("entries", {}))


def write_baseline(path: Path, findings: List[Finding],
                   reasons: Dict[str, str] = None,
                   keep: Dict[str, dict] = None) -> Dict[str, dict]:
    """Rewrite the baseline from the current unsuppressed findings;
    ``keep`` holds entries carried over as they are (those of passes that
    did not run)."""
    entries: Dict[str, dict] = {k: dict(v) for k, v in (keep or {}).items()}
    for f in findings:
        if f.suppressed:
            continue
        e = entries.setdefault(f.key, {"count": 0})
        e["count"] += 1
    for key, entry in entries.items():
        reason = (reasons or {}).get(key)
        if reason:
            entry["reason"] = reason
    path.write_text(json.dumps(
        {"version": VERSION,
         "entries": dict(sorted(entries.items()))}, indent=2) + "\n")
    return entries


def apply_baseline(findings: List[Finding], baseline: Dict[str, dict]
                   ) -> Tuple[List[Finding], List[Finding], List[str]]:
    """Split unsuppressed findings into (baselined, new); also return the
    stale baseline keys whose budget was not used up."""
    budget = {k: int(v.get("count", 0)) for k, v in baseline.items()}
    baselined: List[Finding] = []
    new: List[Finding] = []
    for f in findings:
        if f.suppressed:
            continue
        if budget.get(f.key, 0) > 0:
            budget[f.key] -= 1
            baselined.append(f)
        else:
            new.append(f)
    stale = [k for k, left in budget.items() if left > 0]
    return baselined, new, stale
