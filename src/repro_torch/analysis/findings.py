"""Finding model and rule registry of the port's analysis gate.

Port of ``repro.analysis.findings``.  Every pass (``lint``,
``capture_audit``, ``kernel_budget``) reports the same ``Finding``
record, so the CLI, the baseline file and the report speak one
vocabulary.  A finding is *suppressed* when the flagged line (or its
enclosing ``def``) carries a ``# trace-ok: <reason>`` comment: suppressed
findings are listed in the report and never fail the gate.  The others
are matched against the committed baseline
(``repro_torch/analysis/baseline.json``); anything beyond the baselined
count of its key ``rule|path|symbol`` is NEW and fails the gate.

Rule IDs:

AST lint (source-level, ``lint``)
  HOST-SYNC          a host round trip (``.item()``, ``.tolist()``,
                     ``.cpu()``, ``.numpy()``, ``int()`` / ``float()`` /
                     ``bool()`` of a non-literal, ``np.asarray`` /
                     ``np.array``, ``torch.cuda.synchronize``,
                     ``nonzero``) in code reachable from a capture seed
  SILENT-DEGRADE     an except block around device code (``torch.cuda``,
                     the ``_build`` library, ``ctypes``, a ``*_launch``
                     symbol) that neither raises nor warns
  KERNEL-ROUTE       a kernel wrapper that picks its ``*_plain`` twin by
                     anything but the tensors' device

capture audit (dynamo-level, ``capture_audit``)
  CAPTURE-BREAK      a graph break (or a failure) under
                     ``torch._dynamo`` in a capture entry point
  CAPTURE-RECOMPILE  a shape bucket compiled again after its first call
  CAPTURE-SYNC       a synchronising CUDA call in one call of an entry
                     point (``torch.cuda.set_sync_debug_mode``; the card)
  AUDIT-GAP          a function the reference jits that the port has
                     neither as an entry point nor exempted

kernel budget (``ptxas -v``-level, ``kernel_budget``)
  REG-SPILL          a ``__global__`` spills registers to local memory
  REG-BUDGET         registers x threads a block over an SM's 65,536, or
                     registers over 255
  SMEM-BUDGET        static + largest dynamic shared memory over 48 KiB
                     (no opt-in) or 227 KiB (opt-in)
  BUDGET-STALE       the ``ptxas`` record does not describe today's
                     ``csrc/`` (hash), or the card's live report differs
"""
from __future__ import annotations

import dataclasses
from typing import Optional

RULES = {
    "HOST-SYNC": "host round trip reachable from a capture seed",
    "SILENT-DEGRADE": "except block around device code neither raises nor "
                      "warns",
    "KERNEL-ROUTE": "kernel wrapper picks its plain twin by something other "
                    "than the tensors' device",
    "CAPTURE-BREAK": "graph break under torch._dynamo in a capture entry "
                     "point",
    "CAPTURE-RECOMPILE": "shape bucket compiled again after its first call",
    "CAPTURE-SYNC": "synchronising CUDA call in one call of an entry point",
    "AUDIT-GAP": "function the reference jits is neither an entry point "
                 "nor exempted",
    "REG-SPILL": "kernel spills registers to local memory",
    "REG-BUDGET": "registers x threads a block over 65,536, or registers "
                  "over 255",
    "SMEM-BUDGET": "static + largest dynamic shared memory over the block "
                   "limit",
    "BUDGET-STALE": "ptxas record does not match today's csrc or the live "
                    "report",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str              # one of RULES
    path: str              # repo-relative file (or pseudo-path)
    line: int              # 1-based; 0 when not line-addressable
    symbol: str            # enclosing function qualname / kernel / entry
    message: str
    suppressed: bool = False
    reason: Optional[str] = None   # the trace-ok reason when suppressed

    @property
    def key(self) -> str:
        """Line-independent identity used by the baseline file: routine
        edits that move lines do not churn it; findings sharing a key are
        baselined by count."""
        return f"{self.rule}|{self.path}|{self.symbol}"

    def render(self) -> str:
        sup = f"  [trace-ok: {self.reason}]" if self.suppressed else ""
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{self.rule:17s} {loc} ({self.symbol}): {self.message}{sup}"


def sort_findings(findings):
    return sorted(findings, key=lambda f: (f.rule, f.path, f.symbol, f.line))
