"""The port's analysis gate: host-sync lint, capture audit, kernel budget.

Twin of ``repro.analysis``, turned to the card's failure modes:

* :mod:`repro_torch.analysis.lint` — pure-AST rules over
  ``src/repro_torch`` (host syncs in capture-reachable code, silent
  except-and-degrade, kernel wrappers that route by anything but the
  device);
* :mod:`repro_torch.analysis.capture_audit` — the reference's 13 entry
  points under ``torch._dynamo`` (graph breaks, recompiles a shape
  bucket) on the CPU, and their synchronising CUDA calls on the card;
* :mod:`repro_torch.analysis.kernel_budget` — registers, spills and
  shared memory of every ``__global__`` from ``ptxas -v`` against the
  sm_90 limits.

CLI: ``PYTHONPATH=src python -m repro_torch.analysis`` — exit 0 iff no
finding exceeds ``repro_torch/analysis/baseline.json``.
"""
from repro_torch.analysis.findings import RULES, Finding, sort_findings
from repro_torch.analysis.kernel_budget import (SMEM_DEFAULT_BYTES,
                                                SMEM_OPTIN_BYTES,
                                                max_shards_under_smem)

__all__ = [
    "RULES", "Finding", "sort_findings",
    "SMEM_DEFAULT_BYTES", "SMEM_OPTIN_BYTES", "max_shards_under_smem",
]
