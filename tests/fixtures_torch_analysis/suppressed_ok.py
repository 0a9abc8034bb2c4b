"""Fixture: the trace-ok suppression syntax; every finding here is
suppressed.  Parsed by the port's lint, never imported.
"""
import numpy as np
import torch


@torch.compile
def line_suppressed(x):
    n = int(x.max())  # trace-ok: fixture line-level suppression
    return x + n


# trace-ok: fixture def-level suppression (covers the whole body)
@torch.compile
def def_suppressed(x):
    a = np.asarray(x)
    return x + int(x.max()) + a.shape[0]
