"""Fixture: host syncs in capture-reachable code (HOST-SYNC).

Parsed by the port's lint, never imported.
"""
import numpy as np
import torch


def helper(x):
    return x.sum().item()                  # flagged: reached from a seed


@torch.compile
def captured(x):
    n = int(x.max())                       # flagged: int() of a tensor
    f = float(x.mean())                    # flagged
    b = bool((x > 0).any())                # flagged
    host = x.cpu()                         # flagged
    arr = np.asarray(x)                    # flagged
    lst = x.tolist()                       # flagged
    a2 = x.numpy()                         # flagged
    nz = x.nonzero()                       # flagged: data-dependent size
    nz2 = torch.nonzero(x)                 # flagged
    torch.cuda.synchronize()               # flagged
    k = int(3)                             # NOT flagged: a literal
    return helper(x) + n + f + b + host + arr + lst + a2 + nz + nz2 + k


def later(x):
    return x + 1


compiled_later = torch.compile(later)      # a torch.compile(f) reference


def eager_only(x):
    return x.sum().item()                  # NOT flagged: not reachable
