"""Fixture: kernel wrappers that pick their plain twin by something other
than the tensors' device (KERNEL-ROUTE).  It sits under a ``kernels/``
directory, where the rule looks.  Parsed by the port's lint, never
imported.
"""
import os

from repro_torch.kernels import _build

USE_PLAIN = False


def walk_plain(x):
    return x


def _launch(x):
    _build.launch("foresight_traverse_launch", x.data_ptr())
    return x


def walk_by_flag(x):
    if USE_PLAIN:                           # flagged: a hard-coded flag
        return walk_plain(x)
    return _launch(x)


def walk_by_env(x):
    if os.environ.get("WALK_PLAIN"):        # flagged: an environment variable
        return walk_plain(x)
    return _launch(x)


def walk_by_error(x):
    try:
        return _launch(x)
    except RuntimeError:
        return walk_plain(x)                # flagged: a caught error


def walk_unguarded(x):
    _launch(x)
    return walk_plain(x)                    # flagged: no device test


def walk_by_device(x):
    if x.device.type == "cpu":              # NOT flagged: the device
        return walk_plain(x)
    return _launch(x)


def walk_by_is_cuda(x):
    if not x.is_cuda:                       # NOT flagged
        return walk_plain(x)
    return _launch(x)


def walk_device_after_check(x):
    if x.device.type == "cpu":              # NOT flagged: an early return
        return x
    if x.device.type != "cuda":
        raise ValueError("no kernel for this device")
    return _launch(x)
