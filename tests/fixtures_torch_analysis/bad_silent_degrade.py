"""Fixture: silent except-and-degrade around device code (SILENT-DEGRADE).

Parsed by the port's lint, never imported.
"""
import ctypes
import warnings

import torch

from repro_torch.kernels import _build


def quiet_cuda(x):
    try:
        torch.cuda.synchronize()            # device code in the try body
    except RuntimeError:
        return None                          # flagged: neither raises nor warns


def quiet_launch(x):
    try:
        _build.launch("foresight_traverse_launch", x)
    except Exception:
        pass                                 # flagged


def quiet_library():
    try:
        return ctypes.CDLL("libtraverse.so")
    except OSError:
        return None                          # flagged


def quiet_handler(x):
    try:
        return x.sum()
    except torch.cuda.OutOfMemoryError:
        return None                          # flagged: a device error class


def loud_warn(x):
    try:
        torch.cuda.synchronize()
    except RuntimeError:
        warnings.warn("the card failed; running on the CPU")   # NOT flagged


def loud_raise(x):
    try:
        _build.launch("foresight_traverse_launch", x)
    except RuntimeError as e:
        raise ValueError("launch failed") from e                # NOT flagged


def host_only(path):
    try:
        return open(path).read()
    except OSError:
        return ""                            # NOT flagged: no device code
