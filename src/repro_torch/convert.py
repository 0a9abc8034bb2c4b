"""Carry skiplist states between ``repro`` and the port as numpy arrays.

``state_to_numpy`` / ``state_from_numpy`` use the field names of both
packages' ``SkipListState``, so a test can build a state with one package,
move it across bit for bit (the ``rng`` key included) and search it with
the other.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.skiplist import SkipListState, resolve_device

_FAT_FIELDS = ("fat_keys", "fat_vals", "nlen")


def state_from_numpy(arrays: Dict[str, np.ndarray], device=None
                     ) -> SkipListState:
    """A port state from ``{field: array}`` (``None`` or absent: unset).

    ``device`` follows the package rule: ``None`` means the GPU.
    """
    if any(arrays.get(f) is not None for f in _FAT_FIELDS):
        raise NotImplementedError("fat-layout states are not ported yet "
                                  "(ROADMAP.md Queue 1, fat-node layout)")
    if np.ndim(arrays["keys"]) != 1:
        raise NotImplementedError("stacked (sharded) states are not ported "
                                  "yet (ROADMAP.md Queue 1, sharded engine)")
    dev = resolve_device(device)
    fields = {}
    for name in SkipListState._fields:
        a = arrays.get(name)
        fields[name] = (None if a is None else
                        torch.from_numpy(np.array(a, copy=True)).to(dev))
    return SkipListState(**fields)


def state_to_numpy(state: SkipListState) -> Dict[str, np.ndarray]:
    """``{field: array}`` for every set field of ``state``, copied to host."""
    return {name: t.cpu().numpy() for name, t in state._asdict().items()
            if t is not None}
