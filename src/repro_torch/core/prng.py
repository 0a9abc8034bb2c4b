"""Threefry-2x32 keys and bits, bit-identical to ``jax.random``.

Tower heights come from ``jax.random.bits``; without the same bits a build
links different towers and produces different ``fused`` / ``nxt`` arrays.
This mirrors JAX's partitionable threefry (``jax_threefry_partitionable``,
the default since JAX 0.5): a key is two uint32 words, ``split`` and
``bits`` hash the 64-bit flat index of each output element (as hi/lo
words) under the key, and ``bits`` returns the XOR of the two hash words.

torch's uint32 supports little beyond conversion (on CUDA especially), so
the arithmetic runs in int64 with every result masked back to 32 bits;
keys and bits cross the interface as uint32 tensors.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: ``[0, seed mod 2**32]`` as uint32 [2].

    JAX (32-bit mode) narrows the seed to int32 first, so the high word is
    always 0 and negative seeds wrap.
    """
    key = torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)
    return key.to(torch.uint32)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) on int64 tensors holding uint32."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def _hash_iota(key: torch.Tensor, count: int):
    """Hash the flat indices ``0 .. count-1`` (hi, lo words) under ``key``."""
    k = key.to(torch.int64)
    idx = torch.arange(count, dtype=torch.int64, device=key.device)
    return threefry2x32(k[0], k[1], idx >> 32, idx & _MASK)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``num`` new keys as a uint32 [num, 2] tensor."""
    b1, b2 = _hash_iota(key, num)
    return torch.stack([b1, b2], dim=1).to(torch.uint32)


def bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as a uint32 tensor."""
    b1, b2 = _hash_iota(key, math.prod(shape))
    return (b1 ^ b2).reshape(tuple(shape)).to(torch.uint32)
