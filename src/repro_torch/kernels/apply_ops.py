"""Batched update application: a hand-written CUDA kernel and its plain
version.

The device counterpart of the reference's jitted apply
(``repro.core.skiplist.apply_ops``, a ``lax.scan`` over ``lax.switch`` of
search, insert and delete, which ``repro.core.sharded.apply_ops_sharded``
runs inside its segment passes); there is no Pallas kernel behind it.

``apply_ops_batch(stack, op_types, keys, vals, starts, lens)`` applies a
route-sorted batch in place to a stacked ``SkipListState`` (every tensor
with a leading ``[S]`` axis; a monolithic list is a stack of one): shard
``s`` runs the ops ``[starts[s], starts[s] + lens[s])`` in order, and each
op's result (found / inserted new / deleted, 0 or 1) comes back at its
position in the sorted batch.  On CUDA tensors it launches
``csrc/apply_ops.cu`` (one block a shard: a window of ``WINDOW`` read-only
walks at once, then each op checked against the current state and applied
in order) and counts the launch in ``apply_ops_batch.launches``; on CPU
tensors it runs ``apply_ops_batch_plain``, the port's host loop
(``core.skiplist.apply_ops_inplace`` on each shard's views); any other
device raises.  A failed build or launch raises: there is no fallback.

The kernel leaves every state array and the rng as the plain version does
(and both as the reference does).  One difference of signature: a walk
runs under ``traversal_bound(L, cap)`` steps and past it the kernel traps
(a corrupt table; the reference loops for ever).

The fat insert and delete cases the kernel runs are counted on the
device, in ``fat_cases(device)``, in ``core.skiplist.FAT_CASES``' names
(the plain version counts in ``FAT_CASES`` itself), and so are the window
checks, in ``window_checks(device)``: the ops whose recorded predecessors
all stood, the ops that resumed a walk, and the resumed walks' steps.
Read them once after a run, not per call: the read waits for the card.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict

import torch

from repro_torch.core import sharded as shd
from repro_torch.core import skiplist as sl
from repro_torch.kernels import _build
from repro_torch.kernels.foresight_traverse import traversal_bound

# csrc/apply_ops.cu FatCase order, then its CheckCount order
CASE_NAMES = ("insert_upsert", "insert_first", "insert_room",
              "insert_split", "delete_emptied", "delete_min", "delete_plain")
CHECK_NAMES = ("ops_stood", "walks_resumed", "resumed_steps")
MAX_LEVELS = 32          # kMaxLevels: one lane a level
WINDOW = 256             # kWindow: the ops walked at once
# In the default 48 KiB of dynamic shared memory: the window's predecessor
# rows (kMaxLevels + 1 words an op), its op types, keys, vals, heights and
# rng keys (6 words an op), the median's predecessors, and a staged run's
# keys and vals
MAX_WIDTH = (48 * 1024 // 4 - WINDOW * (MAX_LEVELS + 7) - MAX_LEVELS) // 2

_REF_CTZ: Dict[torch.device, torch.Tensor] = {}
_CASES: Dict[torch.device, torch.Tensor] = {}


def apply_ops_batch_plain(stack: sl.SkipListState, op_types: torch.Tensor,
                          keys: torch.Tensor, vals: torch.Tensor,
                          starts: torch.Tensor, lens: torch.Tensor
                          ) -> torch.Tensor:
    """The host loop: each shard's segment through
    ``core.skiplist.apply_ops_inplace`` on views of the stack, in place;
    results [B] int32 in the sorted order."""
    ops_h, keys_h, vals_h = sl.host_ops(op_types, keys, vals)
    res = [0] * len(keys_h)
    for s, (a, ln) in enumerate(zip(starts.tolist(), lens.tolist())):
        if ln:
            res[a:a + ln] = sl.apply_ops_inplace(
                shd.shard_view(stack, s), ops_h[a:a + ln], keys_h[a:a + ln],
                vals_h[a:a + ln])
    return torch.tensor(res, dtype=torch.int32, device=keys.device)


def apply_ops_batch(stack: sl.SkipListState, op_types: torch.Tensor,
                    keys: torch.Tensor, vals: torch.Tensor,
                    starts: torch.Tensor, lens: torch.Tensor
                    ) -> torch.Tensor:
    """Apply route-sorted int32 ops [B] to the stacked state ``stack`` in
    place; shard ``s`` runs ``[starts[s], starts[s] + lens[s])`` in order.
    Returns results [B] int32 in the sorted order."""
    if stack.keys.device.type == "cpu":
        return apply_ops_batch_plain(stack, op_types, keys, vals, starts,
                                     lens)
    if stack.keys.device.type != "cuda":
        raise ValueError(f"apply_ops_batch: tensors on {stack.keys.device}; "
                         "the kernel runs on CUDA and the plain version on "
                         "the CPU")
    return _launch(stack, op_types, keys, vals, starts, lens,
                   torch.cuda.current_stream(stack.device).cuda_stream)


apply_ops_batch.launches = 0


def _device(device) -> torch.device:
    """``device`` with its index (``cuda`` is the current card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _device_table(cache: Dict, dev: torch.device, make) -> torch.Tensor:
    if dev not in cache:
        cache[dev] = make()
    return cache[dev]


def _counts(device) -> torch.Tensor:
    """The device's counters: the fat cases, then the window checks."""
    dev = _device(device)
    return _device_table(_CASES, dev, lambda: torch.zeros(
        len(CASE_NAMES) + len(CHECK_NAMES), dtype=torch.int64, device=dev))


def fat_cases(device) -> Counter:
    """The fat cases the kernel ran on ``device`` since the last
    ``reset_fat_cases``, by name (one read from the card)."""
    counts = _counts(device)[:len(CASE_NAMES)]
    return Counter(dict(zip(CASE_NAMES, counts.tolist())))


def window_checks(device) -> Dict[str, int]:
    """The kernel's checks on ``device`` since the last ``reset_fat_cases``
    (one read from the card): ``ops_stood``, the ops whose recorded
    predecessors all stood; ``walks_resumed``, the ops that walked again
    below a level that failed; ``resumed_steps``, those walks' steps."""
    counts = _counts(device)[len(CASE_NAMES):]
    return dict(zip(CHECK_NAMES, counts.tolist()))


def reset_fat_cases(device) -> None:
    """Zero the device's counters: the fat cases and the window checks."""
    dev = _device(device)
    if dev in _CASES:
        _CASES[dev].zero_()


def _check(stack: sl.SkipListState, ops, starts: torch.Tensor,
           lens: torch.Tensor) -> None:
    dev = stack.keys.device
    S, cap = stack.keys.shape
    for t in (*(t for t in stack if t is not None), *ops, starts, lens):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("apply_ops_batch: every tensor must be "
                             f"contiguous on {dev}; got one on {t.device}")
    for name, t in stack._asdict().items():
        want = torch.uint32 if name == "rng" else torch.int32
        if t is not None and (t.dtype != want or t.shape[0] != S):
            raise ValueError(f"apply_ops_batch: {name} must be {want} with "
                             f"a leading [{S}] axis; got {t.dtype} "
                             f"{list(t.shape)}")
    for t in (*ops, starts, lens):
        if t.dtype != torch.int32:
            raise ValueError(f"apply_ops_batch: ops, starts and lens must "
                             f"be int32; got {t.dtype}")
    if len({t.shape for t in ops}) != 1 or starts.shape != (S,) or \
            lens.shape != (S,):
        raise ValueError("apply_ops_batch: op arrays must share one shape "
                         f"and starts / lens be [{S}]")
    L = (stack.fused if stack.foresight else stack.nxt).shape[1]
    if L > MAX_LEVELS or stack.node_width > MAX_WIDTH:
        raise ValueError(f"apply_ops_batch: the kernel takes at most "
                         f"{MAX_LEVELS} levels and node width {MAX_WIDTH}; "
                         f"got {L} and {stack.node_width}")
    if stack.foresight and stack.fused.data_ptr() % 8:
        raise ValueError("apply_ops_batch: fused must be 8-byte aligned "
                         "(the kernel moves each record as one int2)")


def _launch(stack: sl.SkipListState, op_types, keys, vals, starts, lens,
            stream: int) -> torch.Tensor:
    """Check the arguments and launch ``apply_ops_launch`` on ``stream``."""
    ops = (op_types, keys, vals)
    _check(stack, ops, starts, lens)
    dev = _device(stack.keys.device)
    S, cap = stack.keys.shape
    L = (stack.fused if stack.foresight else stack.nxt).shape[1]
    results = torch.empty_like(keys)
    if keys.numel() == 0:
        return results
    ref_ctz = _device_table(_REF_CTZ, dev, lambda: torch.tensor(
        sl._REF_CTZ, dtype=torch.int32, device=dev))
    cases = _counts(dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    _build.launch(
        "apply_ops_launch",
        *map(ptr, (stack.fused, stack.nxt, stack.keys, stack.vals,
                   stack.height, stack.n, stack.free_top, stack.free_list,
                   stack.bump, stack.rng, stack.fat_keys, stack.fat_vals,
                   stack.nlen, op_types, keys, vals, starts, lens, ref_ctz,
                   results, cases)),
        S, L, cap, stack.node_width, traversal_bound(L, cap), stream)
    apply_ops_batch.launches += 1
    return results
