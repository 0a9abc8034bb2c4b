#!/usr/bin/env python3
"""Drive the port's main path on one CUDA card and check every result.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases, one JSON line each:

1. card identity (nvidia-smi name and power limit, torch's device name);
2. build of the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, all started together);
3. small check: foresight and base skiplists (n=4000, cap=8192, L=14)
   built on the card equal their CPU builds, and K1 / K2 equal their plain
   versions on a half-hit, half-miss batch; each runs its key-range
   grouping pass (``group_by_key``), which equals its plain version, and
   equals its launch on the lanes in batch order;
4. small update check, same size: a 2000-op mixed stream through
   ``apply_ops`` on the card (the update kernel) equals the CPU run (its
   plain version) in every state array and result (both variants) and
   leaves its input unchanged; K8 (grouped by
   key range) equals its plain version and its batch-order launch on a
   clean, a 40%-corrupted and a lag-1 table, at the default step cap and
   at 9 steps; after an insert-only batch, lag-1 reads answer for the
   stale key set;
4b. ``update_kernel_check``: the update kernel (``csrc/apply_ops.cu``,
   ``kernels.apply_ops``) against its plain version, both on the card, on
   clones of the same small states: node widths 1, 8 and 128, both
   variants, a monolithic list filled until allocation is refused and 8
   shards, streams with op types -1 and 3 and ``KEY_MAX``'s insert, read
   and delete, and at B = 8 ``fat_case_stream`` on an empty list; the
   kernel's window conflicts (consecutive grants, a key in, out and in
   again, a freed id reused, short and window + 1 batches, at B = 1 and 8
   on 10 and on 3 levels) and a free-list pop past ``cap``; every array,
   the rng and every result equal; every fat case counted on the card
   (read once, at the end) ran, and every op's check was counted;
4c. ``rebalance_kernel_check``: the rebalance kernel (K12,
   ``csrc/rebalance.cu``, ``kernels.rebalance``) against its plain version,
   both on the card, on clones of the same states: each pass of every
   rebalancing apply of tests/test_rebalance.py:220's Zipf inserts and
   then deletes at a ceiling of 16 (node widths 1, 8, 128, both variants:
   splits and merges) and of 5 (the dead slots run out), the guard on a
   slot whose count outruns its keys, a given split and merge; every
   array, the boundaries and the counts equal, the whole in-place apply
   equal to guard, update kernel, watermark; then the watermark pass at
   the page table's geometry (8 slots of 16384, L = 16) splitting a shard
   filled to 0.8 and the given merge of its halves (kernel and plain
   timed, each with its phases from the kernel's clock, the byte bound)
   and a pass with nothing to do;
4d. ``scan_kernel_check``: the scan kernel (K13, ``csrc/range_scan.cu``,
   ``kernels.range_scan``) against its plain version on the card, two
   batches of scans a state (a list of 300 keys; 400 keys over 8 shards
   padded to 12, two shards emptied), node widths 1, 8, 128, both
   variants: ``max_out`` hit, ``lo`` past every key, ``hi`` at
   ``KEY_MAX``, spills across emptied shards and into the dead slots, a
   fat run straddling ``lo``, ``to_sorted_keys``; each batch at its
   largest ``max_out`` (the warp's gather) and just below
   ``range_scan.GATHER_FROM`` (lane 0's walk); keys, vals and counts
   equal, the sharded scans equal numpy;
4e. ``search_walk_check``: the recording search walk (K14,
   ``csrc/search_walk.cu``, ``kernels.search_walk``) under ``search`` and
   ``search_validated``, and ``search_fast`` (K1/K2 on the card), against
   their plain versions on the card and the CPU's runs, every field
   (found, vals, node, preds, steps, gathers) equal: 4000-key lists at
   node widths 1, 8 and 128, both
   variants, ``stop_level`` 0 and 2; the lists after 600 mixed ops through
   the update kernel (widths 1 and 8); an empty batch (no launch);
   ``KEY_MAX`` (found, -1); ``search_validated`` on 40% corrupt foreseen
   keys and on a lag-1 view; a corrupt table of each variant, in a
   subprocess, which must end in the kernel's trap;
5. the paper's configuration, once per variant: 2^25 keys drawn from
   [0, 2^26) (Synchrobench: key range twice the size), vals = keys + 1,
   27 levels, capacity 2^26, built on the card with
   ``repro_torch.core.skiplist.build``; 2^20 uniform and 2^20 Zipf(1.2)
   lookups through ``repro_torch.kernels.ops.search_kernel`` held against
   a numpy membership oracle; the kernel held against its plain version on
   the same queries; kernel, plain and ``torch.searchsorted`` times
   (median of CUDA-event timings) and the byte and sector bounds of the
   batch's paths.  K1 and K2 group their lanes by key range first: the
   pass is held against its plain version and a stable argsort and timed
   alone (``group_ms``, beside ``torch.sort``), the walk is also timed on
   the lanes in batch order (``ungrouped_ms``, checked equal) and on lanes
   grouped beforehand (``grouped_walk_ms``), and five calls are profiled
   (the pass's device time against the walk's).  Then the eager reads'
   main path, each call's launches read around it: ``search`` on both
   traffics (one K14 launch each) and ``search_fast`` (one K1/K2 launch,
   no K14), held against the oracle and their plain versions on the card
   (every field; ``steps`` and ``gathers`` also against the replay's path
   lengths), no synchronising call, times, the plain versions' and
   ``torch.searchsorted``'s (for ``search_fast``), ``search``'s bound;
6. updates and versioned reads at the same size: the foresight build in a
   ``VersionedIndex``, ``update`` with 65536 ops of fig3's upd=50% mix
   through the update kernel (each result held against a host oracle,
   then the foresight invariant; its synchronising calls counted: none),
   on both traffics 2^20 lag-1 reads through K8 (``search(lag=1,
   use_kernel=True)``), lag-0 reads through ``search`` (K14) and K1 and
   ``search_validated`` on the lag-1 view (K14), held against the oracle,
   the plain K8 and ``search_validated`` (itself against its plain
   version, timed and bounded as in 5); K8's times
   (grouped, in batch order, the pass alone, a profile), bound, path
   lengths and the queries its ``4L+16`` step cap cuts; then
   ``update_full_size``: the same batch through the update kernel alone on
   clones of the built state, foresight and then base (built there),
   equal to ``update``'s state, us an op by CUDA events, the clone's ms,
   ns a dependent step and the byte bound (the paths' distinct bytes and
   the bytes the batch changes); its first 64 ops through the plain
   version on the card too (three copies of the state), every array
   equal;
7. small sharded check (n=1500 keys in [0, 2^22), vals 3*keys, S=8,
   L=12, both variants): ``build_sharded``, ``split_shard``,
   ``merge_shards`` and ``repack`` on the card equal the CPU; on S=9 (a
   split) K3-K6 equal their plain versions (K5/K6, the tile-sorted walk,
   also their plan-order launch) on a half-hit batch and on the straddle
   stream, which takes K7's split and equals the CPU; an
   undersized ``k_shards`` raises; ``apply_ops_sharded(rebalance=True)``
   on 4 batches of 32 Zipf inserts equals the CPU in every array, result
   and shard count;
7b. small mesh check, the mesh index at D = 1 on one process group of one
   rank (NCCL for the card, gloo for the CPU run; an in-process store):
   ``build_mesh_index`` (n=1500, S=8, L=12, both variants, node widths 1
   and 8), ``search_mesh``, ``search_kernel_mesh`` (K10) and
   ``search_kernel(mesh=)`` on the card equal the CPU in every state
   array, found, vals and node; K5/K6 on the mesh's plan equal their plain
   versions and their plan-order launch; ``apply_ops_mesh(rebalance=True)``
   on an ``empty_mesh_index`` under 4 batches of 32 Zipf inserts, and
   ``pad_shards`` with the
   in-place split, merge, watermark pass and guard, equal the CPU in every
   array, result, shard count and ``DeviceLoadStats``;
7c. ``analysis``, the port's analysis gate (``repro_torch.analysis``):
   the budget pass on the live ptxas report of the build (every
   ``__global__``'s registers, spills, static and largest dynamic shared
   memory, threads a block and resident blocks a SM, against the sm_90
   limits and the committed ``ptxas_sm90a.txt``) and the ``sync`` pass
   (the synchronising CUDA calls of one call of each of the 13 audited
   entry points at their small sizes, on the mesh group above), and the
   update entry points' (``VersionedIndex.update``, ``PageTable._apply``,
   ``apply_ops_mesh``) at 8 and at 64 ops, and for the last two also on a
   state the batch overfills so that the guard splits: none in any (the
   in-place passes run on the card through the rebalance kernel); the
   eager reads' (``search``, ``search_fast``, ``search_validated``,
   ``VersionedIndex.search(lag=0)``, a monolithic store's ``lookup``: none
   allowed) and one ``ServeEngine.submit``'s and watchdog check's
   (reported; they read their answers back);
   fails on any finding outside ``repro_torch/analysis/baseline.json``
   and on ``BUDGET-STALE``.  The full-size phases 5 and 8 each make one more
   call of ``search_kernel`` / ``search_kernel_sharded`` under
   sync-debug mode on their states (``syncs_per_call``), gathered in the
   ``analysis_full_size`` line before 18;
8. the sharded engine at the paper's size, once per variant: the same
   2^25 keys over 64 shards of 2^21 slots, 21 levels, built with
   ``build_sharded``; 2^20 uniform and 2^20 Zipf(1.2) queries through
   ``search_kernel_sharded`` dense (K3/K4) and clustered (K5/K6),
   held against the numpy oracle, each other and the other variant; each
   kernel against its plain version; 65536 updates of fig3's upd=50% mix
   through ``apply_ops_sharded`` (one launch of the update kernel, one warp
   a shard) against a host oracle, then the sharded invariant and an
   unchanged input; the update kernel alone on clones of the stack (as in
   6), and the first 64 ops on shards 0-7 through the plain version too;
   kernel, plain, plan, end-to-end and
   ``torch.searchsorted`` times, bounds from a per-shard replay, path
   lengths, auto-K and the ``ndist`` histogram.  K3/K4 group their lanes
   by shard first (``group_by_shard``): the pass is held against its plain
   version and a stable argsort and timed alone (``group_ms``, beside
   ``torch.sort``), and the dense walk is also timed without the pass,
   on the lanes in batch order (``ungrouped_ms``).  K5/K6 sort each tile
   of plan lanes by key inside their one launch: each is also timed in
   the plan's lane order (``plan_order_ms``, the launch the tile sort
   replaced), checked equal, and one call of each is profiled;
8b. the mesh index at the paper's size, after each sharded variant (its
   stack freed first): ``build_mesh_index(n_devices=1, n_shards=64)``
   equal to ``build_sharded``'s build (fingerprint); both traffics
   through ``search_kernel_mesh`` held against the oracle and the sharded
   clustered answers (found, vals, node); 65536 updates of fig3's mix
   through ``apply_ops_mesh`` (rebalancing off) against the host oracle,
   then ``check_mesh_invariant`` and ``DeviceLoadStats``; times of the
   whole path, its exchange (route, sort, both ``all_to_all``s), its
   K5/K6 launch (beside their plan-order launch, checked equal, and a
   profile of one launch) and the same index's ``search_kernel_sharded``,
   the launch's bound and ``torch.searchsorted``;
9. small fat check, node widths B = 8 and 128, both variants: a fat
   ``build`` (n=4000), ``build_sharded`` (n=1500, S=8), ``split_shard`` to
   S=9, ``merge_shards`` and ``repack`` on the card equal the CPU; K1-K6
   with the K9 postlude equal their plain versions on a half-hit batch at
   the default step cap and at 9 steps; the S=9 straddle stream takes K7
   and equals the CPU; a mixed ``apply_ops`` stream on a dense key range
   runs every insert case (upsert, room, split, first node) and every
   delete case (plain, minimum lane, node emptied) and equals the CPU;
   ``apply_ops_sharded(rebalance=True)`` on Zipf inserts, ``range_scan``,
   ``range_scan_sharded`` and ``check_fat_invariant`` equal the CPU; K1
   with K9 at B = 6 (rows not 16-byte aligned), 33 (not a multiple of 4)
   and 256 (two passes of K9's row compare) equals its plain version;
10. the fat layout at the paper's size: the same 2^25 keys packed into
   runs (``benchmarks/common.py:26-41``, ``benchmarks/fig_fat_node.py``):
   B = 128 (2^19 nodes, capacity 2^21, L = 27), both variants, and B = 8
   (capacity 2^25), foresight, through ``search_kernel`` (K1/K2 + K9,
   grouped by key range, and timed in batch order as in 5); B = 128 over
   S = 64 shards (2^15 node slots a shard, L = 21), both traffics through
   the dense and clustered paths (K3-K6 + K9, K7; the dense walk grouped,
   and timed ungrouped as in 8) and the eager ``search_sharded``; answers
   held against the numpy oracle and the scalar phases' answers, every
   kernel against its plain version, node ids dereferenced into
   ``fat_vals``; 65536 updates of fig3's upd=50%
   mix through ``apply_ops`` (B = 128 monolith) and ``apply_ops_sharded``
   against the host oracle, then ``check_fat_invariant`` and an unchanged
   input; K9 alone (``fat_resolve``, at B = 128 and 8) checked and timed
   on the final predecessors; times, bounds from a replay that counts
   distinct records plus distinct runs x B x 4 bytes, path lengths, peak
   memory;
11. the sample store (``data.store``, ``data.pipeline``) at the paper's
   size, once per variant: the 2^25 keys as sample keys, rows ``[2^25,
   129]`` int32 (17.3 GB) drawn on the card from a seeded generator, 64
   shards, L = 21, ``use_kernel``; two 2^20 ``DataPipeline`` batches
   through ``get_batch`` (K5/K6), a dense ``lookup`` (K3/K4), 8192
   ingests and 8192 evictions of new keys (a batch each through the update
   kernel); found, row ids, tokens, ingested and
   evicted keys, the sharded invariant checked, the stack's
   ``range_scan`` refused (its int32 index wraps at 64 x 21 x 2^21); then
   the monolithic store on every other key (2^24 samples, L = 26) through
   K1/K2 and a 2048-key ``range_scan`` (one launch of the scan kernel, K13)
   held against numpy and against its plain version (both timed, with the
   scan's byte bound); ``get_batch``,
   ``lookup``, the same index's ``search_kernel_sharded`` and pipeline
   times, us an update, build seconds, peak memory;
12. the paged-KV page table (``serving.kvcache``) of a card's pool, once
   per variant: 2^15 pages of 16 tokens (Llama-3-8B's KV at 64 GiB),
   ``use_kernel`` and in-place rebalancing (8 shards of 16384 slots); 8
   prefill bursts of 144 sequences of 16 blocks through ``try_alloc`` (a
   grant a batch through the update kernel) under a seeded
   ``FaultSchedule`` at ``kvcache.alloc`` (one forced pool exhaustion, one
   forced capacity failure), a decode lookup of every block of the newest
   64 sequences (1024 lanes, K5/K6) a burst, ``release`` of the oldest
   past 1024 running, so that the pool ends half full; a request past a
   256-page pool
   that must grant a prefix; conservation, a host dict, the sharded
   invariant and ``InvariantWatchdog`` over a stub engine checked; every
   apply runs the guard (after a K3/K4 presence search) and the watermark
   pass through the rebalance kernel (K12), none read back; the decode
   lookup's time and us an alloc and a release;
13. ``model_smoke_check``, the model plane (``models``, ``configs``)
   and the engine (``serving.engine``) on the card against the CPU: each
   of the ten smoke configs, with params drawn on the CPU from a seeded
   generator and carried to the card, in bf16 and in fp32, runs
   ``forward``, ``prefill`` (a 48-slot cache) and 4 ``decode_step``s on
   both devices (the card fed the CPU's tokens), held within
   ``tests/test_torch_models.py``'s tolerances; ``moe._dispatch_group``'s
   routing integers equal on equal fp32 inputs (TF32 off), a tie case
   included; decode agrees with forward on ``tests/test_models.py``'s
   three archs; the llama3_8b smoke engine (``launch.serve``'s path, 8
   requests) gives the CPU's token ids, steps and events, a flip allowed
   only at a near tie of the CPU's logits (reported);
14. ``serve_full_width``: llama3_8b's full ``CONFIG`` (32 layers, d_model
   4096, GQA 32/8, d_ff 14336, vocab 128256, rope theta 5e5; 7.5e9 bf16
   params drawn on the card from a seeded generator), served through
   ``launch.serve``'s ``make_engine`` / ``make_requests`` / ``serve`` by a
   ``ServeEngine(batch_slots=8, max_len=512, page_tokens=16)``: 16
   requests of 256 seeded uniform tokens, 64 new tokens each; every
   request done, the watchdog green on every step, no page or session
   left; the first wave's 8 requests equal the same batch replayed by
   hand (each prompt prefilled alone, spliced into an 8-slot cache,
   greedy decode), request 1 against a batch-1 run (reported); prefill
   of t[:255] then a decode of t[255] against the full sequence at depth
   1 of the same params (reported at 1, 2, 4, 8, 32: random-init layers
   decorrelate); prefill ms (256 tokens), decode-step ms at 8 live slots
   against its bound (weights and live KV over the HBM rate), tokens/s,
   peak memory, the device kernels of one decode step and one prefill
   (``torch.profiler``).  Then granite_moe_1b (32 experts, top 8) and
   rwkv6_3b at full width: a 256-token prefill and 16 decode steps, finite
   logits,
   MoE conservation and the dispatch's integers card against CPU on layer
   0's router, rwkv6's decode against its forward (by depth, as above);
15. ``train_smoke_check``, the training path (``train.step``,
   ``optim.adamw``, ``checkpoint``, ``launch.train``) on the card against
   the CPU: each of the ten smoke configs, params drawn on the CPU and
   carried across, TF32 off, its loss and every gradient (remat "dots" on
   the card, through the autograd bf16 product) within 1e-3 in fp32 (or
   3x the CPU's own response to a one-ulp nudge) and 0.05 in bf16 (0.1
   for the MoE archs, whose bf16 combine's order varies on the card);
   ``launch.train`` at smoke size (25 steps, a checkpoint every 10) and
   again with a failure injected at step 15: the replay after the
   restore gives the uninterrupted run's losses bit for bit, under
   ``torch.use_deterministic_algorithms``; a train state's checkpoint
   round trip on the card, bit for bit;
16. ``train_full_width``: llama3_8b's widths (d_model 4096, GQA 32/8,
   d_ff 14336, vocab 128256, theta 5e5, remat "dots") at 8 of its 32
   layers (the 32-layer train state does not fit the card), 2.27e9 bf16
   params drawn on the card, the attention weights rescaled to their
   contraction's fan-in (the reference's init saturates attention at this
   width: ``chip_probe_train.py`` reports it); ``make_train_step`` with
   ``adamw.config_for`` on 6 batches of 8 x 1024 tokens that a
   ``DataPipeline`` draws from a ``use_kernel`` store (K1 and its pass),
   then one more under ``torch.profiler``; block 0's and the first two
   layers' gradients through the bf16 product against fp32
   recomputations; 8 steps on one repeated batch (lr 3e-4, warmup 2)
   whose loss must fall; step ms, tokens/s, FLOPs from the shapes (causal
   attention counted as S(S+1)/2 positions, the masked half the port
   computes reported apart) and their share of the bf16 peak and of the
   bound, peak memory and the profile by kernel kind;
17. ``mesh_model_one_card``, the model plane through DTensor on the 1x1
   ``DeviceMesh`` of the one-rank NCCL group (``launch.mesh.model_mesh``):
   the step factories place params, moments, batches and caches by their
   spec trees and run under the policy's ``cs``; held against the same
   factories on the host mesh (plain tensors) on the same params and
   inputs: llama3_8b's full ``CONFIG`` (a prefill of 2 x 256 tokens, 8
   decode steps on seeded tokens; logits within ``MESH_TOL`` of max abs,
   bit equality reported), its widths at 2 of 32 layers trained 3 steps
   on 4 x 1024 tokens (losses and grad norms within ``MESH_TOL``), and
   granite_moe_1b's full ``CONFIG`` (the grouped MoE dispatch under
   ``cs``): a train step on 2 x 256 tokens and a decode step; ms a step
   on each path; both paths under ``torch.use_deterministic_algorithms``
   (the MoE combine's ``index_add_`` and the embedding's backward
   accumulate in a fixed order, so the two paths' sums agree);
18. ``dryrun_cells``: ``python -m repro_torch.launch.dryrun`` (a fake
   process group of 256 or 512 ranks, the step traced on fake CUDA
   tensors) for llama3_8b x train_4k on 16x16, phi35_moe_42b x train_4k
   and jamba_15_large_398b x decode_32k on 2x16x16, three processes
   started together after every timed phase (so that no measured number
   shares the host with them), each one's standard error in a file; per
   device: argument, output and peak GiB beside the card's 80 GB
   (``fits_80gb`` is reported, not required: the traced peak is the
   port's, ROADMAP item 17), product FLOPs and collective bytes by kind;
   any cell that fails to trace fails the run;
19. the script's wall seconds, then the ``kernels`` line: every ported
   kernel with its main-path launches (K5/K6's include those K10, the
   store and the page table made; K1-K4's those of the store, K1's also
   those of the full-width training path), the fat
   launches of K1-K6 as rows of their own, ``fat_resolve``,
   ``search_kernel_mesh`` (K10), ``group_by_shard`` (its launches on the
   four sharded main paths and the store's dense lookups) and
   ``group_by_key`` (its launches on the K1, K2, K8, fat K1/K2,
   monolithic store and training main paths) and ``apply_ops``, the
   update kernel (its launches on every update main path; its times those
   of the monolithic 64-op batch that the plain version also ran, the
   65536-op batch's beside them); ``search_walk`` (K14: the foresight
   ``search`` on traffic A, with its launches on every K14 main path,
   each read around its own call) and its rows for the base variant,
   ``search_validated`` and the fat lists (B = 128 both variants, B = 8).

Then the nvidia-smi line and, last, ``{"ok": true, "device": {...}}``.
Any failed check, build or launch raises, and the script exits non-zero.
``CUBLAS_WORKSPACE_CONFIG`` is set for the whole process, so every phase's
cuBLAS calls run with that workspace.
"""
from __future__ import annotations

import os

# the restart checks run under torch.use_deterministic_algorithms, which
# needs this set before the first cuBLAS call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch import configs as cfgs  # noqa: E402
from repro_torch.analysis import capture_audit as ca  # noqa: E402
from repro_torch.analysis import kernel_budget as kb  # noqa: E402
from repro_torch.analysis.baseline import (apply_baseline,  # noqa: E402
                                           load_baseline)
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.convert import (flat_items, mesh_to_numpy,  # noqa: E402
                                 train_state_to_numpy)
from repro_torch.core import mesh_index as mi  # noqa: E402
from repro_torch.core import rebalance_traced as rbt  # noqa: E402
from repro_torch.core import sharded as shd  # noqa: E402
from repro_torch.core import skiplist as sl  # noqa: E402
from repro_torch.core.validated import (search_validated,  # noqa: E402
                                        search_validated_plain)
from repro_torch.core.versioned import VersionedIndex  # noqa: E402
from repro_torch.data.pipeline import (DataPipeline,  # noqa: E402
                                       PipelineConfig)
from repro_torch.data.store import IndexedSampleStore, StoreConfig  # noqa: E402,E501
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import apply_ops as ak  # noqa: E402
from repro_torch.kernels import foresight_traverse as ft  # noqa: E402
from repro_torch.kernels import mesh_launch as ml  # noqa: E402
from repro_torch.kernels import range_scan as rs  # noqa: E402
from repro_torch.kernels import rebalance as rk  # noqa: E402
from repro_torch.kernels import search_walk as sw  # noqa: E402
from repro_torch.kernels import shard_group as sg  # noqa: E402
from repro_torch.kernels import validated_traverse as vt  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     make_index_mesh, model_mesh)
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel.sharding import place_tree, policy_for  # noqa: E402,E501
from repro_torch.runtime.chaos import (CAPACITY_FAIL,  # noqa: E402
                                       POOL_EXHAUSTED, FaultInjector,
                                       FaultSchedule)
from repro_torch.serving.engine import EngineConfig  # noqa: E402
from repro_torch.serving.kvcache import (PagedCacheConfig,  # noqa: E402
                                         PageTable, page_key)
from repro_torch.serving.watchdog import InvariantWatchdog  # noqa: E402
from repro_torch.train import step as STEP  # noqa: E402

SEED = 0
# benchmarks/fig4_batch_sweep.py:3-4 (2^25 elements), benchmarks/common.py
# (key range 2x the size, capacity the next power of two)
FULL_N, FULL_SPAN, FULL_CAP, FULL_LEVELS = 2**25, 2**26, 2**26, 27
FULL_BATCH = 2**20
SMALL = dict(n=4000, capacity=8192, levels=14)
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12         # H100 SXM non-tensor float32 peak
KERNEL_REPS, PLAIN_REPS = 20, 5
# benchmarks/fig3_sequential.py at upd=50% (benchmarks/common.py:63-73):
# 25% insert, 25% delete, 50% read, keys uniform over the key range; one
# batch through the update kernel (apply_ops.cu), and its first
# PLAIN_UPDATE_OPS through the plain host loop on the card as well
UPDATE_OPS = 65536
PLAIN_UPDATE_OPS = 64
UPDATE_REPS = 2
# The sharded configuration: S = 64, the largest shard count of
# benchmarks/fig_shard_skew.py:37, over the same 2^25 keys: m = 2^19 keys
# and shard_capacity_for(2^25, 64) = 2^21 slots a shard; L = 21 is
# benchmarks/common.py:35's ceil(log2(n)) + 2 for a shard's 2^19 keys.
SHARDS, SHARD_LEVELS = 64, 21
SHARD_UPDATE_OPS = 65536
PLAIN_UPDATE_SHARDS = 8      # the plain comparison's shards of the stack
ZIPF_A = 1.2             # benchmarks/common.py:55-60, YCSB-style hot keys
# The fat configuration: fig_fat_node's acceptance width B = 128 and its
# narrowest B = 8 (benchmarks/fig_fat_node.py:42), capacity as
# benchmarks/common.py:37-38 sizes it; the sharded one keeps S = 64.
FAT_WIDTHS = (128, 8)
TRAVERSE_CU = "src/repro_torch/csrc/traverse.cu"
SHARD_GROUP_CU = "src/repro_torch/csrc/shard_group.cu"
FT_PY = "src/repro/kernels/foresight_traverse.py"
K14_SOURCE = "src/repro_torch/csrc/search_walk.cu"
K14_PLAIN_REPS = 3          # the host loops: 20-60 ms a call at full size
KERNELS = {   # name -> (wrapper, plain version, source, TPU kernel replaced)
    "foresight_traverse": (ft.foresight_traverse, ft.foresight_traverse_plain,
                           TRAVERSE_CU, f"{FT_PY}:303"),
    "base_traverse": (ft.base_traverse, ft.base_traverse_plain, TRAVERSE_CU,
                      f"{FT_PY}:698"),
    "validated_traverse": (vt.validated_traverse, vt.validated_traverse_plain,
                           "src/repro_torch/csrc/validated_traverse.cu",
                           "src/repro/kernels/validated_traverse.py:60"),
    "foresight_traverse_sharded": (ft.foresight_traverse_sharded,
                                   ft.foresight_traverse_sharded_plain,
                                   TRAVERSE_CU, f"{FT_PY}:416"),
    "base_traverse_sharded": (ft.base_traverse_sharded,
                              ft.base_traverse_sharded_plain, TRAVERSE_CU,
                              f"{FT_PY}:462"),
    "foresight_traverse_clustered": (ft.foresight_traverse_clustered,
                                     ft.foresight_traverse_clustered_plain,
                                     TRAVERSE_CU, f"{FT_PY}:585"),
    "base_traverse_clustered": (ft.base_traverse_clustered,
                                ft.base_traverse_clustered_plain,
                                TRAVERSE_CU, f"{FT_PY}:645"),
    # K3/K4's grouping pass: a new kernel that stands in for no TPU kernel
    "group_by_shard": (sg.group_by_shard, sg.group_by_shard_plain,
                       SHARD_GROUP_CU, "none (a new pass; no TPU kernel)"),
    # K2/K8's key-range grouping pass, the same
    "group_by_key": (sg.group_by_key, sg.group_by_key_plain, SHARD_GROUP_CU,
                     "none (a new pass; no TPU kernel)"),
    # the write path: every writer's batch, one block a shard
    "apply_ops": (ak.apply_ops_batch, ak.apply_ops_batch_plain,
                  "src/repro_torch/csrc/apply_ops.cu",
                  "none: src/repro/core/skiplist.py:930 apply_ops, a jitted "
                  "lax.scan (no Pallas kernel)"),
    # the in-place rebalance passes: one cooperative launch a pass
    "rebalance": (rk.rebalance_pass, rk.rebalance_pass_plain,
                  "src/repro_torch/csrc/rebalance.cu",
                  "none: src/repro/core/rebalance_traced.py:245 "
                  "watermark_rebalance_traced and :305 "
                  "exhaustion_guard_traced, lax.while_loop (no Pallas "
                  "kernel)"),
    # the ordered scans: one warp a scan
    "range_scan": (rs.range_scan_batch, rs.range_scan_batch_plain,
                   "src/repro_torch/csrc/range_scan.cu",
                   "none: src/repro/core/skiplist.py:1055 range_scan and "
                   "src/repro/core/sharded.py:324 range_scan_sharded, "
                   "lax.fori_loop (no Pallas kernel)"),
    # the eager recording reads: search and search_validated, one launch
    # a call
    "search_walk": (sw.search_walk, sl.search_plain, K14_SOURCE,
                    "none: src/repro/core/skiplist.py:435 search "
                    "(_search_loop's lax.while_loop, :410) and "
                    "src/repro/core/validated.py:37 search_validated, "
                    "lax.while_loop (no Pallas kernel)"),
}
# the kernels the data and serving planes' main paths launch (the page
# table, the store); every other kernel launches before them
PLANE_KERNELS = ("rebalance", "range_scan")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def reset_launches() -> None:
    for wrapper, *_ in KERNELS.values():
        wrapper.launches = 0
    for wrapper in ft.WALKS:
        wrapper.fat_launches = 0
    ft.fat_resolve.launches = 0
    ml.search_kernel_mesh.launches = 0


def read_launches() -> dict:
    out = {name: w.launches for name, (w, *_) in KERNELS.items()}
    out.update({f"{w.__name__}/fat": w.fat_launches for w in ft.WALKS})
    out["fat_resolve"] = ft.fat_resolve.launches
    out["search_kernel_mesh"] = ml.search_kernel_mesh.launches
    return out


def counted(fn):
    """``fn()`` and the launches that call made, by kernel: every counter
    read just before and just after it."""
    before = read_launches()
    out = fn()
    after = read_launches()
    return out, {name: after[name] - before[name] for name in after}


def table_args(st: sl.SkipListState):
    return (st.fused,) if st.foresight else (st.nxt, st.keys)


def kernel_name(st: sl.SkipListState) -> str:
    return "foresight_traverse" if st.foresight else "base_traverse"


def max_abs_err(a, b) -> int:
    return max(int((x.long() - y.long()).abs().max()) for x, y in zip(a, b))


def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def path_footprint(tables, q: torch.Tensor, sid=None, fat_keys=None
                   ) -> dict:
    """Distinct index entries the batch's paths read, and the path lengths.

    ``tables`` is ``(fused,)`` or ``(nxt, keys)`` with a leading shard axis
    (``[None]`` for a monolithic list); lane ``i`` walks shard ``sid[i]``
    (all 0 when ``sid`` is None), at that shard's offsets.  Replays the
    traversal with plain tensor ops, keeps every index each active lane
    reads (the loop's reads and the final level-0 read) and counts the
    distinct ones with ``torch.unique``.  Foresight reads 8-byte fused
    records; base reads 4-byte ``nxt`` entries and 4-byte ``keys``.  With
    ``fat_keys [S, cap, B]`` the K9 postlude also reads each query's owner
    run, ``B`` 4-byte keys: distinct runs x B x 4 bytes, and ``B``
    compares a query.  Also counts the distinct 32-byte sectors (the
    smallest unit HBM serves).
    """
    foresight = len(tables) == 1
    S, L, cap = tables[0].shape[:3]
    flat = tables[0].reshape(-1, 2) if foresight else tables[0].reshape(-1)
    sid = torch.zeros_like(q).long() if sid is None else sid.long()
    x = torch.zeros_like(q)
    lvl = torch.full_like(q, L - 1)
    path = torch.zeros_like(q)
    rec_idx, key_idx = [], []
    while bool((lvl >= 0).any()):
        active = lvl >= 0
        idx = (sid * L + lvl.clamp(min=0).long()) * cap + x.long()
        if foresight:
            ptr, fk = flat[idx].unbind(1)
        else:
            ptr = flat[idx]
            kidx = sid * cap + ptr.long()
            fk = tables[1].reshape(-1)[kidx]
            key_idx.append(kidx[active])
        rec_idx.append(idx[active])
        path += active.int()
        go = active & (fk < q)
        x = torch.where(go, ptr, x)
        lvl = torch.where(go | ~active, lvl, lvl - 1)
    last = sid * L * cap + x.long()            # the final level-0 read
    rec_idx.append(last)
    if not foresight:
        key_idx.append(sid * cap + flat[last].long())
    arrays = [(torch.cat(rec_idx), 8 if foresight else 4)]
    if key_idx:
        arrays.append((torch.cat(key_idx), 4))
    distinct = sum(int(torch.unique(i).numel()) * b for i, b in arrays)
    sectors = sum(int(torch.unique(i * b // 32).numel()) * 32
                  for i, b in arrays)
    out = dict(distinct_bytes=distinct, sector_bytes=sectors,
               steps=int(path.sum()), path=path, x=x)
    if fat_keys is not None:
        B = fat_keys.shape[-1]
        if foresight:
            cand, ck = flat[last].unbind(1)
        else:
            cand = flat[last]
            ck = tables[1].reshape(-1)[sid * cap + cand.long()]
        owner = torch.where((ck == q) | (x == 0), cand, x)
        runs = int(torch.unique(sid * cap + owner.long()).numel())
        out.update(distinct_runs=runs, compares=B * q.numel())
        out["distinct_bytes"] += runs * B * 4
        out["sector_bytes"] += runs * -(-B * 4 // 32) * 32
    return out


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    line = out.strip().splitlines()[0]
    emit({"phase": "card", "nvidia_smi": line,
          "torch_device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return line


def build_kernels() -> None:
    t0 = time.perf_counter()
    lib = _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": Path(lib._name).name,
          "nvcc_flags": " ".join(_build.NVCC_FLAGS)})


def monolith_launch(name: str, tables, q: torch.Tensor, fat_keys=None,
                    max_steps: int = 0, out_idx=None) -> tuple:
    """K1 (``foresight_traverse``), K2 (``base_traverse``) or K8
    (``validated_traverse``) launched through ``_build.launch`` directly,
    without the wrapper's key grouping:
    lane i walks q[i] and writes at ``out_idx[i]``.  ``out_idx`` None is the
    launch on the lanes in batch order; ``group_by_key``'s (q_sorted, perm)
    as (q, out_idx) is the grouped walk without its pass.  It counts no
    launch."""
    node, key = torch.empty_like(q), torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    idx = None if out_idx is None else out_idx.data_ptr()
    if name == "validated_traverse":
        fused, auth = tables
        L, cap, _ = fused.shape
        _build.launch("validated_traverse_launch", fused.data_ptr(),
                      auth.data_ptr(), idx, q.data_ptr(), node.data_ptr(),
                      key.data_ptr(), q.numel(), L, cap,
                      max_steps or vt.default_max_steps(L), stream)
        return node, key
    L, cap = tables[0].shape[:2]
    _build.launch(f"{name}_launch", *(t.data_ptr() for t in tables),
                  None if fat_keys is None else fat_keys.data_ptr(), idx,
                  q.data_ptr(), node.data_ptr(), key.data_ptr(), q.numel(), L,
                  cap, 1 if fat_keys is None else fat_keys.shape[-1],
                  max_steps or ft.traversal_bound(L, cap), stream)
    return node, key


WALK_KERNELS = {"foresight_traverse": "foresight_kernel",
                "base_traverse": "base_kernel",
                "validated_traverse": "validated_kernel"}


def split_times(name: str, tables, q: torch.Tensor, fat_keys=None) -> dict:
    """K1's, K2's or K8's call taken apart, by CUDA events: the walk on the
    lanes in batch order (``ungrouped_ms``, checked equal to the wrapper's
    answer) and on lanes grouped beforehand (``grouped_walk_ms``, the call
    without its pass); and a profile of five calls, pass against walk."""
    fat = () if fat_keys is None else (fat_keys,)
    want = KERNELS[name][0](*tables, q, *fat)
    check(max_abs_err(want, monolith_launch(name, tables, q, fat_keys)) == 0,
          f"grouped {name} equals its batch-order launch")
    q_s, perm = sg.group_by_key(q)
    check(max_abs_err(want, monolith_launch(name, tables, q_s, fat_keys,
                                            out_idx=perm)) == 0,
          f"{name} on lanes grouped beforehand equals the wrapper")
    walk = WALK_KERNELS[name]
    prof = device_breakdown(lambda: KERNELS[name][0](*tables, q, *fat),
                            calls=5, walk=walk)
    return {
        "ungrouped_ms": time_ms(
            lambda: monolith_launch(name, tables, q, fat_keys), KERNEL_REPS),
        "grouped_walk_ms": time_ms(
            lambda: monolith_launch(name, tables, q_s, fat_keys,
                                    out_idx=perm), KERNEL_REPS),
        "profile": prof,
        "ungrouped_profile": device_breakdown(
            lambda: monolith_launch(name, tables, q, fat_keys), calls=5,
            walk=walk)}


def check_key_grouping(q: torch.Tensor, what: str) -> int:
    """``group_by_key`` on the card equals its plain version, ``perm`` is a
    stable argsort of the key buckets and ``q_sorted = q[perm]``; returns
    the max abs error."""
    q_s, perm = sg.group_by_key(q)
    err = max_abs_err((perm,), (sg.group_by_key_plain(q),))
    check(err == 0, f"group_by_key equals its plain version ({what})")
    check(torch.equal(perm.long(), torch.argsort(sg.key_buckets(q),
                                                 stable=True)),
          f"group_by_key's perm is a stable argsort ({what})")
    check(torch.equal(q_s, q[perm.long()]),
          f"group_by_key's q_sorted ({what})")
    return err


def key_group_times(q: torch.Tensor) -> dict:
    """The key pass alone: its time, its plain version's and a stable
    ``torch.sort`` of the queries' (the library's nearest call)."""
    return dict(
        ms=time_ms(lambda: sg.group_by_key(q), KERNEL_REPS),
        plain_ms=time_ms(lambda: sg.group_by_key_plain(q), PLAIN_REPS),
        library_ms=time_ms(lambda: torch.sort(q, stable=True), KERNEL_REPS),
        # q read once; q_sorted and perm written once
        bound_ms=q.numel() * 12 / HBM_BYTES_PER_S * 1e3)


ANALYSIS_BASELINE = "src/repro_torch/analysis/baseline.json"
# syncs a call of the full-size searches, by path: filled by the full-size
# phases, printed in the analysis_full_size line
FULL_SYNCS = {}


def syncs_per_call(fn) -> dict:
    """One more call of ``fn`` under sync-debug mode: its synchronising
    CUDA calls, in all and by site of the port."""
    torch.cuda.synchronize()
    with ca.count_syncs() as sites:
        fn()
    torch.cuda.synchronize()
    by_site = {}
    for path, func, _ in sites:
        by_site[f"{path}:{func}"] = by_site.get(f"{path}:{func}", 0) + 1
    return {"syncs": len(sites), "sites": by_site}


UPDATE_ENTRY_POINTS = ("VersionedIndex.update", "PageTable._apply",
                       "apply_ops_mesh[rebalance]")


def widened(case: tuple, n: int) -> tuple:
    """An update entry point's case with its last three arguments (op
    types, keys, vals) grown to ``n`` ops: its own ops, then reads of
    other keys.  A read changes no state, so the in-place rebalance
    drivers see the same table at any ``n`` (64 inserts would overfill
    the mesh case's one live shard of 64 slots and add a split's reads),
    while the kernel runs every op."""
    *head, t, k, v = case
    extra = n - k.numel()
    i = torch.arange(extra, dtype=torch.int32, device=k.device)
    return (*head, torch.cat([t, torch.full_like(i, sl.OP_READ)]),
            torch.cat([k, k.max() + 1 + 3 * i]), torch.cat([v, i]))


def splitting_case(name: str, n: int) -> tuple:
    """(fn, args, state before, state after fn) of a rebalancing update
    entry point on a state whose one live shard ``n`` new inserts overfill,
    so that the guard splits it: ``PageTable._apply`` on the capture
    audit's table (``PagedCacheConfig(n_pages=256, levels=4, n_shards=2,
    max_shards=4)``), ``apply_ops_mesh[rebalance]`` on its one-device
    index (4 shards of 64 slots), each filled to 4 below its usable
    capacity first (without rebalancing)."""
    dev = torch.device(DEVICE)
    if name == "PageTable._apply":
        pt = PageTable(PagedCacheConfig(n_pages=256, levels=4, n_shards=2,
                                        rebalance=True, max_shards=4),
                       device=dev)
        shl = pt.index
    else:
        emp = mi.empty_mesh_index(n_devices=1, n_shards=4, capacity=64,
                                  levels=4, key_span=1 << 20, rank=0,
                                  device=dev)
        shl = emp.local
    usable = sl.usable_capacity(shl.shard_capacity, shl.node_width)
    fill = torch.arange(1, usable - 3, dtype=torch.int32, device=dev) * 3
    shl, _ = shd.apply_ops_sharded(shl, torch.full_like(fill, sl.OP_INSERT),
                                   fill, fill)
    new = torch.arange(n, dtype=torch.int32, device=dev) * 3 + 2
    args = (torch.full_like(new, sl.OP_INSERT), new, new)
    if name == "PageTable._apply":
        def fn(t, k, v):
            pt.index = shl
            pt._apply(t, k, v)
            return pt.index
        return fn, args, shl
    mesh = make_index_mesh(1)

    def fn(t, k, v):
        mx = mi.MeshShardedIndex(shl, emp.device_boundaries, 0)
        return mi.apply_ops_mesh(mx, t, k, v, mesh=mesh, rebalance=True,
                                 seed=0)[0].local
    return fn, args, shl


def update_syncs() -> dict:
    """Synchronising calls of one call of each update entry point at 8 and
    at 64 ops, after a warm-up call, by site: on the capture audit's
    state (nothing to split), and for ``PageTable._apply`` and
    ``apply_ops_mesh[rebalance]`` also on a state the batch overfills
    (``splitting_case``: the guard splits, the watermark pass runs on the
    split state).  None may make any: the in-place passes run on the card
    (K12), the guard's presence search is K3/K4."""
    out = {}
    for ep in ca.default_entry_points():
        if ep.name not in UPDATE_ENTRY_POINTS:
            continue
        fn, buckets = ep.build(torch.device(DEVICE))
        case = next(iter(buckets.values()))[0]
        row = {}
        for n in (8, 64):
            args = widened(case, n)
            fn(*args)
            row[n] = syncs_per_call(lambda: fn(*args))
        if ep.name != "VersionedIndex.update":
            for n in (8, 64):
                sfn, sargs, before = splitting_case(ep.name, n)
                sfn(*sargs)
                row[f"split_{n}"] = syncs_per_call(lambda: sfn(*sargs))
                after = sfn(*sargs)
                check(int(rbt.live_shard_count(after))
                      > int(rbt.live_shard_count(before)),
                      f"{ep.name}: the batch of {n} split a shard")
        out[ep.name] = row
        check(all(r["syncs"] == 0 for r in row.values()),
              f"{ep.name} makes no synchronising call, with or without a "
              "split")
    return out


# the eager reads that must make no synchronising call; the engine's
# admission and the watchdog keep their own reads and are reported only
EAGER_READS = ("search", "search_fast", "search_validated",
               "VersionedIndex.search(lag=0)", "IndexedSampleStore.lookup")


def eager_read_syncs() -> dict:
    """Synchronising calls of one call of each eager read on the card,
    after a warm-up call, by site: on a 4000-key list (``SMALL``), its
    ``VersionedIndex``, a monolithic ``IndexedSampleStore`` (its lookup is
    ``search_fast``), then one ``ServeEngine.submit`` and one watchdog
    check of the llama3_8b smoke engine.  Each of ``EAGER_READS`` must make
    none."""
    dev = torch.device(DEVICE)
    keys = small_keys()
    st = sl.build(keys, keys + 1, capacity=SMALL["capacity"],
                  levels=SMALL["levels"], seed=SEED, device=dev)
    q = torch.from_numpy(read_queries(keys, 1 << 22, 4096, SEED)).to(dev)
    vi = VersionedIndex(st)
    store = IndexedSampleStore(StoreConfig(), device=dev)
    check(not store.sharded, "the store's index is one list")
    sq = torch.from_numpy(store.keys_np[:2048].astype(np.int32)).to(dev)
    fns = {"search": lambda: sl.search(st, q),
           "search_fast": lambda: sl.search_fast(st, q),
           "search_validated": lambda: search_validated(st.fused, st.keys,
                                                        st.vals, q),
           "VersionedIndex.search(lag=0)": lambda: vi.search(q, lag=0),
           "IndexedSampleStore.lookup": lambda: store.lookup(sq)}
    cfg = cfgs.get_smoke(FULL_ARCH)
    eng = launch_serve.make_engine(cfg, EngineConfig(batch_slots=4,
                                                     max_len=64),
                                   seed=SEED, device=dev)
    reqs = iter(launch_serve.make_requests(cfg.vocab, 3, 12, 8, seed=SEED))
    fns["ServeEngine.submit"] = lambda: eng.submit(next(reqs))
    fns["InvariantWatchdog.check"] = lambda: eng.watchdog.check(eng)
    out = {}
    for name, fn in fns.items():
        fn()
        out[name] = syncs_per_call(fn)
    check(all(out[name]["syncs"] == 0 for name in EAGER_READS),
          "the eager reads make no synchronising call")
    return out


def analysis_check(smi: str) -> None:
    """The budget pass on the live ptxas report and the sync pass over the
    13 entry points (on the initialised mesh group); no finding may fall
    outside the baseline, and the record must be today's build's."""
    t0 = time.perf_counter()
    budget, _, rows = kb.run_budget(live=True)
    t_budget = time.perf_counter() - t0
    sync_findings, syncs = ca.run_sync_audit()
    _, new, _ = apply_baseline(budget + sync_findings,
                               load_baseline(Path(ANALYSIS_BASELINE)))
    upd = update_syncs()
    reads = eager_read_syncs()
    stale = [f.render() for f in budget if f.rule == "BUDGET-STALE"]
    emit({"phase": "analysis", "card": smi, "kernels": rows,
          # of the record, which the live report equals (else stale)
          "max_shards_under_smem": kb.max_shards_under_smem(),
          "syncs_per_call": {name: {k: v for k, v in row.items()
                                    if k != "sites"}
                             for name, row in syncs.items()},
          "sync_sites": {name: row["sites"] for name, row in syncs.items()},
          "update_syncs_per_call": {name: {n: r["syncs"]
                                           for n, r in row.items()}
                                    for name, row in upd.items()},
          "update_sync_sites": {name: row[64]["sites"]
                                for name, row in upd.items()},
          "eager_read_syncs_per_call": {name: r["syncs"]
                                        for name, r in reads.items()},
          "eager_read_sync_sites": {name: r["sites"]
                                    for name, r in reads.items()},
          "findings": len(budget) + len(sync_findings),
          "new_findings": len(new), "new": [f.render() for f in new],
          "budget_stale": stale, "budget_s": t_budget,
          "seconds": time.perf_counter() - t0})
    check(not stale, "the ptxas record is today's build's and equals the "
                     "live report")
    check(not new, "no analysis finding outside the baseline")


def small_check() -> None:
    rng = np.random.default_rng(SEED)
    keys = np.sort(rng.choice(1 << 22, SMALL["n"], replace=False))
    keys = keys.astype(np.int32)
    q_np = np.concatenate([rng.choice(keys, 2048),
                           rng.integers(0, 1 << 22, 2048)]).astype(np.int32)
    q = torch.from_numpy(q_np).to(DEVICE)
    report = {"phase": "small_check", **SMALL, "batch": q.numel()}
    for foresight in (True, False):
        args = dict(capacity=SMALL["capacity"], levels=SMALL["levels"],
                    foresight=foresight, seed=SEED)
        st = sl.build(keys, keys + 1, device=DEVICE, **args)
        cpu = sl.build(keys, keys + 1, device="cpu", **args)
        for name, t in st._asdict().items():
            if t is not None:
                check(torch.equal(t.cpu(), getattr(cpu, name)),
                      f"card build equals CPU build ({name})")
        wrapper, plain, *_ = KERNELS[kernel_name(st)]
        before = wrapper.launches, sg.group_by_key.launches
        got = wrapper(*table_args(st), q)
        want = plain(*table_args(st), q)
        check(wrapper.launches == before[0] + 1,
              f"{kernel_name(st)} launched")
        err = max_abs_err(got, want)
        check(err == 0, f"{kernel_name(st)} equals its plain version")
        report[kernel_name(st)] = {"max_abs_err": err}
        # K1 and K2 group their lanes by key
        check(sg.group_by_key.launches == before[1] + 1,
              f"{kernel_name(st)} ran group_by_key")
        check(max_abs_err(got, monolith_launch(
            kernel_name(st), table_args(st), q)) == 0,
              f"grouped {kernel_name(st)} equals its batch-order launch")
    report["group_by_key_err"] = check_key_grouping(q, "small")
    emit(report)


def small_keys() -> np.ndarray:
    rng = np.random.default_rng(SEED)
    return np.sort(rng.choice(1 << 22, SMALL["n"], replace=False)
                   ).astype(np.int32)


def mixed_ops(keys: np.ndarray, n: int, span: int, seed: int):
    """(op types, keys, vals) of a read/insert/delete stream; deletes and
    half the reads name present keys, inserts uniform keys."""
    rng = np.random.default_rng(seed)
    types = rng.choice(np.array([sl.OP_READ, sl.OP_INSERT, sl.OP_DELETE],
                                np.int32), n)
    ks = np.where((types == sl.OP_DELETE) | (rng.random(n) < 0.5),
                  rng.choice(keys, n), rng.integers(0, span, n))
    ks = ks.astype(np.int32)
    return types, ks, ks + 1


def on(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


def check_same_state(got: sl.SkipListState, want: sl.SkipListState,
                     what: str) -> None:
    for name, t in got._asdict().items():
        if t is not None:
            check(torch.equal(t.cpu(), getattr(want, name).cpu()),
                  f"{what} ({name})")


def check_k8(fused, auth, q, report: dict, label: str) -> None:
    """K8 (grouped by key) equals its plain version and its launch on the
    lanes in batch order bit for bit, at the default step cap and at a
    truncating one."""
    for max_steps in (0, 9):
        before = sg.group_by_key.launches
        got = vt.validated_traverse(fused, auth, q, max_steps=max_steps)
        check(sg.group_by_key.launches == before + 1,
              f"K8 ran group_by_key ({label})")
        want = vt.validated_traverse_plain(fused, auth, q,
                                           max_steps=max_steps)
        err = max(max_abs_err(got, want), max_abs_err(
            got, monolith_launch("validated_traverse", (fused, auth), q,
                                 max_steps=max_steps)))
        check(err == 0, f"grouped K8 equals its plain version and its "
                        f"batch-order launch ({label}, "
                        f"max_steps={max_steps})")
        report[f"k8_{label}_max_steps_{max_steps}_err"] = err


def small_update_check() -> None:
    """The write side on the card equals the CPU; K8 equals its plain
    version on a clean, a corrupted and a lag-1 table; insert-only lag-1
    reads answer for the stale key set."""
    keys = small_keys()
    args = dict(capacity=SMALL["capacity"], levels=SMALL["levels"],
                seed=SEED)
    stream = mixed_ops(keys, 2000, 1 << 22, SEED + 3)
    report = {"phase": "small_update_check", **SMALL, "ops": 2000}
    t_phase = t0 = time.perf_counter()
    for foresight in (True, False):
        st = sl.build(keys, keys + 1, foresight=foresight, device=DEVICE,
                      **args)
        cpu = sl.build(keys, keys + 1, foresight=foresight, device="cpu",
                       **args)
        new, res = sl.apply_ops(st, *on(DEVICE, *stream))
        new_cpu, res_cpu = sl.apply_ops(cpu, *on("cpu", *stream))
        check(torch.equal(res.cpu(), res_cpu), "apply_ops results, card "
              "equals CPU")
        check_same_state(new, new_cpu, "apply_ops state, card equals CPU")
        check_same_state(st, sl.build(keys, keys + 1, foresight=foresight,
                                      device="cpu", **args),
                         "apply_ops leaves its input unchanged")
        report[f"{'foresight' if foresight else 'base'}_results"] = \
            int(res.sum())
    report["apply_ops_s"] = time.perf_counter() - t0

    st = sl.build(keys, keys + 1, device=DEVICE, **args)
    rng = np.random.default_rng(SEED + 4)
    q, = on(DEVICE, np.concatenate([rng.choice(keys, 2048), rng.integers(
        0, 1 << 22, 2048)]).astype(np.int32))
    check_k8(st.fused, st.keys, q, report, "clean")
    fused = st.fused.cpu().numpy().copy()       # a copy, on any device
    fused[..., 1] = np.where(rng.random(fused.shape[:2]) < 0.4,
                             rng.integers(-2**31 + 1, 2**31 - 1,
                                          fused.shape[:2]), fused[..., 1])
    check_k8(on(DEVICE, fused)[0], st.keys, q, report, "corrupt40")
    vi = VersionedIndex(st)
    vi.update(*on(DEVICE, *stream))
    view = vi.read_view(lag=1)
    check_k8(view.fused, view.auth_keys, q, report, "lag1")

    vi = VersionedIndex(st)
    newk = rng.integers(0, 1 << 22, 512).astype(np.int32)
    vi.update(*on(DEVICE, np.full(512, sl.OP_INSERT, np.int32), newk,
                  newk + 1))
    q2 = torch.cat([q, on(DEVICE, newk)[0]])
    stale = np.isin(q2.cpu().numpy(), keys)
    for use_kernel in (True, False):
        found = vi.search(q2, lag=1, use_kernel=use_kernel).found
        check(np.array_equal(found.cpu().numpy(), stale),
              f"insert-only lag-1 read is stale membership "
              f"(use_kernel={use_kernel})")
    report["insert_only_stale_hits"] = int(stale.sum())
    report["seconds"] = time.perf_counter() - t_phase
    emit(report)


def kernel_check_stream(keys: np.ndarray, span: int, n: int, fill: int,
                        seed: int):
    """``fill`` inserts of fresh keys (past a small list's free slots),
    ``n`` mixed ops of types -1 .. 3 (``lax.switch`` clamps them) on keys
    half of them present, then ``KEY_MAX``'s insert, read, delete and read
    (last: a scalar delete frees the tail's slot)."""
    rng = np.random.default_rng(seed)
    fresh = rng.choice(np.setdiff1d(np.arange(span), keys), fill,
                       replace=False)
    types = np.concatenate([np.full(fill, sl.OP_INSERT),
                            rng.integers(-1, 4, n), [1, 0, 2, 0]])
    ks = np.concatenate([fresh, np.where(
        rng.random(n) < 0.5, rng.choice(keys, n), rng.integers(0, span, n)),
        np.full(4, sl.KEY_MAX)])
    return (types.astype(np.int32), ks.astype(np.int32),
            (ks * 5 + 3).astype(np.int32))


# update_kernel_check's states: (node width, keys, free node slots past
# the build, fresh inserts); the fat lists fill their runs first
KERNEL_CHECK_LISTS = ((1, 600, 20, 40), (8, 160, 2, 200), (128, 128, 1, 140))
# and the lists the window conflicts run on: (node width, levels)
CONFLICT_LISTS = ((1, 10), (8, 10), (1, 3), (8, 3))


def op_runs(*parts):
    """(op type, keys) runs -> the three int32 op arrays, vals key * 5 + 3."""
    types = np.concatenate([np.full(len(k), t) for t, k in parts])
    ks = np.concatenate([np.asarray(k) for _, k in parts])
    return (types.astype(np.int32), ks.astype(np.int32),
            (ks * 5 + 3).astype(np.int32))


def window_conflict_streams(keys: np.ndarray) -> dict:
    """Streams that make the update kernel's recorded predecessors fail
    their check, on the sorted ``keys``: 16-op grants of consecutive ids
    (the page table's), then the same ids read, deleted and inserted
    again; a key inserted, deleted and inserted again inside a window; a
    delete whose freed id the next insert reuses; fewer ops than a window;
    a window and one op."""
    I, R, D, W = sl.OP_INSERT, sl.OP_READ, sl.OP_DELETE, ak.WINDOW
    grants = np.concatenate([np.arange(k + 1, k + 17) for k in keys[1:8:3]])
    k0, k1 = int(keys[2]) + 1, int(keys[3]) + 1
    return {
        "grants": op_runs((I, grants), (R, grants), (D, grants[::-1]),
                          (I, grants[16:])),
        "reinsert": op_runs(*[(t, [k]) for t, k in zip(
            (I, D, I, D, I, D, I), (k0, k0, k0, k1, k1, k1, k0 + 1))],
            (R, [k0, k1])),
        "reuse": op_runs(*[(sl.OP_DELETE, [k]) if i % 2 == 0 else
                           (sl.OP_INSERT, [k + 7]) for i, k in
                           enumerate(np.repeat(keys[4:24], 2))]),
        "short": op_runs((I, [k0, k0 + 1, k0 + 2]), (D, keys[2:3]),
                         (R, [k0, int(keys[2])])),
        "window_plus_one": op_runs((I, k1 + np.arange(W)), (D, [k1])),
    }


def update_kernel_check() -> None:
    """The update kernel against its plain version, both on the card, on
    clones of the same small states: scalar and fat (B = 8, 128), foresight
    and base, a monolithic list filled until allocation is refused and 8
    shards; streams with op types -1 and 3 and ``KEY_MAX``'s cases, and at
    B = 8 ``fat_case_stream`` on an empty list; the window conflicts
    (``window_conflict_streams``) at B = 1 and 8 on 10 and on 3 levels,
    and a free-list pop past ``cap``.  Every array, the rng included, and
    every result equal; each fat case counted on the card (read once, at
    the end) ran, and every op's check was counted, some resuming a
    walk."""
    t0 = time.perf_counter()
    report = {"phase": "update_kernel_check", "comparisons": 0, "ops": 0}
    ak.reset_fat_cases(DEVICE)
    dev = torch.device(DEVICE)
    for width, n, free, fill in KERNEL_CHECK_LISTS:
        keys = small_keys()[:n]
        cap = sl.node_slots_for(n, width) + 2 + free
        for foresight in (True, False):
            what = f"{variant(foresight)} width {width}"
            st = sl.build(keys, keys * 2, capacity=cap, levels=10,
                          foresight=foresight, seed=SEED, node_width=width,
                          device=dev)
            cases = [(one_shard(st), route_sorted(
                None, 1, *kernel_check_stream(keys, 1 << 22, 120, fill,
                                              SEED + width)), "list")]
            if width == 8:
                empty = sl.empty(8, 6, foresight=foresight, seed=SEED,
                                 node_width=width, device=dev)
                cases.append((one_shard(empty), route_sorted(
                    None, 1, *fat_case_stream(width, SEED + width)),
                    "fat cases"))
            shl = shd.build_sharded(keys, keys * 3, n_shards=8, levels=10,
                                    foresight=foresight, seed=SEED,
                                    node_width=width, device=dev)
            cases.append((shl.shards, route_sorted(
                shl.boundaries, 8, *kernel_check_stream(
                    keys, 1 << 22, 160, 0, SEED + 1)), "8 shards"))
            for stack, batch, label in cases:
                got = plain_comparison(stack, batch, f"{what}, {label}",
                                       fill if label == "list" else 0)
                report["comparisons"] += 1
                report["ops"] += batch.n
                if label == "list":
                    report[f"{what} refused_inserts"] = \
                        got["refused_inserts"]
    for width, levels in CONFLICT_LISTS:
        keys = small_keys()[:120]
        for foresight in (True, False):
            st = sl.build(keys, keys * 2, capacity=sl.node_slots_for(
                120, width) + 160, levels=levels, foresight=foresight,
                seed=SEED, node_width=width, device=dev)
            for label, stream in window_conflict_streams(keys).items():
                if label == "window_plus_one" and (width, levels) != (1, 10):
                    continue                  # once: the longest stream
                what = (f"{variant(foresight)} width {width}, {levels} "
                        f"levels, {label}")
                batch = route_sorted(None, 1, *stream)
                plain_comparison(one_shard(st), batch, what)
                report["comparisons"] += 1
                report["ops"] += batch.n
    for foresight in (True, False):     # a free-list pop past cap
        st = sl.build(np.array([5, 9, 13], np.int32), [10, 18, 26],
                      capacity=8, levels=3, foresight=foresight, seed=SEED,
                      device=dev)
        batch = route_sorted(None, 1, *op_runs(
            (sl.OP_DELETE, [sl.KEY_MAX] * 12), (sl.OP_INSERT, [7])))
        plain_comparison(one_shard(st), batch,
                         f"{variant(foresight)}, a pop past cap")
        report["comparisons"] += 1
        report["ops"] += batch.n
    counts = ak.fat_cases(DEVICE)
    report["fat_cases"] = dict(counts)
    for case in ak.CASE_NAMES:
        check(counts[case] > 0, f"the update kernel ran fat case {case}")
    checks = ak.window_checks(DEVICE)
    report["window_checks"] = checks
    check(checks["ops_stood"] + checks["walks_resumed"] == report["ops"]
          and checks["walks_resumed"] > 0,
          "every op's predecessors were checked, and some walks resumed")
    report["seconds"] = time.perf_counter() - t0
    emit(report)


# ---------------------------------------------------------------------------
# The rebalance kernel (K12) and the scan kernel (K13) against their plain
# versions, both on the card
# ---------------------------------------------------------------------------

REBALANCE_WIDTHS = (1, 8, 128)
REBALANCE_SPAN = 1 << 22


def rebalance_start(width: int, foresight: bool, ceiling: int):
    """tests/test_rebalance.py:220's start: 48 keys a fill unit over 4
    shards of 16 node slots (12 of 14 full), padded to ``ceiling``."""
    fill = sl.pack_fill(width)
    keys = np.sort(np.random.default_rng(SEED).choice(
        REBALANCE_SPAN, 48 * fill, replace=False)).astype(np.int32)
    shl = shd.build_sharded(keys, keys * 3, n_shards=4, capacity=16,
                            levels=8, foresight=foresight, seed=SEED,
                            node_width=width, device=DEVICE)
    return keys, rbt.pad_shards(shl, ceiling)


def rebalance_streams(keys: np.ndarray, width: int, n_insert: int) -> list:
    """Batches of 32 fill units: Zipf(1.2) inserts folded into shard 0's
    range (tests/test_rebalance.py:220), then the start keys deleted."""
    fill = sl.pack_fill(width)
    B = 32 * fill
    rng = np.random.default_rng(7)
    hot = int(keys[2])
    out = [(np.full(B, sl.OP_INSERT, np.int32),
            (hot + (rng.zipf(ZIPF_A, B) - 1) % (4096 * fill)
             ).astype(np.int32)) for _ in range(n_insert)]
    for part in (keys[:B], keys[B:]):
        ops_ = np.full(B, sl.OP_READ, np.int32)
        ops_[:part.size] = sl.OP_DELETE
        out.append((ops_, np.concatenate(
            [part, keys[:B - part.size]]).astype(np.int32)))
    return out


def sharded_err(a: shd.ShardedSkipList, b: shd.ShardedSkipList) -> int:
    """The largest difference between two stacks' arrays (0: equal)."""
    pairs = [(x, y) for x, y in zip(a.shards, b.shards) if x is not None]
    pairs.append((a.boundaries, b.boundaries))
    return max(int((as_i32(x).long() - as_i32(y).long()).abs().max())
               for x, y in pairs)


def k12_against_plain(shl: shd.ShardedSkipList, mode: str, report: dict,
                      what: str, **kw) -> tuple:
    """K12 and its plain version on two clones of ``shl``, both on the
    card: every array, the boundaries and the counts equal.  Returns the
    kernel's (state, counts)."""
    a, b = rbt.working_copy(shl), rbt.working_copy(shl)
    got = rk.rebalance_pass(a, mode, **kw)
    want = rk.rebalance_pass_plain(b, mode, **kw)
    err = max(sharded_err(a, b), int((got - want).abs().max()))
    report["max_abs_err"] = max(report["max_abs_err"], err)
    report["comparisons"] += 1
    check(err == 0, f"K12 equals its plain version on the card ({what}, "
                    f"{mode}: every array, the rng, the boundaries and the "
                    "counts)")
    return a, got


def rebalance_kernel_check() -> dict:
    """The rebalance kernel (``csrc/rebalance.cu``) against its plain
    version, both on the card, on clones of the same states: every
    rebalancing apply of tests/test_rebalance.py:220's Zipf inserts and
    then deletes at a ceiling of 16 (node widths 1, 8 and 128, both
    variants; splits and merges), at a ceiling of 5 (the dead slots run
    out), the guard on a slot whose count outruns its keys (the median at
    the minimum, an indivisible key mass), and one given split and merge.
    Each apply's guard and watermark pass is held against the plain
    version, and the whole ``apply_ops_sharded(_in_place=True)`` against
    that sequence.  Then the timed pass: the page table's geometry
    (``PagedCacheConfig(n_pages=2^15)``: 8 slots of 16384 node slots, 16
    levels), one shard filled to 0.8, the watermark pass splitting it
    (kernel and plain, one run each on clones) and a pass with nothing to
    do.  Returns the kernels line's row."""
    t0 = time.perf_counter()
    report = {"phase": "rebalance_kernel_check", "comparisons": 0,
              "applies": 0, "splits": 0, "merges": 0, "max_abs_err": 0}
    runs = [(w, fs, 16, 2 if w == 128 else 3) for w in REBALANCE_WIDTHS
            for fs in (True, False)]
    runs += [(w, True, 5, 3) for w in (1, 8)]
    for width, foresight, ceiling, n_insert in runs:
        what = f"{variant(foresight)} width {width}, ceiling {ceiling}"
        keys, shl = rebalance_start(width, foresight, ceiling)
        most = 0
        for b, (ops_, kk) in enumerate(rebalance_streams(keys, width,
                                                         n_insert)):
            t, k, v = (torch.from_numpy(x).to(DEVICE)
                       for x in (ops_, kk, kk * 2))
            g, cg = k12_against_plain(shl, "guard", report, what,
                                      op_types=t, keys=k, seed=b)
            perm, starts, lens = shd._route_batch(g, k)
            res = shd._apply_segments_inplace(g.shards, t, k, v, perm,
                                              starts, lens)
            w, cw = k12_against_plain(g, "watermark", report, what, seed=b)
            out, res2 = shd.apply_ops_sharded(shl, t, k, v, rebalance=True,
                                              seed=b, _in_place=True)
            check(torch.equal(res, res2) and sharded_err(out, w) == 0,
                  f"the rebalancing apply is guard, update kernel, "
                  f"watermark ({what})")
            report["applies"] += 1
            report["splits"] += int(cg[0]) + int(cw[0])
            report["merges"] += int(cw[1])
            shl = out
            most = max(most, int(rbt.live_shard_count(shl)))
        if ceiling == 5:
            check(most == 5, f"the dead slots ran out ({what})")
    check(report["splits"] > 0 and report["merges"] > 0,
          "the streams split and merged shards")
    for width in (1, 8):                 # a count that outruns the keys
        keys, shl = rebalance_start(width, True, 16)
        usable = sl.usable_capacity(16, width)
        for case in ("dead", "live"):
            x = rbt.working_copy(shl)
            if case == "dead":
                s, kk, op = x.n_shards - 1, keys[:1], sl.OP_READ
            else:
                kk = np.asarray([int(keys[-1]) + 7], np.int32)
                s = int(shd.route(x.boundaries, torch.from_numpy(kk))[0])
                op = sl.OP_INSERT
            x.shards.n[s] = 2 * usable - (op == sl.OP_INSERT)
            _, c = k12_against_plain(
                x, "guard", report, f"width {width}, {case} slot",
                op_types=torch.full((1,), op, dtype=torch.int32,
                                    device=DEVICE),
                keys=torch.from_numpy(kk).to(DEVICE), seed=1)
            check(int(c[0]) == 0, "an indivisible key mass splits nothing")
        at = torch.tensor(int(shl.boundaries[1]) + 1, dtype=torch.int32,
                          device=DEVICE)
        x, _ = k12_against_plain(shl, "split", report, f"width {width}",
                                 s=1, at=at, seed=5)
        k12_against_plain(x, "merge", report, f"width {width}", s=1,
                          seed=3)
    report.update(rebalance_times())
    report["seconds"] = time.perf_counter() - t0
    emit(report)
    _, _, source, replaces = KERNELS["rebalance"]
    return {"name": "rebalance", "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0,
            "max_abs_err": report["max_abs_err"],
            "ms": report["split_ms"], "plain_ms": report["split_plain_ms"],
            "bound_ms": report["split_bound_ms"], "bound_by": "bytes",
            "library_ms": None, "noop_pass_ms": report["noop_ms"],
            "split_walk_nodes": report["split_walk_nodes"],
            "split_phases_ms": report["split_phases_ms"],
            "merge_ms": report["merge_ms"],
            "merge_plain_ms": report["merge_plain_ms"],
            "merge_bound_ms": report["merge_bound_ms"]}


def slot_bytes(shl: shd.ShardedSkipList) -> int:
    """Bytes of one slot of a stack, every array."""
    return sum(t[0].numel() * t.element_size() for t in shl.shards
               if t is not None)


def k12_timed(shl: shd.ShardedSkipList, mode: str, *, reps: int = 1,
              device_time: bool = False, **kw) -> tuple:
    """K12 on ``reps`` fresh clones of ``shl`` (CUDA events around the
    wrapper's call, one run a clone) and its plain version once on another
    (the host clock), every kernel run held equal to the plain version;
    with ``device_time`` also the kernel's own device time a call
    (``torch.profiler``, 5 calls on fresh clones).  Returns (the last
    run's state, its counts, {"ms": a run's times, "plain_ms", "phases_ms":
    each run's first trip from ``rk.last_phases``, "device_ms"})."""
    b = rbt.working_copy(shl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = rk.rebalance_pass_plain(b, mode, **kw)
    torch.cuda.synchronize()
    out = {"ms": [], "plain_ms": (time.perf_counter() - t0) * 1e3,
           "phases_ms": [], "device_ms": None}
    for _ in range(reps):
        a = rbt.working_copy(shl)
        got, ms = event_ms(lambda: rk.rebalance_pass(a, mode, **kw))
        out["ms"].append(ms)
        out["phases_ms"].append(rk.last_phases(a))
        check(sharded_err(a, b) == 0 and torch.equal(got, want),
              f"the timed K12 {mode} pass equals its plain version")
    if device_time:
        out["device_ms"] = device_breakdown(
            lambda: rk.rebalance_pass(rbt.working_copy(shl), mode, **kw),
            calls=5, walk="rebalance_kernel")["walk_device_ms"]
    return a, got, out


def page_table_states() -> tuple:
    """The page table's index (``PagedCacheConfig(n_pages=2^15)``: 8 slots
    of 16,384 node slots, 16 levels) empty, the same with one shard filled
    to 0.8, and that shard's keys."""
    cfg = PagedCacheConfig(n_pages=PT_PAGES, page_tokens=PT_PAGE_TOKENS,
                           levels=PT_LEVELS, foresight=True, use_kernel=True,
                           rebalance=True, seed=SEED)
    base = PageTable(cfg, device=DEVICE).index
    usable = sl.usable_capacity(base.shard_capacity, base.node_width)
    n = int(0.8 * usable)
    kk = torch.arange(1, n + 1, dtype=torch.int32, device=DEVICE) * 7
    full, _ = shd.apply_ops_sharded(base, torch.full_like(kk, sl.OP_INSERT),
                                    kk, kk)
    return base, full, n


def rebalance_times() -> dict:
    """K12 at the page table's geometry: the watermark pass splitting one
    shard filled to 0.8, then the given merge of its two halves (kernel and
    plain on clones, one run each; the kernel's state checked against the
    plain version's), each with its phases from the kernel's own clock, and
    a pass with nothing to do (the median of ``KERNEL_REPS`` runs, the
    wrapper's host time included).  The byte bound of a split or merge: the
    run read once (a level-0 record and a val a key), the slots right of it
    read and written once as they shift, and the two slots written."""
    base, full, n = page_table_states()
    noop_ms = time_ms(lambda: rk.rebalance_pass(base, "watermark"),
                      KERNEL_REPS)
    s = int(torch.argmax(full.shards.n))
    split, got, st = k12_timed(full, "watermark")
    check(int(got[0]) >= 1 and int(split.shards.n[s]) + int(
        split.shards.n[s + 1]) == n, "the timed watermark pass split the "
                                     "full shard, as its plain version did")
    _, mgot, mt = k12_timed(split, "merge", s=s, seed=1)
    check(int(mgot[1]) == 1, "the timed merge merged the two halves")
    S = full.n_shards
    moved = (S - 2) * 2 * slot_bytes(full) + 2 * slot_bytes(full)
    read = n * (8 + 4)
    bound_ms = (moved + read) / HBM_BYTES_PER_S * 1e3
    return {"noop_ms": noop_ms, "split_ms": st["ms"][0],
            "split_plain_ms": st["plain_ms"],
            "split_counts": got.tolist(), "split_walk_nodes": n,
            "split_slots": S, "split_slot_capacity": full.shard_capacity,
            "split_bound_bytes": moved + read, "split_bound_ms": bound_ms,
            "split_phases_ms": st["phases_ms"][0], "merge_ms": mt["ms"][0],
            "merge_plain_ms": mt["plain_ms"], "merge_bound_ms": bound_ms,
            "merge_phases_ms": mt["phases_ms"][0]}


def scan_cases(keys: np.ndarray, width: int) -> list:
    """(lo, hi, max_out): max_out hit, the whole list, lo past every key,
    hi at KEY_MAX, lo below every key, an empty range, lo inside a run
    (fat: the run straddles it), a long range."""
    k = keys
    mid = int(k[k.size // 2])
    return [(int(k[3]), int(k[-3]), 5), (int(k[0]), int(k[-1]) + 1, k.size),
            (int(k[-1]) + 1, sl.KEY_MAX, 8), (mid, sl.KEY_MAX, 40),
            (-5, int(k[10]), 64), (mid, mid, 4),
            (mid + 1, mid + 3 * width, 30),
            (int(k[k.size // 3]), int(k[k.size // 3]) + 500, 200)]


def scan_kernel_check() -> None:
    """The scan kernel (``csrc/range_scan.cu``) against its plain version,
    both on the card, two batches of scans a state: a monolithic list of
    300 keys and 400 keys over 8 shards of 128 slots padded to 12, the
    keys of shards 2 and 3 deleted (node widths 1, 8 and 128, both
    variants); ``max_out`` hit, ``lo`` past every key, ``hi`` at
    ``KEY_MAX``, spills across emptied shards and into the dead slots, a
    fat run straddling ``lo``, and ``to_sorted_keys``.  Each batch runs at
    its cases' largest ``max_out`` (the warp's top-down gather) and at
    ``GATHER_FROM - 1`` (a scalar scan walked by lane 0).  Keys, vals and counts equal, and the
    sharded scans equal a numpy oracle."""
    t0 = time.perf_counter()
    report = {"phase": "scan_kernel_check", "scans": 0, "batches": 0,
              "max_abs_err": 0}
    rng = np.random.default_rng(SEED)
    for width in (1, 8, 128):
        for foresight in (True, False):
            what = f"{variant(foresight)} width {width}"
            keys = np.sort(rng.choice(1 << 16, 300, replace=False)
                           ).astype(np.int32)
            cap = (2 * 300 + 16 if width == 1
                   else 2 * 300 // sl.pack_fill(width) + 16)
            st = sl.build(keys, keys * 3 + 1, capacity=cap, levels=9,
                          foresight=foresight, seed=SEED, node_width=width,
                          device=DEVICE)
            skeys = np.sort(rng.choice(1 << 16, 400, replace=False)
                            ).astype(np.int32)
            shl = rbt.pad_shards(shd.build_sharded(
                skeys, skeys * 5, n_shards=8, capacity=128, levels=8,
                foresight=foresight, seed=SEED, node_width=width,
                device=DEVICE), 12)
            b = shl.boundaries.cpu().numpy()
            gone = skeys[(skeys >= b[2]) & (skeys < b[4])]
            gone_t = torch.from_numpy(gone).to(DEVICE)
            shl, _ = shd.apply_ops_sharded(
                shl, torch.full_like(gone_t, sl.OP_DELETE), gone_t, gone_t)
            live = np.setdiff1d(skeys, gone)
            sh_cases = scan_cases(live, width) + [
                (int(b[1]) + 1, int(b[6]), 200), (int(b[7]), sl.KEY_MAX, 100),
                (int(live[-1]), sl.KEY_MAX, 3), (int(b[2]), int(b[4]), 10),
                (int(live[live < b[2]][-3]), int(b[6]), 30),
                (int(live[-3]), sl.KEY_MAX, 30)]
            jobs = [(sl._stack_of_one(st), None, scan_cases(keys, width),
                     None),
                    (shl.shards, shl.boundaries, sh_cases, live)]
            for stack, bnd, cases, oracle in jobs:
                # the cases' largest max_out (the warp's gather), then one
                # below GATHER_FROM (a scalar scan walked by lane 0)
                for m in (max(c[2] for c in cases), rs.GATHER_FROM - 1):
                    lo = torch.tensor([c[0] for c in cases],
                                      dtype=torch.int32, device=DEVICE)
                    hi = torch.tensor([c[1] for c in cases],
                                      dtype=torch.int32, device=DEVICE)
                    got = rs.range_scan_batch(stack, bnd, lo, hi, m)
                    want = rs.range_scan_batch_plain(stack, bnd, lo, hi, m)
                    err = max(int((g.long() - w.long()).abs().max())
                              for g, w in zip(got, want))
                    report["max_abs_err"] = max(report["max_abs_err"], err)
                    where = "sharded" if bnd is not None else "list"
                    check(err == 0, f"K13 equals its plain version on the "
                                    f"card ({what}, {where}, max_out {m})")
                    if oracle is not None:
                        for i, (a, z, _) in enumerate(cases):
                            sel = oracle[(oracle >= a) & (oracle < z)][:m]
                            check(int(want[2][i]) == sel.size
                                  and np.array_equal(
                                      want[0][i, :sel.size].cpu().numpy(),
                                      sel),
                                  f"the sharded scan equals numpy ({what})")
                    report["scans"] += len(cases)
                    report["batches"] += 1
            for m in (1, 40, 305):
                got = sl.to_sorted_keys(st, m)
                want = sl.to_sorted_keys_plain(st, m)
                check(torch.equal(got, want),
                      f"to_sorted_keys equals its plain version ({what})")
    report["seconds"] = time.perf_counter() - t0
    emit(report)


SEARCH_FIELDS = sl.SearchResult._fields


def result_err(got, want, fields, what: str) -> int:
    """Every field of two read results equal in dtype, shape and value
    (checked); the largest absolute difference, 0."""
    err = 0
    for name, g, w in zip(fields, got, want):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{what}: {name} dtype and shape")
        if g.numel():
            err = max(err, int((g.cpu().long() - w.cpu().long()).abs().max()))
    check(err == 0, f"{what}: every field equal")
    return err


def k14_against_plain(st: dict, q_np: np.ndarray, what: str,
                      stop: int = 0) -> int:
    """``search`` (at ``stop``, one K14 launch) and ``search_fast`` (one
    K1/K2 launch) on the card, against their plain versions on the same
    card state and the CPU's run on the CPU state; the max abs error, 0."""
    q = {dev: torch.from_numpy(q_np).to(dev) for dev in (DEVICE, "cpu")}
    got, n_got = counted(lambda: sl.search(st[DEVICE], q[DEVICE],
                                           stop_level=stop))
    fast, n_fast = counted(lambda: sl.search_fast(st[DEVICE], q[DEVICE]))
    walk = kernel_name(st[DEVICE])
    check(n_got["search_walk"] == 1 and n_fast["search_walk"] == 0 and
          n_fast[walk] == 1, f"search launched K14 once and search_fast "
                             f"{walk} once ({what})")
    err = max(
        result_err(got, sl.search_plain(st[DEVICE], q[DEVICE],
                                        stop_level=stop),
                   SEARCH_FIELDS, f"K14 search = plain on the card ({what})"),
        result_err(got, sl.search(st["cpu"], q["cpu"], stop_level=stop),
                   SEARCH_FIELDS, f"K14 search = the CPU ({what})"),
        result_err(fast, sl.search_fast_plain(st[DEVICE], q[DEVICE]),
                   ("found", "vals"), f"search_fast = plain ({what})"),
        result_err(fast, sl.search_fast(st["cpu"], q["cpu"]),
                   ("found", "vals"), f"search_fast = the CPU ({what})"))
    check(not bool(got.preds[:, :stop].any()),
          f"preds below stop_level stay 0 ({what})")
    return err


def read_queries(keys: np.ndarray, span: int, n: int, seed: int
                 ) -> np.ndarray:
    """Half keys, half draws from the span, and the edges: ``KEY_MAX``, the
    least key, one below it and ``KEY_MIN + 1``."""
    rng = np.random.default_rng(seed)
    edge = [sl.KEY_MAX, int(keys[0]), int(keys[0]) - 1, sl.KEY_MIN + 1]
    return np.concatenate([rng.choice(keys, n // 2),
                           rng.integers(0, span, n // 2), edge]
                          ).astype(np.int32)


# a level-0 cycle: node 302 (key 3010) points back at node 102 (key 1010)
# with a key below every query, so the unvalidated walk for 3015 loops
# (the reference's would loop for ever); K14 must trap
K14_CYCLE = """
import sys
import torch
sys.path.insert(0, {src!r})
from repro_torch.core import skiplist as sl
keys = list(range(10, 6000, 10))
st = sl.build(keys, list(range(len(keys))), capacity=1024, levels=8,
              foresight={foresight!r}, seed=1, device="cuda")
if st.foresight:
    st.fused[0, 302] = torch.tensor([102, 0], dtype=torch.int32)
else:
    st.nxt[0, 302] = 102
    st.keys[102] = 0
sl.search(st, torch.tensor([3015], dtype=torch.int32, device="cuda"))
torch.cuda.synchronize()
print("NO TRAP")
"""


def k14_cycle_traps() -> dict:
    """Start ``K14_CYCLE`` for each variant, in subprocesses run side by
    side; each must fail in the kernel's trap.  Returns the CUDA error
    each one reported."""
    procs = {variant(fs): subprocess.Popen(
        [sys.executable, "-c", K14_CYCLE.format(
            src=str(Path(__file__).resolve().parent / "src"),
            foresight=fs)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for fs in (True, False)}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        check(proc.returncode != 0 and "NO TRAP" not in stdout and
              "CUDA error" in stderr,
              f"a corrupt {name} table ends in K14's trap: {stdout[-300:]} "
              f"{stderr[-600:]}")
        out[name] = [ln for ln in stderr.splitlines()
                     if "CUDA error" in ln][-1][-200:]
    return out


def search_walk_check() -> None:
    """The recording search walk (K14, ``csrc/search_walk.cu``) and
    ``search_fast`` (K1/K2) against their plain versions on the card and
    the CPU's runs, bit for bit in every field (found, vals, node, preds,
    steps, gathers): lists of 4000 keys at
    node widths 1, 8 and 128, both variants, ``stop_level`` 0 and 2; the
    same lists after 600 mixed ops through the update kernel (ids out of
    key order, freed slots reused), widths 1 and 8; an empty batch (no
    launch); ``KEY_MAX`` (found, -1); ``search_validated`` on 40% corrupt
    foreseen keys and on a lag-1 view; a corrupt table of each variant, in
    a subprocess, ending in the trap."""
    t0 = time.perf_counter()
    report = {"phase": "search_walk_check", "comparisons": 0,
              "max_abs_err": 0}
    keys = small_keys()
    span = 1 << 22
    launches0 = sw.search_walk.launches

    def note(err: int) -> None:
        report["comparisons"] += 1
        report["max_abs_err"] = max(report["max_abs_err"], err)

    for width in (1, 8, 128):
        cap = SMALL["capacity"] if width == 1 else fat_capacity(SMALL["n"],
                                                                 width)
        for foresight in (True, False):
            what = f"{variant(foresight)} width {width}"
            st = {dev: sl.build(keys, keys + 1, capacity=cap,
                                levels=SMALL["levels"], foresight=foresight,
                                seed=SEED, node_width=width, device=dev)
                  for dev in (DEVICE, "cpu")}
            q_np = read_queries(keys, span, 1024, SEED + width)
            for stop in (0, 2):
                note(k14_against_plain(st, q_np, f"{what}, stop {stop}",
                                       stop))
            res = sl.search(st[DEVICE], torch.full(
                (33,), sl.KEY_MAX, dtype=torch.int32, device=DEVICE))
            check(bool(res.found.all()) and
                  bool((res.vals == sl.NULL_VAL).all()),
                  f"KEY_MAX is found with -1 ({what})")
            if width == 128:
                continue
            stream = mixed_ops(keys, 600, span, SEED + 7)
            after = {dev: sl.apply_ops(st[dev], *on(dev, *stream))[0]
                     for dev in st}
            check_same_state(after[DEVICE], after["cpu"],
                             f"K11's state equals the CPU's ({what})")
            q_np = np.concatenate([read_queries(keys, span, 1024, SEED + 9),
                                   stream[1]])      # deleted, inserted keys
            for stop in (0, 2):
                note(k14_against_plain(after, q_np, f"{what} after K11, "
                                       f"stop {stop}", stop))
    st = sl.build(keys, keys + 1, capacity=SMALL["capacity"],
                  levels=SMALL["levels"], seed=SEED, device=DEVICE)
    empty = torch.zeros(0, dtype=torch.int32, device=DEVICE)
    before = sw.search_walk.launches
    res = sl.search(st, empty)
    check(res.preds.shape == (0, SMALL["levels"]) and int(res.steps) == 0
          and int(res.gathers) == 0 and sl.search_fast(st, empty)[0].numel()
          == 0 and search_validated(st.fused, st.keys, st.vals,
                                    empty).found.numel() == 0 and
          sw.search_walk.launches == before,
          "an empty batch reads nothing and launches nothing")
    rng = np.random.default_rng(SEED + 4)
    fused = st.fused.cpu().numpy().copy()
    fused[..., 1] = np.where(rng.random(fused.shape[:2]) < 0.4,
                             rng.integers(-2**31 + 1, 2**31 - 1,
                                          fused.shape[:2]), fused[..., 1])
    vi = VersionedIndex(st)
    vi.update(*on(DEVICE, *mixed_ops(keys, 2000, span, SEED + 3)))
    view = vi.read_view(lag=1)
    q_np = read_queries(keys, span, 4096, SEED + 5)
    views = {"corrupt40": (on(DEVICE, fused)[0], st.keys, st.vals),
             "lag1": (view.fused, view.auth_keys, view.vals)}
    for label, args in views.items():
        cpu_args = [t.cpu() for t in args]
        q = torch.from_numpy(q_np).to(DEVICE)
        before = sw.search_walk.launches
        got = search_validated(*args, q)
        check(sw.search_walk.launches == before + 1,
              f"search_validated launched K14 ({label})")
        note(max(result_err(got, search_validated_plain(*args, q),
                            SEARCH_FIELDS, f"K14 validated = plain on the "
                                           f"card ({label})"),
                 result_err(got, search_validated(*cpu_args, q.cpu()),
                            SEARCH_FIELDS, f"K14 validated = the CPU "
                                           f"({label})")))
    report["k14_launches"] = sw.search_walk.launches - launches0
    report["trap"] = k14_cycle_traps()
    report["seconds"] = time.perf_counter() - t0
    emit(report)


def synchrobench_ops(n: int, seed: int):
    """fig3_sequential's upd=50% mix: 25% insert, 25% delete, 50% read,
    keys uniform over [0, FULL_SPAN), inserted vals = key + 1."""
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    types = np.where(u < 0.25, sl.OP_INSERT,
                     np.where(u < 0.5, sl.OP_DELETE, sl.OP_READ))
    ks = rng.integers(0, FULL_SPAN, n).astype(np.int32)
    return types.astype(np.int32), ks, ks + 1


def host_oracle(keys_np: np.ndarray, types, ks):
    """Per-op results of the stream on the sorted keys, and the key set
    after it."""
    idx = np.minimum(np.searchsorted(keys_np, ks), len(keys_np) - 1)
    present = dict(zip(ks.tolist(), (keys_np[idx] == ks).tolist()))
    results = []
    for t, k in zip(types.tolist(), ks.tolist()):
        p = present[k]
        if t == sl.OP_INSERT:
            present[k] = True
        elif t == sl.OP_DELETE:
            present[k] = False
        results.append(int(not p if t == sl.OP_INSERT else p))
    gone = [k for k, v in present.items() if not v]
    new = [k for k, v in present.items() if v]
    current = np.union1d(np.setdiff1d(keys_np, gone), new).astype(np.int32)
    return np.array(results, np.int32), current


# ---------------------------------------------------------------------------
# The update kernel (apply_ops.cu) at full size: routing, times and bounds
# ---------------------------------------------------------------------------

def route_sorted(boundaries, n_shards: int, types, ks, vs):
    """A batch as ``apply_ops_sharded`` hands it to the kernel, on the card:
    the ops sorted by shard (stable), their shard ids, ``starts`` /
    ``lens`` a shard; ``boundaries`` None is one shard."""
    t, k, v = on(torch.device(DEVICE), types, ks, vs)
    sid = (torch.zeros_like(k) if boundaries is None
           else shd.route(boundaries, k))
    perm = torch.argsort(sid, stable=True)
    starts, lens = shd.shard_segments(sid[perm], n_shards)
    return SimpleNamespace(ops=(t[perm], k[perm], v[perm]), sid=sid[perm],
                           perm=perm, starts=starts, lens=lens, n=k.numel(),
                           shards=int((lens > 0).sum()))


def stack_tables(stack: sl.SkipListState):
    """A stacked state's walk tables, leading shard axis kept."""
    return (stack.fused,) if stack.foresight else (stack.nxt, stack.keys)


def as_i32(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def same_on_card(a: sl.SkipListState, b: sl.SkipListState) -> bool:
    """Every array of two states equal, compared on the card."""
    return all(torch.equal(as_i32(x), as_i32(y)) for x, y in zip(a, b)
               if x is not None)


def changed_bytes(before: sl.SkipListState, after: sl.SkipListState) -> int:
    """Bytes of ``after`` that differ from ``before``: what the batch must
    write at least (compared in chunks of 2^28 words)."""
    n = torch.zeros((), dtype=torch.int64, device=DEVICE)
    for x, y in zip(before, after):
        if x is None:
            continue
        xf, yf = as_i32(x).reshape(-1), as_i32(y).reshape(-1)
        for i in range(0, xf.numel(), 1 << 28):
            n += (xf[i:i + (1 << 28)] != yf[i:i + (1 << 28)]).sum()
    return int(n) * 4


def update_bound(stack: sl.SkipListState, batch, after: sl.SkipListState
                 ) -> dict:
    """The batch's paths replayed on ``stack`` (each op's walk; a fat
    split's second walk is not counted) and its byte bound: the distinct
    bytes the paths read, the bytes the batch changes, the ops read and
    the results written, over the card's memory rate."""
    fp = path_footprint(stack_tables(stack), batch.ops[1], batch.sid,
                        stack.fat_keys)
    written = changed_bytes(stack, after)
    total = fp["distinct_bytes"] + written + batch.n * 16
    per_shard = torch.bincount(batch.sid.long(), weights=fp["path"].double(),
                               minlength=batch.lens.numel())
    return {"steps": fp["steps"], "mean_path_steps": fp["steps"] / batch.n,
            "critical_shard_steps": int(per_shard.max()),
            "distinct_read_bytes": fp["distinct_bytes"],
            "written_bytes": written, "bound_bytes": total,
            "bound_ms": total / HBM_BYTES_PER_S * 1e3}


def event_ms(fn):
    """(``fn()``'s result, its CUDA-event ms): one run, no warm-up (the
    kernel changes the state it runs on)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def update_times(stack: sl.SkipListState, batch, want=None) -> tuple:
    """The update kernel alone on ``batch`` over fresh clones of the
    stacked ``stack`` (``UPDATE_REPS`` runs, the clone not timed), the
    clone's own ms, ns a dependent step, the byte bound and the kernel's
    window checks (the last run's, read once).  Every run's results equal
    the first's (and ``want``'s).  Returns (report, the last run's state,
    its results)."""
    clone_ms = time_ms(lambda: sl._clone(stack), PLAIN_REPS)
    times, first, after = [], None, None
    for _ in range(UPDATE_REPS):
        after = None                   # one clone at a time
        after = sl._clone(stack)
        ak.reset_fat_cases(DEVICE)
        res, ms = event_ms(lambda: ak.apply_ops_batch(
            after, *batch.ops, batch.starts, batch.lens))
        times.append(ms)
        first = res if first is None else first
        check(torch.equal(res, first) and (want is None or
                                           torch.equal(res, want)),
              "the update kernel's results equal on every run")
    ms = statistics.median(times)
    checks = ak.window_checks(DEVICE)          # the last run's
    check(checks["ops_stood"] + checks["walks_resumed"] == batch.n,
          "the update kernel checked every op's predecessors")
    b = update_bound(stack, batch, after)
    return ({"ops": batch.n, "shards_with_ops": batch.shards, "ms": ms,
             "reps_ms": times, "us_per_op": ms * 1e3 / batch.n,
             "clone_ms": clone_ms, "window_checks": checks,
             "resumed_share": checks["walks_resumed"] / batch.n,
             "steps_per_resumed_walk": checks["resumed_steps"]
             / max(checks["walks_resumed"], 1), **b,
             "ns_per_step": ms * 1e6 / b["steps"],
             "ns_per_critical_shard_step": ms * 1e6
             / b["critical_shard_steps"],
             "bound_share": b["bound_ms"] / ms}, after, first)


def plain_comparison(stack: sl.SkipListState, batch, what: str,
                     fill: int = 0) -> dict:
    """The update kernel and its plain version (the host loop, on the
    card) on two clones of ``stack``: every array, the rng included, and
    every result equal; each one's time; the byte bound.  ``fill``: the
    batch opens with that many inserts of fresh keys into one list, and
    some must be refused for want of a slot."""
    a, b = sl._clone(stack), sl._clone(stack)
    res_k, ms = event_ms(lambda: ak.apply_ops_batch(
        a, *batch.ops, batch.starts, batch.lens))
    t0 = time.perf_counter()
    res_p = ak.apply_ops_batch_plain(b, *batch.ops, batch.starts,
                                     batch.lens)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = int((res_k - res_p).abs().max()) if batch.n else 0
    check(err == 0 and same_on_card(a, b),
          f"the update kernel equals its plain version on the card "
          f"({what}: every array, the rng and the results)")
    bound = update_bound(stack, batch, a)
    del a, b
    refused = int((res_k[:fill] == 0).sum())
    check(refused > 0 or not fill, f"the list filled up ({what})")
    return {"ops": batch.n, "shards_with_ops": batch.shards, "ms": ms,
            "refused_inserts": refused,
            "plain_ms": plain_ms, "us_per_op": ms * 1e3 / batch.n,
            "plain_us_per_op": plain_ms * 1e3 / batch.n,
            "max_abs_err": err, **bound,
            "ns_per_step": ms * 1e6 / bound["steps"]}


def one_shard(state: sl.SkipListState) -> sl.SkipListState:
    """A monolithic state as a stack of one (views)."""
    return sl.SkipListState(*(None if t is None else t[None] for t in state))


def check_lookups(found, vals, q_np, keys_np, what: str) -> None:
    idx = np.minimum(np.searchsorted(keys_np, q_np), len(keys_np) - 1)
    hit = keys_np[idx] == q_np
    check(np.array_equal(found.cpu().numpy(), hit), f"{what}: found")
    check(np.array_equal(vals.cpu().numpy(),
                         np.where(hit, q_np + 1, sl.NULL_VAL)),
          f"{what}: vals")


def validated_footprint(fused, auth, q, max_steps: int) -> dict:
    """What K8 reads on this batch, and each query's untruncated path.

    Replays the validated traversal with plain tensor ops.  Up to
    ``max_steps`` it keeps every fused record index each active lane reads
    and every ``auth`` index the kernel loads (level 0, and above it only
    where the foreseen key says advance), plus the final level-0 record
    and its key.  Past ``max_steps`` it only counts steps, for the path
    lengths the cap cuts.
    """
    L, cap, _ = fused.shape
    flat = fused.view(-1, 2)
    x = torch.zeros_like(q)
    lvl = torch.full_like(q, L - 1)
    path = torch.zeros_like(q)
    rec_idx, key_idx, loads, step = [], [], 0, 0
    x_at_cap = x
    while bool((lvl >= 0).any()):
        active = lvl >= 0
        idx = lvl.clamp(min=0).long() * cap + x.long()
        ptr, fk = flat[idx].unbind(1)
        need = active & ((lvl == 0) | (fk < q))
        go = need & (auth[ptr.long()] < q)
        if step < max_steps:
            rec_idx.append(idx[active])
            key_idx.append(ptr[need].long())
            loads += int(active.sum()) + int(need.sum())
        path += active.int()
        x = torch.where(go, ptr, x)
        lvl = torch.where(go | ~active, lvl, lvl - 1)
        step += 1
        if step == max_steps:
            x_at_cap = x
    if step < max_steps:
        x_at_cap = x
    rec_idx.append(x_at_cap.long())
    key_idx.append(flat[x_at_cap.long(), 0].long())
    arrays = [(torch.cat(rec_idx), 8), (torch.cat(key_idx), 4)]
    return dict(
        distinct_bytes=sum(int(torch.unique(i).numel()) * b
                           for i, b in arrays),
        sector_bytes=sum(int(torch.unique(i * b // 32).numel()) * 32
                         for i, b in arrays),
        loads=loads, path=path)


def versioned_full_size(keys_np: np.ndarray, traffic: dict) -> dict:
    """Updates and mixed-view reads at the paper's size: build, one update
    batch through ``VersionedIndex.update``, then on each traffic 2^20
    lag-1 reads through K8 and lag-0 reads through ``search`` and K1, each
    held against a host oracle.  K8 groups its lanes by key range: it is
    also timed on the lanes in batch order and the pass alone, and five
    calls are profiled (``split_times``).  The main path also runs
    ``search_validated`` on the lag-1 view (K14), held against its plain
    version, timed and bounded (``k14_row``).  Returns ({traffic: K8's
    kernels-line row}, the key pass's launches on the main path, the
    update kernel's row, {traffic: K14's validated row})."""
    stage_s, t_stage = {}, time.perf_counter()
    t_phase = t_stage

    def lap(stage: str) -> None:
        """Seconds since the last lap, device work included."""
        nonlocal t_stage
        torch.cuda.synchronize()
        now = time.perf_counter()
        stage_s[stage] = stage_s.get(stage, 0.0) + now - t_stage
        t_stage = now

    dev = torch.device(DEVICE)
    types, ks, vs = synchrobench_ops(UPDATE_OPS, SEED + 2)
    want_results, current = host_oracle(keys_np, types, ks)
    lap("host_oracle")
    qs = {name: torch.from_numpy(q).to(dev) for name, q in traffic.items()}
    torch.cuda.reset_peak_memory_stats()

    # The main path, with every launch counter at 0 just before it.
    reset_launches()
    t0 = time.perf_counter()
    vi = VersionedIndex(sl.build(torch.from_numpy(keys_np).to(dev),
                                 torch.from_numpy(keys_np + 1).to(dev),
                                 capacity=FULL_CAP, levels=FULL_LEVELS,
                                 seed=SEED, device=dev))
    st0 = vi.current
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    update_args = on(dev, types, ks, vs)
    t0 = time.perf_counter()
    results = vi.update(*update_args)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    view = vi.read_view(lag=1)
    reads, k14_calls = {}, {}
    for name, q in qs.items():
        lag0, n_lag0 = counted(lambda: vi.search(q, lag=0))
        val, n_val = counted(lambda: search_validated(
            view.fused, view.auth_keys, view.vals, q))
        check(n_lag0["search_walk"] == 1 and n_val["search_walk"] == 1,
              f"the lag-0 read and search_validated launched K14 once "
              f"each ({name})")
        k14_calls[name] = {"lag0": n_lag0["search_walk"],
                           "validated": n_val["search_walk"]}
        reads[name] = (vi.search(q, lag=1, use_kernel=True), lag0,
                       ops.search_kernel(vi.current, q), val)
    torch.cuda.synchronize()
    launches = read_launches()
    lap("main_path")
    for name in ("validated_traverse", "foresight_traverse"):
        check(launches[name] >= 1, f"versioned path launched {name}")
    check(launches["search_walk"] == sum(n for c in k14_calls.values()
                                         for n in c.values()),
          "the versioned K14 launches add up to the counter's total")
    check(launches["apply_ops"] == 1, "VersionedIndex.update launched the "
                                      "update kernel once for the batch")
    update_syncs = syncs_per_call(lambda: VersionedIndex(st0).update(
        *update_args))
    check(update_syncs["syncs"] == 0, "VersionedIndex.update makes no "
                                      "synchronising call at full size")
    check(launches["group_by_key"] == 2 * len(qs),
          "versioned path ran group_by_key once a K8 and a K1 call")

    check(np.array_equal(results.cpu().numpy(), want_results),
          "every apply_ops result equals the oracle")
    check(bool(sl.check_foresight_invariant(vi.current)),
          "foresight invariant holds after the update")
    for name, (_, lag0, k1, _) in reads.items():
        check_lookups(lag0.found, lag0.vals, traffic[name], current,
                      f"lag-0 search ({name})")
        check_lookups(k1.found, k1.vals, traffic[name], current,
                      f"K1 on vi.current ({name})")
    n_live = int(vi.current.n)
    live_keys = sl.sorted_live_kv(vi.current)[0][:n_live]
    check(np.array_equal(live_keys.cpu().numpy(), current),
          "sorted_live_kv equals the oracle's key set")
    lap("oracle_checks")

    fused, auth = view.fused, view.auth_keys
    tables = (fused, auth)
    max_steps = vt.default_max_steps(FULL_LEVELS)
    wrapper, plain, source, replaces = KERNELS["validated_traverse"]
    rows, k14_rows = {}, {}
    for name, q in qs.items():
        lag1 = reads[name][0]
        fp = validated_footprint(fused, auth, q, max_steps)
        cut = fp["path"] > max_steps
        lap("footprint_replay")
        got = vt.validated_traverse(fused, auth, q)
        err = max_abs_err(got, vt.validated_traverse_plain(fused, auth, q))
        check(err == 0, f"K8 equals its plain version at full size ({name})")
        check(torch.equal(got[0], lag1.node),
              f"K8 node is the lag-1 read's ({name})")
        ref = reads[name][3]
        keep = ~cut            # a lane cut at max_steps has no equal there
        check(torch.equal(lag1.found[keep], ref.found[keep]),
              f"K8 found equals search_validated ({name})")
        check(torch.equal(lag1.vals[keep], ref.vals[keep]),
              f"K8 vals equals search_validated ({name})")
        hit = keep & ref.found
        check(torch.equal(lag1.node[hit], ref.node[hit]),
              f"K8 node equals search_validated where found ({name})")
        g_err = check_key_grouping(q, f"versioned {name}")
        lap("k8_checks")
        # K14's validated read: every field against its plain version on
        # the card, steps and gathers against an uncapped replay
        plain = search_validated_plain(fused, auth, view.vals, q)
        k14_err = result_err(ref, plain, SEARCH_FIELDS,
                             f"K14 validated = plain at full size ({name})")
        fp14 = validated_footprint(fused, auth, q,
                                   ft.traversal_bound(*fused.shape[:2]))
        k14_counts = k14_counters(ref, plain, fp14["path"], 2,
                                  f"validated, {name}")
        del plain
        B = q.numel()
        vals_bytes = int(torch.unique(ref.node[ref.found]).numel()) * 4
        k14 = k14_row(
            "validated", lambda: search_validated(fused, auth, view.vals, q),
            lambda: search_validated_plain(fused, auth, view.vals, q),
            fp14["distinct_bytes"],
            B * (4 + 1 + 4 + 4 + 4 * FULL_LEVELS) + 8 + vals_bytes,
            fp14["loads"], sum(c["validated"] for c in k14_calls.values()),
            k14_err, None, f"validated, {name}")
        # the lag-0 reads' K14 launches, each read around its call
        k14.update(k14_counts, lag0_launches=sum(
            c["lag0"] for c in k14_calls.values()))
        emit({"phase": "versioned_full_size_k14", "traffic": name,
              "n": FULL_N, "levels": FULL_LEVELS, "batch": B, "view": "lag 1",
              "rows": [k14], "library": "no single PyTorch call gives "
                                        "search_validated's preds",
              "mean_path_steps": float(fp14["path"].float().mean()),
              "max_path_steps": int(fp14["path"].max())})
        k14_rows[name] = k14
        del fp14
        lap("k14")

        kernel_ms = time_ms(lambda: vt.validated_traverse(fused, auth, q),
                            KERNEL_REPS)
        split = split_times("validated_traverse", tables, q)
        plain_ms = time_ms(lambda: vt.validated_traverse_plain(fused, auth,
                                                               q),
                           PLAIN_REPS)
        library_ms = time_ms(lambda: torch.searchsorted(live_keys, q),
                             KERNEL_REPS)
        k1_ms = time_ms(lambda: ft.foresight_traverse(vi.current.fused, q),
                        KERNEL_REPS)
        group = {**key_group_times(q), "max_abs_err": g_err}
        lap("timing")
        io_bytes = q.numel() * 4 * 3           # queries in, node + key out
        bytes_ms = (fp["distinct_bytes"] + io_bytes) / HBM_BYTES_PER_S * 1e3
        ops_ms = fp["loads"] / SCALAR_OPS_PER_S * 1e3   # one compare a load
        bound_ms = max(bytes_ms, ops_ms)
        sector_ms = (fp["sector_bytes"] + io_bytes) / HBM_BYTES_PER_S * 1e3
        rows[name] = {
            "name": "validated_traverse", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches["validated_traverse"],
            "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "sector_bound_ms": sector_ms,
            "ungrouped_ms": split["ungrouped_ms"]}
        emit({"phase": "versioned_full_size", "traffic": name, "n": FULL_N,
              "levels": FULL_LEVELS, "capacity": FULL_CAP,
              "batch": q.numel(), "update_ops": UPDATE_OPS,
              "op_mix": "25% insert, 25% delete, 50% read",
              "results_by_op": {t: int(want_results[types == code].sum())
                                for t, code in (("read_hits", sl.OP_READ),
                                                ("inserted", sl.OP_INSERT),
                                                ("deleted", sl.OP_DELETE))},
              "build_s": build_s, "update_s": update_s,
              "update_us_per_op": update_s / UPDATE_OPS * 1e6,
              "update_syncs_per_call": update_syncs["syncs"],
              "n_after": n_live, "lag0_hits": int(reads[name][1].found.sum()),
              "lag1_hits": int(lag1.found.sum()), **rows[name],
              **split, "group": group,
              "grouped_over_ungrouped_ms": kernel_ms / split["ungrouped_ms"],
              "mops": q.numel() / kernel_ms / 1e3,
              "k1_ms": k1_ms, "k8_over_k1_ms": kernel_ms / k1_ms,
              "validation_load": "on level 0, and above it only on a "
                                 "foreseen advance",
              "mean_path_steps": float(fp["path"].float().mean()),
              "max_path_steps": int(fp["path"].max()),
              "max_steps": max_steps,
              "queries_over_max_steps": int(cut.sum()),
              "distinct_bytes": fp["distinct_bytes"],
              "sector_bytes": fp["sector_bytes"],
              "bound_share": bound_ms / kernel_ms,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
              "stage_s": stage_s, "seconds": time.perf_counter() - t_phase})
        del fp, got, ref, lag1
    states = [st0, vi.current]          # the callee frees them
    del vi, view, fused, auth, tables, reads, live_keys, st0
    torch.cuda.empty_cache()
    update_row = monolithic_update_kernel(keys_np, (types, ks, vs), results,
                                          states)
    update_row["launches"] = launches["apply_ops"]
    return rows, launches["group_by_key"], update_row, k14_rows


def monolithic_update_kernel(keys_np: np.ndarray, stream: tuple,
                             results: torch.Tensor, states: list) -> dict:
    """The update kernel at the paper's size, monolithic: the versioned
    phase's batch on clones of its built state (``states``: the built
    state and the one ``VersionedIndex.update`` made, which the kernel's
    must equal; taken out of the list so that this frees them), the first
    ``PLAIN_UPDATE_OPS`` ops through the plain version too (three copies
    of the state: the built one and two clones), then the same for the
    base variant, built here.  Emits the ``update_full_size`` line;
    returns the kernels line's row."""
    t0 = time.perf_counter()
    st0, current = states
    states.clear()
    torch.cuda.reset_peak_memory_stats()
    batch = route_sorted(None, 1, *stream)
    head = route_sorted(None, 1, *(a[:PLAIN_UPDATE_OPS] for a in stream))
    report = {"phase": "update_full_size", "layout": "monolithic",
              "n": FULL_N, "levels": FULL_LEVELS, "capacity": FULL_CAP,
              "op_mix": "25% insert, 25% delete, 50% read"}
    rep, after, _ = update_times(one_shard(st0), batch, want=results)
    check(same_on_card(after, one_shard(current)),
          "the update kernel on a clone equals VersionedIndex.update's "
          "state")
    del after, current
    torch.cuda.empty_cache()
    rep["plain_check"] = plain_comparison(one_shard(st0), head,
                                          "monolithic foresight")
    report["foresight"] = rep
    del st0
    torch.cuda.empty_cache()
    dev = torch.device(DEVICE)
    base = sl.build(torch.from_numpy(keys_np).to(dev),
                    torch.from_numpy(keys_np + 1).to(dev),
                    capacity=FULL_CAP, levels=FULL_LEVELS, seed=SEED,
                    foresight=False, device=dev)
    rep, after, _ = update_times(one_shard(base), batch, want=results)
    del after
    rep["plain_check"] = plain_comparison(one_shard(base), head,
                                          "monolithic base")
    report["base"] = rep
    del base
    torch.cuda.empty_cache()
    report["foresight_over_base_ms"] = report["foresight"]["ms"] \
        / report["base"]["ms"]
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    report["seconds"] = time.perf_counter() - t0
    emit(report)
    fg, pc = report["foresight"], report["foresight"]["plain_check"]
    _, _, source, replaces = KERNELS["apply_ops"]
    # the line's times are the first PLAIN_UPDATE_OPS ops', where the plain
    # version ran on the same inputs; the whole batch's beside them
    return {"name": "apply_ops", "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0,
            "max_abs_err": pc["max_abs_err"], "ms": pc["ms"],
            "plain_ms": pc["plain_ms"], "bound_ms": pc["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "ops": pc["ops"],
            "batch_ops": fg["ops"], "batch_ms": fg["ms"],
            "batch_bound_ms": fg["bound_ms"],
            "batch_us_per_op": fg["us_per_op"],
            "base_batch_ms": report["base"]["ms"],
            "clone_ms": fg["clone_ms"]}


def enqueue_ms(fn, reps: int) -> float:
    """Median host time of ``fn()`` over ``reps`` calls, each from an idle
    card, nothing waited for: the host's share of a call's event time."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def k14_row(name: str, fn, plain_fn, path_bytes: int, io_bytes: int,
            path_steps: int, launches: int, err: int, library_ms,
            what: str) -> dict:
    """A K14 call at full size: its syncs a call (none allowed), its time
    (median of ``KERNEL_REPS`` by CUDA events) and its plain version's
    (``K14_PLAIN_REPS``), the kernel's device time in a profile of five
    calls, the host's time to enqueue a call (``enqueue_ms``), and its
    bound: the bytes its paths read
    (distinct), plus the bytes it reads and writes a query, over the HBM
    rate, or one compare a step, whichever is longer."""
    syncs = syncs_per_call(fn)["syncs"]
    check(syncs == 0, f"{name} makes no synchronising call ({what})")
    ms = time_ms(fn, KERNEL_REPS)
    plain_ms = time_ms(plain_fn, K14_PLAIN_REPS)
    prof = device_breakdown(fn, calls=5, walk="search_walk_kernel")
    host_ms = enqueue_ms(fn, KERNEL_REPS)
    bytes_ms = (path_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = path_steps / SCALAR_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    return {"name": f"search_walk/{name}", "route": "cuda",
            "source": K14_SOURCE, "replaces": KERNELS["search_walk"][3],
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "syncs_per_call": syncs,
            "bound_share": bound_ms / ms, "path_bytes": path_bytes,
            "io_bytes": io_bytes,
            # the kernel's own device time, and the call's other kernels
            # (the counters' zeroing), from a profile
            "kernel_device_ms": prof["walk_device_ms"],
            "kernel_launches_profiled": prof["walk_launches"],
            "other_device_ms": prof["pass_device_ms"], "enqueue_ms": host_ms}


def k14_counters(res: sl.SearchResult, plain: sl.SearchResult,
                 path: torch.Tensor, g: int, what: str) -> dict:
    """``steps`` and ``gathers`` beside the plain version's, both checked
    against a replay's path lengths: the longest path, and g times their
    sum (int32, wrapping)."""
    out = {"steps": int(res.steps), "plain_steps": int(plain.steps),
           "gathers": int(res.gathers), "plain_gathers": int(plain.gathers)}
    want = int(np.int64(g * int(path.sum())).astype(np.int32))
    check(out["steps"] == out["plain_steps"] == int(path.max()) and
          out["gathers"] == out["plain_gathers"] == want,
          f"K14's steps and gathers are the loop's ({what})")
    return out


def k14_full_size(st: sl.SkipListState, q: torch.Tensor, reads: tuple,
                  fp: dict, q_np: np.ndarray, keys_np: np.ndarray,
                  launches: dict, k14_launches: int, library_ms: float,
                  what: str) -> tuple:
    """``search`` and ``search_fast`` at full size: the main path's answers
    (``reads``) against the oracle and against the plain versions on the
    card (every field), steps and gathers against the replay ``fp``;
    ``launches``: this traffic's calls' on the main path, by kernel, and
    ``k14_launches`` the path's ``search`` calls' K14 launches.  Returns
    ``search``'s row (``k14_row``) and ``search_fast``'s numbers: K1/K2
    and its pass, so no K14 row (its launches, syncs a call, ms by events,
    its plain version's and ``torch.searchsorted``'s)."""
    rec, fast = reads
    check_lookups(rec.found, rec.vals, q_np, keys_np, f"search ({what})")
    check_lookups(*fast, q_np, keys_np, f"search_fast ({what})")
    plain = sl.search_plain(st, q)
    err = result_err(rec, plain, SEARCH_FIELDS,
                     f"K14 search = plain at full size ({what})")
    f_err = result_err(fast, sl.search_fast_plain(st, q), ("found", "vals"),
                       f"search_fast = plain at full size ({what})")
    g = 1 if st.foresight else 2
    counters = k14_counters(rec, plain, fp["path"], g, what)
    del plain
    B, L = q.numel(), st.levels
    vals_bytes = int(torch.unique(rec.node[rec.found]).numel()) * 4
    row = k14_row("search", lambda: sl.search(st, q),
                  lambda: sl.search_plain(st, q), fp["distinct_bytes"],
                  B * (4 + 1 + 4 + 4 + 4 * L) + 8 + vals_bytes,
                  fp["steps"], k14_launches, err, None, what)
    row.update(counters)
    fast_fn = lambda: sl.search_fast(st, q)       # noqa: E731
    syncs = syncs_per_call(fast_fn)["syncs"]
    check(syncs == 0, f"search_fast makes no synchronising call ({what})")
    fast_row = {"kernels": {k: n for k, n in launches["search_fast"].items()
                            if n}, "max_abs_err": f_err,
                "syncs_per_call": syncs,
                "ms": time_ms(fast_fn, KERNEL_REPS),
                "plain_ms": time_ms(lambda: sl.search_fast_plain(st, q),
                                    K14_PLAIN_REPS),
                "library_ms": library_ms}
    return row, fast_row


def full_size(keys_np: np.ndarray, traffic: dict, foresight: bool) -> dict:
    """Build at the paper's size, run the main path on each traffic, check,
    time, bound.  K1 and K2 group their lanes by key range: each is also
    timed on the lanes in batch order (``ungrouped_ms``, checked equal) and
    the pass alone (``group_ms``), and five calls are profiled
    (``split_times``).  Returns {traffic: its kernels-line row}; a row
    also carries the pass's row under ``group``."""
    dev = torch.device(DEVICE)
    keys = torch.from_numpy(keys_np).to(dev)
    qs = {name: torch.from_numpy(q).to(dev) for name, q in traffic.items()}
    torch.cuda.reset_peak_memory_stats()

    # The main path, with every launch counter at 0 just before it.
    reset_launches()
    t0 = time.perf_counter()
    st = sl.build(keys, keys + 1, capacity=FULL_CAP, levels=FULL_LEVELS,
                  foresight=foresight, seed=SEED, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    search_s, res = {}, {}
    for name, q in qs.items():
        t0 = time.perf_counter()
        res[name] = ops.search_kernel(st, q)
        torch.cuda.synchronize()
        search_s[name] = time.perf_counter() - t0
    launches = read_launches()
    name = kernel_name(st)
    check(launches[name] >= 1, f"main path launched {name}")
    check(launches["group_by_key"] == len(qs),
          f"main path ran group_by_key once a {name} call")
    syncs = {tname: syncs_per_call(lambda q=q: ops.search_kernel(st, q))
             for tname, q in qs.items()}
    FULL_SYNCS[f"search_kernel[{variant(foresight)}]"] = syncs
    # The eager reads' main path, every launch counter at 0 just before
    # it and each call's launches read around it: search on K14,
    # search_fast on K1/K2 and its pass
    reset_launches()
    k14_reads, eager = {}, {}
    for tname, q in qs.items():
        rec, n_rec = counted(lambda: sl.search(st, q))
        fast, n_fast = counted(lambda: sl.search_fast(st, q))
        check(n_rec["search_walk"] == 1 and n_rec[name] == 0,
              f"search launched K14 once and no {name} ({tname})")
        check(n_fast[name] == 1 and n_fast["search_walk"] == 0,
              f"search_fast launched {name} once and no K14 ({tname})")
        k14_reads[tname] = (rec, fast)
        eager[tname] = {"search": n_rec, "search_fast": n_fast}
    torch.cuda.synchronize()
    totals = read_launches()
    check(totals["search_walk"] == sum(e["search"]["search_walk"]
                                       for e in eager.values()) and
          totals[name] == sum(e["search_fast"][name]
                              for e in eager.values()),
          "the eager reads' launches add up to the counters' totals")
    # search_fast's walks and passes join the K1/K2 and pass rows
    for kernel in (name, "group_by_key"):
        launches[kernel] += totals[kernel]

    wrapper, plain, source, replaces = KERNELS[name]
    tables = table_args(st)
    rows = {}
    for tname, q in qs.items():
        check_lookups(res[tname].found, res[tname].vals, traffic[tname],
                      keys_np, f"search_kernel ({tname})")
        got = wrapper(*tables, q)
        err = max_abs_err(got, plain(*tables, q))
        check(err == 0, f"{name} equals its plain version at full size "
                        f"({tname})")
        kernel_ms = time_ms(lambda: wrapper(*tables, q), KERNEL_REPS)
        plain_ms = time_ms(lambda: plain(*tables, q), PLAIN_REPS)
        library_ms = time_ms(lambda: torch.searchsorted(keys, q),
                             KERNEL_REPS)
        # the batch-order launch, the pass
        g_err = check_key_grouping(q, f"full size {tname}")
        extra = {**split_times(name, tables, q),
                 "group": {**key_group_times(q), "max_abs_err": g_err}}
        extra["grouped_over_ungrouped_ms"] = kernel_ms / extra["ungrouped_ms"]

        fp = path_footprint(tuple(t[None] for t in tables), q)
        io_bytes = q.numel() * 4 * 3             # queries in, node + key out
        bytes_ms = (fp["distinct_bytes"] + io_bytes) / HBM_BYTES_PER_S * 1e3
        ops_ms = fp["steps"] / SCALAR_OPS_PER_S * 1e3   # one compare a step
        bound_ms = max(bytes_ms, ops_ms)
        sector_ms = (fp["sector_bytes"] + io_bytes) / HBM_BYTES_PER_S * 1e3
        rows[tname] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "sector_bound_ms": sector_ms,
            "ungrouped_ms": extra["ungrouped_ms"]}
        emit({"phase": "full_size", "traffic": tname, "n": FULL_N,
              "levels": FULL_LEVELS, "capacity": FULL_CAP,
              "batch": q.numel(),
              "table_gb": ops.tile_bytes(FULL_LEVELS, FULL_CAP,
                                         foresight) / 1e9,
              "build_s": build_s, "search_kernel_s": search_s[tname],
              "syncs_per_call": syncs[tname]["syncs"],
              "hits": int(res[tname].found.sum()), **rows[tname], **extra,
              "mops": q.numel() / kernel_ms / 1e3,
              "mean_path_steps": fp["steps"] / q.numel(),
              "max_path_steps": int(fp["path"].max()),
              "distinct_bytes": fp["distinct_bytes"],
              "distinct_count": "torch.unique over the read indices of a "
                                "plain replay of the batch's paths",
              "sector_bytes": fp["sector_bytes"],
              "bound_share": bound_ms / kernel_ms,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        rows[tname]["k14"], fast_row = k14_full_size(
            st, q, k14_reads.pop(tname), fp, traffic[tname], keys_np,
            eager[tname], totals["search_walk"], library_ms,
            f"{variant(foresight)}, {tname}")
        emit({"phase": "full_size_k14", "traffic": tname, "n": FULL_N,
              "levels": FULL_LEVELS, "batch": q.numel(),
              "rows": [rows[tname]["k14"]], "search_fast": fast_row,
              "library": "no single PyTorch call gives search's preds"})
        rows[tname]["group"] = {
            "name": "group_by_key", "route": "cuda",
            "source": SHARD_GROUP_CU,
            "replaces": KERNELS["group_by_key"][3],
            "launches": launches["group_by_key"], **extra["group"],
            "bound_by": "bytes", "sector_bound_ms": extra["group"][
                "bound_ms"]}
        del fp, got
    del st, res, tables
    torch.cuda.empty_cache()
    return rows


def variant(foresight: bool) -> str:
    return "foresight" if foresight else "base"


def shard_tables(shl: shd.ShardedSkipList):
    return ((shl.shards.fused,) if shl.foresight
            else (shl.shards.nxt, shl.shards.keys))


def sharded_names(foresight: bool):
    """(dense kernel, clustered kernel) names of a variant."""
    v = variant(foresight)
    return f"{v}_traverse_sharded", f"{v}_traverse_clustered"


def check_same_sharded(got: shd.ShardedSkipList, want: shd.ShardedSkipList,
                       what: str) -> None:
    check(got.n_shards == want.n_shards, f"{what} (shard count)")
    check(torch.equal(got.boundaries.cpu(), want.boundaries.cpu()),
          f"{what} (boundaries)")
    check_same_state(got.shards, want.shards, what)


def straddle_stream(boundaries: torch.Tensor, n_blocks: int = 4,
                    tail_per_shard: int = 2) -> np.ndarray:
    """tests/test_clustered_traversal.py:308-326: hot shard-0 blocks and one
    last sorted block that straddles every shard."""
    b = boundaries.cpu().numpy().astype(np.int64)
    S = b.shape[0]
    n_tail = tail_per_shard * (S - 1)
    rng = np.random.default_rng(99)
    hot = rng.integers(0, b[1], n_blocks * ft.QBLK - n_tail)
    tail = np.concatenate([
        np.linspace(b[i], (b[i + 1] if i + 1 < S else b[-1] + 2) - 1,
                    tail_per_shard, dtype=np.int64) for i in range(1, S)])
    return np.concatenate([hot, tail]).astype(np.int32)


def check_sharded_kernels(shl, q, report: dict, label: str) -> None:
    """The dense and clustered kernels equal their plain versions on the
    card, on ``q`` routed (dense) and planned (clustered)."""
    dense, clus = sharded_names(shl.foresight)
    sid = shd.route(shl.boundaries, q)
    plan = ops.cluster_queries(shl.boundaries, ops._pad(q)[0])
    for name, args in ((dense, (sid, q)),
                       (clus, (plan.block_sids, plan.ndist, plan.sid_sorted,
                               plan.q_sorted))):
        wrapper, plain, *_ = KERNELS[name]
        before = wrapper.launches
        got = wrapper(*shard_tables(shl), *args)
        check(wrapper.launches == before + 1, f"{name} launched ({label})")
        err = max_abs_err(got, plain(*shard_tables(shl), *args))
        check(err == 0, f"{name} equals its plain version ({label})")
        report[f"{name}_{label}_err"] = err
        if name == clus:
            check(all(torch.equal(a, b) for a, b in zip(
                clustered_walk(shard_tables(shl), args, None), got)),
                f"{name} equals its plan-order launch ({label})")


def small_sharded_check() -> None:
    """The sharded engine on the card equals the CPU: build, split / merge /
    repack, K3-K6 against their plain versions (a half-hit batch and the
    straddle stream through K7), the undersized-K refusal, and a rebalancing
    Zipf insert stream."""
    rng = np.random.default_rng(SEED)
    keys = np.sort(rng.choice(1 << 22, 1500, replace=False)).astype(np.int32)
    args = dict(n_shards=8, levels=12, seed=SEED)
    report = {"phase": "small_sharded_check", "n": 1500, **args}
    t0 = time.perf_counter()
    for foresight in (True, False):
        v = variant(foresight)
        shl = shd.build_sharded(keys, keys * 3, foresight=foresight,
                                device=DEVICE, **args)
        cpu = shd.build_sharded(keys, keys * 3, foresight=foresight,
                                device="cpu", **args)
        check_same_sharded(shl, cpu, f"{v} build_sharded, card equals CPU")
        for name, fn in (("split_shard", lambda x: shd.split_shard(x, 0)),
                         ("merge_shards",
                          lambda x: shd.merge_shards(x, 2, seed=1)),
                         ("repack", lambda x: shd.repack(x, 5, seed=2))):
            check_same_sharded(fn(shl), fn(cpu),
                               f"{v} {name}, card equals CPU")
        shl, cpu = shd.split_shard(shl, 0), shd.split_shard(cpu, 0)   # S = 9
        q_np = np.concatenate([rng.choice(keys, 2048), rng.integers(
            0, 1 << 22, 2048)]).astype(np.int32)
        check_sharded_kernels(shl, on(DEVICE, q_np)[0], report,
                              f"{v}_half_hit")
        q, = on(DEVICE, straddle_stream(shl.boundaries))
        check_sharded_kernels(shl, q, report, f"{v}_straddle")
        plan = ops.cluster_queries(shl.boundaries, ops._pad(q)[0])
        split = ops.plan_degeneration_split(plan.ndist, shl.n_shards)
        check(split is not None, "the straddle stream takes K7's split")
        dense, clus = (KERNELS[n][0] for n in sharded_names(foresight))
        before = dense.launches, clus.launches
        got = ops.search_kernel_sharded(shl, q)
        check((dense.launches, clus.launches) ==
              (before[0] + 1, before[1] + 1), "K7 launched both kernels")
        want = ops.search_kernel_sharded(cpu, q.cpu())
        check(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
              f"{v} search_kernel_sharded (K7), card equals CPU")
        report[f"{v}_straddle_k_small"] = split[0]
        try:
            ops.search_kernel_sharded(shl, q, k_shards=2)
        except ValueError:
            report[f"{v}_undersized_k"] = "raised"
        else:
            raise RuntimeError("check failed: undersized k_shards raises")

    # tests/test_rebalance.py:220's stream on a fully live index: 48 keys
    # over 4 shards of 16 slots, 4 batches of 32 Zipf inserts into shard 0
    krng = np.random.default_rng(SEED)
    k48 = np.sort(krng.choice(1 << 16, 48, replace=False)).astype(np.int32)
    results = {}
    for foresight in (True, False):
        v = variant(foresight)
        zrng = np.random.default_rng(7)
        st = {dev: shd.build_sharded(k48, k48 * 3, n_shards=4, capacity=16,
                                     levels=8, seed=SEED, foresight=foresight,
                                     device=dev) for dev in (DEVICE, "cpu")}
        for b in range(4):
            kk = (int(k48[2]) + (zrng.zipf(ZIPF_A, 32) - 1) % 4096
                  ).astype(np.int32)
            ins = np.full(32, sl.OP_INSERT, np.int32)
            res = {}
            for dev in st:
                st[dev], res[dev] = shd.apply_ops_sharded(
                    st[dev], *on(dev, ins, kk, kk * 2), rebalance=True,
                    seed=b)
            check(torch.equal(res[DEVICE].cpu(), res["cpu"]),
                  f"{v} rebalancing apply_ops_sharded results, card = CPU")
            check_same_sharded(st[DEVICE], st["cpu"],
                               f"{v} rebalancing apply_ops_sharded state")
        results[f"{v}_shards_after_zipf"] = st[DEVICE].n_shards
    report.update(results, zipf_ops=4 * 32, seconds=time.perf_counter() - t0)
    emit(report)


def fingerprint(shl: shd.ShardedSkipList) -> list:
    """Position-weighted sums of every stacked tensor, shard by shard."""
    out = [shl.boundaries.cpu().tolist()]
    for t in shl.shards:
        if t is None:
            continue
        for s in range(t.shape[0]):
            v = t[s].reshape(-1).long()
            w = torch.arange(1, v.numel() + 1, device=v.device)
            out.append(int((v * w).sum()))
    return out


def ungrouped_walk(shl: shd.ShardedSkipList, sid: torch.Tensor,
                   q: torch.Tensor, fat_keys) -> tuple:
    """The dense walk without grouping: lane i walks (sid[i], q[i]) in
    batch order and writes at i (``out_idx`` null).
    Called through ``_build.launch`` directly, to time it beside the
    grouped wrapper; it counts no launch."""
    node, key = torch.empty_like(q), torch.empty_like(q)
    tables = shard_tables(shl)
    S, L, cap = tables[0].shape[:3]
    width = 1 if fat_keys is None else fat_keys.shape[-1]
    symbol = ("foresight_sharded_launch" if shl.foresight
              else "base_sharded_launch")
    _build.launch(symbol, *(t.data_ptr() for t in tables),
                  None if fat_keys is None else fat_keys.data_ptr(),
                  sid.data_ptr(), None, q.data_ptr(), node.data_ptr(),
                  key.data_ptr(), q.numel(), S, L, cap, width,
                  ft.traversal_bound(L, cap),
                  torch.cuda.current_stream().cuda_stream)
    return node, key


def clustered_walk(tables, args, fat_keys) -> tuple:
    """K5 / K6 in the plan's lane order, one thread a lane (the launch the
    tile sort replaced, kept only as this yardstick), through the launcher
    directly; it counts no launch.  ``args`` are the wrapper's
    (block_sids, ndist, sid_sorted, q_sorted)."""
    bs, _, _, q = args
    node, key = torch.empty_like(q), torch.empty_like(q)
    S, L, cap = tables[0].shape[:3]
    v = "foresight" if len(tables) == 1 else "base"
    _build.launch(f"{v}_clustered_plan_order_launch",
                  *(t.data_ptr() for t in tables),
                  None if fat_keys is None else fat_keys.data_ptr(),
                  *(t.data_ptr() for t in args), node.data_ptr(),
                  key.data_ptr(), q.numel(), S, bs.shape[1], L, cap,
                  1 if fat_keys is None else fat_keys.shape[-1],
                  ft.traversal_bound(L, cap),
                  torch.cuda.current_stream().cuda_stream)
    return node, key


def clustered_times(tables, args, fat_keys, name: str) -> dict:
    """K5 / K6's wrapper (the tile-sorted walk) checked equal to the
    plan-order launch and timed beside it; the tile size, and profiles of
    one call (one kernel, no pass) and of the plan-order launch."""
    wrapper = KERNELS[name][0]
    fat = () if fat_keys is None else (fat_keys,)
    got = wrapper(*tables, *args, *fat)
    check(all(torch.equal(a, b) for a, b in
              zip(clustered_walk(tables, args, fat_keys), got)),
          f"{name} equals its plan-order launch")
    return {"plan_order_ms": time_ms(
                lambda: clustered_walk(tables, args, fat_keys), KERNEL_REPS),
            "tile_lanes": ft.CLUSTERED_TILE,
            "device_breakdown": device_breakdown(
                lambda: wrapper(*tables, *args, *fat), calls=5),
            "plan_order_device_breakdown": device_breakdown(
                lambda: clustered_walk(tables, args, fat_keys), calls=5)}


def check_grouping(sid: torch.Tensor, q: torch.Tensor, what: str) -> int:
    """``group_by_shard`` on the card equals its plain version (perm and
    offsets), ``perm`` a stable argsort of the bucket ids, and the sorted
    lanes ``q[perm]`` and ``sid[perm]``; returns the max abs error."""
    q_s, sid_s, perm, offsets = sg.group_by_shard(sid, q, SHARDS)
    err = max_abs_err((perm, offsets), sg.group_by_shard_plain(sid, SHARDS))
    check(err == 0, f"group_by_shard equals its plain version ({what})")
    mapped = torch.where((sid >= 0) & (sid < SHARDS), sid, SHARDS)
    check(torch.equal(perm.long(), torch.argsort(mapped, stable=True)),
          f"group_by_shard's perm is a stable argsort ({what})")
    check(torch.equal(q_s, q[perm.long()]) and
          torch.equal(sid_s, sid[perm.long()]),
          f"group_by_shard's q_sorted and sid_sorted ({what})")
    return err


def sharded_full_size(keys_np: np.ndarray, traffic: dict, stream: tuple,
                      foresight: bool, first: dict, width: int = 1,
                      scalar: dict = None) -> tuple:
    """The paper's keys over 64 shards: build, both traffics through the
    dense and clustered paths, one update batch (``stream``: the ops and
    their host-oracle answers), then checks, times and bounds.  ``first``
    carries the foresight run's answers to the base run.  ``width`` > 1
    builds fat shards (K9 in every launch; the eager ``search_sharded``
    and node ids into ``fat_vals`` are checked too, and ``scalar``, the
    scalar runs' answers, must give the same found and vals).  The dense
    kernel is also timed ungrouped (``ungrouped_walk``), and the grouping
    pass alone.  Returns (kernels-line rows, answers, the build's
    fingerprint, the grouping pass's row and times)."""
    stage_s, t_stage = {}, time.perf_counter()
    t_phase = t_stage

    def lap(stage: str) -> None:
        nonlocal t_stage
        torch.cuda.synchronize()
        now = time.perf_counter()
        stage_s[stage] = stage_s.get(stage, 0.0) + now - t_stage
        t_stage = now

    dev = torch.device(DEVICE)
    v = variant(foresight)
    fat = width > 1
    dense, clus = sharded_names(foresight)
    row = (lambda n: fat_row_name(n, width)) if fat else (lambda n: n)
    count = (lambda n: f"{n}/fat") if fat else (lambda n: n)
    (types, ks, vs), want_results, current = stream
    qs = {name: torch.from_numpy(q).to(dev) for name, q in traffic.items()}
    grouping = {"dense_ms": {}, "ungrouped_ms": {}}
    torch.cuda.reset_peak_memory_stats()

    # The main path, with every launch counter at 0 just before it.
    reset_launches()
    t0 = time.perf_counter()
    shl = shd.build_sharded(torch.from_numpy(keys_np).to(dev),
                            torch.from_numpy(keys_np + 1).to(dev),
                            n_shards=SHARDS, levels=SHARD_LEVELS,
                            foresight=foresight, seed=SEED,
                            node_width=width, device=dev)
    fatk = shl.shards.fat_keys                     # None on scalar shards
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    res = {(name, cl): ops.search_kernel_sharded(shl, q, cluster=cl)
           for name, q in qs.items() for cl in (False, True)}
    before = fingerprint(shl)
    t0 = time.perf_counter()
    new, results = shd.apply_ops_sharded(shl, *on(dev, types, ks, vs))
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    after_update = ops.search_kernel_sharded(new, qs["uniform"])
    torch.cuda.synchronize()
    launches = read_launches()
    lap("main_path")
    for name in (dense, clus):
        check(launches[count(name)] >= 1, f"sharded path launched {name} "
                                          f"(width {width})")
    if fat:
        check(launches["fat_resolve"] >= 1, "sharded path ran K9")
    else:
        syncs = {f"{name},{'clustered' if cl else 'dense'}": syncs_per_call(
            lambda q=q, cl=cl: ops.search_kernel_sharded(shl, q, cluster=cl))
            for name, q in qs.items() for cl in (False, True)}
        FULL_SYNCS[f"search_kernel_sharded[{v}]"] = syncs

    answers = {}
    for (name, cl), r in res.items():
        what = f"{v} width {width} {name} cluster={cl}"
        check_lookups(r.found, r.vals, traffic[name], keys_np, what)
        answers[(name, cl)] = [t.cpu() for t in r]
        if fat:
            hit = r.found
            check(torch.equal(shl.shards.fat_vals.reshape(-1)[
                r.node[hit].long()], r.vals[hit]),
                f"{what}: node ids dereference into fat_vals")
            check(all(torch.equal(a, b) for a, b in zip(
                answers[(name, cl)][:2], scalar[(name, cl)][:2])),
                f"{what}: found and vals equal the scalar run's")
    if fat:            # S * L * cap = 4.4e7: the eager search takes it
        for name, q in qs.items():
            f, vals = shd.search_sharded(shl, q)
            check(torch.equal(f, res[(name, False)].found) and
                  torch.equal(vals, res[(name, False)].vals),
                  f"{v} fat search_sharded equals the kernels ({name})")
    for name in qs:
        check(all(torch.equal(a, b) for a, b in
                  zip(answers[(name, True)], answers[(name, False)])),
              f"{v} {name}: clustered equals dense (found, vals, node)")
    if first:
        check(all(torch.equal(a, b) for key in answers
                  for a, b in zip(answers[key], first[key])),
              "foresight and base give the same found, vals, node")
    check(np.array_equal(results.cpu().numpy(), want_results),
          "every apply_ops_sharded result equals the oracle")
    check_lookups(after_update.found, after_update.vals, traffic["uniform"],
                  current, "search_kernel_sharded after the update")
    check(bool(shd.check_sharded_invariant(new, expect_n=len(current))),
          "sharded invariant and live count after the update")
    if fat:
        check(all(bool(sl.check_fat_invariant(shd.shard_view(new.shards, s)))
                  for s in range(new.n_shards)),
              "check_fat_invariant on every shard after the update")
    check(fingerprint(shl) == before, "apply_ops_sharded leaves its input "
                                      "unchanged")
    check(launches["apply_ops"] == 1, "apply_ops_sharded launched the "
                                      "update kernel once for the batch")
    grouping["apply_ops_launches"] = launches["apply_ops"]
    del new, after_update
    torch.cuda.empty_cache()
    lap("oracle_checks")
    upd = sharded_update_kernel(shl, stream[0], want_results,
                                f"{v} width {width}")
    lap("update_kernel")

    phase = "fat_sharded_full_size" if fat else "sharded_full_size"
    report = {"phase": phase, "variant": v, "node_width": width,
              "n": FULL_N, "shards": SHARDS, "levels": SHARD_LEVELS,
              "shard_capacity": shl.shard_capacity,
              "index_gb": SHARDS * ops.tile_bytes(
                  SHARD_LEVELS, shl.shard_capacity, foresight, width) / 1e9,
              "stack_gb": sum(t.numel() * t.element_size()
                              for t in shl.shards if t is not None) / 1e9,
              "build_s": build_s, "update_ops": SHARD_UPDATE_OPS,
              "update_s": update_s,
              "update_us_per_op": update_s / SHARD_UPDATE_OPS * 1e6}
    if not fat:
        report["syncs_per_call"] = {k: r["syncs"] for k, r in syncs.items()}
    sorted_keys = torch.from_numpy(keys_np).to(dev)
    rows = {}
    report["update_kernel"] = upd
    for name, q in qs.items():
        sid = shd.route(shl.boundaries, q)
        plan = ops.cluster_queries(shl.boundaries, q)
        split = ops.plan_degeneration_split(plan.ndist, SHARDS)
        clus_args = (plan.block_sids, plan.ndist, plan.sid_sorted,
                     plan.q_sorted)
        fp = path_footprint(shard_tables(shl), q, sid, fatk)
        lap("footprint_replay")
        t = {}
        for kname, args in ((dense, (sid, q)), (clus, clus_args)):
            wrapper, plain, *_ = KERNELS[kname]
            got = wrapper(*shard_tables(shl), *args, fatk)
            err = max_abs_err(got, plain(*shard_tables(shl), *args, fatk))
            check(err == 0, f"{kname} (width {width}) equals its plain "
                            f"version ({name})")
            t[kname] = dict(
                err=err,
                ms=time_ms(lambda: wrapper(*shard_tables(shl), *args, fatk),
                           KERNEL_REPS),
                plain_ms=time_ms(lambda: plain(*shard_tables(shl), *args,
                                               fatk), PLAIN_REPS))
            if kname == dense:     # the ungrouped launch, in the same run
                check(all(torch.equal(a, b) for a, b in zip(
                    ungrouped_walk(shl, sid, q, fatk), got)),
                    f"{kname} ungrouped equals grouped ({name})")
                t[kname]["ungrouped_ms"] = time_ms(
                    lambda: ungrouped_walk(shl, sid, q, fatk), KERNEL_REPS)
                # device time by kernel of one call: the pass and the walk
                t[kname]["profile"] = device_breakdown(
                    lambda: wrapper(*shard_tables(shl), *args, fatk))
                t[kname]["ungrouped_profile"] = device_breakdown(
                    lambda: ungrouped_walk(shl, sid, q, fatk))
            else:           # the plan-order launch, in the same run
                t[kname].update(clustered_times(shard_tables(shl), args,
                                                fatk, kname))
        g_err = check_grouping(sid, q, f"{v} width {width} {name}")
        group = dict(
            err=g_err,
            ms=time_ms(lambda: sg.group_by_shard(sid, q, SHARDS),
                       KERNEL_REPS),
            plain_ms=time_ms(lambda: sg.group_by_shard_plain(sid, SHARDS),
                             PLAIN_REPS),
            library_ms=time_ms(lambda: torch.sort(sid, stable=True),
                               KERNEL_REPS))
        lap("kernel_checks_and_timing")
        plan_ms = time_ms(lambda: ops.cluster_queries(shl.boundaries, q),
                          KERNEL_REPS)
        e2e = {cl: time_ms(lambda: ops.search_kernel_sharded(
            shl, q, cluster=cl), KERNEL_REPS) for cl in (False, True)}
        library_ms = time_ms(lambda: torch.searchsorted(sorted_keys, q),
                             KERNEL_REPS)
        lap("timing")
        B = q.numel()
        nblk, K = plan.block_sids.shape
        io = {dense: B * 4 * 4,                       # q, sid in; node, key
              clus: B * 4 * 4 + (nblk * K + nblk) * 4}   # + the plan
        # one compare a step, and B a query for K9's run
        ops_ms = (fp["steps"] + fp.get("compares", 0)) \
            / SCALAR_OPS_PER_S * 1e3
        nd = plan.ndist.cpu().numpy()
        report[name] = {
            "phase": phase, "variant": v, "node_width": width,
            "traffic": name,
            "batch": B, "hits": int(res[(name, False)].found.sum()),
            "mean_path_steps": fp["steps"] / B,
            "max_path_steps": int(fp["path"].max()),
            "distinct_bytes": fp["distinct_bytes"],
            "distinct_runs": fp.get("distinct_runs"),
            "sector_bytes": fp["sector_bytes"],
            "auto_k": K, "k7_split": None if split is None else {
                "k_small": split[0], "keep_blocks": len(split[1]),
                "straggler_blocks": len(split[2])},
            "ndist_histogram": {int(k): int(c) for k, c in
                                zip(*np.unique(nd, return_counts=True))},
            "lanes_on_busiest_shard": int(torch.bincount(
                plan.sid_sorted.long(), minlength=SHARDS).max()),
            "plan_ms": plan_ms, "search_kernel_sharded_ms": {
                "dense": e2e[False], "clustered": e2e[True]},
            "library_ms": library_ms,
            "group_ms": group["ms"],
            "group_by_shard_launches": launches["group_by_shard"]}
        # sid and q read once; q_sorted, sid_sorted, perm and the offsets
        # written once
        group_bytes_ms = (B * 4 * 5 + (SHARDS + 2) * 4) \
            / HBM_BYTES_PER_S * 1e3
        report[name]["group_by_shard"] = {
            **group, "bound_ms": group_bytes_ms,
            "bound_share": group_bytes_ms / group["ms"]}
        grouping.setdefault("row", {
            "name": "group_by_shard", "route": "cuda",
            "source": SHARD_GROUP_CU, "replaces": KERNELS["group_by_shard"][3],
            "launches": launches["group_by_shard"], "max_abs_err": g_err,
            "ms": group["ms"], "plain_ms": group["plain_ms"],
            "bound_ms": group_bytes_ms, "bound_by": "bytes",
            "library_ms": group["library_ms"]})
        grouping["row"]["max_abs_err"] = max(grouping["row"]["max_abs_err"],
                                             g_err)
        for kname in (dense, clus):
            bytes_ms = (fp["distinct_bytes"] + io[kname]) \
                / HBM_BYTES_PER_S * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            sector_ms = (fp["sector_bytes"] + io[kname]) \
                / HBM_BYTES_PER_S * 1e3
            report[name][kname] = {
                **t[kname], "mops": B / t[kname]["ms"] / 1e3,
                "bound_ms": bound_ms, "sector_bound_ms": sector_ms,
                "bound_share": bound_ms / t[kname]["ms"]}
            if kname == dense:
                report[name][kname]["grouped_over_ungrouped_ms"] = \
                    t[kname]["ms"] / t[kname]["ungrouped_ms"]
                grouping["dense_ms"][name] = t[kname]["ms"]
                grouping["ungrouped_ms"][name] = t[kname]["ungrouped_ms"]
            wrapper, plain, source, replaces = KERNELS[kname]
            rows.setdefault(kname, {
                "name": row(kname), "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[count(kname)],
                "max_abs_err": t[kname]["err"], "ms": t[kname]["ms"],
                "plain_ms": t[kname]["plain_ms"], "bound_ms": bound_ms,
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": library_ms, "sector_bound_ms": sector_ms,
                **({"ungrouped_ms": t[kname]["ungrouped_ms"]}
                   if kname == dense else
                   {"plan_order_ms": t[kname]["plan_order_ms"],
                    "tile_lanes": t[kname]["tile_lanes"]})})
    report["clustered_over_dense_ms"] = {
        name: report[name][clus]["ms"] / report[name][dense]["ms"]
        for name in qs}
    report["clustered_over_plan_order_ms"] = {
        name: report[name][clus]["ms"] / report[name][clus]["plan_order_ms"]
        for name in qs}
    for name in qs:                      # one line a traffic, then the phase
        emit(report.pop(name))
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    report["stage_s"] = stage_s
    report["seconds"] = time.perf_counter() - t_phase
    emit(report)
    del shl, res, sorted_keys, qs, fatk
    torch.cuda.empty_cache()
    return list(rows.values()), answers, before, grouping


def sharded_update_kernel(shl: shd.ShardedSkipList, stream: tuple,
                          want: np.ndarray, what: str) -> dict:
    """The update kernel alone on the sharded phase's batch (clones of the
    stack, results unsorted and held against the oracle), and its first
    ``PLAIN_UPDATE_OPS`` ops on the first ``PLAIN_UPDATE_SHARDS`` shards
    through the plain version too (a copy of those shards and two clones:
    three copies of the whole stack would not fit)."""
    types, ks, vs = stream
    batch = route_sorted(shl.boundaries, SHARDS, types, ks, vs)
    upd, after, res_sorted = update_times(shl.shards, batch)
    del after
    res = torch.empty_like(res_sorted)
    res[batch.perm] = res_sorted
    check(np.array_equal(res.cpu().numpy(), want),
          f"the update kernel's results equal the oracle ({what})")
    sid = shd.route(shl.boundaries, torch.from_numpy(ks).to(DEVICE))
    idx = np.flatnonzero(sid.cpu().numpy() < PLAIN_UPDATE_SHARDS)
    idx = idx[:PLAIN_UPDATE_OPS]
    sub = sl.SkipListState(*(None if t is None else
                             t[:PLAIN_UPDATE_SHARDS].clone()
                             for t in shl.shards))
    head = route_sorted(shl.boundaries[:PLAIN_UPDATE_SHARDS],
                        PLAIN_UPDATE_SHARDS, types[idx], ks[idx], vs[idx])
    upd["plain_check"] = plain_comparison(sub, head, f"{what}, "
                                          f"{PLAIN_UPDATE_SHARDS} shards")
    del sub
    torch.cuda.empty_cache()
    return upd


# ---------------------------------------------------------------------------
# The mesh index (K10) at D = 1: one process group of one rank
# ---------------------------------------------------------------------------

MESH_PY = "src/repro/kernels/mesh_launch.py"


def init_mesh_group() -> dict:
    """One rank, world size 1, an in-process store (no TCP rendezvous): NCCL
    carries the card's tensors; gloo (on the loopback device) carries the
    CPU run that the card is held against.  {device: its index mesh}."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.HashStore(),
                            rank=0, world_size=1)
    return {DEVICE: make_index_mesh(1), "cpu": make_index_mesh(1, "cpu")}


def check_same_mesh(got: mi.MeshShardedIndex, want: mi.MeshShardedIndex,
                    what: str) -> None:
    a, b = mesh_to_numpy(got), mesh_to_numpy(want)
    check(sorted(a) == sorted(b), f"{what} (fields)")
    for k in a:
        check(np.array_equal(a[k], b[k]), f"{what} ({k})")


def check_same_stats(got: rbt.DeviceLoadStats, want: rbt.DeviceLoadStats,
                     what: str) -> None:
    for g, w in zip(got, want):
        check(g.dtype == w.dtype and torch.equal(g.cpu(), w.cpu()),
              f"{what} (DeviceLoadStats)")


def mesh_plan(mx: mi.MeshShardedIndex, q: torch.Tensor) -> tuple:
    """K5/K6's arguments for the lanes a one-device mesh receives (``q``
    itself), planned as ``search_kernel_mesh`` plans them."""
    local = mx.local
    plan = ops.cluster_queries(local.boundaries, ops._pad(q)[0],
                               k_shards=min(ft.QBLK, local.n_shards))
    return (plan.block_sids, plan.ndist, plan.sid_sorted, plan.q_sorted,
            local.shards.fat_keys)


def small_mesh_check(meshes: dict) -> None:
    """The mesh index on the card equals the port's CPU run: build, the
    eager and kernel searches, the dispatch, K5/K6 against their plain
    versions, a rebalancing apply on an empty mesh index, and the in-place
    passes on a padded index."""
    rng = np.random.default_rng(SEED)
    keys = np.sort(rng.choice(1 << 22, 1500, replace=False)).astype(np.int32)
    q_np = np.concatenate([rng.choice(keys, 2048), rng.integers(
        0, 1 << 22, 2048)]).astype(np.int32)
    report = {"phase": "small_mesh_check", "n": 1500, "shards": 8,
              "levels": 12, "devices": 1}
    t0 = time.perf_counter()
    for foresight in (True, False):
        for width in (1, 8):
            label = f"{variant(foresight)} B={width}"
            mx, out = {}, {}
            for dev, mesh in meshes.items():
                mx[dev] = mi.build_mesh_index(
                    keys, keys * 3, n_devices=1, n_shards=8, levels=12,
                    seed=SEED, foresight=foresight, node_width=width, rank=0,
                    device=dev)
                q, = on(dev, q_np)
                before = ml.search_kernel_mesh.launches
                out[dev] = [*mi.search_mesh(mx[dev], q, mesh=mesh),
                            *ml.search_kernel_mesh(mx[dev], q, mesh=mesh),
                            *ops.search_kernel(mx[dev], q, mesh=mesh)]
                if dev == DEVICE:
                    check(ml.search_kernel_mesh.launches == before + 2,
                          f"{label}: K10 launched K5/K6")
            check_same_mesh(mx[DEVICE], mx["cpu"],
                            f"{label} build_mesh_index, card equals CPU")
            check(all(torch.equal(a.cpu(), b) for a, b in
                      zip(out[DEVICE], out["cpu"])),
                  f"{label} search_mesh, search_kernel_mesh and search_kernel"
                  "(mesh=): found, vals, node, card equals CPU")
            check(torch.equal(out[DEVICE][0], out[DEVICE][2]) and
                  torch.equal(out[DEVICE][1], out[DEVICE][3]),
                  f"{label}: the kernels equal the eager mesh search")
            name = sharded_names(foresight)[1]
            wrapper, plain, *_ = KERNELS[name]
            local = mx[DEVICE].local
            args = mesh_plan(mx[DEVICE], on(DEVICE, q_np)[0])
            got = wrapper(*shard_tables(local), *args)
            err = max_abs_err(got, plain(*shard_tables(local), *args))
            check(err == 0, f"{label}: {name} equals its plain version")
            check(all(torch.equal(a, b) for a, b in zip(clustered_walk(
                shard_tables(local), args[:4], args[4]), got)),
                f"{label}: {name} equals its plan-order launch")
            report[f"{name}_B{width}_err"] = err

    # rebalancing: the in-place passes on an empty mesh index (8 shards of
    # 16 slots) under 4 batches of 32 Zipf inserts, and on a padded index
    k48 = np.sort(np.random.default_rng(SEED).choice(
        1 << 16, 48, replace=False)).astype(np.int32)
    for foresight in (True, False):
        v = variant(foresight)
        em = {dev: mi.empty_mesh_index(
            n_devices=1, n_shards=8, capacity=16, levels=8, seed=SEED,
            foresight=foresight, key_span=1 << 16, rank=0, device=dev)
            for dev in meshes}
        zrng = np.random.default_rng(7)
        for b in range(4):
            kk = (int(k48[2]) + (zrng.zipf(ZIPF_A, 32) - 1) % 4096
                  ).astype(np.int32)
            ins = np.full(32, sl.OP_INSERT, np.int32)
            res, stats = {}, {}
            for dev, mesh in meshes.items():
                em[dev], res[dev], stats[dev] = mi.apply_ops_mesh(
                    em[dev], *on(dev, ins, kk, kk * 2), mesh=mesh,
                    rebalance=True, seed=b)
            what = f"{v} rebalancing apply_ops_mesh, batch {b}"
            check(torch.equal(res[DEVICE].cpu(), res["cpu"]),
                  f"{what}: results, card equals CPU")
            check_same_mesh(em[DEVICE], em["cpu"], f"{what}: state")
            check_same_stats(stats[DEVICE], stats["cpu"], what)
        report[f"{v}_live_shards_after_zipf"] = int(rbt.live_shard_count(
            em[DEVICE].local))
        check(report[f"{v}_live_shards_after_zipf"] > 1,
              f"{v}: the in-place passes split the empty mesh index")
        st = {}
        for dev in meshes:
            x = rbt.pad_shards(shd.build_sharded(
                k48, k48 * 3, n_shards=4, capacity=16, levels=8, seed=SEED,
                foresight=foresight, device=dev), 16)
            at = int(x.boundaries[1]) + 1
            x = rbt.split_shard_traced(x, 1, at, seed=5)
            x = rbt.merge_shards_traced(x, 1, seed=3)
            x, stats = rbt.watermark_rebalance_traced(x, seed=2)
            kk = (int(k48[2]) + (np.random.default_rng(9).zipf(ZIPF_A, 96)
                                 - 1) % 4096).astype(np.int32)
            x, splits = rbt.exhaustion_guard_traced(
                x, *on(dev, np.full(96, sl.OP_INSERT, np.int32), kk),
                seed=11)
            st[dev] = (x, tuple(int(c) for c in stats), int(splits))
        check_same_sharded(st[DEVICE][0], st["cpu"][0],
                           f"{v} pad_shards + in-place passes")
        check(st[DEVICE][1:] == st["cpu"][1:],
              f"{v} in-place passes: split and merge counts")
        report[f"{v}_in_place_guard_splits"] = st[DEVICE][2]
    report["seconds"] = time.perf_counter() - t0
    emit(report)


def mesh_exchange(mx: mi.MeshShardedIndex, q: torch.Tensor, mesh) -> list:
    """K10's data movement alone: route, sort, the outbound exchange of
    the queries and the return exchange of three result lanes."""
    D, _, group = mi._validate(mx, mesh)
    did = shd.route(mx.device_boundaries, q)
    (rq,), _, perm, starts, did_s = mi._exchange_out(did, (q,), (0,), D,
                                                     group)
    return mi._exchange_back((rq, rq, rq), perm, starts, did_s, D, group)


def device_breakdown(fn, top: int = 10, tries: int = 3, calls: int = 1,
                     walk: str = None) -> dict:
    """``calls`` calls of ``fn`` under ``torch.profiler``: the device
    kernels that ran, by device time a call (the ``top`` largest), and
    their sum.  A profile that recorded no device event (the tracer
    sometimes loses a cycle's events), or with ``walk`` fewer launches of
    that kernel than calls, is taken again, at most ``tries`` times in
    all.  With ``walk`` the sum is also split into that kernel's time and
    the rest's (a grouping pass), beside its launches a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = sorted(((e.key, e.device_time_total / 1e3 / calls,
                        e.count / calls)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.device_time_total > 0),
                      key=lambda r: -r[1])
        if rows and (walk is None or sum(n for k, _, n in rows
                                         if walk in k) >= 1):
            break
    out = {"device_ms": sum(r[1] for r in rows), "launches":
           sum(r[2] for r in rows), "top": [[k[:80], ms, n]
                                            for k, ms, n in rows[:top]]}
    if walk is not None:
        out["walk_device_ms"] = sum(ms for k, ms, _ in rows if walk in k)
        out["walk_launches"] = sum(n for k, _, n in rows if walk in k)
        out["pass_device_ms"] = out["device_ms"] - out["walk_device_ms"]
        out["calls"] = calls
    return out


def mesh_full_size(keys_np: np.ndarray, traffic: dict, stream: tuple,
                   foresight: bool, sharded: tuple, mesh) -> dict:
    """The paper's keys through ``build_mesh_index(n_devices=1,
    n_shards=64)``: the build against ``build_sharded``'s fingerprint, both
    traffics through ``search_kernel_mesh`` against the oracle and the
    sharded clustered answers (``sharded``: (fingerprint, answers)), 256
    updates through ``apply_ops_mesh``, then times of the whole path, its
    exchange and its K5/K6 launch, with the bound and the library time.
    Returns the phase's report."""
    stage_s, t_stage = {}, time.perf_counter()
    t_phase = t_stage

    def lap(stage: str) -> None:
        nonlocal t_stage
        torch.cuda.synchronize()
        now = time.perf_counter()
        stage_s[stage] = stage_s.get(stage, 0.0) + now - t_stage
        t_stage = now

    dev = torch.device(DEVICE)
    v = variant(foresight)
    clus = sharded_names(foresight)[1]
    fp_sharded, answers = sharded
    (types, ks, vs), want_results, current = stream
    qs = {name: torch.from_numpy(q).to(dev) for name, q in traffic.items()}
    torch.cuda.reset_peak_memory_stats()

    # The main path, with every launch counter at 0 just before it.
    reset_launches()
    t0 = time.perf_counter()
    mx = mi.build_mesh_index(torch.from_numpy(keys_np).to(dev),
                             torch.from_numpy(keys_np + 1).to(dev),
                             n_devices=1, n_shards=SHARDS,
                             levels=SHARD_LEVELS, foresight=foresight,
                             seed=SEED, rank=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    res = {name: ml.search_kernel_mesh(mx, q, mesh=mesh)
           for name, q in qs.items()}
    t0 = time.perf_counter()
    new, results, stats = mi.apply_ops_mesh(mx, *on(dev, types, ks, vs),
                                            mesh=mesh)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    after_update = ml.search_kernel_mesh(new, qs["uniform"], mesh=mesh)
    torch.cuda.synchronize()
    launches = read_launches()
    mesh_launches = launches["search_kernel_mesh"]
    lap("main_path")
    check(mesh_launches >= 1 and launches[clus] == mesh_launches,
          f"the mesh path launched {clus} through K10")

    check(fingerprint(mx.local) == fp_sharded,
          f"{v} build_mesh_index equals build_sharded (fingerprint)")
    for name, r in res.items():
        what = f"{v} search_kernel_mesh {name}"
        check_lookups(r.found, r.vals, traffic[name], keys_np, what)
        check(all(torch.equal(a.cpu(), b) for a, b in
                  zip(r, answers[(name, True)])),
              f"{what}: found, vals, node equal search_kernel_sharded's")
    check(np.array_equal(results.cpu().numpy(), want_results),
          "every apply_ops_mesh result equals the oracle")
    check_lookups(after_update.found, after_update.vals, traffic["uniform"],
                  current, "search_kernel_mesh after the update")
    check(bool(mi.check_mesh_invariant(new, expect_n=len(current),
                                       mesh=mesh)),
          "check_mesh_invariant and the live count after the update")
    check(int(stats.live[0]) == len(current) and
          int(stats.routed[0]) == SHARD_UPDATE_OPS and
          float(stats.live_imbalance) == 1.0,
          "DeviceLoadStats after the update")
    del new, after_update
    torch.cuda.empty_cache()
    lap("oracle_checks")

    report = {"phase": "mesh_full_size", "variant": v, "devices": 1,
              "n": FULL_N, "shards": SHARDS, "levels": SHARD_LEVELS,
              "shard_capacity": mx.shard_capacity, "k_shards":
              min(ft.QBLK, SHARDS), "build_s": build_s,
              "update_ops": SHARD_UPDATE_OPS, "update_s": update_s,
              "update_us_per_op": update_s / SHARD_UPDATE_OPS * 1e6,
              "k10_launches": mesh_launches}
    sorted_keys = torch.from_numpy(keys_np).to(dev)
    wrapper, plain, *_ = KERNELS[clus]
    tables = shard_tables(mx.local)
    for name, q in qs.items():
        args = mesh_plan(mx, q)
        got = wrapper(*tables, *args)
        err = max_abs_err(got, plain(*tables, *args))
        check(err == 0, f"{clus} equals its plain version on the mesh's "
                        f"lanes ({name})")
        check(all(torch.equal(a, b) for a, b in
                  zip(clustered_walk(tables, args[:4], args[4]), got)),
              f"{clus} equals its plan-order launch on the mesh's lanes "
              f"({name})")
        del got
        sid = shd.route(mx.local.boundaries, q)
        fp = path_footprint(tables, q, sid)
        lap("kernel_check_and_replay")
        t = dict(
            e2e_ms=time_ms(lambda: ml.search_kernel_mesh(mx, q, mesh=mesh),
                           KERNEL_REPS),
            # the same index as one ShardedSkipList, the same call as K10's
            sharded_e2e_ms=time_ms(lambda: ops.search_kernel_sharded(
                mx.local, q, cluster=True, k_shards=args[0].shape[1]),
                KERNEL_REPS),
            exchange_ms=time_ms(lambda: mesh_exchange(mx, q, mesh),
                                KERNEL_REPS),
            ms=time_ms(lambda: wrapper(*tables, *args), KERNEL_REPS),
            plan_order_ms=time_ms(
                lambda: clustered_walk(tables, args[:4], args[4]),
                KERNEL_REPS),
            plain_ms=time_ms(lambda: plain(*tables, *args), PLAIN_REPS),
            library_ms=time_ms(lambda: torch.searchsorted(sorted_keys, q),
                               KERNEL_REPS))
        prof = device_breakdown(
            lambda: ml.search_kernel_mesh(mx, q, mesh=mesh))
        prof["idle_share"] = 1 - prof["device_ms"] / t["e2e_ms"]
        t["kernel_device_breakdown"] = device_breakdown(
            lambda: wrapper(*tables, *args), calls=5)
        lap("timing")
        B = q.numel()
        nblk, K = args[0].shape
        io = B * 4 * 4 + (nblk * K + nblk) * 4         # q, sid, node, key
        bytes_ms = (fp["distinct_bytes"] + io) / HBM_BYTES_PER_S * 1e3
        ops_ms = fp["steps"] / SCALAR_OPS_PER_S * 1e3
        report[name] = {**t, "max_abs_err": err, "batch": B,
                        "hits": int(res[name].found.sum()),
                        "mean_path_steps": fp["steps"] / B,
                        "bound_ms": max(bytes_ms, ops_ms),
                        "sector_bound_ms": (fp["sector_bytes"] + io)
                        / HBM_BYTES_PER_S * 1e3,
                        "bound_by": ("bytes" if bytes_ms >= ops_ms
                                     else "operations"),
                        "exchange_share": t["exchange_ms"] / t["e2e_ms"],
                        "mesh_over_sharded_e2e": t["e2e_ms"]
                        / t["sharded_e2e_ms"], "profile": prof}
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    report["stage_s"] = stage_s
    report["seconds"] = time.perf_counter() - t_phase
    emit(report)
    del mx, res, sorted_keys, qs, tables
    torch.cuda.empty_cache()
    report["launches"] = launches
    return report


def mesh_row(reports: list) -> dict:
    """The kernels-line row of K10, from the foresight run on traffic A
    (uniform); launches over both variants' main paths."""
    a = reports[0]["uniform"]
    return {"name": "search_kernel_mesh", "route": "cuda",
            "source": TRAVERSE_CU, "launcher":
            "src/repro_torch/kernels/mesh_launch.py",
            "replaces": f"{MESH_PY}:78",
            "launches": sum(r["k10_launches"] for r in reports),
            "max_abs_err": max(r[t]["max_abs_err"] for r in reports
                               for t in ("uniform", "zipf")),
            "ms": a["ms"], "plain_ms": a["plain_ms"],
            "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
            "sector_bound_ms": a["sector_bound_ms"],
            "library_ms": a["library_ms"], "e2e_ms": a["e2e_ms"],
            "exchange_ms": a["exchange_ms"],
            "plan_order_ms": a["plan_order_ms"]}


def fat_tables(st: sl.SkipListState):
    """A fat state's walk tables, then its run keys (the K9 argument)."""
    return (*table_args(st), st.fat_keys)


def fat_row_name(name: str, width: int) -> str:
    return f"{name}/fat{width}"


def check_fat_kernel(name: str, tables, args, report: dict, label: str,
                     max_steps: int = 0) -> None:
    """Kernel ``name`` with K9 equals its plain version on the card; the
    launch is counted as a fat launch.  ``tables`` ends with fat_keys."""
    wrapper, plain, *_ = KERNELS[name]
    *walk, fat = tables
    before = wrapper.fat_launches
    got = wrapper(*walk, *args, fat, max_steps=max_steps)
    check(wrapper.fat_launches == before + 1, f"{name} fat launch counted")
    err = max_abs_err(got, plain(*walk, *args, fat, max_steps=max_steps))
    check(err == 0, f"{name} + K9 equals its plain version ({label}, "
                    f"max_steps={max_steps})")
    report[f"{name}_{label}_steps{max_steps}_err"] = err


def fat_case_stream(width: int, seed: int):
    """Ops on the dense range [0, 1.25 B) that run every fat case: the
    first node of an empty list, shifts with room, a median split,
    upserts, deletes of a run's minimum and of an inner lane, emptied
    runs, the list emptied and a first node again."""
    rng = np.random.default_rng(seed)
    span = width + width // 4
    fill = rng.permutation(span).astype(np.int32)
    mixed = rng.integers(0, span, 32).astype(np.int32)
    drain = rng.permutation(span).astype(np.int32)
    ks = np.concatenate([fill, fill[:4], mixed, drain, fill[:3]])
    types = np.concatenate([
        np.full(span + 4, sl.OP_INSERT), rng.integers(1, 3, 32),
        np.full(span, sl.OP_DELETE), np.full(3, sl.OP_INSERT)])
    return types.astype(np.int32), ks, ks * 5 + 1


def small_fat_check() -> None:
    """The fat layout on the card equals the CPU, at B = 8 and 128, both
    variants; K1-K6 with K9 equal their plain versions; every update case
    runs; K1 + K9 at B = 6, 33 and 256, K9's tiling edges."""
    rng = np.random.default_rng(SEED)
    keys = small_keys()
    keys_sh = np.sort(rng.choice(1 << 22, 1500, replace=False)
                      ).astype(np.int32)
    report = {"phase": "small_fat_check", "n": SMALL["n"], "levels": 14,
              "sharded_n": 1500, "shards": "8, then 9"}
    t0 = time.perf_counter()
    for width in (8, 128):
        for foresight in (True, False):
            v = f"{variant(foresight)}{width}"
            k1 = f"{variant(foresight)}_traverse"
            args = dict(capacity=sl.node_slots_for(2 * SMALL["n"], width)
                        + 4, levels=14, foresight=foresight,
                        node_width=width, seed=SEED)
            st = sl.build(keys, keys + 1, device=DEVICE, **args)
            cpu = sl.build(keys, keys + 1, device="cpu", **args)
            check_same_state(st, cpu, f"{v} fat build, card equals CPU")
            q, = on(DEVICE, np.concatenate([rng.choice(keys, 2048),
                                            rng.integers(0, 1 << 22, 2048)]
                                           ).astype(np.int32))
            for max_steps in (0, 9):
                check_fat_kernel(k1, fat_tables(st), (q,), report, v,
                                 max_steps)
            got = ops.search_kernel(st, q)
            want = ops.search_kernel(cpu, q.cpu())
            check(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
                  f"{v} fat search_kernel, card equals CPU")
            for lo, hi, m in ((0, 1 << 22, 300), (int(keys[50]) + 1,
                                                  int(keys[900]), 64)):
                check(all(torch.equal(a.cpu(), b) for a, b in zip(
                    sl.range_scan(st, lo, hi, m),
                    sl.range_scan(cpu, lo, hi, m))),
                      f"{v} fat range_scan, card equals CPU")

            stream = fat_case_stream(width, SEED + width)
            empty = {dev: sl.empty(8, 6, foresight=foresight, seed=SEED,
                                   node_width=width, device=dev)
                     for dev in (DEVICE, "cpu")}
            new, res = sl.apply_ops(empty[DEVICE], *on(DEVICE, *stream))
            sl.FAT_CASES.clear()        # the plain version counts its cases
            new_cpu, res_cpu = sl.apply_ops(empty["cpu"], *on("cpu",
                                                              *stream))
            report[f"{v}_update_cases"] = dict(sl.FAT_CASES)
            for case in ak.CASE_NAMES:
                check(sl.FAT_CASES[case] > 0, f"{v} update case {case} ran")
            check(torch.equal(res.cpu(), res_cpu),
                  f"{v} fat apply_ops results, card equals CPU")
            check_same_state(new, new_cpu, f"{v} fat apply_ops state")
            check(bool(sl.check_fat_invariant(new)) and
                  bool(sl.check_fat_invariant(new_cpu)),
                  f"{v} check_fat_invariant after the stream")
            check_same_state(empty[DEVICE], sl.empty(
                8, 6, foresight=foresight, seed=SEED, node_width=width,
                device="cpu"), f"{v} fat apply_ops leaves its input unchanged")

            sargs = dict(n_shards=8, levels=12, foresight=foresight,
                         node_width=width, seed=SEED)
            shl = shd.build_sharded(keys_sh, keys_sh * 3, device=DEVICE,
                                    **sargs)
            shc = shd.build_sharded(keys_sh, keys_sh * 3, device="cpu",
                                    **sargs)
            check_same_sharded(shl, shc, f"{v} fat build_sharded")
            for name, fn in (("split_shard", lambda x: shd.split_shard(x, 0)),
                             ("merge_shards",
                              lambda x: shd.merge_shards(x, 2, seed=1)),
                             ("repack", lambda x: shd.repack(x, 5, seed=2))):
                check_same_sharded(fn(shl), fn(shc), f"{v} fat {name}")
            shl, shc = shd.split_shard(shl, 0), shd.split_shard(shc, 0)
            dense, clus = sharded_names(foresight)
            tables = (*shard_tables(shl), shl.shards.fat_keys)
            q, = on(DEVICE, np.concatenate([
                rng.choice(keys_sh, 2048),
                rng.integers(0, 1 << 22, 2048)]).astype(np.int32))
            sid = shd.route(shl.boundaries, q)
            plan = ops.cluster_queries(shl.boundaries, ops._pad(q)[0])
            for max_steps in (0, 9):
                check_fat_kernel(dense, tables, (sid, q), report, v,
                                 max_steps)
                check_fat_kernel(clus, tables, (plan.block_sids, plan.ndist,
                                                plan.sid_sorted,
                                                plan.q_sorted),
                                 report, v, max_steps)
            q, = on(DEVICE, straddle_stream(shl.boundaries))
            plan = ops.cluster_queries(shl.boundaries, ops._pad(q)[0])
            check(ops.plan_degeneration_split(plan.ndist, 9) is not None,
                  f"{v} fat straddle stream takes K7's split")
            w_d, w_c = (KERNELS[n][0] for n in (dense, clus))
            before = w_d.fat_launches, w_c.fat_launches
            got = ops.search_kernel_sharded(shl, q)
            check((w_d.fat_launches, w_c.fat_launches) ==
                  (before[0] + 1, before[1] + 1), f"{v} fat K7 launched both")
            want = ops.search_kernel_sharded(shc, q.cpu())
            check(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
                  f"{v} fat search_kernel_sharded (K7), card equals CPU")
            f, vals = shd.search_sharded(shl, q)
            check(torch.equal(f, got.found) and torch.equal(vals, got.vals),
                  f"{v} fat search_sharded equals the kernels")
            b = shc.boundaries.numpy()
            for lo, hi, m in ((0, 1 << 22, 200), (int(b[2]) - 5000,
                                                  int(b[5]) + 7, 100)):
                check(all(torch.equal(a.cpu(), c) for a, c in zip(
                    shd.range_scan_sharded(shl, lo, hi, m),
                    shd.range_scan_sharded(shc, lo, hi, m))),
                      f"{v} fat range_scan_sharded, card equals CPU")

        # tests/test_rebalance.py:220's Zipf inserts on 48 keys, fat shards
        krng, zrng = np.random.default_rng(SEED), np.random.default_rng(7)
        k48 = np.sort(krng.choice(1 << 16, 48, replace=False)
                      ).astype(np.int32)
        st = {dev: shd.build_sharded(k48, k48 * 3, n_shards=4, levels=8,
                                     seed=SEED, node_width=width, device=dev)
              for dev in (DEVICE, "cpu")}
        for b in range(4):
            kk = (int(k48[2]) + (zrng.zipf(ZIPF_A, 32) - 1) % 4096
                  ).astype(np.int32)
            ins = np.full(32, sl.OP_INSERT, np.int32)
            res = {}
            for dev in st:
                st[dev], res[dev] = shd.apply_ops_sharded(
                    st[dev], *on(dev, ins, kk, kk * 2), rebalance=True,
                    seed=b)
            check(torch.equal(res[DEVICE].cpu(), res["cpu"]),
                  f"fat{width} rebalancing apply_ops_sharded results")
            check_same_sharded(st[DEVICE], st["cpu"],
                               f"fat{width} rebalancing apply_ops_sharded")
        report[f"fat{width}_shards_after_zipf"] = st[DEVICE].n_shards

    # K9's tiling edges: rows not 16-byte aligned (6), a width that is not
    # a multiple of 4 (33), two passes of the row compare (256)
    for width in (6, 33, 256):
        args = dict(capacity=sl.node_slots_for(2 * SMALL["n"], width) + 4,
                    levels=14, node_width=width, seed=SEED)
        st = sl.build(keys, keys + 1, device=DEVICE, **args)
        check_same_state(st, sl.build(keys, keys + 1, device="cpu", **args),
                         f"fat{width} build, card equals CPU")
        q, = on(DEVICE, np.concatenate([rng.choice(keys, 2048), rng.integers(
            0, 1 << 22, 2048)]).astype(np.int32))
        for max_steps in (0, 9):
            check_fat_kernel("foresight_traverse", fat_tables(st), (q,),
                             report, f"foresight{width}", max_steps)
    report["seconds"] = time.perf_counter() - t0
    emit(report)


def fat_capacity(n: int, width: int) -> int:
    """benchmarks/common.py:37-38: the node slots of ``n`` keys at build
    fill, doubled, + 4, to the next power of two."""
    return 1 << (2 * sl.node_slots_for(n, width) + 4 - 1).bit_length()


def fat_full_size(keys_np: np.ndarray, q_np: np.ndarray, width: int,
                  foresight: bool, stream: tuple) -> dict:
    """The paper's keys in runs of ``width``: build, the main path through
    ``search_kernel`` (K1/K2 + K9), ``search`` (K14 with K9 inside, its
    launches read around the call) and, with ``stream``, one update batch
    through ``apply_ops``; checks, times, the byte bound and, on the
    foresight B = 128 list, K9 alone.  Returns the report; its ``row`` is
    the kernels-line row, ``k9`` K9's own and ``k14`` K14's on this
    list."""
    stage_s, t_stage = {}, time.perf_counter()
    t_phase = t_stage

    def lap(stage: str) -> None:
        nonlocal t_stage
        torch.cuda.synchronize()
        now = time.perf_counter()
        stage_s[stage] = now - t_stage
        t_stage = now

    dev = torch.device(DEVICE)
    v = variant(foresight)
    name = f"{v}_traverse"
    keys = torch.from_numpy(keys_np).to(dev)
    q = torch.from_numpy(q_np).to(dev)
    cap = fat_capacity(FULL_N, width)
    torch.cuda.reset_peak_memory_stats()

    # The main path, with every launch counter at 0 just before it.
    reset_launches()
    t0 = time.perf_counter()
    st = sl.build(keys, keys + 1, capacity=cap, levels=FULL_LEVELS,
                  foresight=foresight, seed=SEED, node_width=width,
                  device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = ops.search_kernel(st, q)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    rec, n_rec = counted(lambda: sl.search(st, q))
    check(n_rec["search_walk"] == 1 and n_rec[f"{name}/fat"] == 0,
          f"fat{width} search launched K14 once and no {name}")
    report = {"phase": "fat_full_size", "variant": v, "node_width": width,
              "n": FULL_N, "levels": FULL_LEVELS, "capacity": cap,
              "nodes": int(st.bump) - 2, "batch": q.numel(),
              "fused_gib": (st.fused if foresight else st.nxt).numel() * 4
              / 2**30, "runs_gib": 2 * st.fat_keys.numel() * 4 / 2**30,
              "build_s": build_s, "search_kernel_s": search_s}
    if stream is not None:
        (types, ks, vs), want_results, current = stream
        saved = [t.clone() for t in st if t is not None]
        t0 = time.perf_counter()
        new, results = sl.apply_ops(st, *on(dev, types, ks, vs))
        torch.cuda.synchronize()
        update_s = time.perf_counter() - t0
        after = ops.search_kernel(new, q)
    torch.cuda.synchronize()
    launches = read_launches()
    lap("main_path")
    check(launches[f"{name}/fat"] >= 1 and launches["fat_resolve"] >= 1,
          f"main path launched {name} with K9 (width {width})")
    check(launches["apply_ops"] == (stream is not None),
          f"the fat{width} update batch launched the update kernel once")
    check(launches["search_walk"] == n_rec["search_walk"],
          f"fat{width} K14's launches add up to the counter's total")

    check_lookups(res.found, res.vals, q_np, keys_np,
                  f"fat{width} search_kernel")
    check_lookups(rec.found, rec.vals, q_np, keys_np, f"fat{width} search")
    flat_vals = st.fat_vals.reshape(-1)
    check(torch.equal(flat_vals[res.node[res.found].long()],
                      res.vals[res.found]),
          f"fat{width} node ids dereference into fat_vals")
    if stream is not None:
        check(np.array_equal(results.cpu().numpy(), want_results),
              f"fat{width} every apply_ops result equals the oracle")
        check(bool(sl.check_fat_invariant(new)),
              f"fat{width} check_fat_invariant after the update")
        check(all(torch.equal(a, b) for a, b in
                  zip([t for t in st if t is not None], saved)),
              f"fat{width} apply_ops leaves its input unchanged")
        check_lookups(after.found, after.vals, q_np, current,
                      f"fat{width} search_kernel after the update")
        report.update(update_ops=len(types), update_s=update_s,
                      update_us_per_op=update_s / len(types) * 1e6,
                      n_after=int(new.n))
        del new, after, saved
        upd, _, _ = update_times(one_shard(st), route_sorted(
            None, 1, types, ks, vs), want=results)
        report["update_kernel"] = upd
    lap("oracle_checks")

    wrapper, plain, source, replaces = KERNELS[name]
    tables = fat_tables(st)
    walk, fat = tables[:-1], tables[-1]
    err = max_abs_err(wrapper(*walk, q, fat), plain(*walk, q, fat))
    check(err == 0, f"{name} + K9 equals its plain version (width {width})")
    fp = path_footprint(tuple(t[None] for t in walk), q,
                        fat_keys=fat[None])
    lap("footprint_replay")
    kernel_ms = time_ms(lambda: wrapper(*walk, q, fat), KERNEL_REPS)
    plain_ms = time_ms(lambda: plain(*walk, q, fat), PLAIN_REPS)
    library_ms = time_ms(lambda: torch.searchsorted(keys, q), KERNEL_REPS)
    # K1/K2 + K9 group by key: the batch order too
    split = split_times(name, walk, q, fat)
    extra = {"ungrouped_ms": split["ungrouped_ms"]}
    report.update(split, group_by_key_launches=launches["group_by_key"],
                  apply_ops_launches=launches["apply_ops"])
    lap("timing")
    io_bytes = q.numel() * 4 * 3             # queries in, node + key out
    bytes_ms = (fp["distinct_bytes"] + io_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = (fp["steps"] + fp["compares"]) / SCALAR_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    report["row"] = {
        "name": fat_row_name(name, width), "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[f"{name}/fat"],
        "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms, **extra}
    report.update(
        hits=int(res.found.sum()), mops=q.numel() / kernel_ms / 1e3, **extra,
        ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_share=bound_ms / kernel_ms,
        mean_path_steps=fp["steps"] / q.numel(),
        max_path_steps=int(fp["path"].max()),
        distinct_bytes=fp["distinct_bytes"],
        distinct_runs=fp["distinct_runs"], sector_bytes=fp["sector_bytes"],
        sector_bound_ms=(fp["sector_bytes"] + io_bytes)
        / HBM_BYTES_PER_S * 1e3)

    # K14 on the fat list: every field against its plain version on the
    # card, steps and gathers against the replay; its row beside K1/K2 + K9
    plain14 = sl.search_plain(st, q)
    err14 = result_err(rec, plain14, SEARCH_FIELDS,
                       f"K14 search = plain at full size (fat{width}, {v})")
    counts14 = k14_counters(rec, plain14, fp["path"], 1 if foresight else 2,
                            f"fat{width}, {v}")
    del plain14
    B, L = q.numel(), st.levels
    vals14 = int(torch.unique(rec.node[rec.found]).numel()) * 4
    report["k14"] = k14_row(
        fat_row_name("search" if foresight else "search/base", width),
        lambda: sl.search(st, q),
        lambda: sl.search_plain(st, q), fp["distinct_bytes"],
        B * (4 + 1 + 4 + 4 + 4 * L) + 8 + vals14,
        fp["steps"] + fp["compares"], n_rec["search_walk"], err14, None,
        f"fat{width}, {v}")
    report["k14"].update(counts14, k1_ms=kernel_ms)
    report["k14_over_walk_ms"] = report["k14"]["ms"] / kernel_ms
    del rec
    lap("k14")

    if foresight:
        # K9 alone on the batch's final predecessors: what the postlude
        # costs beside the walk.
        x = fp["x"]
        got = ft.fat_resolve(st.fused, fat, x, q)
        err9 = max_abs_err(got, ft.fat_resolve_plain(st.fused, fat, x, q))
        check(err9 == 0,
              f"K9 alone equals its plain version (width {width})")
        check(all(torch.equal(a, b) for a, b in
                  zip(got, wrapper(*walk, q, fat))),
              f"K9 alone equals the postlude of K1 (width {width})")
        cand, ck = st.fused[0, x.long()].unbind(1)
        owner = torch.where((ck == q) | (x == 0), cand, x).long()
        rows = fat[owner]                        # [batch, B] owner runs
        k9_ms = time_ms(lambda: ft.fat_resolve(st.fused, fat, x, q),
                        KERNEL_REPS)
        k9_plain_ms = time_ms(
            lambda: ft.fat_resolve_plain(st.fused, fat, x, q), PLAIN_REPS)
        k9_library_ms = time_ms(lambda: torch.searchsorted(rows, q[:, None]),
                                KERNEL_REPS)
        del rows
        # x's level-0 records and the distinct owner runs; x and q in,
        # node and key out
        k9_bytes = (int(torch.unique(x).numel()) * 8
                    + fp["distinct_runs"] * width * 4 + q.numel() * 16)
        k9_bytes_ms = k9_bytes / HBM_BYTES_PER_S * 1e3
        # the same in 32-byte sectors (a run of B = 128 keys is 16 sectors)
        k9_sectors = (int(torch.unique(x.long() * 8 // 32).numel()) * 32
                      + fp["distinct_runs"] * -(-width * 4 // 32) * 32
                      + q.numel() * 16)
        k9_ops_ms = fp["compares"] / SCALAR_OPS_PER_S * 1e3
        report["k9"] = {
            "name": "fat_resolve", "route": "cuda", "source": TRAVERSE_CU,
            "replaces": f"{FT_PY}:223", "launches": None,
            "max_abs_err": err9, "ms": k9_ms, "plain_ms": k9_plain_ms,
            "bound_ms": max(k9_bytes_ms, k9_ops_ms),
            "bound_by": "bytes" if k9_bytes_ms >= k9_ops_ms
            else "operations", "library_ms": k9_library_ms,
            "sector_bound_ms": k9_sectors / HBM_BYTES_PER_S * 1e3}
        report["k9_share_of_k1_fat"] = k9_ms / kernel_ms
        lap("k9_alone")
    report.update(peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                  stage_s=stage_s, seconds=time.perf_counter() - t_phase)
    emit({k: v for k, v in report.items() if k != "row"})
    del st, res, tables, walk, fat, flat_vals, keys, fp
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# The data plane and the serving index plane at full size
# ---------------------------------------------------------------------------

# benchmarks/macro_store.py and examples/index_service.py drive the store;
# StoreConfig's defaults: rows of seq_len + 1 = 129 tokens, vocab 256.
STORE_SEQ, STORE_VOCAB, STORE_PIPE_SEED = 128, 256, 17
STORE_UPDATES = 8192         # new keys ingested, then evicted
# The monolithic store: the store's capacity rule (next power of two of 2n
# + 4) gives 2^27 slots at 2^25 samples, where levels * capacity passes
# 2^31 - 1 for any L >= 16 (the reference's int32 record index); 2^24
# samples (every other key) keep 2^26 slots at L = ceil(log2 n) + 2 = 26.
MONO_STORE_N, MONO_STORE_LEVELS = 2**24, 26
SCAN_OUT = 2048
SCAN_OUTS = (64, SCAN_OUT, 65536)   # the timed scans: the shortest the
                                    # warp gathers (range_scan.GATHER_FROM),
                                    # the store's and a very long one
# The page pool: Llama-3-8B (src/repro/configs/llama3_8b.py: 32 layers, 8
# KV heads of 128) keeps 32 * 2 * 8 * 128 * 2 B = 128 KiB of bf16 KV a
# token, so 2^15 pages of 16 tokens are 64 GiB of KV beside 16 GB of
# weights on one 80 GB card.
PT_PAGES, PT_PAGE_TOKENS, PT_LEVELS = 2**15, 16, 16
PT_BLOCKS = 16               # blocks a sequence: 256-token contexts
PT_RUNNING = 1024            # sequences kept live: half the pool's pages
PT_DECODE = 64               # sequences a decode step looks up: 1024 lanes
# 8 bursts of 144 sequences (2 denied by faults) admit 1150, 18400 pages,
# and release the 126 past PT_RUNNING: the pool ends half full (16384 of
# 32768 pages).  Each grant of 16 pages is one update batch through the
# update kernel (until PR 24 a host loop at ~20 ms a page, which cut the
# stream to 3% of the pool).  The request past the pool runs on a pool of
# PT_PAST_POOL pages, the same configuration otherwise.
PT_PREFILL, PT_BURSTS = 144, 8   # sequences admitted a burst; bursts
PT_PAST_POOL = 256
PT_FAULT_SEED = 1            # FaultSchedule.random at kvcache.alloc:
                             # pool_exhausted at burst 4, capacity_fail at 7


def store_rows(n: int) -> torch.Tensor:
    """``[n, 129]`` int32 tokens drawn on the card from a seeded generator
    (the Markov corpus is a numpy draw, held equal on the CPU)."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED)
    return torch.randint(0, STORE_VOCAB, (n, STORE_SEQ + 1), generator=g,
                         dtype=torch.int32, device=DEVICE)


def new_keys(keys_np: np.ndarray, n: int, seed: int) -> np.ndarray:
    """``n`` distinct keys of [0, 2^26) that the store does not hold."""
    rng = np.random.default_rng(seed)
    cand = np.unique(rng.integers(0, FULL_SPAN, 4 * n))
    cand = cand[~np.isin(cand, keys_np)]
    return rng.permutation(cand)[:n].astype(np.int32)


def launches_on(path_launches: dict, names) -> dict:
    return {name: path_launches[name] for name in names}


def check_batch(store: IndexedSampleStore, pipe: DataPipeline, step: int,
                batch: dict, what: str) -> None:
    """A pipeline batch against the rows it drew: every key found, the row
    ids the positions ``batch_keys`` drew, the tokens those rows gathered
    apart."""
    keys = pipe.batch_keys(step)
    pos = np.searchsorted(store.keys_np, keys)
    check(bool(batch["found"].all()), f"{what}: every key found")
    _, rid = store.lookup(torch.from_numpy(keys.astype(np.int32)))
    check(np.array_equal(rid.cpu().numpy(), pos),
          f"{what}: row ids are the drawn positions")
    rows = store.rows[torch.from_numpy(pos).to(store.device)]
    check(torch.equal(batch["tokens"], rows[:, :-1]) and
          torch.equal(batch["labels"], rows[:, 1:]),
          f"{what}: tokens and labels are the drawn rows")


# the scan kernel's row of the kernels line, from the monolithic store
SCAN_ROW = {}


def scan_times(state: sl.SkipListState, lo: int, hi: int, max_out: int,
               *, reps: int = KERNEL_REPS, device_time: bool = False
               ) -> dict:
    """K13 on one scan of the store (kernel: the median of ``reps`` runs;
    plain: one run, both on the card), held equal; with ``device_time``
    also the kernel's own device time a call (``torch.profiler``, 5
    calls).  Its byte bound: the positioning walk's distinct records, each
    scanned key's level-0 record and val read once, the outputs written
    once."""
    stack = sl._stack_of_one(state)
    lo_t, hi_t = rs.bound_lanes(lo, DEVICE), rs.bound_lanes(hi, DEVICE)
    scan = lambda: rs.range_scan_batch(stack, None, lo_t, hi_t, max_out)
    got = scan()
    ms = time_ms(scan, reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = rs.range_scan_batch_plain(stack, None, lo_t, hi_t, max_out)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(int((g.long() - w.long()).abs().max())
              for g, w in zip(got, want))
    check(err == 0, "K13 equals its plain version on the store's scan")
    walk = path_footprint(stack_tables(stack), lo_t)["distinct_bytes"]
    count = int(got[2][0])
    rec = 8                       # foresight's record; base's ptr + key
    total = walk + count * (rec + 4) + max_out * 8 + 4
    out = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
           "count": count, "bound_bytes": total,
           "bound_ms": total / HBM_BYTES_PER_S * 1e3}
    if device_time:
        out["device_ms"] = device_breakdown(
            scan, calls=5, walk="range_scan_kernel")["walk_device_ms"]
    return out


def store_full_size(keys_np: np.ndarray, rows: torch.Tensor,
                    foresight: bool) -> tuple:
    """The sample store at the paper's size: 2^25 samples (the chip_smoke
    keys), rows ``[2^25, 129]`` on the card, 64 shards of L = 21 (the
    sharded configuration), ``use_kernel``.  Traffic: two 2^20 pipeline
    batches through ``get_batch`` (clustered: K5/K6, or K7), one dense
    ``lookup`` (K3/K4), 256 ingests and 256 evictions of new keys; the
    stack's ``range_scan`` is refused (the reference's int32 stack index
    wraps at 64 x 21 x 2^21).  Then the monolithic store (every other key,
    2^24 samples, L = 26): a pipeline batch through K1/K2 and a range scan
    held against numpy.  Returns (report, launches on the main paths)."""
    stage_s, t_stage = {}, time.perf_counter()
    t_phase = t_stage

    def lap(stage: str) -> None:
        nonlocal t_stage
        torch.cuda.synchronize()
        now = time.perf_counter()
        stage_s[stage] = stage_s.get(stage, 0.0) + now - t_stage
        t_stage = now

    v = variant(foresight)
    dense, clus = sharded_names(foresight)
    mono = "foresight_traverse" if foresight else "base_traverse"
    torch.cuda.reset_peak_memory_stats()
    cfg = StoreConfig(n_samples=FULL_N, seq_len=STORE_SEQ,
                      index_levels=SHARD_LEVELS, foresight=foresight,
                      use_kernel=True, n_shards=SHARDS, seed=SEED)
    fresh = new_keys(keys_np, STORE_UPDATES, SEED + 7)
    fresh_t = torch.from_numpy(fresh).to(DEVICE)
    fresh_rows = torch.arange(STORE_UPDATES, dtype=torch.int32,
                              device=DEVICE)

    # The main path, with every launch counter at 0 just before it.
    reset_launches()
    t0 = time.perf_counter()
    store = IndexedSampleStore(cfg, rows=rows, keys=keys_np, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    pipe = DataPipeline(store, PipelineConfig(global_batch=FULL_BATCH,
                                              seed=STORE_PIPE_SEED))
    batches = [pipe.get_batch(step) for step in (0, 1)]
    q_dense = torch.from_numpy(pipe.batch_keys(2).astype(np.int32))
    store.cfg.clustered = False
    dense_found, dense_rid = store.lookup(q_dense)
    store.cfg.clustered = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ingest_res = store.ingest(fresh_t, fresh_rows)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    after_ingest = store.lookup(fresh_t)
    t0 = time.perf_counter()
    evict_res = store.evict(fresh_t)
    torch.cuda.synchronize()
    evict_s = time.perf_counter() - t0
    after_evict = store.lookup(fresh_t)
    torch.cuda.synchronize()
    launches = read_launches()
    lap("main_path")
    for name in (dense, clus, "group_by_shard"):
        check(launches[name] >= 1, f"store path launched {name}")
    check(launches["apply_ops"] == 2, "ingest and evict launched the update "
                                      "kernel once each")

    for step, batch in enumerate(batches):
        check_batch(store, pipe, step, batch, f"{v} store batch {step}")
    d_keys = q_dense.numpy()
    check(bool(dense_found.all()) and np.array_equal(
        dense_rid.cpu().numpy(), np.searchsorted(store.keys_np, d_keys)),
        f"{v} dense lookup (K3/K4): found, row ids")
    check(bool(ingest_res.all()) and bool(evict_res.all()),
          f"{v} every ingest and eviction applied")
    check(bool(after_ingest[0].all()) and torch.equal(after_ingest[1],
                                                      fresh_rows),
          f"{v} ingested keys found with their rows")
    check(not bool(after_evict[0].any()), f"{v} evicted keys missed")
    check(bool(shd.check_sharded_invariant(store.index, expect_n=FULL_N)),
          f"{v} sharded invariant and live count after ingest + evict")
    wraps = SHARDS * SHARD_LEVELS * store.index.shard_capacity > \
        shd.MAX_INDEX
    try:
        store.range_scan(int(keys_np[0]), int(keys_np[-1]), SCAN_OUT)
        refused = ""
    except ValueError as e:
        refused = str(e)
    check(("2**31 - 1" in refused) == wraps,
          f"{v} range_scan refused exactly where the reference's int32 "
          "stack index wraps (64 x 21 x 2^21 does)")
    lap("checks")

    keys_t = torch.from_numpy(pipe.batch_keys(0).astype(np.int32)).to(
        DEVICE)
    t = {"get_batch_ms": time_ms(lambda: store.get_batch(keys_t),
                                 KERNEL_REPS),
         "lookup_ms": time_ms(lambda: store.lookup(keys_t), KERNEL_REPS),
         "search_kernel_sharded_ms": time_ms(
             lambda: ops.search_kernel_sharded(store.index, keys_t),
             KERNEL_REPS),
         "pipeline_get_batch_ms": time_ms(lambda: pipe.get_batch(3),
                                          PLAIN_REPS)}
    store.cfg.clustered = False
    t["dense_lookup_ms"] = time_ms(lambda: store.lookup(keys_t),
                                   KERNEL_REPS)
    store.cfg.clustered = True
    t["store_overhead_ms"] = t["lookup_ms"] - t["search_kernel_sharded_ms"]
    lap("timing")
    report = {"phase": "store_full_size", "variant": v, "store": "sharded",
              "n": FULL_N,
              "seq_len": STORE_SEQ, "shards": store.n_shards,
              "levels": SHARD_LEVELS,
              "shard_capacity": store.index.shard_capacity,
              "rows_gb": rows.numel() * 4 / 1e9,
              "index_gb": sum(x.numel() * x.element_size()
                              for x in store.index.shards
                              if x is not None) / 1e9,
              "batch": FULL_BATCH, "build_s": build_s, **t,
              "get_batch_mrows_per_s": FULL_BATCH / t["get_batch_ms"] / 1e3,
              "ingest_us_per_op": ingest_s / STORE_UPDATES * 1e6,
              "evict_us_per_op": evict_s / STORE_UPDATES * 1e6,
              "range_scan": refused.split(":")[0] or "ran",
              "launches": launches_on(launches, (dense, clus,
                                                 "group_by_shard",
                                                 "apply_ops"))}
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    report["stage_s"] = dict(stage_s)
    report["seconds"] = time.perf_counter() - t_phase
    emit(report)
    del store, pipe, batches, after_ingest, after_evict
    torch.cuda.empty_cache()

    # The monolithic store (K1/K2) and its range scan.  n_shards=1: the
    # reference's auto rule would shard it for its VMEM budget (and raises
    # at this size).
    t_mono = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mono_keys = keys_np[::2]
    mcfg = StoreConfig(n_samples=MONO_STORE_N, seq_len=STORE_SEQ,
                       index_levels=MONO_STORE_LEVELS, foresight=foresight,
                       use_kernel=True, n_shards=1, seed=SEED)
    reset_launches()
    t0 = time.perf_counter()
    mstore = IndexedSampleStore(mcfg, rows=rows[:MONO_STORE_N],
                                keys=mono_keys, device=DEVICE)
    torch.cuda.synchronize()
    mono_build_s = time.perf_counter() - t0
    mpipe = DataPipeline(mstore, PipelineConfig(global_batch=FULL_BATCH,
                                                seed=STORE_PIPE_SEED))
    mbatch = mpipe.get_batch(0)
    lo = int(mono_keys[MONO_STORE_N // 2])
    scan = mstore.range_scan(lo, FULL_SPAN, SCAN_OUT)
    torch.cuda.synchronize()
    mlaunch = read_launches()
    lap("monolithic_main_path")
    check(not mstore.sharded and mlaunch[mono] >= 1
          and mlaunch["group_by_key"] >= 1 and mlaunch["range_scan"] == 1,
          f"monolithic store path launched {mono}, its key pass and the "
          "scan kernel")
    check_batch(mstore, mpipe, 0, mbatch, f"{v} monolithic store batch")
    at = MONO_STORE_N // 2
    want_k = mono_keys[at:at + SCAN_OUT]
    check(int(scan[2]) == SCAN_OUT and np.array_equal(
        scan[0].cpu().numpy(), want_k) and np.array_equal(
        scan[1].cpu().numpy(), np.arange(at, at + SCAN_OUT)),
        f"{v} range_scan equals the numpy oracle (keys, row ids)")
    mkeys = torch.from_numpy(mpipe.batch_keys(0).astype(np.int32)).to(
        DEVICE)
    mreport = {
        "phase": "store_full_size", "variant": v, "store": "monolithic",
        "n": MONO_STORE_N, "levels": MONO_STORE_LEVELS,
        "capacity": mstore.index.capacity, "build_s": mono_build_s,
        "get_batch_ms": time_ms(lambda: mstore.get_batch(mkeys),
                                KERNEL_REPS),
        "search_kernel_ms": time_ms(
            lambda: ops.search_kernel(mstore.index, mkeys), KERNEL_REPS),
        "range_scan_ms": time_ms(
            lambda: mstore.range_scan(lo, FULL_SPAN, SCAN_OUT), KERNEL_REPS),
        "scan_out": SCAN_OUT,
        "launches": launches_on(mlaunch, (mono, "group_by_key",
                                          "range_scan"))}
    mreport["scans"] = {m: scan_times(mstore.index, lo, FULL_SPAN, m)
                        for m in SCAN_OUTS}
    mreport["scan"] = mreport["scans"][SCAN_OUT]
    others = {m: {k: sc[k] for k in ("ms", "plain_ms", "bound_ms", "count")}
              for m, sc in mreport["scans"].items() if m != SCAN_OUT}
    if foresight:
        _, _, source, replaces = KERNELS["range_scan"]
        sc = mreport["scan"]
        SCAN_ROW["row"] = {
            "name": "range_scan", "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0,
            "max_abs_err": max(x["max_abs_err"]
                               for x in mreport["scans"].values()),
            "ms": sc["ms"], "plain_ms": sc["plain_ms"],
            "bound_ms": sc["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "scan_out": SCAN_OUT, "n": MONO_STORE_N,
            "base_ms": None, "other_scans": others, "base_other_ms": None}
    else:
        SCAN_ROW["row"]["base_ms"] = mreport["scan"]["ms"]
        SCAN_ROW["row"]["base_other_ms"] = {m: o["ms"]
                                            for m, o in others.items()}
    lap("monolithic_checks_and_timing")
    mreport["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    mreport["stage_s"] = stage_s
    mreport["seconds"] = time.perf_counter() - t_mono
    emit(mreport)
    del mstore, mpipe, mbatch
    torch.cuda.empty_cache()
    return report, {**report["launches"], **mreport["launches"]}


class ServeStub:
    """The surface ``InvariantWatchdog.check`` reads of a serving engine:
    the page table, the running sequences (one slot each, ``PT_BLOCKS``
    blocks), an empty queue and a session table keyed by sequence id."""

    def __init__(self, pages: PageTable, running, steps: int):
        self.pages, self.steps, self.queue = pages, steps, []
        self.slots = [SimpleNamespace(rid=int(s)) for s in running]
        k = torch.tensor(sorted(int(s) for s in running), dtype=torch.int32)
        cap = 1 << (len(running) + 2).bit_length()
        self.sessions = sl.build(k, k, capacity=max(cap, 16), levels=12,
                                 device=DEVICE)

    @staticmethod
    def blocks_of(_req) -> int:
        return PT_BLOCKS


def grant_times(pt: PageTable, seq: int, reps: int = 20) -> dict:
    """Where a grant's time goes: one ``PageTable._apply`` of a sequence's
    ``PT_BLOCKS`` inserts on the table as it ends (its index put back
    before each call): host ms a call (synchronised, the mean of
    ``reps``), the device's kernels in it (``device_breakdown``, 5 calls)
    and the device's idle share of the host time."""
    idx = pt.index
    keys = torch.from_numpy(page_key(np.full(PT_BLOCKS, seq),
                                     np.arange(PT_BLOCKS)).astype(np.int32)
                            ).to(DEVICE)
    ins = torch.full_like(keys, sl.OP_INSERT)
    pages = torch.arange(PT_BLOCKS, dtype=torch.int32, device=DEVICE)

    def one():
        pt.index = idx
        return pt._apply(ins, keys, pages)

    one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        one()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    prof = device_breakdown(one, calls=5)
    pt.index = idx
    return {"ops": PT_BLOCKS, "host_ms": host_ms,
            "device_ms": prof["device_ms"], "launches": prof["launches"],
            "idle_share": 1 - prof["device_ms"] / host_ms,
            "top": prof["top"]}


def page_table_full_size(foresight: bool) -> tuple:
    """A page pool one card serves: ``PagedCacheConfig(n_pages=2^15,
    page_tokens=16, levels=16, use_kernel=True, rebalance=True)`` (the
    reference's rule: 8 shards of 16384 slots).  ``PT_BURSTS`` bursts:
    ``try_alloc`` of ``PT_PREFILL`` new sequences of 16 blocks (a seeded
    ``FaultSchedule`` at ``kvcache.alloc`` forces a zero grant or a failed
    one), a decode step that looks up every block of the newest
    ``PT_DECODE`` running sequences (16 lanes each; K5/K6), and
    ``release`` of the oldest past ``PT_RUNNING``.  Then one
    ``try_alloc`` past a pool of ``PT_PAST_POOL`` pages, which must grant
    the free prefix.  Checks: conservation after every burst, every
    lookup against a host dict, the sharded invariant, the watchdog over
    ``ServeStub``.
    Returns (report, launches on the main path)."""
    stage_s, t_stage = {}, time.perf_counter()
    t_phase = t_stage

    def lap(stage: str) -> None:
        nonlocal t_stage
        torch.cuda.synchronize()
        now = time.perf_counter()
        stage_s[stage] = stage_s.get(stage, 0.0) + now - t_stage
        t_stage = now

    v = variant(foresight)
    dense, clus = sharded_names(foresight)
    cfg = PagedCacheConfig(n_pages=PT_PAGES, page_tokens=PT_PAGE_TOKENS,
                           levels=PT_LEVELS, foresight=foresight,
                           use_kernel=True, rebalance=True, seed=SEED)
    faults = FaultSchedule.random(PT_FAULT_SEED, n_steps=PT_BURSTS,
                                  n_faults=2, sites=("kvcache.alloc",))
    check({f.kind for f in faults} == {POOL_EXHAUSTED, CAPACITY_FAIL} and
          len({f.step for f in faults}) == 2,
          "the fault schedule holds both kinds at two bursts")
    inj = FaultInjector(faults)
    blocks = np.arange(PT_BLOCKS)
    oracle, running, finished = {}, [], []
    counts = {"alloc_blocks": 0, "release_blocks": 0, "decode_lanes": 0,
              "denied": 0}
    secs = {"alloc": 0.0, "release": 0.0}
    conserved = True

    def decode(seqs):
        sq = np.repeat(np.asarray(seqs, np.int64), PT_BLOCKS)
        bk = np.tile(blocks, len(seqs))
        return sq, bk, pt.lookup(sq, bk)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    pt = PageTable(cfg, chaos=inj, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    S0, next_seq, lookups = pt.index.n_shards, 0, []
    for burst in range(PT_BURSTS):
        inj.advance(burst)
        for _ in range(PT_PREFILL):
            t0 = time.perf_counter()
            ok, pages = pt.try_alloc(np.full(PT_BLOCKS, next_seq), blocks)
            secs["alloc"] += time.perf_counter() - t0
            if ok.all():
                oracle.update({(next_seq, b): int(p)
                               for b, p in zip(blocks, pages)})
                running.append(next_seq)
                counts["alloc_blocks"] += PT_BLOCKS
            else:
                check(not ok.any(), "a fault denies the whole grant")
                counts["denied"] += 1
            next_seq += 1
        sq, bk, (found, got) = decode(running[-PT_DECODE:])
        want_p = np.array([oracle[(s, b)] for s, b in zip(sq.tolist(),
                                                          bk.tolist())])
        lookups.append((found, got, want_p))
        counts["decode_lanes"] += sq.size
        while len(running) > PT_RUNNING:
            seq = running.pop(0)
            t0 = time.perf_counter()
            freed = pt.release(seq, PT_BLOCKS)
            secs["release"] += time.perf_counter() - t0
            check(freed == PT_BLOCKS, "release frees every block")
            counts["release_blocks"] += PT_BLOCKS
            for b in blocks:
                del oracle[(seq, b)]
            finished.append(seq)
        conserved &= len(pt.free) + pt.n_live == PT_PAGES
    # past the pool, on a pool of PT_PAST_POOL pages: one request for a
    # sequence more than the pool holds
    small = PageTable(dataclasses.replace(cfg, n_pages=PT_PAST_POOL),
                      device=DEVICE)
    want = PT_PAST_POOL + PT_BLOCKS
    seq_ids = np.arange(want) // PT_BLOCKS
    blk_ids = np.arange(want) % PT_BLOCKS
    t0 = time.perf_counter()
    ok, pages = small.try_alloc(seq_ids, blk_ids)
    past_s = time.perf_counter() - t0
    past_found, past_got = small.lookup(seq_ids, blk_ids)
    torch.cuda.synchronize()
    launches = read_launches()
    lap("main_path")
    check(launches[clus] >= 1, f"page-table path launched {clus}")
    check(launches["apply_ops"] >= counts["alloc_blocks"] // PT_BLOCKS,
          "every grant and release launched the update kernel")
    check(launches["rebalance"] == 2 * launches["apply_ops"] and
          launches[dense] >= launches["apply_ops"],
          "every apply ran the guard (after its K3/K4 presence search) and "
          "the watermark pass through the rebalance kernel")

    check(conserved and len(pt.free) + pt.n_live == PT_PAGES,
          f"{v} free + live == n_pages after every burst")
    check(ok.sum() == PT_PAST_POOL and ok[:PT_PAST_POOL].all()
          and small.n_free == 0 and small.n_live == PT_PAST_POOL,
          f"{v} try_alloc past the pool grants the free prefix")
    check(np.array_equal(past_found.cpu().numpy(), ok) and np.array_equal(
        past_got.cpu().numpy(), np.where(ok, pages, sl.NULL_VAL)),
        f"{v} the granted prefix is mapped, the rest is not")
    check(bool(shd.check_sharded_invariant(small.index,
                                           expect_n=PT_PAST_POOL)),
          f"{v} sharded invariant of the filled pool")
    check(sorted(f.kind for f in inj.fired) ==
          sorted(f.kind for f in faults) and counts["denied"] == len(faults),
          f"{v} every scheduled fault fired and denied its grant")
    for i, (found, got, want_p) in enumerate(lookups):
        check(bool(found.all()) and np.array_equal(got.cpu().numpy(),
                                                   want_p),
              f"{v} decode step {i}: every block found at its page")
    # the final state against the host dict: live blocks and finished ones
    probe = running[-PT_RUNNING:] + finished[:PT_RUNNING // 4]
    sq, bk, (found, got) = decode(probe)
    want_p = np.array([oracle.get((int(s), int(b)), sl.NULL_VAL)
                       for s, b in zip(sq, bk)])
    check(np.array_equal(found.cpu().numpy(), want_p >= 0) and
          np.array_equal(got.cpu().numpy(), want_p),
          f"{v} lookups equal the host dict (live and finished blocks)")
    check(pt.index.n_shards == S0, f"{v} the shard axis stays at the "
                                   "ceiling")
    check(bool(shd.check_sharded_invariant(pt.index, expect_n=pt.n_live)),
          f"{v} sharded invariant and live count")
    stub = ServeStub(pt, sorted({int(s) for (s, _) in oracle}), PT_BURSTS)
    report_wd = InvariantWatchdog().check(stub)
    check(report_wd.ok, f"{v} invariant watchdog green")
    lap("checks")

    sq, bk, _ = decode(running[-PT_DECODE:])
    decode_ms = time_ms(lambda: pt.lookup(sq, bk), KERNEL_REPS)
    grant = grant_times(pt, next_seq)
    keys = torch.from_numpy(page_key(sq, bk).astype(np.int32)).to(DEVICE)
    kernel_ms = time_ms(lambda: ops.search_kernel(pt.index, keys),
                        KERNEL_REPS)
    lap("timing")
    live_shards = int((pt.index.boundaries != sl.KEY_MAX).sum())
    report = {"phase": "page_table_full_size", "variant": v,
              "n_pages": PT_PAGES, "page_tokens": PT_PAGE_TOKENS,
              "levels": PT_LEVELS, "shards": S0,
              "shard_capacity": pt.index.shard_capacity,
              "live_shards": live_shards, "build_s": build_s,
              "sequences_admitted": counts["alloc_blocks"] // PT_BLOCKS,
              "sequences_released": len(finished),
              "faults_fired": [f.kind for f in inj.fired],
              "pool_fill": pt.n_live / PT_PAGES,
              "past_pool": {"n_pages": PT_PAST_POOL, "request": int(want),
                            "granted": int(ok.sum()), "seconds": past_s,
                            "live_shards": int((small.index.boundaries
                                                != sl.KEY_MAX).sum())},
              **counts,
              "alloc_us_per_block": secs["alloc"] / counts["alloc_blocks"]
              * 1e6,
              "release_us_per_block": secs["release"]
              / max(1, counts["release_blocks"]) * 1e6,
              "past_pool_us_per_block": past_s / int(ok.sum()) * 1e6,
              "grant": grant,
              "decode_lanes_per_step": int(sq.size),
              "decode_lookup_ms": decode_ms,
              "search_kernel_sharded_ms": kernel_ms,
              "launches": launches_on(launches, (
                  clus, dense, "group_by_shard", "apply_ops", "rebalance")),
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
              "stage_s": stage_s,
              "seconds": time.perf_counter() - t_phase}
    emit(report)
    del pt, small, stub
    torch.cuda.empty_cache()
    return report, report["launches"]


# ---------------------------------------------------------------------------
# The LLM serving path: the model plane and the engine
# ---------------------------------------------------------------------------

# The smoke check: each smoke config at tests/test_torch_models.py's batch,
# prompt, cache and decode count, with its tolerances (fractions of the
# CPU logits' max abs; the recurrent three amplify a last-bit difference
# to a third of their logits at smoke size, see that file).
MODEL_B, MODEL_S, MODEL_MAX_LEN, MODEL_DECODES = 2, 16, 48, 4
MODEL_TOL = {"float32": 1e-3, "bfloat16": 0.05}
CHAOTIC, CHAOTIC_TOL = ("rwkv6_3b", "jamba_15_large_398b",
                        "whisper_tiny"), 0.75
FLIP_TOL = 0.05              # a greedy flip at a top-two gap below this
                             # (of max |logits|) is a near tie
# The full-width serving cell: llama3_8b's CONFIG (src/repro/configs/
# llama3_8b.py), nothing cut; 16 requests of 256 seeded uniform tokens,
# 64 new tokens each, 8 batch slots of 512 positions, 16-token pages.
FULL_ARCH, FULL_REQUESTS, FULL_PROMPT, FULL_MAX_NEW = "llama3_8b", 16, 256, 64
FULL_ENGINE = dict(batch_slots=8, max_len=512, page_tokens=16)
FULL_OTHERS, FULL_OTHER_DECODES = ("granite_moe_1b", "rwkv6_3b"), 16
MODEL_REPS = 5


def to_device(tree, dev):
    """A tree of dicts, lists and tensors, copied to ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in TT.leaves(tree))


def model_tol(arch: str, dtype: str) -> float:
    if dtype == "bfloat16" and arch in CHAOTIC:
        return CHAOTIC_TOL
    return MODEL_TOL[dtype]


def gap_frac(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|, on the CPU in fp32."""
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    check(g.shape == w.shape and bool(torch.isfinite(g).all()),
          "finite logits of the expected shape")
    return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-6)


def smoke_params(cfg, dtype: str, seed: int = SEED):
    gen = torch.Generator().manual_seed(seed)
    return TT._build_params(cfg, TL.ParamBuilder(
        "init", gen, dtype=getattr(torch, dtype)))


def run_model(cfg, params, toks, extra, fed=None) -> dict:
    """forward, prefill and ``MODEL_DECODES`` decode steps; each decode
    feeds ``fed`` (the CPU run's argmax) or this run's own argmax."""
    logits, aux = TT.forward(cfg, params, toks, extra)
    lg, cache = TT.prefill(cfg, params, toks, MODEL_MAX_LEN,
                           extra_embeds=extra)
    out = {"forward": logits, "aux": aux, "prefill": lg, "decode": [],
           "fed": []}
    for i in range(MODEL_DECODES):
        nxt = (torch.argmax(lg, -1)[:, None].to(torch.int32) if fed is None
               else fed[i].to(toks.device))
        lg, cache = TT.decode_step(cfg, params, cache, nxt)
        out["decode"].append(lg)
        out["fed"].append(nxt.cpu())
    out["cache"] = cache
    return out


def greedy_logits(cfg, params, prompt: torch.Tensor, n: int,
                  max_len: int) -> tuple:
    """Manual greedy prefill + decode of one prompt: (tokens, the logits
    each was taken from)."""
    lg, cache = TT.prefill(cfg, params, prompt[None], max_len)
    toks, logits = [int(torch.argmax(lg[0]))], [lg[0]]
    for _ in range(n - 1):
        nxt = torch.tensor([[toks[-1]]], dtype=torch.int32,
                           device=prompt.device)
        lg, cache = TT.decode_step(cfg, params, cache, nxt)
        toks.append(int(torch.argmax(lg[0])))
        logits.append(lg[0])
    return toks, logits


def compare_greedy(got, want, logits_at, tie_tol: float, what: str) -> dict:
    """Tokens ``got`` against ``want``: equal, or equal up to a flip at a
    near tie (``want``'s top-two gap at that step at most ``tie_tol`` of
    its logits' max abs, and ``got`` took the second).  Anything else
    fails.  Returns the flip, or None."""
    check(len(got) == len(want), f"{what}: token counts equal")
    diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if not diff:
        return None
    i = diff[0]
    lg = logits_at(i).float().cpu()
    top = torch.sort(lg, descending=True, stable=True).indices[:2].tolist()
    gap = float(lg[top[0]] - lg[top[1]])
    flip = {"token": i, "want": int(want[i]), "got": int(got[i]),
            "top_two_gap": gap, "max_abs_logit": float(lg.abs().max())}
    check(top == [want[i], got[i]] and gap <= tie_tol * flip["max_abs_logit"],
          f"{what}: token {i} differs beyond a near tie ({flip})")
    return flip


def dispatch_on_both(xt: torch.Tensor, router: torch.Tensor, K: int, C: int,
                     what: str) -> dict:
    """``moe._dispatch_group`` on equal fp32 inputs on the card and the
    CPU: the routing integers equal, the gathered rows equal."""
    E = router.shape[1]
    out = {}
    for dev in (DEVICE, "cpu"):
        buf, info, aux = TMOE._dispatch_group(xt.to(dev), router.to(dev), K,
                                              C, E)
        out[dev] = (buf.cpu(), [t.cpu() for t in info], float(aux))
    (gbuf, ginfo, gaux), (cbuf, cinfo, caux) = out[DEVICE], out["cpu"]
    for name, g, c in zip(("tok_s", "gate_s", "slot", "keep"), ginfo, cinfo):
        if name != "gate_s":
            check(torch.equal(g, c), f"{what}: {name} equal card and CPU")
    check(torch.equal(gbuf, cbuf), f"{what}: dispatch buffers equal")
    return {"tokens": int(xt.shape[0]), "top_k": K, "experts": E,
            "capacity": C, "kept": int(ginfo[3].sum()),
            "gate_gap": float((ginfo[1] - cinfo[1]).abs().max()),
            "aux": gaux, "aux_cpu": caux}


def check_conservation(info, T: int, K: int, C: int, E: int,
                       what: str) -> dict:
    """Every token routed K times; kept slots unique, in range, at most C
    an expert; the kept gates of a token with none dropped sum to 1."""
    tok_s, gate_s, slot, keep = [t.cpu() for t in info]
    check(torch.equal(torch.bincount(tok_s.long(), minlength=T),
                      torch.full((T,), K)), f"{what}: K routes a token")
    kept = slot[keep]
    check(bool((kept < E * C).all()) and kept.unique().numel() ==
          kept.numel(), f"{what}: kept slots unique and in range")
    per_e = torch.bincount((kept // C).long(), minlength=E)
    check(bool((per_e <= C).all()), f"{what}: at most C tokens an expert")
    sums = torch.zeros(T).index_add_(0, tok_s.long(),
                                     torch.where(keep, gate_s, 0.0))
    whole = torch.zeros(T, dtype=torch.long).index_add_(
        0, tok_s.long(), (~keep).long()) == 0
    check(torch.allclose(sums[whole], torch.ones(int(whole.sum())),
                         atol=1e-5), f"{what}: kept gates sum to 1")
    return {"routes": int(tok_s.numel()), "kept": int(keep.sum()),
            "dropped": int((~keep).sum()), "max_per_expert": int(per_e.max())}


def model_smoke_check() -> dict:
    """The ten smoke configs on the card against the CPU; the MoE
    dispatch's integers; decode against forward; the smoke engine."""
    t_phase = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is off for fp32 products (the router)")
    archs = {}
    for arch in cfgs.ARCH_IDS:
        cfg = cfgs.get_smoke(arch)
        row = {}
        for dtype in ("bfloat16", "float32"):
            params = smoke_params(cfg, dtype)
            rng = np.random.default_rng(SEED)
            toks = torch.from_numpy(rng.integers(
                0, cfg.vocab, (MODEL_B, MODEL_S)).astype(np.int32))
            extra = None
            if cfg.family in ("vlm", "audio"):
                extra = torch.from_numpy(rng.standard_normal(
                    (MODEL_B, cfg.n_extra_embeds, cfg.d_model)).astype(
                        np.float32)).to(getattr(torch, dtype))
            cpu = run_model(cfg, params, toks, extra)
            gpu = run_model(cfg, to_device(params, DEVICE), toks.to(DEVICE),
                            to_device(extra, DEVICE), fed=cpu["fed"])
            gaps = [gap_frac(gpu["forward"], cpu["forward"]),
                    gap_frac(gpu["prefill"], cpu["prefill"])] + [
                gap_frac(g, c) for g, c in zip(gpu["decode"], cpu["decode"])]
            tol = model_tol(arch, dtype)
            check(max(gaps) <= tol, f"{arch} {dtype}: card within {tol} of "
                                    f"the CPU ({max(gaps):.3e})")
            for (k, g), (_, c) in zip(flat_items(gpu["cache"]),
                                      flat_items(cpu["cache"])):
                check(g.dtype == c.dtype and g.shape == c.shape,
                      f"{arch} {dtype}: cache {k} dtype and shape")
                if not g.is_floating_point():
                    check(torch.equal(g.cpu(), c), f"{arch}: cache {k}")
            row[dtype] = {"max_gap": max(gaps), "tol": tol,
                          "forward_gap": gaps[0], "prefill_gap": gaps[1],
                          "decode_gap": max(gaps[2:])}
        archs[arch] = row

    # MoE routing integers, card against CPU, on equal fp32 inputs
    rng = np.random.default_rng(SEED + 3)
    dispatch = []
    for T, K, E in ((64, 2, 8), (600, 2, 8), (256, 8, 32)):
        xt = torch.from_numpy(rng.standard_normal((T, 64)).astype(np.float32))
        router = torch.from_numpy(rng.standard_normal((64, E)).astype(
            np.float32))
        dispatch.append(dispatch_on_both(xt, router, K, 128,
                                         f"dispatch T={T} K={K} E={E}"))
    col = torch.from_numpy(rng.standard_normal((64, 1)).astype(np.float32))
    router = torch.cat([router[:, :3], col, col, router[:, 5:6], col], 1)
    dispatch.append(dispatch_on_both(xt[:, :64], router, 3, 128,
                                     "dispatch with tied experts 3, 4, 6"))

    # decode against forward (tests/test_models.py's three archs); the
    # hybrid in fp32: the reference's Mamba forward convolves in bf16 and
    # its decode in fp32 (ROADMAP Queue 3)
    consistency = {}
    for arch, dtype in (("llama3_8b", "bfloat16"), ("rwkv6_3b", "bfloat16"),
                        ("hybrid_nomoe", "float32")):
        cfg = (TT.ModelConfig(
            name="hybrid_nomoe", family="hybrid", n_layers=4, pattern_len=4,
            d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=256,
            mixer="mamba", attn_positions=(2,), remat="none",
            sub_quadratic=True) if arch == "hybrid_nomoe"
            else cfgs.get_smoke(arch))
        params = to_device(smoke_params(cfg, dtype), DEVICE)
        toks = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab, (2, 12)).astype(np.int32)).to(DEVICE)
        full, _ = TT.forward(cfg, params, toks)
        _, cache = TT.prefill(cfg, params, toks[:, :11], max_len=16)
        step, _ = TT.decode_step(cfg, params, cache, toks[:, 11:12])
        err = (step - full[:, -1]).abs().float().cpu()
        bound = 0.15 + 0.08 * full[:, -1].abs().float().cpu()
        check(bool((err <= bound).all()), f"{arch}: decode agrees with "
                                          "forward (rtol 0.08, atol 0.15)")
        consistency[arch] = {"dtype": dtype, "max_abs": float(err.max())}

    # the smoke engine on both devices, the same params and requests
    cfg = cfgs.get_smoke(FULL_ARCH)
    params = smoke_params(cfg, "bfloat16")
    engines = {}
    for dev in ("cpu", DEVICE):
        eng = launch_serve.make_engine(
            cfg, EngineConfig(batch_slots=4, max_len=64), device=dev,
            params=to_device(params, dev))
        reqs = launch_serve.make_requests(cfg.vocab, 8, 12, 8, seed=SEED)
        seconds = launch_serve.serve(eng, reqs)
        check(all(r.done for r in reqs) and eng.pages.n_live == 0 and
              int(eng.sessions.n) == 0 and eng.watchdog.violations == 0,
              f"smoke engine on {dev}: every request done, nothing left")
        engines[dev] = (eng, reqs, seconds)
    (ceng, creqs, _), (geng, greqs, gsec) = engines["cpu"], engines[DEVICE]
    check(ceng.steps == geng.steps and ceng.log.replay_key() ==
          geng.log.replay_key(), "smoke engine: steps and events equal")
    flips = []
    for c, g in zip(creqs, greqs):
        prompt = torch.from_numpy(np.asarray(c.prompt, np.int32))
        flip = compare_greedy(
            g.out, c.out, lambda i, c=c, p=prompt: forced_logits(
                cfg, params, p, c.out[:i], 64), FLIP_TOL,
            f"smoke engine rid {c.rid}")
        if flip is not None:
            flips.append({"rid": c.rid, "prompt": c.prompt.tolist(), **flip})
    report = {"phase": "model_smoke_check", "archs": archs,
              "dispatch": dispatch, "decode_vs_forward": consistency,
              "engine": {"requests": len(creqs), "steps": geng.steps,
                         "card_seconds": gsec,
                         "tokens": sum(len(r.out) for r in greqs),
                         "near_tie_flips": flips},
              "seconds": time.perf_counter() - t_phase}
    emit(report)
    return report


def forced_logits(cfg, params, prompt: torch.Tensor, prefix, max_len: int
                  ) -> torch.Tensor:
    """The logits after prefill of ``prompt`` and decodes of ``prefix``."""
    lg, cache = TT.prefill(cfg, params, prompt[None], max_len)
    for t in prefix:
        lg, cache = TT.decode_step(cfg, params, cache, torch.tensor(
            [[int(t)]], dtype=torch.int32, device=prompt.device))
    return lg[0]


def replay_batch(cfg, params, prompts, n: int, max_len: int) -> list:
    """Greedy decode of ``prompts`` as one batch, each prefilled alone and
    written into its slot of the batch cache (every leaf whose axis 1 is
    the batch): ``n`` tokens a prompt."""
    B = len(prompts)
    cache = TT.init_cache(cfg, params, B, max_len, device=prompts[0].device)
    first = []
    for slot, p in enumerate(prompts):
        lg, c1 = TT.prefill(cfg, params, p[None], max_len)
        first.append(int(torch.argmax(lg[0])))
        for dst_c, src_c in zip(cache["blocks"], c1["blocks"]):
            for key, dst in dst_c.items():
                if dst.dim() >= 2 and dst.shape[1] == B:
                    dst[:, slot] = src_c[key][:, 0]
        cache["pos"][slot] = c1["pos"][0]
    out = [[t] for t in first]
    for _ in range(n - 1):
        nxt = torch.tensor([[o[-1]] for o in out], dtype=torch.int32,
                           device=prompts[0].device)
        lg, cache = TT.decode_step(cfg, params, cache, nxt)
        for o, t in zip(out, torch.argmax(lg, -1).tolist()):
            o.append(int(t))
    return out


def first_difference(got, want, want_logits) -> dict:
    """Where two greedy runs first differ, and ``want``'s top-two logit
    gap there."""
    diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    out = {"equal_tokens": diff[0] if diff else len(got),
           "of": len(got)}
    if diff:
        lg = want_logits[diff[0]].float().cpu()
        top = torch.sort(lg, descending=True, stable=True).indices[:2]
        out.update(got=int(got[diff[0]]), want=int(want[diff[0]]),
                   got_is_second=int(top[1]) == got[diff[0]],
                   top_two_gap=float(lg[top[0]] - lg[top[1]]),
                   max_abs_logit=float(lg.abs().max()))
    return out


def layers_of(cfg, params, depth: int) -> tuple:
    """The config and params of the first ``depth`` layers (reps of the
    stack) of a model: views, nothing copied."""
    reps = depth // cfg.pattern_len
    cut = dataclasses.replace(cfg, n_layers=depth)
    blocks = [{k: (v[:reps] if isinstance(v, torch.Tensor) else
                   {kk: vv[:reps] for kk, vv in v.items()})
               for k, v in b.items()} for b in params["blocks"]]
    return cut, {**params, "blocks": blocks}


AGREE_DEPTHS = (1, 2, 4, 8, 32)
AGREE_CHECK_DEPTH = 1        # llama3_8b at depth 2 read 4.7% of 5% once


def depth_agreement(cfg, params, t: torch.Tensor, max_len: int) -> dict:
    """max |decode(t[k]) - full(t[:k+1])| / max |full| at each depth of
    ``AGREE_DEPTHS`` (up to the model's), at theta 1e4 against forward and
    at ``rope_theta`` against prefill of the whole sequence."""
    k = t.shape[1] - 1
    out = {}
    for theta in dict.fromkeys((1e4, cfg.rope_theta)):
        row = {}
        for depth in (d for d in AGREE_DEPTHS if d <= cfg.n_layers):
            c, p = layers_of(dataclasses.replace(cfg, rope_theta=theta),
                             params, depth)
            _, cache = TT.prefill(c, p, t[:, :k], max_len)
            step, _ = TT.decode_step(c, p, cache, t[:, k:k + 1])
            full = (TT.forward(c, p, t)[0][:, -1] if theta == 1e4 else
                    TT.prefill(c, p, t, max_len)[0])
            row[str(depth)] = gap_frac(step, full)
            del cache
        out[f"theta_{theta:g}"] = row
    return out


def decode_bound(params, cache, cfg) -> dict:
    """Bytes a decode step must read: every weight once, and the live KV
    (each slot's ``len`` positions of K and V in every attention layer)."""
    weights = tree_bytes(params)
    kv = 0
    for (mixer, _), c in zip(cfg.pattern(), cache["blocks"]):
        if mixer == "attention":
            per_pos = c["k"].shape[-2] * c["k"].shape[-1] * \
                c["k"].element_size() * 2
            kv += int(c["len"].long().sum()) * per_pos
    return {"weight_bytes": weights, "live_kv_bytes": kv,
            "bound_ms": (weights + kv) / HBM_BYTES_PER_S * 1e3}


def serve_full_width() -> dict:
    """llama3_8b's full CONFIG served through ``launch.serve``'s path;
    then granite_moe_1b and rwkv6_3b at full width."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = cfgs.get_config(FULL_ARCH)
    t0 = time.perf_counter()
    params = TT.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = launch_serve.make_engine(cfg, EngineConfig(**FULL_ENGINE),
                                   device=DEVICE, params=params)
    reqs = launch_serve.make_requests(cfg.vocab, FULL_REQUESTS, FULL_PROMPT,
                                      FULL_MAX_NEW, seed=SEED)
    serve_s = launch_serve.serve(eng, reqs)
    n_tokens = sum(len(r.out) for r in reqs)
    check(all(r.done and len(r.out) == FULL_MAX_NEW for r in reqs),
          "full width: every request finished with its tokens")
    check(eng.watchdog.violations == 0 and eng.watchdog.checks >= eng.steps,
          "full width: the watchdog green on every step")
    check(eng.pages.n_live == 0 and int(eng.sessions.n) == 0,
          "full width: no page and no session left")

    # the first wave (requests 1-8, admitted together into slots 0-7)
    # replayed by hand: each prompt prefilled alone and written into its
    # slot of an 8-slot cache, then greedy decode of the whole batch.  The
    # same products at the same shapes: the tokens must be equal.
    slots = FULL_ENGINE["batch_slots"]
    prompts = [torch.from_numpy(np.asarray(r.prompt, np.int32)).to(DEVICE)
               for r in reqs[:slots]]
    replay = replay_batch(cfg, params, prompts, FULL_MAX_NEW,
                          FULL_ENGINE["max_len"])
    for r, toks in zip(reqs[:slots], replay):
        check(r.out == toks, f"full width rid {r.rid}: the engine's tokens "
                             "equal the batch replayed by hand")
    # request 1 alone (batch 1): other product shapes, other roundings,
    # which 32 random-init layers amplify (see below); reported
    manual, manual_logits = greedy_logits(cfg, params, prompts[0],
                                          FULL_MAX_NEW,
                                          FULL_ENGINE["max_len"])
    batch1 = first_difference(reqs[0].out, manual, manual_logits)
    del manual_logits

    # prefill of t[:k] then a decode of t[k] against forward(t[:k+1]) at
    # the first D layers of the same params.  Random-init layers amplify a
    # last-bit difference several times over each (fp32 too), so the check
    # is at D = AGREE_CHECK_DEPTH and the gap is reported at every depth;
    # forward runs rotary at the default theta (the reference's quirk), so
    # that check runs at theta 1e4, and at rope_theta 5e5 prefill(t[:k+1])
    # stands in for it
    t = prompts[0][None]
    agree = depth_agreement(cfg, params, t, FULL_ENGINE["max_len"])
    check(all(row[str(AGREE_CHECK_DEPTH)] <= MODEL_TOL["bfloat16"]
              for row in agree.values()),
          "full width: decode agrees with the full sequence")

    # times: prefill of 256 tokens; a decode step at 8 live slots
    prefill_ms = time_ms(lambda: TT.prefill(cfg, params, t,
                                            FULL_ENGINE["max_len"]),
                         MODEL_REPS)
    batch = torch.tensor([[r.out[-1]] for r in reqs[-FULL_ENGINE[
        "batch_slots"]:]], dtype=torch.int32, device=DEVICE)
    decode_ms = time_ms(lambda: TT.decode_step(cfg, params, eng.cache,
                                               batch), MODEL_REPS)
    bound = decode_bound(params, eng.cache, cfg)
    # where a step's time goes: the device kernels of one call of each
    profile = {
        "decode": device_breakdown(lambda: TT.decode_step(
            cfg, params, eng.cache, batch), top=8),
        "prefill": device_breakdown(lambda: TT.prefill(
            cfg, params, t, FULL_ENGINE["max_len"]), top=8)}
    report = {
        "phase": "serve_full_width", "arch": FULL_ARCH,
        "config": dataclasses.asdict(cfg),
        "params": sum(p.numel() for p in TT.leaves(params)),
        "param_bytes": tree_bytes(params), "init_s": init_s,
        "engine": FULL_ENGINE, "requests": FULL_REQUESTS,
        "prompt_tokens": FULL_PROMPT, "max_new": FULL_MAX_NEW,
        "engine_steps": eng.steps, "watchdog_checks": eng.watchdog.checks,
        "serve_s": serve_s, "generated_tokens": n_tokens,
        "tokens_per_s": n_tokens / serve_s,
        "prefill_ms": prefill_ms, "decode_step_ms": decode_ms,
        "decode_tokens_per_s": FULL_ENGINE["batch_slots"] / decode_ms * 1e3,
        **bound, "decode_bound_share": bound["bound_ms"] / decode_ms,
        "profile": profile,
        "decode_device_busy_share": profile["decode"]["device_ms"]
        / decode_ms,
        "replay_equal_rids": [r.rid for r in reqs[:slots]],
        "rid1_vs_batch1": batch1,
        "decode_vs_full_sequence_gap_by_depth": agree,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del eng, params
    torch.cuda.empty_cache()

    for arch in FULL_OTHERS:
        report[arch] = full_width_other(arch)
    report["seconds"] = time.perf_counter() - t_phase
    emit(report)
    return report


def full_width_other(arch: str) -> dict:
    """One 256-token prefill and 16 decode steps at the full CONFIG:
    finite logits; MoE conservation (granite), decode against forward
    (rwkv6)."""
    t_arch = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = cfgs.get_config(arch)
    params = TT.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        SEED))
    rng = np.random.default_rng(SEED + 7)
    t = torch.from_numpy(rng.integers(0, cfg.vocab, (1, FULL_PROMPT)).astype(
        np.int32)).to(DEVICE)
    max_len = FULL_PROMPT + FULL_OTHER_DECODES
    lg, cache = TT.prefill(cfg, params, t, max_len)
    finite = bool(torch.isfinite(lg).all())
    for _ in range(FULL_OTHER_DECODES):
        lg, cache = TT.decode_step(cfg, params, cache,
                                   torch.argmax(lg, -1)[:, None].to(
                                       torch.int32))
        finite &= bool(torch.isfinite(lg).all())
    check(finite, f"{arch} full width: finite logits")
    out = {"params": sum(p.numel() for p in TT.leaves(params)),
           "prefill_ms": time_ms(lambda: TT.prefill(cfg, params, t, max_len),
                                 2),
           "decode_step_ms": time_ms(lambda: TT.decode_step(
               cfg, params, cache, t[:, :1]), 3)}
    if cfg.moe_experts:
        # layer 0's router on the normed embeddings of the prompt
        blk = params["blocks"][0]
        h = TL.rms_norm(TL.embed_fwd(params["embed"], t), blk["ln2"][0])
        h, router = h.reshape(FULL_PROMPT, -1), blk["ffn"]["router"][0]
        E, K = cfg.moe_experts, cfg.moe_top_k
        C = TMOE.capacity(FULL_PROMPT, K, E, cfg.capacity_factor)
        _, info, _ = TMOE._dispatch_group(h, router, K, C, E)
        out["conservation"] = check_conservation(info, FULL_PROMPT, K, C, E,
                                                 f"{arch} layer 0")
        out["dispatch_card_vs_cpu"] = dispatch_on_both(
            h.float(), router, K, C, f"{arch} layer 0")
    else:
        agree = depth_agreement(cfg, params, t, max_len)["theta_10000"]
        out["decode_vs_forward_gap_by_depth"] = agree
        check(agree[str(AGREE_CHECK_DEPTH)] <= MODEL_TOL["bfloat16"],
              f"{arch} full width: decode agrees with forward")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["seconds"] = time.perf_counter() - t_arch
    del params, cache
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The training path: gradients, AdamW, checkpoints, the step factory,
# launch.train
# ---------------------------------------------------------------------------

# The smoke check: each smoke config's loss and gradients on the card (at
# remat "dots": the selective checkpoint around the autograd product)
# against the CPU's (remat "none"), params drawn on the CPU; fractions of
# each leaf's max abs.  fp32: FP32_TOL, or 3x the CPU's own response to a
# one-ulp nudge of half of every leaf where that is larger (as in
# tests/test_torch_models.py: whisper_tiny's fp32 gradients move by 4e-3
# of max abs under such a nudge; the card's gap 3.1e-3, the other nine
# archs' at most 1.4e-4).  bf16: the card's products round the cotangent
# to bf16 (layers._F32Product), the CPU's run on fp32 copies; measured
# 0.012-0.025 over the ten archs (H100 80GB HBM3, 700 W), bound 0.05; the
# MoE archs 0.1: their combine adds into bf16 through index_add_, whose
# order changes from run to run on the card (granite_moe_1b read 0.020,
# 0.022 and 0.038 in three runs).
TRAIN_B, TRAIN_S = 2, 16
TRAIN_TOL = {"float32": 1e-3, "bfloat16": 0.05}
TRAIN_MOE_BF16_TOL = 0.1
OWN_FACTOR = 3
# launch.train at smoke size: the uninterrupted run against one with an
# injected failure (tests/test_system.py's driver case)
TRAIN_DRIVER_ARGS = ["--smoke", "--steps", "25", "--global-batch", "4",
                     "--seq-len", "32", "--ckpt-every", "10",
                     "--log-every", "10"]
TRAIN_FAIL_AT = 15
# The full-width training cell: llama3_8b's CONFIG widths (d_model 4096,
# GQA 32/8, d_ff 14336, vocab 128256, rope theta 5e5, remat "dots") at 8
# of its 32 layers: the 32-layer train state (7.50e9 params x 12 B: bf16
# params and grads, fp32 mu and nu) is 90 GB, past the card's 80 GB; at 8
# layers it is 2.27e9 params, 27.2 GB.  Global batch 8 x 1024 tokens from
# a DataPipeline over a use_kernel store (K1 and its grouping pass).
FULL_TRAIN_DEPTH = 8
FULL_TRAIN_BATCH, FULL_TRAIN_SEQ, FULL_TRAIN_SAMPLES = 8, 1024, 4096
FULL_TRAIN_STEPS, FULL_TRAIN_REPEAT = 6, 8
FULL_TRAIN_LR, FULL_TRAIN_WARMUP = 3e-4, 2
# Set from a run on an H100 80GB HBM3 at 700 W: the repeated batch's loss
# fell by 4.35 (11.715 -> 7.365); block 0's bf16 gradients sat within
# 0.0128 of fp32 (fraction of max abs), the first 2 layers' with the head
# 0.0126.
FULL_TRAIN_DROP = 1.0          # the last loss below the first by this
FULL_BLOCK_TOL = 0.05          # bf16 gradients against fp32 recomputed
FULL_HEAD_SEQ = 256            # tokens of the 2-layer gradient check
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 peak (700 W)


def nudged(params, seed: int):
    """``params`` with half the elements of every leaf one step up (their
    bit pattern plus one)."""
    gen = torch.Generator().manual_seed(seed)
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}

    def nudge(t):
        half = torch.rand(t.shape, generator=gen) < 0.5
        return torch.where(half, (t.view(ints[t.dtype]) + 1).view(t.dtype), t)
    return adamw.tree_map(nudge, params)


def smoke_loss_grads(cfg, params, toks, extra) -> tuple:
    """``loss_fn``'s value and gradient leaves, labels the tokens shifted."""
    loss, _, grads = STEP.loss_and_grads(cfg, params, {
        "tokens": toks, "labels": torch.roll(toks, -1, 1), "extra": extra})
    return loss, TT.leaves(grads)


def leaf_gaps(got, want) -> list:
    """max |got - want| / max |want| a leaf, on the CPU in fp32."""
    out = []
    for g, w in zip(got, want):
        g, w = g.detach().float().cpu(), w.detach().float().cpu()
        check(g.shape == w.shape and bool(torch.isfinite(g).all()),
              "finite gradients of the expected shape")
        out.append(float((g - w).abs().max()) / max(float(w.abs().max()),
                                                    1e-30))
    return out


@contextlib.contextmanager
def deterministic():
    """torch.use_deterministic_algorithms(True) inside the block: the
    embedding gather's backward and index_add_ accumulate without
    atomics' order; an op with no deterministic CUDA version raises."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def train_driver(extra_args) -> tuple:
    """``launch.train.run`` on the card: (history, its stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hist = launch_train.run(launch_train.parse_args(
            TRAIN_DRIVER_ARGS + ["--device", DEVICE] + extra_args))
    return hist, out.getvalue()


def train_smoke_check() -> dict:
    """The ten smoke configs' gradients card against CPU; launch.train
    with an injected failure, replayed bit for bit; a checkpoint round
    trip on the card."""
    t_phase = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is off for fp32 products")
    archs, failed = {}, []
    for arch in cfgs.ARCH_IDS:
        cfg = cfgs.get_smoke(arch)
        row = {}
        for dtype in ("float32", "bfloat16"):
            params = smoke_params(cfg, dtype)
            gen = torch.Generator().manual_seed(SEED)
            toks = torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_S),
                                 generator=gen, dtype=torch.int32)
            extra = None
            if cfg.family in ("vlm", "audio"):
                extra = torch.randn((TRAIN_B, cfg.n_extra_embeds,
                                     cfg.d_model), generator=gen).to(
                                         getattr(torch, dtype))
            cpu_cfg = dataclasses.replace(cfg, remat="none")
            closs, cgrads = smoke_loss_grads(cpu_cfg, params, toks, extra)
            own = max(leaf_gaps(smoke_loss_grads(
                cpu_cfg, nudged(params, SEED + 7), toks, extra)[1], cgrads))
            gloss, ggrads = smoke_loss_grads(
                dataclasses.replace(cfg, remat="dots"),
                to_device(params, DEVICE), toks.to(DEVICE),
                to_device(extra, DEVICE))
            gaps = leaf_gaps(ggrads, cgrads)
            loss_gap = abs(float(gloss) - float(closs)) / abs(float(closs))
            tol = TRAIN_TOL[dtype]
            if dtype == "float32":
                tol = max(tol, OWN_FACTOR * own)
            elif cfg.moe_experts:
                tol = TRAIN_MOE_BF16_TOL
            keys = [k for k, _ in flat_items(params)]
            row[dtype] = {"max_gap": max(gaps), "loss_gap": loss_gap,
                          "cpu_own_response": own, "tol": tol,
                          "worst_leaf": keys[int(np.argmax(gaps))]}
            if max(gaps + [loss_gap]) > tol:
                failed.append(f"{arch} {dtype}: card gradients within "
                              f"{tol:.3e} of the CPU ({max(gaps):.3e})")
        archs[arch] = row

    # launch.train: the uninterrupted run, and one with a failure injected
    # at step 15 and restored from step 10's checkpoint; deterministic
    with tempfile.TemporaryDirectory() as d, deterministic():
        t0 = time.perf_counter()
        plain, _ = train_driver(["--ckpt-dir", os.path.join(d, "a")])
        hist, text = train_driver(["--ckpt-dir", os.path.join(d, "b"),
                                   "--fail-at", str(TRAIN_FAIL_AT)])
        driver_s = time.perf_counter() - t0
        check("injected failure" in text and "done: 25 steps" in text,
              "launch.train survives the injected failure and finishes")
        check([s for s, _ in hist] == list(range(TRAIN_FAIL_AT + 1)) +
              list(range(10, 25)), "launch.train replays steps 10-24")
        plain = dict(plain)
        check(all(loss == plain[s] for s, loss in hist),
              "launch.train: the replay's losses equal the uninterrupted "
              "run's, bit for bit")
        # a checkpoint round trip of a train state on the card
        cfg = cfgs.get_smoke("llama3_8b")
        opt_cfg = adamw.config_for(cfg.name)
        params = TT.init_params(cfg, torch.Generator(device=DEVICE)
                                .manual_seed(SEED))
        fn, _, (p_abs, o_abs) = STEP.make_train_step(
            cfg, policy_for(cfg.name), make_host_mesh(DEVICE), 2, opt_cfg)
        toks = torch.randint(0, cfg.vocab, (2, 17), device=DEVICE,
                             dtype=torch.int32)
        params, opt, _ = fn(params, adamw.init(opt_cfg, params),
                            {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
        state = {"params": params, "opt": opt}
        mgr = CheckpointManager(os.path.join(d, "c"))
        mgr.save(1, state)
        back = mgr.restore(1, {"params": p_abs, "opt": o_abs}, device=DEVICE)
        want, got = train_state_to_numpy(state), train_state_to_numpy(back)
        on_card = [t.device.type == torch.device(DEVICE).type
                   for t in adamw.tree_leaves([back["params"],
                                               list(back["opt"])])]
        check(want.keys() == got.keys() and all(
            np.array_equal(want[k], got[k]) and want[k].dtype == got[k].dtype
            for k in want) and all(on_card),
            "checkpoint round trip on the card, bit for bit")
    report = {"phase": "train_smoke_check", "archs": archs,
              "failed": failed,
              "driver": {"steps_run": len(hist), "replayed": len(hist) - 25,
                         "final_loss": hist[-1][1], "seconds": driver_s},
              "checkpoint_leaves": len(want),
              "seconds": time.perf_counter() - t_phase}
    emit(report)
    check(not failed, "; ".join(failed))
    return report


def train_step_flops(cfg, B: int, S: int) -> dict:
    """Operations of one train step from the shapes: the weight GEMMs
    forward and backward (x3), attention's two products over the causal
    S(S+1)/2 positions forward, recomputed under remat "dots" and backward
    (x4), and the tied head (x3).  The port computes every chunk pair of
    the S x S square; its masked half is reported apart, as waste."""
    T, d, hd = B * S, cfg.d_model, cfg.head_dim
    H, Hkv, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    layer = 2 * T * d * (2 * H * hd + 2 * Hkv * hd) + 2 * T * d * f * 3
    head = 2 * T * d * cfg.vocab
    gemm = (3 * layer) * cfg.n_layers + 3 * head
    attn_all = 4 * 2 * 2 * B * H * (S * (S + 1) // 2) * hd * cfg.n_layers
    square = 4 * 2 * 2 * B * H * S * S * hd * cfg.n_layers
    return {"gemm_flops": gemm, "attention_fp32_flops": attn_all,
            "attention_masked_fp32_flops": square - attn_all,
            "flops": gemm + attn_all,
            "bound_ms": (gemm / BF16_FLOPS_PER_S
                         + attn_all / SCALAR_OPS_PER_S) * 1e3}


def kernel_classes(prof) -> dict:
    """Device ms of a profiled window by kind of kernel."""
    from torch.autograd import DeviceType
    out = {"gemm": 0.0, "elementwise": 0.0, "copy": 0.0, "reduce": 0.0,
           "other": 0.0}
    n = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.device_time_total <= 0:
            continue
        k, ms = e.key.lower(), e.device_time_total / 1e3
        n += e.count
        if any(w in k for w in ("gemm", "nvjet", "xmma", "cutlass",
                                "cublas", "sm90_")):
            out["gemm"] += ms
        elif any(w in k for w in ("memcpy", "memset", "copy")):
            out["copy"] += ms
        elif "elementwise" in k:
            out["elementwise"] += ms
        elif "reduce" in k:
            out["reduce"] += ms
        else:
            out["other"] += ms
    out["device_ms"] = sum(out.values())
    out["launches"] = n
    return out


def block_grad_gap(cfg, params, toks) -> dict:
    """Block 0's gradients through the bf16 product (``_F32Product``, the
    cotangent rounded to bf16) against an fp32 recomputation on fp32
    copies of the same params and input (TF32 off): the gap a leaf."""
    S = toks.shape[1]
    blk = [TT._at(b, 0) for b in params["blocks"]]
    x16 = TL.embed_fwd(params["embed"], toks).detach()
    pos = torch.arange(S, device=toks.device)[None]
    r = torch.randn(x16.shape, generator=torch.Generator(
        device=DEVICE).manual_seed(SEED + 11), device=DEVICE)
    grads = {}
    for name, conv in (("bf16", lambda t: t), ("fp32", lambda t: t.float())):
        leaves = [conv(t).detach().requires_grad_(True)
                  for t in TT.leaves(blk)]
        it = iter(leaves)
        tree = adamw.tree_map(lambda _: next(it), blk)
        x = conv(x16).requires_grad_(True)
        y, _ = TT._block_body(cfg, cfg.pattern(), (x, torch.zeros(
            (), device=DEVICE)), tree, pos)
        grads[name] = torch.autograd.grad((y.float() * r).sum(),
                                          leaves + [x])
    gaps = leaf_gaps(grads["bf16"], grads["fp32"])
    keys = [k for k, _ in flat_items(blk)] + ["x"]
    return {"tokens": int(toks.numel()), "max_gap": max(gaps),
            "gaps": dict(zip(keys, gaps))}


def model_grad_gap(cfg, params, toks) -> dict:
    """The first 2 layers' loss and gradients, with the tied head, through
    the card's bf16 products (remat "dots") against fp32 copies of the same
    params (remat "none"): the gap a leaf."""
    c2, p2 = layers_of(cfg, params, 2)
    l16, g16 = smoke_loss_grads(c2, p2, toks, None)
    p32 = adamw.tree_map(lambda t: t.float(), p2)
    l32, g32 = smoke_loss_grads(dataclasses.replace(c2, remat="none"), p32,
                                toks, None)
    gaps = leaf_gaps(g16, g32)
    keys = [k for k, _ in flat_items(p2)]
    del p32, g32, g16
    return {"tokens": int(toks.numel()), "loss_bf16": float(l16),
            "loss_fp32": float(l32), "max_gap": max(gaps),
            "gaps": dict(zip(keys, gaps))}


def contraction_fan_in(cfg, params) -> dict:
    """Rescale the attention weights, in place, from the reference's
    random init (``ParamBuilder`` takes ``fan_in = shape[-2]``: heads for
    ``wq`` / ``wk`` / ``wv`` [d, H, hd], head_dim for ``wo`` [H, hd, d])
    to the fan-in of their contraction (d_model; H * hd).  At llama3_8b's
    width the reference's rule gives q and k entries of std 11 and 23 and
    attention scores of std ~255: a saturated softmax, whose gradients
    the bf16 and fp32 products disagree on entirely.  Returns the
    factors."""
    d, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    factors = {"wq": (H / d) ** 0.5, "wk": (Hkv / d) ** 0.5,
               "wv": (Hkv / d) ** 0.5, "wo": H ** -0.5}
    for (mixer, _), blk in zip(cfg.pattern(), params["blocks"]):
        if mixer == "attention":
            for k, f in factors.items():
                blk["mixer"][k].mul_(f)
    return factors


def train_full_width() -> dict:
    """llama3_8b's width at 8 layers trained through make_train_step on
    the pipeline's batches, then on one repeated batch."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(cfgs.get_config(FULL_ARCH),
                              n_layers=FULL_TRAIN_DEPTH)
    check(cfg.remat == "dots", "llama3_8b trains at remat 'dots'")
    B, S = FULL_TRAIN_BATCH, FULL_TRAIN_SEQ
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    t0 = time.perf_counter()
    params = TT.init_params(cfg, gen)
    rows = torch.randint(0, cfg.vocab, (FULL_TRAIN_SAMPLES, S + 1),
                         generator=gen, device=DEVICE, dtype=torch.int32)
    store = IndexedSampleStore(StoreConfig(
        n_samples=FULL_TRAIN_SAMPLES, seq_len=S, vocab=cfg.vocab,
        use_kernel=True), rows=rows, device=DEVICE)
    pipe = DataPipeline(store, PipelineConfig(global_batch=B))
    opt_cfg = adamw.config_for(FULL_ARCH, total_steps=1000)
    fn, _, _ = STEP.make_train_step(cfg, policy_for(FULL_ARCH),
                                    make_host_mesh(DEVICE), B, opt_cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in TT.leaves(params))
    rescale = contraction_fan_in(cfg, params)
    opt = adamw.init(opt_cfg, params)

    # the main path: six steps on the pipeline's batches
    reset_launches()
    steps = []
    for step in range(FULL_TRAIN_STEPS):
        batch = pipe.get_batch(step)
        check(bool(batch["found"].all()), "full-width batch: every key found")
        t0 = time.perf_counter()
        params, opt, m = fn(params, opt, {"tokens": batch["tokens"],
                                          "labels": batch["labels"]})
        torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "lr": float(m["lr"])})
    launches = read_launches()
    check(all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"])
              for s in steps), "full width: every loss and grad_norm finite")
    path = launches_on(launches, ("foresight_traverse", "group_by_key"))
    for name, n in path.items():
        check(n > 0, f"{name} launched on the full-width training path")
    step_ms = statistics.median(s["ms"] for s in steps[1:])
    flops = train_step_flops(cfg, B, S)

    # where a step's time goes: one more pipeline step under the profiler
    from torch.profiler import ProfilerActivity, profile
    batch = pipe.get_batch(FULL_TRAIN_STEPS)
    batch = {"tokens": batch["tokens"], "labels": batch["labels"]}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, m = fn(params, opt, batch)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    profile_row = kernel_classes(prof)
    profile_row["profiled_step_wall_ms"] = prof_ms
    profile_row["busy_share"] = profile_row["device_ms"] / step_ms
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # the gradients at full width, through the card's bf16 products,
    # against fp32 recomputations: block 0 alone, and the first 2 layers
    # with the head
    del m
    failed = []
    block = block_grad_gap(cfg, params, batch["tokens"][:1])
    if block["max_gap"] > FULL_BLOCK_TOL:
        failed.append(f"block 0's bf16 gradients within {FULL_BLOCK_TOL} of "
                      f"fp32 ({block['max_gap']:.3e})")
    head = model_grad_gap(cfg, params, batch["tokens"][:1, :FULL_HEAD_SEQ])
    if head["max_gap"] > FULL_BLOCK_TOL:
        failed.append(f"2 layers' bf16 gradients within {FULL_BLOCK_TOL} of "
                      f"fp32 ({head['max_gap']:.3e})")

    # eight steps on one batch, a fresh AdamW state at lr 3e-4 after 2
    # warmup steps: the loss must fall
    del opt
    torch.cuda.empty_cache()
    rep_cfg = dataclasses.replace(opt_cfg, lr_peak=FULL_TRAIN_LR,
                                  warmup_steps=FULL_TRAIN_WARMUP)
    fn_rep, _, _ = STEP.make_train_step(cfg, policy_for(FULL_ARCH),
                                        make_host_mesh(DEVICE), B, rep_cfg)
    opt = adamw.init(rep_cfg, params)
    repeat, repeat_norms = [], []
    for _ in range(FULL_TRAIN_REPEAT):
        params, opt, m = fn_rep(params, opt, batch)
        repeat.append(float(m["loss"]))
        repeat_norms.append(float(m["grad_norm"]))
    if not (np.isfinite(repeat).all() and
            repeat[-1] <= repeat[0] - FULL_TRAIN_DROP):
        failed.append(f"the repeated batch's loss falls by {FULL_TRAIN_DROP} "
                      f"({repeat[0]:.4f} -> {repeat[-1]:.4f})")
    del opt, m
    torch.cuda.empty_cache()
    report = {
        "phase": "train_full_width", "arch": FULL_ARCH,
        "config": dataclasses.asdict(cfg), "depth_cut": f"{FULL_TRAIN_DEPTH}"
        " of 32 layers", "params": n_params, "init_s": init_s,
        "attention_rescaled_by": rescale,
        "global_batch": B, "seq_len": S, "steps": steps,
        "step_ms": step_ms, "tokens_per_s": B * S / step_ms * 1e3,
        **flops, "flops_share_of_bf16_peak":
            flops["flops"] / (step_ms * 1e-3) / BF16_FLOPS_PER_S,
        "bound_share": flops["bound_ms"] / step_ms,
        "profile": profile_row, "peak_gib": peak_gib,
        "repeated_batch_losses": repeat,
        "repeated_batch_grad_norms": repeat_norms,
        "repeated_batch_drop": repeat[0] - repeat[-1],
        "block0_bf16_vs_fp32": block, "two_layers_bf16_vs_fp32": head,
        "failed": failed,
        "launches": path, "seconds": time.perf_counter() - t_phase}
    del params, store, rows, pipe
    torch.cuda.empty_cache()
    emit(report)
    check(not failed, "full width: " + "; ".join(failed))
    return report


MESH_TOL = 1e-3                # mesh against plain, of max abs (bf16)
MESH_PROMPT, MESH_BATCH, MESH_DECODES = 256, 2, 8
MESH_TRAIN_DEPTH, MESH_TRAIN_STEPS = 2, 3
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 4, 1024
MESH_MOE_ARCH, MESH_MOE_BATCH, MESH_MOE_SEQ = "granite_moe_1b", 2, 256
DRYRUN_CELLS = (("llama3_8b", "train_4k", False),
                ("phi35_moe_42b", "train_4k", True),
                ("jamba_15_large_398b", "decode_32k", True))
CARD_BYTES = 80e9


def plain(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value (a plain tensor passes)."""
    return t.full_tensor() if hasattr(t, "placements") else t


def timed(fn) -> tuple:
    """(fn(), its ms by the host clock around a synchronised call)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def serve_on(cfg, mesh, params, toks, fed, max_len: int) -> dict:
    """Prefill ``toks`` then decode ``fed`` through the step factories on
    ``mesh``; the logits (plain) and each call's ms."""
    B = toks.shape[0]
    pol = policy_for(cfg.name)
    pre, (p_shd, _, _), _ = STEP.make_prefill_step(cfg, pol, mesh, B,
                                                   toks.shape[1], max_len)
    dec, _, _ = STEP.make_decode_step(cfg, pol, mesh, B, max_len)
    params = place_tree(params, p_shd, mesh)
    (lg, cache), pre_ms = timed(lambda: pre(params, {"tokens": toks}))
    out = {"logits": [plain(lg)], "prefill_ms": pre_ms, "decode_ms": []}
    for t in fed:
        (lg, cache), ms = timed(lambda: dec(params, cache, {"tokens": t}))
        out["logits"].append(plain(lg))
        out["decode_ms"].append(ms)
    check(all(hasattr(v, "placements") for _, v in flat_items(cache))
          == (mesh.device_mesh is not None), "the cache placed on the mesh")
    return out


def train_on(cfg, mesh, params, batches, opt_cfg) -> dict:
    """``make_train_step`` on ``mesh`` over ``batches`` from a copy of
    ``params``: losses, grad norms and ms a step."""
    B = batches[0]["tokens"].shape[0]
    fn, (p_shd, o_shd, _), _ = STEP.make_train_step(
        cfg, policy_for(cfg.name), mesh, B, opt_cfg)
    params = place_tree(adamw.tree_map(torch.clone, params), p_shd, mesh)
    opt = place_tree(adamw.init(opt_cfg, params), o_shd, mesh)
    out = {"loss": [], "grad_norm": [], "ms": []}
    for batch in batches:
        (params, opt, m), ms = timed(lambda: fn(params, opt, batch))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["ms"].append(ms)
    check(all(hasattr(v, "placements") for _, v in flat_items(params))
          == (mesh.device_mesh is not None), "the params placed on the mesh")
    return out


def rel_gaps(got: list, want: list) -> float:
    return max(abs(g - w) / max(abs(w), 1e-12) for g, w in zip(got, want))


def mesh_model_one_card() -> dict:
    """The model plane through DTensor on the 1x1 DeviceMesh of the
    one-rank group, against the plain path."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = model_mesh((1, 1), ("data", "model"), DEVICE)
    host = make_host_mesh(DEVICE)
    check(mesh.device_mesh is not None, "a DeviceMesh on the NCCL group")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    report = {"phase": "mesh_model_one_card"}

    # llama3_8b's full CONFIG: prefill and decode
    cfg = cfgs.get_config(FULL_ARCH)
    params = TT.init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab, (MESH_BATCH, MESH_PROMPT),
                         generator=gen, device=DEVICE, dtype=torch.int32)
    fed = [torch.randint(0, cfg.vocab, (MESH_BATCH, 1), generator=gen,
                         device=DEVICE, dtype=torch.int32)
           for _ in range(MESH_DECODES)]
    max_len = MESH_PROMPT + MESH_DECODES
    with deterministic():
        runs = {name: serve_on(cfg, m, params, toks, fed, max_len)
                for name, m in (("mesh", mesh), ("plain", host))}
    gaps = [gap_frac(a, b) for a, b in zip(runs["mesh"]["logits"],
                                           runs["plain"]["logits"])]
    report["llama3_8b_serve"] = {
        "prefill_ms": {k: r["prefill_ms"] for k, r in runs.items()},
        "decode_ms": {k: statistics.median(r["decode_ms"])
                      for k, r in runs.items()},
        "max_logit_gap": max(gaps),
        "bit_equal": all(torch.equal(a, b) for a, b in zip(
            runs["mesh"]["logits"], runs["plain"]["logits"]))}
    del runs

    # its widths at 2 layers: three train steps on each path
    tcfg, tparams = layers_of(cfg, params, MESH_TRAIN_DEPTH)
    tparams = adamw.tree_map(torch.clone, tparams)
    del params
    torch.cuda.empty_cache()
    contraction_fan_in(tcfg, tparams)
    batches = []
    for _ in range(MESH_TRAIN_STEPS):
        t = torch.randint(0, cfg.vocab, (MESH_TRAIN_BATCH,
                                         MESH_TRAIN_SEQ + 1),
                          generator=gen, device=DEVICE, dtype=torch.int32)
        batches.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    opt_cfg = adamw.config_for(FULL_ARCH, total_steps=1000)
    with deterministic():
        runs = {name: train_on(tcfg, m, tparams, batches, opt_cfg)
                for name, m in (("mesh", mesh), ("plain", host))}
    report["llama3_8b_train"] = {
        "ms": {k: statistics.median(r["ms"][1:]) for k, r in runs.items()},
        "loss": runs["mesh"]["loss"], "plain_loss": runs["plain"]["loss"],
        "loss_gap": rel_gaps(runs["mesh"]["loss"], runs["plain"]["loss"]),
        "grad_norm_gap": rel_gaps(runs["mesh"]["grad_norm"],
                                  runs["plain"]["grad_norm"])}
    del tparams, runs, batches
    torch.cuda.empty_cache()

    # granite_moe_1b's full CONFIG: the grouped MoE dispatch under cs
    cfg = cfgs.get_config(MESH_MOE_ARCH)
    params = TT.init_params(cfg, gen)
    t = torch.randint(0, cfg.vocab, (MESH_MOE_BATCH, MESH_MOE_SEQ + 1),
                      generator=gen, device=DEVICE, dtype=torch.int32)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    opt_cfg = adamw.config_for(MESH_MOE_ARCH, total_steps=1000)
    with deterministic():
        runs = {name: train_on(cfg, m, params, [batch], opt_cfg)
                for name, m in (("mesh", mesh), ("plain", host))}
        srv = {name: serve_on(cfg, m, params, t[:, :16], [t[:, 16:17]], 32)
               for name, m in (("mesh", mesh), ("plain", host))}
    moe_gaps = [gap_frac(a, b) for a, b in zip(srv["mesh"]["logits"],
                                               srv["plain"]["logits"])]
    report["granite_moe_1b"] = {
        "train_ms": {k: r["ms"][0] for k, r in runs.items()},
        "decode_ms": {k: r["decode_ms"][0] for k, r in srv.items()},
        "loss": runs["mesh"]["loss"][0],
        "loss_gap": rel_gaps(runs["mesh"]["loss"], runs["plain"]["loss"]),
        "grad_norm_gap": rel_gaps(runs["mesh"]["grad_norm"],
                                  runs["plain"]["grad_norm"]),
        "max_logit_gap": max(moe_gaps)}
    del params, runs, srv
    torch.cuda.empty_cache()
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    report["seconds"] = time.perf_counter() - t_phase
    emit(report)
    serve, train, moe = (report[k] for k in (
        "llama3_8b_serve", "llama3_8b_train", "granite_moe_1b"))
    check(serve["max_logit_gap"] <= MESH_TOL, "mesh: llama3_8b logits "
          "equal the plain path's within MESH_TOL")
    check(train["loss_gap"] <= MESH_TOL
          and train["grad_norm_gap"] <= MESH_TOL,
          "mesh: the train steps' losses and grad norms equal the plain "
          "path's within MESH_TOL")
    check(moe["loss_gap"] <= MESH_TOL and moe["grad_norm_gap"] <= MESH_TOL
          and moe["max_logit_gap"] <= MESH_TOL,
          "mesh: granite_moe_1b's step and decode equal the plain path's "
          "within MESH_TOL")
    return report


def dryrun_cells() -> dict:
    """The three dry-run cells, each in a process of its own (a process
    has one default group), all started together after the timed phases,
    so that their host work overlaps none of them; each one's standard
    error goes to a file.  Their per-device memory, FLOPs and
    collectives."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"), OMP_NUM_THREADS="1")
    report = {"phase": "dryrun_cells", "cells": []}
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        try:
            for i, (arch, shape, mp) in enumerate(DRYRUN_CELLS):
                out = os.path.join(tmp, f"cell_{i}.json")
                err = open(os.path.join(tmp, f"cell_{i}.err"), "w+")
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--out", out]
                procs.append((out, err, subprocess.Popen(
                    cmd + (["--multi-pod"] if mp else []), env=env,
                    stdout=subprocess.DEVNULL, stderr=err)))
            for (out, err, proc), (arch, shape, mp) in zip(procs,
                                                           DRYRUN_CELLS):
                proc.wait()
                err.seek(0)
                check(proc.returncode == 0 and os.path.exists(out),
                      f"dry-run {arch} x {shape}: {err.read()[-2000:]}")
                with open(out) as f:
                    res = json.load(f)
                mem = res["memory_analysis"]
                report["cells"].append({
                    "arch": arch, "shape": shape,
                    "mesh": "2x16x16" if mp else "16x16",
                    "device": res["device"],
                    "argument_gib": mem["argument_size_in_bytes"] / 2**30,
                    "output_gib": mem["output_size_in_bytes"] / 2**30,
                    "peak_gib": mem["peak_size_in_bytes"] / 2**30,
                    "fits_80gb": mem["peak_size_in_bytes"] <= CARD_BYTES,
                    "flops": res["cost_analysis"]["flops"],
                    "collective_bytes": res["collectives"]["per_kind"],
                    "trace_s": res["compile_s"], "build_s": res["lower_s"]})
                check(res["ok"] and res["device"] == "cuda",
                      f"dry-run {arch} x {shape} traced on fake CUDA tensors")
        finally:
            for _, err, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
                err.close()
    report["seconds"] = time.perf_counter() - t0
    emit(report)
    return report


def zipf_queries(keys: np.ndarray, batch: int, a: float = ZIPF_A,
                 seed: int = 1) -> np.ndarray:
    """benchmarks/common.py:55-60: Zipf(a) over the key population by rank."""
    rng = np.random.default_rng(seed)
    return keys[(rng.zipf(a, batch) - 1) % len(keys)].astype(np.int32)


def k14_kernel_rows(mono: dict, validated: dict) -> list:
    """K14's kernels-line rows, traffic A: ``search_walk`` (the foresight
    ``search``; its ``launches`` K14's on every main path, each read
    around its own call: both full-size variants' ``search`` on both
    traffics, the versioned lag-0 reads and ``search_validated``), then
    the base ``search`` and the validated read, each with its own calls'
    launches.  The fat lists' rows join after their phase."""
    k14 = {fs: mono[fs]["uniform"].pop("k14") for fs in (True, False)}
    for fs in (True, False):
        mono[fs]["zipf"].pop("k14")
    val = validated["uniform"]
    subs = [{**k14[False], "name": "search_walk/search/base"}, val]
    main = {**k14[True], "name": "search_walk"}
    main["launches"] += (k14[False]["launches"] + val["launches"]
                         + val["lag0_launches"])
    return [main, *subs]


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    smi = card_identity()
    build_kernels()
    run_phases(smi, t_start)


def run_phases(smi: str, t_start: float) -> None:
    """Every phase after the build."""
    small_check()
    small_update_check()
    update_kernel_check()
    rebalance_row = rebalance_kernel_check()
    scan_kernel_check()
    search_walk_check()
    small_sharded_check()
    meshes = init_mesh_group()
    small_mesh_check(meshes)
    analysis_check(smi)
    rng = np.random.default_rng(SEED)
    keys_np = np.sort(rng.choice(FULL_SPAN, FULL_N, replace=False))
    keys_np = keys_np.astype(np.int32)
    q_np = np.random.default_rng(SEED + 1).integers(
        0, FULL_SPAN, FULL_BATCH).astype(np.int32)
    traffic = {"uniform": q_np, "zipf": zipf_queries(keys_np, FULL_BATCH)}
    mono = {foresight: full_size(keys_np, traffic, foresight)
            for foresight in (True, False)}
    # K1 over K2: both grouped, and both in batch order
    emit({"phase": "ratio",
          "foresight_over_base_ms": {
              name: {"grouped": mono[True][name]["ms"]
                     / mono[False][name]["ms"],
                     "batch_order": mono[True][name]["ungrouped_ms"]
                     / mono[False][name]["ungrouped_ms"]}
              for name in traffic}})
    versioned, versioned_groups, update_row, k14_validated = \
        versioned_full_size(keys_np, traffic)
    # The kernels line takes traffic A's rows; the pass's launches are those
    # of every path that ran it (K1's, K2's, K8's, and the fat K1's and
    # K2's below).
    key_row = mono[False]["uniform"].pop("group")
    key_row["launches"] += mono[True]["uniform"].pop("group")["launches"]
    for foresight in (True, False):
        mono[foresight]["zipf"].pop("group")
    key_row["launches"] += versioned_groups
    rows = [mono[True]["uniform"], mono[False]["uniform"],
            versioned["uniform"], key_row, update_row, rebalance_row,
            *k14_kernel_rows(mono, k14_validated)]
    ops_ = synchrobench_ops(SHARD_UPDATE_OPS, SEED + 5)
    t0 = time.perf_counter()
    stream = (ops_, *host_oracle(keys_np, *ops_[:2]))
    emit({"phase": "sharded_host_oracle", "seconds": time.perf_counter() - t0})
    answers, scalar_answers, mesh_reports, grouping = {}, {}, [], {}
    for foresight in (True, False):
        sharded_rows, answers, fp, grouping[(foresight, 1)] = \
            sharded_full_size(keys_np, traffic, stream, foresight, answers)
        scalar_answers = scalar_answers or answers
        rows += sharded_rows
        mesh_reports.append(mesh_full_size(keys_np, traffic, stream,
                                           foresight, (fp, answers),
                                           meshes[DEVICE]))
    for g in grouping.values():         # the sharded paths' batches
        update_row["launches"] += g["apply_ops_launches"]
    group_row = grouping[(True, 1)]["row"]
    group_row["launches"] += grouping[(False, 1)]["row"]["launches"]
    group_row["max_abs_err"] = max(group_row["max_abs_err"],
                                   grouping[(False, 1)]["row"]["max_abs_err"])
    rows.append(group_row)
    by_name = {r["name"]: r for r in rows}
    pending = {}                    # launches of rows not made yet (K13's)
    for r in mesh_reports:          # K10's K5/K6 launches count there too
        for name in KERNELS:
            if name in by_name:
                by_name[name]["launches"] += r["launches"][name]
            else:
                pending[name] = pending.get(name, 0) + r["launches"][name]
    rows.append(mesh_row(mesh_reports))
    check(rows[-1]["launches"] > 0, "search_kernel_mesh (K10) launched on "
                                    "the mesh path")
    emit({"phase": "sharded_ratio",
          "foresight_over_base_ms": {
              kind: by_name[f"foresight_traverse_{kind}"]["ms"]
              / by_name[f"base_traverse_{kind}"]["ms"]
              for kind in ("sharded", "clustered")},
          # K5 over K6 tile-sorted (above) and in the plan's order (before)
          "clustered_plan_order_foresight_over_base_ms":
              by_name["foresight_traverse_clustered"]["plan_order_ms"]
              / by_name["base_traverse_clustered"]["plan_order_ms"],
          "sharded_over_monolithic_ms": {
              v: by_name[f"{v}_traverse_sharded"]["ms"]
              / by_name[f"{v}_traverse"]["ms"]
              for v in ("foresight", "base")},
          "dense_foresight_over_base_ms": {
              traffic_name: {
                  "grouped": grouping[(True, 1)]["dense_ms"][traffic_name]
                  / grouping[(False, 1)]["dense_ms"][traffic_name],
                  "ungrouped":
                  grouping[(True, 1)]["ungrouped_ms"][traffic_name]
                  / grouping[(False, 1)]["ungrouped_ms"][traffic_name]}
              for traffic_name in traffic}})
    for name in KERNELS:
        if name not in PLANE_KERNELS:
            check(by_name[name]["launches"] > 0,
                  f"{name} launched on its path")

    small_fat_check()
    fat = {(w, fs): fat_full_size(keys_np, q_np, w, fs,
                                  stream if (w, fs) == (128, True) else None)
           for w, fs in ((128, True), (128, False), (8, True))}
    fat_rows = [r["row"] for r in fat.values()]
    answers = {}
    for foresight in (True, False):
        sharded_rows, answers, _, grouping[(foresight, 128)] = \
            sharded_full_size(keys_np, traffic, stream, foresight, answers,
                              width=128, scalar=scalar_answers)
        fat_rows += sharded_rows
        g = grouping[(foresight, 128)]["row"]    # the pass's fat-path runs
        group_row["launches"] += g["launches"]
        update_row["launches"] += grouping[(foresight, 128)][
            "apply_ops_launches"]
        group_row["max_abs_err"] = max(group_row["max_abs_err"],
                                       g["max_abs_err"])
    key_row["launches"] += sum(f["group_by_key_launches"]
                               for f in fat.values())
    update_row["launches"] += sum(f["apply_ops_launches"]
                                  for f in fat.values())
    fat_by_name = {r["name"]: r for r in fat_rows}
    k14_fat = [f["k14"] for f in fat.values()]
    by_name["search_walk"]["launches"] += sum(r["launches"] for r in k14_fat)
    k9 = fat[(128, True)]["k9"]
    k9["launches"] = sum(r["launches"] for r in fat_rows)
    check(k9["launches"] > 0, "fat_resolve (K9) launched on the fat paths")
    emit({"phase": "fat_ratio",
          "foresight_over_base_ms": fat[(128, True)]["ms"]
          / fat[(128, False)]["ms"],
          "fat128_over_scalar_k1_ms": fat[(128, True)]["ms"]
          / by_name["foresight_traverse"]["ms"],
          "fat8_over_scalar_k1_ms": fat[(8, True)]["ms"]
          / by_name["foresight_traverse"]["ms"],
          "k9_alone_over_k1_fat128_ms": fat[(128, True)]["k9_share_of_k1_fat"],
          "k9_alone_over_k1_fat8_ms": fat[(8, True)]["k9_share_of_k1_fat"],
          "clustered_foresight_over_base_ms": {
              key: fat_by_name["foresight_traverse_clustered/fat128"][key]
              / fat_by_name["base_traverse_clustered/fat128"][key]
              for key in ("ms", "plan_order_ms")},
          "fat_over_scalar_ms": {
              r["name"]: r["ms"] / by_name[r["name"].split("/")[0]]["ms"]
              for r in fat_rows}})
    for r in fat_rows:
        check(r["launches"] > 0, f"{r['name']} launched on its path")
    rows += fat_rows + [k9] + k14_fat

    # The data plane and the serving index plane over the same kernels:
    # their main paths' launches join the kernels' rows.
    torch.cuda.empty_cache()
    rows_t = store_rows(FULL_N)
    plane_runs = [store_full_size(keys_np, rows_t, fs) for fs in (True,
                                                                  False)]
    del rows_t
    torch.cuda.empty_cache()
    plane_runs += [page_table_full_size(fs) for fs in (True, False)]
    rows.append(SCAN_ROW.pop("row"))
    by_name = {r["name"]: r for r in rows}
    for name, n in pending.items():
        by_name[name]["launches"] += n
    for _, paths in plane_runs:
        for name, n in paths.items():
            by_name[name]["launches"] += n
    for name in PLANE_KERNELS:
        check(by_name[name]["launches"] > 0, f"{name} launched on the "
                                             "data and serving planes")
    # The model across a mesh: DTensor on the one-rank group's 1x1
    # DeviceMesh (no kernel of the table)
    torch.cuda.empty_cache()
    mesh_model_one_card()
    dist.destroy_process_group()
    # The LLM serving path: no kernel of the table runs on it (the
    # engine's page table keeps the reference's use_kernel=False)
    torch.cuda.empty_cache()
    model_smoke_check()
    serve_full_width()
    # The training path: its store (use_kernel) launches K1 and its pass
    train_smoke_check()
    for name, n in train_full_width()["launches"].items():
        by_name[name]["launches"] += n
    emit({"phase": "analysis_full_size", "card": smi, "n": FULL_N,
          "batch": FULL_BATCH, "syncs_per_call": FULL_SYNCS})
    check(len(FULL_SYNCS) == 4, "syncs counted on both variants' full-size "
                                "search_kernel and search_kernel_sharded")
    # the dry-run's fake groups, on the host alone (no kernel of the table)
    dryrun_cells()
    emit({"phase": "wall", "seconds": time.perf_counter() - t_start})
    emit({"kernels": rows})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
