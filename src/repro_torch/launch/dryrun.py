"""Multi-pod dry-run: trace every (arch x shape x mesh) cell's step on the
production mesh (port of ``repro.launch.dryrun``).

For each cell this module:
  1. opens a fake process group (``torch.distributed``'s ``"fake"``
     backend: collectives that move nothing) of 256 or 512 ranks, this
     process rank 0, and builds the production mesh on it (16x16, or
     2x16x16 with ``--multi-pod``; ``launch.mesh.make_production_mesh``);
  2. builds the step (train / prefill / decode) with its spec trees
     (``train.step``) and its inputs as fake DTensors, each rank's shard
     only, placed by those specs;
  3. runs the step under ``launch.costs.CostMode`` (fake tensors: no
     storage, no arithmetic) with the card's numerics
     (``models.layers.card_numerics``: bf16 products with fp32
     accumulation, as on the card, not the CPU's fp32 copies), proving
     that the distribution config holds together (every placement,
     redistribution and local op resolves);
  4. records one device's memory, work and collectives into a JSON blob
     with the reference's keys.

Keys.  ``memory_analysis``: ``argument_size_in_bytes`` and
``output_size_in_bytes`` are the bytes of one rank's shards of the
step's inputs and outputs (local shapes), ``alias_size_in_bytes`` those
of the outputs that are inputs updated in place (the donated train
state), ``peak_size_in_bytes`` (the port's own) the peak of the live
local storages during the step, arguments included, and
``temp_size_in_bytes`` that peak less the arguments.  ``cost_analysis``
is ``launch.costs.cost_dict``: product ``flops`` and ``bytes accessed``
of one device.  ``collectives``: result bytes by kind (all-gather,
all-reduce, reduce-scatter, all-to-all) and op counts.  There is no HLO,
so ``hlo_bytes`` and ``scan_trip_counts`` have no counterpart and are
left out (the port's loops over layers and time run in Python, each
iteration traced); ``--save-hlo`` writes the traced local ops and their
counts instead.  ``lower_s`` is the time to build the step and its
placed inputs, ``compile_s`` the time to trace the step.

The device type of the fake tensors and of the mesh is the card's
(``cuda``) unless ``--device cpu`` (the CPU tests) is given; nothing
runs on a device either way.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_8b \\
      --shape train_4k [--multi-pod] [--device cpu] [--out out.json]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import tree_flatten
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.costs import CostMode, cost_dict
from repro_torch.launch.mesh import (MULTI_POD_AXES, MULTI_POD_SHAPE,
                                     PRODUCTION_AXES, PRODUCTION_SHAPE,
                                     make_production_mesh, model_mesh)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import (Policy, _map, fitted_spec,
                                           is_dtensor, policy_for,
                                           to_placements)
from repro_torch.train import step as STEP


def input_specs(arch: str, shape_name: str) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input of this cell."""
    cfg, spec = get_config(arch), SHAPES[shape_name]
    if spec.kind == "train":
        return STEP.train_input_specs(cfg, spec.global_batch, spec.seq_len)
    if spec.kind == "prefill":
        return STEP.prefill_input_specs(cfg, spec.global_batch, spec.seq_len)
    return STEP.decode_input_specs(cfg, spec.global_batch)


def collective_bytes(trace: CostMode) -> Dict[str, Any]:
    """The reference's ``collectives`` entry: the result bytes of every
    collective the traced step issued, in total and by kind (the
    reference parses them out of its compiled HLO), their op count (and,
    the port's own, ops by kind)."""
    per_kind = {k: v["bytes"] for k, v in trace.collectives.items()}
    return {"total_bytes": sum(per_kind.values()),
            "ops": sum(v["ops"] for v in trace.collectives.values()),
            "per_kind": per_kind,
            "per_kind_ops": {k: v["ops"]
                             for k, v in trace.collectives.items()}}


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake default process group of ``world_size`` ranks (this process
    rank 0) for the duration; its collectives move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_group: a default process group is "
                           "already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def local_bytes(tree) -> int:
    """Bytes of one rank's shards of a tree's tensors."""
    out = 0
    for t in tree_flatten(tree)[0]:
        loc = t.to_local() if is_dtensor(t) else t
        out += loc.numel() * loc.element_size()
    return out


def _empty(abstract_tree, spec_tree, mesh):
    """Uninitialised DTensors shaped as ``abstract_tree``'s leaves, laid
    out by ``spec_tree`` (each rank allocates its shard only)."""
    from torch.distributed.tensor import empty as dempty
    dm = mesh.device_mesh

    def one(ab, spec):
        shape = tuple(ab.shape)
        return dempty(shape, dtype=ab.dtype, device_mesh=dm,
                      placements=to_placements(
                          fitted_spec(spec, shape, mesh), dm))
    return _map(one, abstract_tree, spec_tree)


def step_args(cfg: T.ModelConfig, policy: Policy, mesh, kind: str,
              global_batch: int, seq_len: int,
              opt_cfg: Optional[adamw.AdamWConfig] = None):
    """The step of ``kind`` (train / prefill / decode) on ``mesh`` and a
    function that makes its inputs as uninitialised DTensors placed by
    its spec trees (under a ``FakeTensorMode``, fake ones): ``(fn,
    make_args)``.  Call it outside fake mode (it builds process groups)
    and ``make_args`` inside."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    if kind == "train":
        fn, (p_shd, o_shd, b_shd), (p_abs, o_abs) = STEP.make_train_step(
            cfg, policy, mesh, global_batch, opt_cfg)
        batch_abs = STEP.train_input_specs(cfg, global_batch, seq_len)
        return fn, lambda: (_empty(p_abs, p_shd, mesh),
                            _empty(o_abs, o_shd, mesh),
                            _empty(batch_abs, b_shd, mesh))
    if kind == "prefill":
        fn, (p_shd, b_shd, _), (p_abs, _) = STEP.make_prefill_step(
            cfg, policy, mesh, global_batch, seq_len, seq_len)
        batch_abs = STEP.prefill_input_specs(cfg, global_batch, seq_len)
        return fn, lambda: (_empty(p_abs, p_shd, mesh),
                            _empty(batch_abs, b_shd, mesh))
    fn, (p_shd, c_shd, t_shd), (p_abs, c_abs) = STEP.make_decode_step(
        cfg, policy, mesh, global_batch, seq_len)
    tok_abs = STEP.decode_input_specs(cfg, global_batch)
    return fn, lambda: (_empty(p_abs, p_shd, mesh),
                        _empty(c_abs, c_shd, mesh),
                        _empty(tok_abs, t_shd, mesh))


def argument_bytes(arch: str, shape_name: str, multi_pod: bool,
                   device=None) -> int:
    """One device's bytes of the cell's step inputs under the policy's
    placement (fake tensors in a fake group; nothing is traced)."""
    cfg, spec = get_config(arch), SHAPES[shape_name]
    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    dev = "cuda" if device is None else torch.device(device).type
    with fake_group(math.prod(shape)):
        # the mesh first: a DeviceMesh cannot be built under fake tensors
        mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
        _, make_args = step_args(cfg, policy_for(arch), mesh, spec.kind,
                                 spec.global_batch, spec.seq_len,
                                 adamw.config_for(arch))
        with CostMode(allow_non_fake_inputs=True):
            return sum(local_bytes(a) for a in make_args())


def trace_step(cfg: T.ModelConfig, policy: Policy, mesh, kind: str,
               global_batch: int, seq_len: int,
               opt_cfg: Optional[adamw.AdamWConfig] = None
               ) -> Tuple[Dict[str, Any], CostMode]:
    """Trace one step of ``kind`` (train / prefill / decode) on ``mesh``
    (a ``ModelMesh`` with a ``device_mesh``) at the given batch and
    sequence; ``(record, trace)``."""
    t0 = time.time()
    fn, make_args = step_args(cfg, policy, mesh, kind, global_batch, seq_len,
                              opt_cfg)
    with CostMode(allow_non_fake_inputs=True) as trace:
        args = make_args()
        arg_bytes = sum(local_bytes(a) for a in args)
        lower_s = time.time() - t0
        trace.reset()
        t0 = time.time()
        with L.card_numerics():
            outs = fn(*args)
        trace_s = time.time() - t0
        out_bytes = sum(local_bytes(o) for o in outs)
        # the train step updates its params and moments in place
        alias = (local_bytes(outs[0]) + local_bytes(outs[1])
                 if kind == "train" else 0)
    mem = {"argument_size_in_bytes": arg_bytes,
           "output_size_in_bytes": out_bytes,
           "alias_size_in_bytes": alias,
           "temp_size_in_bytes": trace.peak_bytes - arg_bytes,
           "peak_size_in_bytes": trace.peak_bytes}
    record = {"lower_s": round(lower_s, 2), "compile_s": round(trace_s, 2),
              "memory_analysis": mem, "cost_analysis": cost_dict(trace),
              "collectives": collective_bytes(trace)}
    return record, trace


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             device=None, save_hlo: str = "") -> Dict[str, Any]:
    """Dry-run one cell in a fake group of 256 (16x16) or 512 (2x16x16)
    ranks; ``device`` is the device type of the trace (``None``: the
    card's, ``"cuda"``)."""
    cfg = get_config(arch)
    spec = SHAPES[shape_name]
    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    n_devices = math.prod(shape)
    dev = "cuda" if device is None else torch.device(device).type
    with fake_group(n_devices):
        mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
        rec, trace = trace_step(cfg, policy_for(arch), mesh, spec.kind,
                                spec.global_batch, spec.seq_len,
                                adamw.config_for(arch))
    if save_hlo:
        with open(save_hlo, "w") as f:
            for op, n in sorted(trace.ops.items()):
                f.write(f"{op} {n}\n")
    out = {"arch": arch, "shape": shape_name, "kind": spec.kind,
           "multi_pod": multi_pod, "n_devices": n_devices,
           "mesh": dict(zip(MULTI_POD_AXES if multi_pod else PRODUCTION_AXES,
                            shape)),
           "device": dev, "seq_len": spec.seq_len,
           "global_batch": spec.global_batch,
           "param_count": cfg.param_count(),
           "active_param_count": cfg.active_param_count(), **rec,
           "ok": True}
    return out


def run_smoke_cell(cfg: T.ModelConfig, kind: str, global_batch: int,
                   seq_len: int, shape=(2, 4), axes=PRODUCTION_AXES,
                   policy: Optional[Policy] = None, device="cpu"
                   ) -> Dict[str, Any]:
    """``trace_step`` of a config of one's own on a mesh of one's own in a
    fake group of its size (the tests' small cells)."""
    with fake_group(math.prod(shape)):
        mesh = model_mesh(shape, axes, device)
        rec, _ = trace_step(cfg, policy or Policy(), mesh, kind,
                            global_batch, seq_len)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device type of the trace (default: cuda)")
    ap.add_argument("--out", default="")
    ap.add_argument("--save-hlo", default="",
                    help="write the traced local ops and their counts")
    args = ap.parse_args()

    res = run_cell(args.arch, args.shape, args.multi_pod, args.device,
                   args.save_hlo)
    js = json.dumps(res, indent=2)
    print(js)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js)
    print(f"\n== {args.arch} x {args.shape} "
          f"({'multi-pod 2x16x16' if args.multi_pod else 'single-pod 16x16'}) "
          f"compiled OK in {res['compile_s']}s ==", file=sys.stderr)


if __name__ == "__main__":
    main()
