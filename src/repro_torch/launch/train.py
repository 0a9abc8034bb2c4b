"""End-to-end training driver: data -> train step -> checkpoint / restart
(port of ``repro.launch.train``).

The production loop on one device: the deterministic skiplist-indexed
data pipeline, the train step (``train.step.make_train_step``), atomic
checkpoints with auto-resume, straggler monitoring, and an optional
injected failure (the integration test of the restart path).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \\
      --smoke --steps 60 --ckpt-dir "$(mktemp -d)" [--fail-at 30] \\
      [--device cpu]

Params are drawn on the device from a ``torch.Generator`` seeded with 0;
``--device`` defaults to the GPU and raises without one.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.skiplist import resolve_device
from repro_torch.data.pipeline import DataPipeline, PipelineConfig
from repro_torch.data.store import IndexedSampleStore, StoreConfig
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import policy_for
from repro_torch.runtime.ft import InjectedFailure, StepTimer, StragglerMonitor
from repro_torch.train import step as STEP


def build(arch: str, smoke: bool, global_batch: int, seq_len: int,
          production_mesh: bool, total_steps: int, device=None):
    cfg = get_smoke(arch) if smoke else get_config(arch)
    mesh = (make_production_mesh(device=device) if production_mesh
            else make_host_mesh(device))
    policy = policy_for(arch)
    opt_cfg = adamw.config_for(arch, total_steps=total_steps)
    fn, shardings, abstracts = STEP.make_train_step(
        cfg, policy, mesh, global_batch, opt_cfg)
    return cfg, mesh, policy, opt_cfg, fn, shardings, abstracts


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a failure at this step (restart test)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run "
                         "without one)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> List[tuple]:
    """The training loop; returns ``(step, loss)`` of every step run, in
    order (a step replayed after the restore appears again)."""
    dev = resolve_device(args.device)
    cfg, mesh, policy, opt_cfg, fn, shardings, (p_abs, o_abs) = build(
        args.arch, args.smoke, args.global_batch, args.seq_len, False,
        args.steps, dev)

    store = IndexedSampleStore(StoreConfig(
        n_samples=512, seq_len=args.seq_len, vocab=cfg.vocab), device=dev)
    pipe = DataPipeline(store, PipelineConfig(global_batch=args.global_batch))
    monitor = StragglerMonitor(n_hosts=1)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    state_abs = {"params": p_abs, "opt": o_abs}

    def fresh_state():
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        return {"params": params, "opt": adamw.init(opt_cfg, params)}

    start = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        state = ckpt.restore(start, state_abs, device=dev)
        print(f"resumed from checkpoint step {start}", flush=True)
    else:
        state = fresh_state()
    params, opt_state = state["params"], state["opt"]

    history = []
    failed_once = False
    step_i = start
    while step_i < args.steps:
        batch = pipe.get_batch(step_i)
        batch = {"tokens": batch["tokens"], "labels": batch["labels"]}
        with StepTimer() as st:
            params, opt_state, metrics = fn(params, opt_state, batch)
            loss = float(metrics["loss"])          # waits for the step
        history.append((step_i, loss))
        monitor.record(step_i, {0: st.t})
        if args.fail_at == step_i and not failed_once:
            failed_once = True
            print(f"!! injected failure at step {step_i}; restarting "
                  f"from latest checkpoint", flush=True)
            if ckpt is None:
                raise InjectedFailure("no checkpoint dir configured")
            rs = ckpt.latest_step() or 0
            if rs:
                st2 = ckpt.restore(rs, state_abs, device=dev)
                params, opt_state = st2["params"], st2["opt"]
            else:
                state = fresh_state()
                params, opt_state = state["params"], state["opt"]
            step_i = rs
            continue
        if step_i % args.log_every == 0:
            print(f"step {step_i:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} {st.t*1e3:.0f}ms",
                  flush=True)
        step_i += 1
        if ckpt is not None and step_i % args.ckpt_every == 0:
            ckpt.save(step_i, {"params": params, "opt": opt_state},
                      {"loss": loss})
    if ckpt is not None:
        ckpt.save(args.steps, {"params": params, "opt": opt_state})
        ckpt.wait()
    # a run resumed from a checkpoint at --steps runs no step
    last = f"final loss {history[-1][1]:.4f}" if history else "no step run"
    print(f"done: {args.steps} steps, {last}")
    return history


def main(argv: Optional[List[str]] = None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
