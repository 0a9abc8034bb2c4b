"""Serving entry point: continuous-batched generation behind the skiplist tables
(port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \
      --smoke --requests 8 --max-new 8 [--device cpu]

Params are drawn from a ``torch.Generator`` seeded with ``--seed`` on the
serving device; ``--device`` defaults to the GPU and raises without one.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core.skiplist import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving.engine import EngineConfig, Request, ServeEngine


def make_engine(cfg: T.ModelConfig, ecfg: EngineConfig, seed: int = 0,
                device=None, params=None) -> ServeEngine:
    """An engine over ``params``, or over params drawn on ``device`` from
    a generator seeded with ``seed``."""
    dev = resolve_device(device)
    if params is None:
        params = T.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed))
    return ServeEngine(cfg, params, ecfg, device=dev)


def make_requests(vocab: int, n: int, prompt_len: int, max_new: int,
                  seed: int = 0) -> List[Request]:
    """``n`` requests, rids 1..n, with seeded uniform prompts."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i + 1,
                    prompt=rng.integers(0, vocab, prompt_len,
                                        dtype=np.int32),
                    max_new=max_new)
            for i in range(n)]


def serve(eng: ServeEngine, reqs: List[Request]) -> float:
    """Submit every request and run the engine to the end; seconds taken
    (host clock, the device synchronised at the end)."""
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run(max_steps=len(reqs) * max(r.max_new for r in reqs) * 4)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    return time.perf_counter() - t0


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run "
                         "without one)")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    eng = make_engine(cfg, EngineConfig(batch_slots=args.batch_slots,
                                        max_len=args.max_len),
                      seed=args.seed, device=args.device)
    reqs = make_requests(cfg.vocab, args.requests, args.prompt_len,
                         args.max_new, args.seed)
    dt = serve(eng, reqs)
    toks = sum(len(r.out) for r in reqs if r.done)
    print(f"served {sum(r.done for r in reqs)}/{args.requests} requests, "
          f"{toks} tokens in {dt:.1f}s ({toks / max(dt, 1e-9):.1f} tok/s); "
          f"decode steps {eng.steps}; pages live {eng.pages.n_live}; "
          f"sessions {int(eng.sessions.n)}")


if __name__ == "__main__":
    main()
