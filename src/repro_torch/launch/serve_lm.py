"""Serve a small LM with continuously-batched requests (port of the entry
point ``examples/serve_lm.py``).

The full serving plane: session table + paged-KV page table (both
Foresight-skiplist-indexed) around the prefill/decode model plane.

  PYTHONPATH=src python -m repro_torch.launch.serve_lm [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.configs import get_smoke
from repro_torch.launch.serve import make_engine, make_requests, serve
from repro_torch.serving.engine import EngineConfig


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run "
                         "without one)")
    args = ap.parse_args(argv)
    cfg = get_smoke("llama3_8b")
    eng = make_engine(cfg, EngineConfig(batch_slots=4, max_len=96),
                      seed=0, device=args.device)
    reqs = make_requests(cfg.vocab, 10, 12, 8, seed=0)
    dt = serve(eng, reqs)

    done = [r for r in reqs if r.done]
    toks = sum(len(r.out) for r in done)
    print(f"served {len(done)}/10 requests, {toks} tokens "
          f"in {dt:.1f}s ({toks / dt:.1f} tok/s on {eng.device})")
    print(f"decode steps: {eng.steps}; pages live at end: "
          f"{eng.pages.n_live}; sessions open: {int(eng.sessions.n)}")
    for r in done[:3]:
        print(f"  req {r.rid}: prompt[:4]={r.prompt[:4].tolist()} "
              f"-> out={r.out}")


if __name__ == "__main__":
    main()
