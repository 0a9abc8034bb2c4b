"""End-to-end training example: a smoke-scale model, a few hundred steps
(port of the entry point ``examples/train_lm.py``).

A thin wrapper over the training driver (``launch.train``) with settings
that train a visible loss curve, checkpointing into a temporary
directory.

  PYTHONPATH=src python -m repro_torch.launch.train_lm [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile
from typing import List, Optional

from repro_torch.launch import train


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run "
                         "without one)")
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as ckpt:
        train.main(["--arch", "llama3_8b", "--smoke",
                    "--steps", str(args.steps), "--global-batch", "8",
                    "--seq-len", "64", "--ckpt-dir", ckpt,
                    "--ckpt-every", "50", "--log-every", "20"]
                   + (["--device", args.device] if args.device else []))


if __name__ == "__main__":
    main()
