"""Run the full dry-run matrix: every (arch x shape) cell on both meshes
(port of ``repro.launch.dryrun_all``).

Appends one JSON line a cell to ``--out`` (resumable: cells already
there with ``ok`` are skipped), so the long matrix can run in the
background and a later pass can stream results.  Each cell runs in a
fresh ``python -m repro_torch.launch.dryrun`` process, since a process
has one default process group and each cell opens its own fake group of
256 or 512 ranks; ``--jobs`` runs that many cells at once.  A cell that
fails is recorded with its error and the matrix goes on; the exit code
is 1 when any cell failed.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun_all \\
      [--out results/dryrun_cells.jsonl] [--jobs 8] [--timeout 1700] \\
      [--shapes train_4k,decode_32k]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor, as_completed


def _cell(arch: str, shape: str, mp: bool, timeout: float) -> dict:
    """One cell in its own process: its record, or the error."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cell.json")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--out", out]
        if mp:
            cmd.append("--multi-pod")
        t0 = time.time()
        try:
            run = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=timeout)
        except subprocess.TimeoutExpired:
            return {"arch": arch, "shape": shape, "multi_pod": mp,
                    "ok": False, "error": f"timeout after {timeout:.0f} s"}
        if run.returncode == 0 and os.path.exists(out):
            with open(out) as f:
                res = json.load(f)
            res["wall_s"] = round(time.time() - t0, 2)
            return res
        return {"arch": arch, "shape": shape, "multi_pod": mp, "ok": False,
                "error": f"exit {run.returncode}",
                "trace": run.stderr[-2000:]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun_cells.jsonl")
    ap.add_argument("--only-arch", default="")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--shapes", default="",
                    help="comma-separated shapes to run (default: all)")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--timeout", type=float, default=7200.0,
                    help="seconds a cell may take")
    args = ap.parse_args()

    from repro_torch.configs import ARCH_IDS, cells

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("ok"):
                        done.add((r["arch"], r["shape"], r["multi_pod"]))
                except json.JSONDecodeError:
                    pass

    jobs = []
    for arch in ARCH_IDS:
        if args.only_arch and arch != args.only_arch:
            continue
        for shape, _ in cells(arch):
            if args.shapes and shape not in args.shapes.split(","):
                continue
            jobs.append((arch, shape, False))
            if not args.single_pod_only:
                jobs.append((arch, shape, True))

    t_start = time.time()
    todo = [j for j in jobs if j not in done]
    for i, j in enumerate(jobs):
        if j in done:
            print(f"[{i+1}/{len(jobs)}] skip {j[0]} {j[1]} mp={j[2]}",
                  flush=True)
    failed = 0
    with ThreadPoolExecutor(max_workers=max(1, args.jobs)) as pool:
        futures = {pool.submit(_cell, *j, args.timeout): j
                   for j in todo}
        # each line as its cell ends, so a cut run keeps what it finished
        for n, fut in enumerate(as_completed(futures)):
            (arch, shape, mp), res = futures[fut], fut.result()
            failed += not res.get("ok")
            with open(args.out, "a") as f:
                f.write(json.dumps(res) + "\n")
            print(f"[{n+1}/{len(todo)}] {arch} {shape} mp={mp} "
                  f"ok={res.get('ok')} {res.get('wall_s', '-')}s "
                  f"(total {time.time()-t_start:.0f}s)", flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
