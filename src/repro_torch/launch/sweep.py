"""Run the full dry-run sweep: every (arch × shape × mesh) cell as an
isolated subprocess, resumable — existing JSON artifacts are skipped — the
port of the JAX package's ``launch/sweep.py``.

  PYTHONPATH=src python -m repro_torch.launch.sweep [--mesh pod multipod] \\
      [--jobs 1] [--timeout 3600]

A cell that fails leaves ``<cell>.json.err`` (the ends of its output and
errors), one past ``--timeout`` seconds ``TIMEOUT after <s> s``; a rerun
tries both again.  ``--jobs`` runs that many cells at once (each a
single-threaded trace on ``meta``).  Each line of ``<out>/sweep.log``
records a cell's status and wall seconds.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ARCHS = [
    "qwen3-0.6b", "mamba2-370m", "whisper-tiny", "zamba2-1.2b",
    "qwen2-vl-2b", "glm4-9b", "phi3-medium-14b", "nemotron-4-15b",
    "moonshot-v1-16b-a3b", "qwen3-moe-30b-a3b",
]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def cell_path(out: str, arch: str, shape: str, mesh: str) -> str:
    mesh_name = "pod2x16x16" if mesh == "multipod" else "pod16x16"
    return os.path.join(out, f"{arch}__{shape}__{mesh_name}.json")


def run_one(arch: str, shape: str, mesh: str, out: str,
            timeout: float) -> tuple[str, float]:
    """One cell in its own process -> (OK, FAILED or TIMEOUT, seconds)."""
    path = cell_path(out, arch, shape, mesh)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--out", out]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.time()
    try:
        r = subprocess.run(cmd, timeout=timeout, capture_output=True,
                           text=True, env=env)
    except subprocess.TimeoutExpired:
        with open(path + ".err", "w") as f:
            f.write(f"TIMEOUT after {timeout:.0f} s")
        return "TIMEOUT", time.time() - t0
    if r.returncode != 0:
        with open(path + ".err", "w") as f:
            f.write(r.stdout[-4000:] + "\n---\n" + r.stderr[-8000:])
        return "FAILED", time.time() - t0
    if os.path.exists(path + ".err"):
        os.remove(path + ".err")
    return "OK", time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", nargs="+", default=["pod", "multipod"])
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--archs", nargs="+", default=ARCHS)
    ap.add_argument("--shapes", nargs="+", default=SHAPES)
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--jobs", type=int, default=1)
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    cells = [(a, s, m) for m in args.mesh for s in args.shapes
             for a in args.archs]
    todo = [c for c in cells if not os.path.exists(cell_path(args.out, *c))]
    print(f"[sweep] {len(cells) - len(todo)} of {len(cells)} cells done, "
          f"{len(todo)} to run", flush=True)
    t0 = time.time()

    def one(cell):
        status, secs = run_one(*cell, args.out, args.timeout)
        line = f"{cell[0]} {cell[1]} {cell[2]} {status} {secs:.1f}"
        with open(os.path.join(args.out, "sweep.log"), "a") as f:
            f.write(line + "\n")
        print(f"[sweep] {line}", flush=True)
        return status

    with ThreadPoolExecutor(max(1, args.jobs)) as pool:
        results = list(pool.map(one, todo))
    ok = results.count("OK")
    print(f"[sweep] finished: {ok} ok, {len(results) - ok} failed, "
          f"{time.time() - t0:.0f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
