"""Quickstart on the PyTorch port: the paper's 2D Jacobi benchmark through
every encoding, all dispatched through the unified ``make_plan`` API, then
run to convergence through the ``solve`` engine.  The port of
examples/quickstart.py.

  PYTHONPATH=src python examples/torch_quickstart.py              # card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Builds a 64x64 Laplace problem with Dirichlet BC = 1.0 (paper Table 1
shape), lowers it through (a) the dense-layer encoding, (b) the convolution
encoding with the mask trick and in pad mode, (c) the direct CUDA stencil
kernel, (d) the temporally-blocked fused kernel, (e) whatever the auto cost
model picks — cross-validates that all agree with the reference oracle,
reports the paper's delivered-performance metric for each, and finally
runs the experiment itself: iterate until the relative residual converges.
On the CPU the kernel backends run their plain PyTorch versions.
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.core import (BoundaryMode, DeliveredPerf,
                              encoding_flops_per_point, laplace_jacobi,
                              make_plan, solve)


def seconds(fn, x, device) -> float:
    """Wall seconds of one call after one warm-up (the card synchronised)."""
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else lambda: None)
    fn(x)
    sync()
    t0 = time.perf_counter()
    fn(x)
    sync()
    return time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    dev = args.device
    spec = laplace_jacobi(2)
    grid = (args.grid, args.grid)
    iters = args.iters
    steps = 4
    rng = np.random.default_rng(0)
    x0 = torch.as_tensor(rng.standard_normal((steps, *grid)),
                         dtype=torch.float32, device=dev)

    print(f"== 2D Jacobi, grid {grid}, {iters} iterations, BC=1.0, "
          f"on {dev} ==")
    # the oracle, via the same solver engine (fixed-iteration mode)
    ref = solve(spec, x0, backend="reference", bc=1.0, rtol=None,
                atol=None, max_iters=iters, device=dev).x

    plans = {
        "dense-layer (Alg 1)": make_plan(
            spec, grid, backend="dense", bc=1.0, mode=BoundaryMode.MATRIX,
            iters=iters, device=dev),
        "conv-layer (Alg 2, mask trick)": make_plan(
            spec, grid, backend="conv", bc=1.0, mode=BoundaryMode.MASK,
            iters=iters, device=dev),
        "conv-layer (pad mode)": make_plan(
            spec, grid, backend="conv", bc=1.0, mode=BoundaryMode.PAD,
            iters=iters, device=dev),
        "cuda direct": make_plan(
            spec, grid, backend="cuda", bc=1.0, iters=iters, device=dev),
        "cuda fused T=4": make_plan(
            spec, grid, backend="cuda_fused", bc=1.0, iters=iters, fuse=4,
            device=dev),
    }
    auto = make_plan(spec, grid, backend="auto", bc=1.0, iters=iters,
                     device=dev)
    plans[f"auto -> {auto.backend}"] = auto

    n = grid[0] * grid[1]
    worst = 0.0
    for name, plan in plans.items():
        if plan.backend == "dense":
            flops = encoding_flops_per_point(spec, "dense", n_total=n)
        elif plan.backend in ("conv", "conv3d_native"):
            flops = encoding_flops_per_point(spec, "conv")
        else:
            flops = encoding_flops_per_point(spec, "direct")
        err = float((plan(x0) - ref).abs().max())
        worst = max(worst, err)
        perf = DeliveredPerf(n * steps, flops, 7, iters,
                             seconds(plan, x0, dev))
        print(f"{name:32s} max|err|={err:.2e}  "
              f"delivered={perf.delivered_gflops:8.3f} GFLOPS  "
              f"useful={perf.useful_gflops:7.3f}  "
              f"waste x{perf.waste_ratio:.1f}")
    print("\nall encodings agree with the reference oracle")

    print("\n== run to convergence (solve) ==")
    res = solve(spec, torch.zeros(grid, device=dev), bc=1.0, rtol=1e-6,
                check_every=20, max_iters=20_000, device=dev)
    print(f"auto -> {res.backend}: converged={res.converged} in "
          f"{res.iterations} iterations  (residual {res.residual:.2e}, "
          f"{res.wall_seconds:.2f}s wall, "
          f"{res.wall_seconds / res.iterations * 1e6:.0f} us/iter)")
    return {"max_err": worst, "converged": res.converged,
            "iterations": res.iterations}


if __name__ == "__main__":
    main()
