"""Geometric multigrid vs single-level Jacobi on the PyTorch port — the
Table-1 Laplace solve with the V-cycle built out of the port's own stencil
plans, then a heterogeneous-diffusion problem (a per-cell conductivity
field as a variable-coefficient stencil) through the dense, conv and CUDA
encodings.  The port of examples/multigrid.py.

  PYTHONPATH=src python examples/torch_multigrid.py              # card
  PYTHONPATH=src python examples/torch_multigrid.py --device cpu
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.core import (BoundaryMode, heterogeneous_jacobi,
                              laplace_jacobi, multigrid_solve, solve,
                              stencil_apply)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--grid", type=int, default=64,
                    help="the Laplace grid's side; the heterogeneous one "
                         "is one more")
    args = ap.parse_args(argv)
    dev = args.device
    grid = (args.grid, args.grid)
    bc_value = 1.0
    spec = laplace_jacobi(2)
    x0 = torch.zeros(grid, device=dev)

    print(f"== Laplace on {grid}, walls at {bc_value}, on {dev} ==")
    jac = solve(spec, x0, bc=bc_value, rtol=1e-6, check_every=20,
                max_iters=20_000, device=dev)
    print(f"jacobi:    {jac.iterations} iterations "
          f"(residual {jac.residual:.1e}, backend {jac.backend})")

    mg = multigrid_solve(spec, x0, bc=bc_value, rtol=1e-6, device=dev)
    print(f"multigrid: {mg.cycles} V-cycles = {mg.work_units:.0f} fine-grid "
          f"work units (residual {mg.residual:.1e}, levels "
          f"{'->'.join(str(s[0]) for s in mg.level_shapes)}, smoother "
          f"red-black)")
    err = float((mg.x - jac.x).abs().max())
    print(f"agreement |mg - jacobi|_max = {err:.1e}; multigrid did "
          f"{jac.iterations / mg.work_units:.0f}x less fine-grid work\n")

    # Variable-coefficient diffusion: a conductive inclusion in a slab.
    n = args.grid + 1
    kappa = np.ones((n, n), np.float32)
    lo, hi = n * 20 // 65, n * 45 // 65
    kappa[lo:hi, lo:hi] = 10.0  # 10x more conductive block in the middle
    hspec = heterogeneous_jacobi(kappa)
    print(f"== heterogeneous diffusion on ({n}, {n}), kappa in "
          f"[{kappa.min():.0f}, {kappa.max():.0f}] ==")
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((n, n)),
                        dtype=torch.float32, device=dev)
    ref = stencil_apply(hspec, x, backend="reference", bc=bc_value,
                        device=dev)
    errs = {}
    for backend in ("dense", "conv", "cuda"):
        mode = (BoundaryMode.MATRIX if backend == "dense"
                else BoundaryMode.MASK)
        out = stencil_apply(hspec, x, backend=backend, mode=mode,
                            bc=bc_value, device=dev)
        errs[backend] = float((out - ref).abs().max())
        print(f"{backend:8s} err={errs[backend]:.2e}")

    hres = multigrid_solve(hspec, torch.zeros((n, n), device=dev),
                           bc=bc_value, rtol=1e-6, device=dev)
    print(f"multigrid: converged={hres.converged} in {hres.cycles} V-cycles "
          f"({hres.work_units:.0f} work units, residual {hres.residual:.1e})")
    return {"jacobi": jac, "multigrid": mg, "errors": errs,
            "heterogeneous": hres, "agreement": err}


if __name__ == "__main__":
    main()
