"""3D heat diffusion with non-zero Dirichlet boundary conditions on the
PyTorch port — the paper's Fig 6 scenario (X=64, Y=64, Z=10) through the
channels-trick Conv2D encoding, native Conv3D and the CUDA kernel, run to
convergence through the ``solve`` engine; optionally distributed over a
tile mesh with halo exchange (the same ``solve()`` entry point,
``backend="halo"``).  The port of examples/heat3d.py.

  PYTHONPATH=src python examples/torch_heat3d.py [--distributed]     # card
  PYTHONPATH=src python examples/torch_heat3d.py --device cpu \\
      --distributed --tiles 8                                         # CPU

On the card the tiles go round-robin on the visible CUDA devices (all on
one card where there is one); with ``--device cpu`` every tile sits on the
CPU.
"""
import argparse
import sys

sys.path.insert(0, "src")

import torch

from repro_torch.core import laplace_jacobi, solve
from repro_torch.parallel import make_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiles", type=int, default=8,
                    help="tiles of the --distributed mesh, (2, tiles // 2)")
    ap.add_argument("--max-iters", type=int, default=20_000,
                    help="iteration budget of the converged solves")
    args = ap.parse_args(argv)
    dev = args.device

    spec = laplace_jacobi(3)
    bc_value = 100.0  # hot walls
    grid = (10, 64, 64)
    x0 = torch.zeros(grid)
    solved = dict(bc=bc_value, rtol=1e-6, check_every=20,
                  max_iters=args.max_iters, device=dev)

    print(f"== 3D heat, grid (Z,X,Y)={grid}, walls at {bc_value} ==")
    # One spec, three encodings — all through the unified solver engine
    # (fixed-iteration mode), cross-validated against the oracle backend.
    ref = solve(spec, x0, backend="reference", bc=bc_value, rtol=None,
                atol=None, max_iters=args.iters, device=dev).x
    for backend in ("conv", "conv3d_native", "cuda", "auto"):
        res = solve(spec, x0, backend=backend, bc=bc_value, rtol=None,
                    atol=None, max_iters=args.iters, device=dev)
        tag = f"auto -> {res.backend}" if backend == "auto" else backend
        print(f"{tag:22s} err={float((res.x - ref).abs().max()):.2e}")

    # the actual experiment: iterate until the walls' heat fills the slab
    res = solve(spec, x0, backend="auto", **solved)
    centre = res.x[grid[0] // 2, grid[1] // 2, grid[2] // 2]
    print(f"solve: converged={res.converged} after {res.iterations} iters "
          f"(residual {res.residual:.1e}, backend {res.backend}); centre "
          f"temperature {float(centre):.3f} (walls {bc_value}) — heat "
          f"diffused inward")

    if args.distributed:
        n = args.tiles
        if n < 2 or n % 2:
            raise SystemExit("--tiles must be even and at least 2")
        # distribute the 2D X-Y plane of the mid-Z slice problem over the
        # tile mesh — the identical solve() call, backend="halo"
        mesh = make_mesh((2, n // 2), ("data", "model"),
                         devices="cpu" if dev == "cpu" else None)
        spec2 = laplace_jacobi(2)
        x2 = torch.zeros(2, 64, 64)
        dist = solve(spec2, x2, backend="halo", mesh=mesh, **solved)
        single = solve(spec2, x2, backend="reference", **solved)
        err = float((dist.x - single.x).abs().max())
        print(f"distributed halo-exchange solve (mesh "
              f"{dict(zip(mesh.axis_names, mesh.shape))}, tiles on "
              f"{sorted({str(d) for d in mesh.devices})}, fuse "
              f"{dist.fuse}): iters={dist.iterations.tolist()} vs "
              f"single-device {single.iterations.tolist()}, field "
              f"err={err:.2e}")
        return dist, single
    return None


if __name__ == "__main__":
    main()
