"""Print the wall times of the Fig-6 and heterogeneous Fig-6 single-grid
solves through the ``cuda`` backend (K4), one warm-up solve and then
``REPEATS`` timed ones each, as one JSON object {solve: [iterations,
[ms, ...]]}.  Run it from two checkouts on one card, alternating, to
compare host-bound walls whose spread is wide:

    PYTHONPATH=<checkout>/src python3 <checkout>/tests/_torch_solve_walls.py
"""
import json

import numpy as np
import torch

import repro_torch.core as T

REPEATS = 5
GRID = (10, 64, 64)   # configs/jacobi.py's Fig-6 grid, as chip_smoke.py
SOLVE = dict(bc=1.0, rtol=1e-6, check_every=20, max_iters=10_000)


def main():
    kappa = 1.0 + 9.0 * np.random.default_rng(0).random(GRID)
    out = {}
    for name, spec in (("fig6", T.laplace_jacobi(3)),
                       ("hetero3d", T.heterogeneous_jacobi(kappa))):
        solver = T.Solver(spec, GRID, backend="cuda",
                          device=torch.device("cuda"), **SOLVE)
        solver.solve(torch.zeros(GRID))
        runs = [solver.solve(torch.zeros(GRID)) for _ in range(REPEATS)]
        out[name] = [runs[-1].iterations,
                     [r.wall_seconds * 1e3 for r in runs]]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
