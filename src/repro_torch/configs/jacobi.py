"""The paper's own benchmark configurations (§4): the JAX package's
``configs/jacobi.py``, copied.

Table 1: 2D Jacobi, problem size 2048 M elements, X=Y=64 per step;
         dense over 7 iterations (the CS-1 layer-memory limit),
         conv over 3500 iterations.
Fig 5:   shapes {32x64, 64x64, 128x64, 128x128} at 3500 iterations.
Fig 6:   3D, X=64 Y=64 Z=10, non-zero BCs, 3500 iterations, 12 workers.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class JacobiConfig:
    name: str
    ndim: int
    grid: tuple[int, ...]          # per-step tile (X, Y) or (Z, X, Y)
    problem_elements: int          # total problem size (N * steps)
    iterations: int
    bc_value: float = 1.0
    encoding: str = "conv"         # conv | dense | conv3d_channels | direct

    @property
    def n_per_step(self) -> int:
        n = 1
        for g in self.grid:
            n *= g
        return n

    @property
    def steps(self) -> int:
        return max(1, self.problem_elements // self.n_per_step)


_2048M = 2048 * 10**6

JACOBI_CONFIGS: dict[str, JacobiConfig] = {
    # Table 1 rows (per-encoding)
    "table1-dense": JacobiConfig("table1-dense", 2, (64, 64), _2048M, 7,
                                 encoding="dense"),
    "table1-conv": JacobiConfig("table1-conv", 2, (64, 64), _2048M, 3500,
                                encoding="conv"),
    # Fig 5 shape sweep
    "fig5-32x64": JacobiConfig("fig5-32x64", 2, (32, 64), _2048M, 3500),
    "fig5-64x64": JacobiConfig("fig5-64x64", 2, (64, 64), _2048M, 3500),
    "fig5-128x64": JacobiConfig("fig5-128x64", 2, (128, 64), _2048M, 3500),
    "fig5-128x128": JacobiConfig("fig5-128x128", 2, (128, 128), _2048M, 3500),
    # Fig 6: 3D with non-zero BCs (X=64, Y=64, Z=10)
    "fig6-3d": JacobiConfig("fig6-3d", 3, (10, 64, 64), _2048M, 3500,
                            encoding="conv3d_channels"),
}
