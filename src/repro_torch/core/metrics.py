"""The paper's *delivered performance* metric (Eq. 1) and FLOP accounting.

    delivered = problemSize * stencilFLOP * iterations / time

``stencilFLOP`` counts the FLOPs the *encoding* implies per output element —
including the redundant ones the paper highlights in §4:

  useful (2D Laplace)     7        4 mul + 3 add
  conv encoding (3×3)     17       full window: 9 mul + 8 add
  dense encoding          2N-1     8191 for N=4096 (X=Y=64)
  mask trick (+BC)        +2       one mul + one add per element
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.stencil import StencilSpec


@dataclasses.dataclass(frozen=True)
class DeliveredPerf:
    problem_size: int          # total elements processed (N * steps)
    stencil_flop: int          # per-element FLOPs the encoding performs
    useful_flop: int           # per-element FLOPs that contribute (paper: 7)
    iterations: int
    seconds: float

    @property
    def delivered_gflops(self) -> float:
        return self.problem_size * self.stencil_flop * self.iterations / self.seconds / 1e9

    @property
    def useful_gflops(self) -> float:
        return self.problem_size * self.useful_flop * self.iterations / self.seconds / 1e9

    @property
    def waste_ratio(self) -> float:
        """delivered/useful — 1.0 is a perfect encoding (direct stencil)."""
        return self.stencil_flop / self.useful_flop

    def row(self, label: str) -> str:
        return (
            f"{label},{self.problem_size},{self.iterations},{self.seconds:.4f},"
            f"{self.delivered_gflops:.2f},{self.useful_gflops:.2f},{self.waste_ratio:.1f}"
        )


def encoding_flops_per_point(
    spec: StencilSpec,
    encoding: str,
    n_total: int | None = None,
    mask_trick: bool = True,
) -> int:
    """Per-element FLOP count for an encoding, per the paper's §4 accounting."""
    extra = 2 if mask_trick else 0  # out*mask + bc
    if encoding == "dense":
        if n_total is None:
            raise ValueError("dense encoding needs n_total")
        return spec.delivered_flops_per_point_dense(n_total)  # matrix already holds BCs
    if encoding == "conv":
        return spec.delivered_flops_per_point_conv() + extra
    if encoding == "conv3d_channels":
        # Banded channel matrix: every output channel convolves all Z input
        # channels through a kh*kw window -> Z * window MACs per element.
        if n_total is None:
            raise ValueError("conv3d_channels needs n_total = Z (depth)")
        window = int(np.prod(spec.footprint[1:]))
        return 2 * n_total * window - 1 + extra
    if encoding == "direct":
        return spec.useful_flops_per_point + extra
    raise ValueError(f"unknown encoding {encoding!r}")
