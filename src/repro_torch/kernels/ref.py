"""Naive oracles for the kernels, per batch element through the shifted-add
reference (``core/reference.py``)."""
from __future__ import annotations

import torch

from repro_torch.core.boundary import DirichletBC
from repro_torch.core.reference import apply_stencil
from repro_torch.core.stencil import StencilSpec


def stencil2d_ref(x: torch.Tensor, spec: StencilSpec) -> torch.Tensor:
    """Raw 2D stencil, zero padding.  x: (batch, H, W)."""
    return torch.stack([apply_stencil(x[i], spec) for i in range(x.shape[0])])


def jacobi2d_ref(x: torch.Tensor, spec: StencilSpec, bc_value: float,
                 iterations: int) -> torch.Tensor:
    """Jacobi with scalar Dirichlet BC.  x: (batch, H, W)."""
    bc = DirichletBC(bc_value)
    out = []
    for i in range(x.shape[0]):
        g = bc.set_boundary(x[i])
        for _ in range(iterations):
            g = bc.apply_mask_trick(apply_stencil(g, spec))
        out.append(g)
    return torch.stack(out)
