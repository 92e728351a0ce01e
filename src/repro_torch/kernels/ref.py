"""Naive oracles for the kernels, per batch element through the shifted-add
reference (``core/reference.py``)."""
from __future__ import annotations

import torch

from repro_torch.core.boundary import DirichletBC
from repro_torch.core.reference import apply_stencil
from repro_torch.core.stencil import StencilSpec


def stencil_ref(x: torch.Tensor, spec: StencilSpec) -> torch.Tensor:
    """Raw stencil of any rank, zero padding.  x: (batch, *grid)."""
    return torch.stack([apply_stencil(x[i], spec) for i in range(x.shape[0])])


stencil2d_ref = stencil3d_ref = stencil_ref


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


def dense_stencil_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (S, N) @ w: (N, N) with fp32 accumulation."""
    return (x.float() @ w.float()).to(x.dtype)
