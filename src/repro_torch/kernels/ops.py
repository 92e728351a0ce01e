"""The iteration loops around the kernels.

``jacobi2d`` sets the Dirichlet shell, then runs the kernel pass by pass:
``fuse`` iterations per pass through the fused kernel, or one per pass
through the direct kernel for variable-coefficient specs at fuse=1.
``jacobi3d`` sets the shell and runs one 3D kernel pass per iteration.
``dense_jacobi_kernel`` runs the dense encoding, one matrix-product pass per
iteration.  Each kernel runs as its plain version on a CPU tensor and as
CUDA on a CUDA one.
"""
from __future__ import annotations

import torch

from repro_torch.core.boundary import DirichletBC
from repro_torch.core.stencil import StencilSpec
from repro_torch.kernels.dense_stencil import dense_stencil_matmul
from repro_torch.kernels.jacobi_fused import jacobi2d_fused_step
from repro_torch.kernels.stencil2d import resolve_fields, stencil2d
from repro_torch.kernels.stencil3d import stencil3d


def jacobi2d(
    x0: torch.Tensor,
    spec: StencilSpec,
    *,
    bc_value: float,
    iterations: int,
    fuse: int = 1,
    rim: str = "trapezoid",
    fields: torch.Tensor | None = None,
) -> torch.Tensor:
    """``iterations`` Jacobi steps on (batch, H, W) through the kernels.

    fuse=1 streams one iteration per pass over device memory (the
    paper-faithful pipeline); fuse=T runs T iterations per pass, with
    ``rim`` selecting the fusion geometry (see jacobi_fused.py).
    ``iterations`` must be divisible by ``fuse``.  Variable-coefficient
    specs take the direct ``stencil2d`` kernel at fuse=1 and the fused
    kernel at fuse>1; ``fields`` overrides their baked per-cell values with
    a (V, H, W) stack.
    """
    if iterations % fuse:
        raise ValueError(f"iterations={iterations} not divisible by fuse={fuse}")
    # Resolved once here, so no pass copies the fields to the device again.
    fields = resolve_fields(spec, fields, x0.device)
    direct = spec.is_variable and fuse == 1
    if direct or iterations == 0:
        x = DirichletBC(bc_value).set_boundary(x0, 2)
    else:
        # The fused kernel pins the shell before its first step: that is
        # the seeding, done without another pass over the grid.
        x = x0.contiguous()
    for _ in range(iterations // fuse):
        if direct:
            x = stencil2d(x, spec, bc_value=bc_value, fields=fields)
        else:
            x = jacobi2d_fused_step(x, spec, fuse=fuse, bc_value=bc_value,
                                    rim=rim, fields=fields)
    return x


def jacobi3d(
    x0: torch.Tensor,
    spec: StencilSpec,
    *,
    bc_value: float,
    iterations: int,
    fields: torch.Tensor | None = None,
) -> torch.Tensor:
    """``iterations`` 3D Jacobi steps on (batch, Z, X, Y) through K4.

    ``fields`` overrides a variable spec's baked per-cell values with a
    (V, Z, X, Y) stack.
    """
    fields = resolve_fields(spec, fields, x0.device)
    x = DirichletBC(bc_value).set_boundary(x0, 3)
    for _ in range(iterations):
        x = stencil3d(x, spec, bc_value=bc_value, fields=fields)
    return x


def dense_jacobi_kernel(x0: torch.Tensor, matrix: torch.Tensor, *,
                        iterations: int) -> torch.Tensor:
    """The dense encoding through K5.  x0: (batch, *grid).

    The BC lives inside ``matrix`` (identity rows): build it with
    ``core.build_dense_matrix`` and set the shell on x0 first.
    """
    batch, grid_shape = x0.shape[0], x0.shape[1:]
    x = x0.reshape(batch, -1)
    for _ in range(iterations):
        x = dense_stencil_matmul(x, matrix)
    return x.reshape(batch, *grid_shape)


__all__ = ["dense_jacobi_kernel", "dense_stencil_matmul", "jacobi2d",
           "jacobi2d_fused_step", "jacobi3d", "stencil2d", "stencil3d"]
