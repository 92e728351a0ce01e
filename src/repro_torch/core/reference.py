"""Plain shifted-add stencil application — the oracle every encoding matches.

``apply_stencil`` computes the operator by shifted adds (no conv, no matmul)
in the spec's canonical tap order, with zero padding outside the grid.  All
encodings (dense, conv, CUDA kernels) are validated against this.
"""
from __future__ import annotations

import torch

from repro_torch.core.boundary import DirichletBC
from repro_torch.core.stencil import StencilSpec, WeightField


def shift(x: torch.Tensor, offset: tuple[int, ...]) -> torch.Tensor:
    """x shifted so result[..., i] = x[..., i + offset], zero-filled at the
    edges.  ``offset`` addresses the trailing ``len(offset)`` dims."""
    lead = x.ndim - len(offset)
    for d, o in enumerate(offset):
        if o == 0:
            continue
        axis = lead + d
        n = x.shape[axis]
        keep = max(n - abs(o), 0)
        kept = x.narrow(axis, min(max(o, 0), n), keep)
        zshape = list(x.shape)
        zshape[axis] = n - keep
        zeros = x.new_zeros(zshape)
        x = torch.cat((kept, zeros) if o > 0 else (zeros, kept), dim=axis)
    return x


def apply_stencil(x: torch.Tensor, spec: StencilSpec,
                  fields: torch.Tensor | None = None) -> torch.Tensor:
    """One raw stencil application with zero (implicit) padding outside.

    ``x`` is a grid or a batch of grids (the trailing ``spec.ndim`` dims).
    Scalar taps contribute ``w * shift(x, off)``; per-cell weight fields
    contribute ``w[i] * x[i + off]`` (indexed at the *output* cell).
    ``fields`` optionally overrides the spec's per-cell values: a (V, *grid)
    stack in canonical tap order (see ``StencilSpec.field_stack``).
    """
    grid = tuple(x.shape[x.ndim - spec.ndim:])
    if spec.is_variable and spec.weights_shape != grid:
        raise ValueError(
            f"spec {spec.name} carries {spec.weights_shape}-shaped weight "
            f"fields but the grid is {grid}")
    if spec.is_variable:
        fields = torch.as_tensor(
            spec.field_stack() if fields is None else fields, device=x.device)
    acc = torch.zeros_like(x)
    k = 0
    for off, w in spec.taps:
        if isinstance(w, WeightField):
            wt = fields[k].to(x.dtype)
            k += 1
        else:
            wt = torch.tensor(w, dtype=torch.float32).to(x.dtype)
        acc = acc + wt * shift(x, off)
    return acc


def jacobi_step(x: torch.Tensor, spec: StencilSpec, bc: DirichletBC,
                fields: torch.Tensor | None = None,
                source: torch.Tensor | None = None) -> torch.Tensor:
    """One Jacobi iteration with Dirichlet BCs: interior updated, shell held.

    With a ``source`` term the interior update becomes ``S x + s``.
    """
    out = apply_stencil(x, spec, fields)
    if source is not None:
        out = out + source
    return bc.apply_mask_trick(out, spec.ndim)


def jacobi_reference(
    x0: torch.Tensor, spec: StencilSpec, bc: DirichletBC, iterations: int
) -> torch.Tensor:
    """``iterations`` Jacobi steps, plain Python loop (oracle — not for perf)."""
    x = bc.set_boundary(x0, spec.ndim)
    for _ in range(iterations):
        x = jacobi_step(x, spec, bc)
    return x
