"""Dense-layer encoding of a stencil (paper Algorithm 1 / Figure 1).

The grid is flattened to a vector of length N and one Jacobi iteration becomes
a matrix–vector product with an N×N matrix W:

    out_flat = x_flat @ W,    W[j, i] = weight of x_j's contribution to out_i

Boundary conditions are encoded *inside the matrix*: rows/cols for boundary
cells form an identity block, so Dirichlet values persist through iterations
with no extra ops (the paper's stated advantage of this encoding).  The cost
is what the paper measures: O(N²) storage and (2N-1) FLOPs per output
element, nearly all redundant (8191 vs 7 useful for X=Y=64).

The product is ``torch.matmul``, as the JAX package left it to XLA's matmul:
this encoding is one of the paper's comparators, not a kernel of this port.
In fp32 it runs at full fp32 precision on the card (PyTorch's default
``allow_tf32=False`` for matmul).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.boundary import DirichletBC
from repro_torch.core.plan import resolve_device
from repro_torch.core.stencil import StencilSpec, WeightField


def build_dense_matrix(
    grid_shape: tuple[int, ...], spec: StencilSpec, dtype=np.float32,
    include_variable: bool = True,
) -> np.ndarray:
    """Materialize the N×N stencil matrix with identity boundary rows.

    Variable-coefficient taps fold in for free: the matrix column for output
    cell ``i`` holds ``w_k(i)``.
    """
    if spec.ndim != len(grid_shape):
        raise ValueError(f"spec is {spec.ndim}D but grid is {len(grid_shape)}D")
    if spec.is_variable and spec.weights_shape != tuple(grid_shape):
        raise ValueError(
            f"spec {spec.name} carries {spec.weights_shape}-shaped weight "
            f"fields but the grid is {tuple(grid_shape)}")
    n = int(np.prod(grid_shape))
    w = np.zeros((n, n), dtype=dtype)
    interior = np.zeros(grid_shape, dtype=bool)
    interior[tuple(slice(1, -1) for _ in grid_shape)] = True

    strides = np.array([int(np.prod(grid_shape[d + 1:]))
                        for d in range(len(grid_shape))])
    for flat_i in range(n):
        idx = np.unravel_index(flat_i, grid_shape)
        if not interior[idx]:
            # Boundary cell: identity row — BC value persists (paper Fig 1).
            w[flat_i, flat_i] = 1.0
            continue
        for off, weight in spec.taps:
            nbr = np.array(idx) + np.array(off)
            if np.any(nbr < 0) or np.any(nbr >= np.array(grid_shape)):
                # Radius > 1 taps can reach past the grid from interior
                # cells; zero-pad semantics means they contribute nothing.
                continue
            flat_j = int(np.dot(nbr, strides))
            # column = output, row = input (x @ W); per-cell fields are
            # indexed at the output cell
            if isinstance(weight, WeightField):
                if not include_variable:
                    continue
                wv = weight.array[idx]
            else:
                wv = weight
            w[flat_j, flat_i] += wv
    return w


def var_tap_indices(
    grid_shape: tuple[int, ...], spec: StencilSpec
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Scatter indices that place runtime per-cell fields into the matrix.

    Returns ``(tap_k, flat_j, flat_i)`` int64 arrays, one entry per
    (variable tap, interior output cell with in-bounds neighbour) pair, so a
    (V, *grid) field stack becomes the matrix

        W = W0; W[flat_j, flat_i] += fields.reshape(V, -1)[tap_k, flat_i]

    where ``W0 = build_dense_matrix(..., include_variable=False)``.
    """
    n = int(np.prod(grid_shape))
    interior = np.zeros(grid_shape, dtype=bool)
    interior[tuple(slice(1, -1) for _ in grid_shape)] = True
    strides = np.array([int(np.prod(grid_shape[d + 1:]))
                        for d in range(len(grid_shape))])
    var_offsets = [off for off, w in spec.taps if isinstance(w, WeightField)]
    tap_k, flat_j, flat_i = [], [], []
    for flat in range(n):
        idx = np.unravel_index(flat, grid_shape)
        if not interior[idx]:
            continue
        for k, off in enumerate(var_offsets):
            nbr = np.array(idx) + np.array(off)
            if np.any(nbr < 0) or np.any(nbr >= np.array(grid_shape)):
                continue
            tap_k.append(k)
            flat_j.append(int(np.dot(nbr, strides)))
            flat_i.append(flat)
    return (np.asarray(tap_k, np.int64), np.asarray(flat_j, np.int64),
            np.asarray(flat_i, np.int64))


def dense_jacobi(
    x0: torch.Tensor, matrix: torch.Tensor, iterations: int,
    drive: torch.Tensor | None = None,
) -> torch.Tensor:
    """Algorithm 1: flatten, then ``iterations`` dense-layer applications.

    ``x0`` has shape (batch, *grid_shape).  The product runs in fp32 and
    rounds to x0's type once per iteration, as JAX's
    ``preferred_element_type=float32``.  ``drive`` is an optional flattened
    additive term per iteration ((n,) or (batch, n), zero on the boundary
    shell so the identity rows keep pinning the Dirichlet values).
    """
    batch = x0.shape[0]
    x = x0.reshape(batch, -1)
    m = matrix.float()
    for _ in range(iterations):
        y = torch.matmul(x.float(), m)
        if drive is not None:
            y = y + drive.float()
        x = y.to(x0.dtype)
    return x.reshape(x0.shape)


def dense_jacobi_with_bc(
    x0,
    spec: StencilSpec,
    bc: DirichletBC,
    iterations: int,
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """Convenience wrapper: build the matrix, seed the BCs into x0's shell,
    iterate.  ``x0`` is (batch, *grid), a tensor or an array, moved to
    ``device`` (None: the card)."""
    dev = resolve_device(device)
    x0 = torch.as_tensor(x0, device=dev).to(dtype)
    grid_shape = tuple(x0.shape[1:])
    matrix = torch.as_tensor(build_dense_matrix(grid_shape, spec),
                             device=dev).to(dtype)
    return dense_jacobi(bc.set_boundary(x0, len(grid_shape)), matrix,
                        iterations)


def dense_layer_bytes(grid_shape: tuple[int, ...], iterations: int,
                      bytes_per_el: int = 2) -> int:
    """Memory the CS-1 model needed: one N² layer *per iteration* (paper §4);
    with N=4096 and fp16, 7 iterations ≈ 235 MB of layer weights."""
    n = int(np.prod(grid_shape))
    return n * n * bytes_per_el * iterations
