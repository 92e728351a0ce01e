"""Convolution-layer encoding of a stencil (paper Algorithm 2, Figures 2-4).

2D: the stencil's footprint window slides over the input (``F.conv2d``,
NCHW — the only layout the CS-1 supported).  Non-zero Dirichlet BCs use the
paper's mask trick (BoundaryMode.MASK); BoundaryMode.PAD re-writes the shell
from x.

3D: the CS-1 only had Conv2D, so the third dimension maps onto the
*channels* axis (paper Figures 3-4): a (dz, dx, dy) tap with weight w
becomes kernel[z_out, z_out+dz, dx, dy] = w, a banded Z x Z channel-mixing
matrix.  Native Conv3D (``F.conv3d``, NCDHW) is the encoding the paper
could not use.

Variable coefficients ride the *gather trick*: a one-hot kernel (one output
channel per varying tap) extracts each neighbour into a channel, and the
per-cell fields apply as an elementwise multiply-and-reduce over channels
(2D through Conv2D, 3D through native Conv3D).

The conv is a library call, as the JAX package left it to XLA's
convolution; it is one of the paper's own comparators, not a kernel of this
port.  On the card it runs with TF32 off (cuDNN's default is on), so the
``conv`` and ``conv3d_native`` backends stay fp32 comparators.
Convolutions compute in fp32 and round to the working type once per call,
as JAX's ``preferred_element_type=float32``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.boundary import BoundaryMode, DirichletBC, runtime_bc_grids
from repro_torch.core.stencil import StencilSpec, WeightField


def _seed_and_drive(grid, bc, bc_value, source, dtype, x0):
    """(seeded x, mask, drive) shared by the MASK-trick executors.

    Every mask-trick body computes ``y = conv(x) * mask + drive`` with
    ``drive = bc_grid + mask * source``; ``drive`` carries a leading
    broadcast axis ((1, *grid) or (B, *grid) for a batched source).
    """
    dev = x0.device
    if bc_value is None:
        mask = bc.interior_mask(grid, dtype, dev)
        bcg = bc.bc_grid(grid, dtype, dev)
        x = bc.set_boundary(x0.to(dtype), len(grid))
    else:
        mask, bcg = runtime_bc_grids(grid, bc_value, dtype, dev)
        x = x0.to(dtype) * mask + bcg
    drive = bcg[None]
    if source is not None:
        drive = drive + mask * torch.as_tensor(source, device=dev).to(dtype)
    return x, mask, drive


def _padding(spec: StencilSpec, dims=None) -> tuple[int, ...]:
    """F.pad widths that align the footprint window with the offsets along
    the spec's ``dims`` (all by default) — the 'same' padding for the
    symmetric footprints of every family.  F.pad lists the last dim
    first."""
    dims = range(spec.ndim) if dims is None else dims
    pad = ()
    for d in reversed(dims):
        pad += (-min(off[d] for off, _ in spec.taps),
                max(off[d] for off, _ in spec.taps))
    return pad


def conv2d_kernel(spec: StencilSpec, dtype=np.float32) -> np.ndarray:
    """OIHW kernel (1,1,kh,kw) — Figure 2 of the paper for 2D Laplace."""
    if spec.ndim != 2:
        raise ValueError("conv2d_kernel needs a 2D spec")
    return spec.to_kernel(dtype)[None, None]


def conv2d_apply(x: torch.Tensor, kernel: torch.Tensor,
                 padding: "str | tuple[int, ...]" = "SAME") -> torch.Tensor:
    """One conv application.  x: (batch, C, H, W) with an OIHW kernel, or
    (batch, C, D, H, W) with an OIDHW kernel (a native 3D conv).

    ``padding`` is JAX's "SAME" (zeros, the output the input's size) or
    "VALID" (no padding), or explicit F.pad widths (last dim first).
    Computes in fp32, returns x's type.
    """
    xf = x.float()
    kf = kernel.float()
    nd = xf.ndim - 2
    if padding == "SAME":
        # XLA's split for stride 1: (k-1)//2 before, the rest after.
        padding = ()
        for k in reversed(kf.shape[2:]):
            padding += ((k - 1) // 2, k - 1 - (k - 1) // 2)
    elif padding == "VALID":
        padding = None
    elif isinstance(padding, str):
        raise ValueError(f"padding must be 'SAME', 'VALID' or F.pad widths, "
                         f"not {padding!r}")
    if padding is not None:
        xf = F.pad(xf, padding)
    if xf.device.type == "cpu" and torch.backends.mkldnn.is_available():
        # F.conv2d's and F.conv3d's CPU heuristics send a batch of one
        # through im2col and sgemm, whose blocked sums round differently
        # from the oneDNN direct convolution they take for larger batches.
        # oneDNN for every batch keeps batched solves equal to one-by-one
        # solves, and sums the window in row-major order, as the
        # shifted-add oracle does.
        y = torch.ops.aten.mkldnn_convolution(xf, kf, None, [0] * nd,
                                              [1] * nd, [1] * nd, 1)
    else:
        conv = F.conv2d if nd == 2 else F.conv3d
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            y = conv(xf, kf)
    return y.to(x.dtype)


def conv_jacobi_2d(
    x0: torch.Tensor,
    spec: StencilSpec,
    bc: DirichletBC,
    iterations: int,
    mode: BoundaryMode = BoundaryMode.MASK,
    dtype=torch.float32,
    *,
    source: torch.Tensor | None = None,
    bc_value=None,
) -> torch.Tensor:
    """Algorithm 2 of the paper.  x0: (batch, H, W) → (batch, H, W).

    ``source``/``bc_value`` are optional runtime operands; they fold into
    the mask-trick drive grid, so they require ``BoundaryMode.MASK``.
    """
    if mode is BoundaryMode.PAD and spec.radius != 1:
        # With a 1-cell boundary shell, 'valid'+re-pad only reconstructs the
        # zero-padded semantics for radius-1 stencils; use MASK otherwise.
        raise ValueError("BoundaryMode.PAD requires a radius-1 stencil")
    if mode not in (BoundaryMode.MASK, BoundaryMode.PAD):
        raise ValueError(f"unsupported mode for conv encoding: {mode}")
    if (source is not None or bc_value is not None) \
            and mode is not BoundaryMode.MASK:
        raise ValueError("runtime source/bc_value operands fold into the "
                         "mask-trick drive grid (BoundaryMode.MASK only)")
    grid = tuple(x0.shape[1:])
    kernel = torch.as_tensor(conv2d_kernel(spec), device=x0.device)
    x, mask, drive = _seed_and_drive(grid, bc, bc_value, source, dtype, x0)
    x, mask, drive = x[:, None], mask[None, None], drive[:, None]
    pad = _padding(spec)
    for _ in range(iterations):
        if mode is BoundaryMode.MASK:
            # Paper §3: zero the convolved boundary, add the BC values back.
            x = conv2d_apply(x, kernel, pad) * mask + drive
        else:
            # 'valid' conv on the interior; the shell is re-written from x
            # itself (it holds the Dirichlet values, which never change).
            y = F.pad(conv2d_apply(x, kernel, "VALID"), (1, 1, 1, 1))
            x = y * mask + x * (1.0 - mask)
    return x[:, 0]


def conv3d_channels_kernel(spec: StencilSpec, depth: int,
                           dtype=np.float32) -> np.ndarray:
    """OIHW kernel (Z, Z, kx, ky) encoding a 3D stencil in Conv2D channels.

    Offsets are (dz, dx, dy): dz indexes the channel band, (dx, dy) the 2D
    window.  Output channel z reads input channels z+dz — the banded matrix
    of paper Figure 4.
    """
    if spec.ndim != 3:
        raise ValueError("conv3d_channels_kernel needs a 3D spec")
    if spec.is_variable:
        raise ValueError(
            "the channels-trick Conv2D shares its band weights across the "
            "whole X-Y plane; per-cell weight fields are not expressible — "
            "use conv3d_native, dense, or cuda")
    _, fx, fy = spec.footprint
    lo = [min(off[d] for off, _ in spec.taps) for d in range(3)]
    ker = np.zeros((depth, depth, fx, fy), dtype=dtype)
    for (dz, dx, dy), w in spec.taps:
        for z_out in range(depth):
            z_in = z_out + dz
            if 0 <= z_in < depth:
                ker[z_out, z_in, dx - lo[1], dy - lo[2]] += w
    return ker


def conv_jacobi_3d_channels(
    x0: torch.Tensor,
    spec: StencilSpec,
    bc: DirichletBC,
    iterations: int,
    dtype=torch.float32,
    *,
    source: torch.Tensor | None = None,
    bc_value=None,
) -> torch.Tensor:
    """The paper's 3D approach.  x0: (batch, Z, X, Y); Z rides the channel
    axis.

    The channel band handles dz itself, so the *mask* treats the Z faces as
    boundary too: the mask and bc grids are built on the full 3D shape and
    broadcast as (1, Z, X, Y).
    """
    grid = tuple(x0.shape[1:])
    kernel = torch.as_tensor(conv3d_channels_kernel(spec, depth=grid[0]),
                             device=x0.device)
    x, mask, drive = _seed_and_drive(grid, bc, bc_value, source, dtype, x0)
    pad = _padding(spec, dims=(1, 2))
    for _ in range(iterations):
        x = conv2d_apply(x, kernel, pad) * mask + drive
    return x


def conv3d_kernel(spec: StencilSpec, dtype=np.float32) -> np.ndarray:
    """OIDHW kernel (1, 1, kz, kx, ky) for a native 3D convolution."""
    if spec.ndim != 3:
        raise ValueError("conv3d_kernel needs a 3D spec")
    return spec.to_kernel(dtype)[None, None]


def conv_jacobi_3d_native(
    x0: torch.Tensor,
    spec: StencilSpec,
    bc: DirichletBC,
    iterations: int,
    dtype=torch.float32,
    *,
    source: torch.Tensor | None = None,
    bc_value=None,
) -> torch.Tensor:
    """Native Conv3D path — the encoding the paper could not use on the
    CS-1.  x0: (batch, Z, X, Y) → (batch, Z, X, Y)."""
    grid = tuple(x0.shape[1:])
    kernel = torch.as_tensor(conv3d_kernel(spec), device=x0.device)
    x, mask, drive = _seed_and_drive(grid, bc, bc_value, source, dtype, x0)
    x, mask, drive = x[:, None], mask[None, None], drive[:, None]
    pad = _padding(spec)
    for _ in range(iterations):
        x = conv2d_apply(x, kernel, pad) * mask + drive
    return x[:, 0]


def split_var_kernels(spec: StencilSpec, dtype=np.float32):
    """Split a (possibly mixed) spec into conv-friendly pieces.

    Returns ``(scalar_kernel, gather_kernel, fields)``:

      scalar_kernel  (1, 1, *footprint) holding the constant taps (zeros if
                     every tap varies);
      gather_kernel  (V, 1, *footprint), one one-hot output channel per
                     varying tap — the conv that extracts each neighbour;
      fields         (V, *grid) stacked per-cell weight fields, in the same
                     channel order as ``gather_kernel``.
    """
    lo = [min(off[d] for off, _ in spec.taps) for d in range(spec.ndim)]
    fp = spec.footprint
    scalar = np.zeros((1, 1) + fp, dtype=dtype)
    onehots, fields = [], []
    for off, w in spec.taps:
        idx = tuple(o - l for o, l in zip(off, lo))
        if isinstance(w, WeightField):
            oh = np.zeros((1,) + fp, dtype=dtype)
            oh[(0,) + idx] = 1.0
            onehots.append(oh)
            fields.append(w.array)
        else:
            scalar[(0, 0) + idx] += w
    gather = np.stack(onehots) if onehots else np.zeros((0, 1) + fp, dtype)
    flds = (np.stack(fields).astype(dtype) if fields
            else np.zeros((0,) + (spec.weights_shape or ()), dtype))
    return scalar, gather, flds


@functools.lru_cache(maxsize=64)
def _var_kernels(spec: StencilSpec, device: torch.device, dtype):
    """``split_var_kernels(spec)`` on ``device``, the baked fields in
    ``dtype``: split and uploaded once per (spec, device, dtype), so the
    chunks of a cached solver, and an adjoint's backward solve, stop
    rebuilding them on every call."""
    scalar_k, gather_k, baked = split_var_kernels(spec)
    return (torch.as_tensor(scalar_k, device=device),
            torch.as_tensor(gather_k, device=device),
            torch.as_tensor(baked, device=device).to(dtype))


def conv_var_jacobi(
    x0: torch.Tensor,
    spec: StencilSpec,
    bc: DirichletBC,
    iterations: int,
    dtype=torch.float32,
    *,
    fields: torch.Tensor | None = None,
    source: torch.Tensor | None = None,
    bc_value=None,
) -> torch.Tensor:
    """Variable-coefficient Jacobi via the gather trick (MASK mode).

    2D runs through Conv2D (NCHW); 3D through native Conv3D (NCDHW) — the
    channels-trick 3D path cannot express per-cell fields.  x0: (batch,
    *grid) → (batch, *grid).  ``fields`` optionally overrides the spec's
    baked per-cell values with a runtime (V, *grid) stack.
    """
    if spec.ndim not in (2, 3):
        raise ValueError("conv gather trick supports 2D and 3D specs")
    grid = tuple(x0.shape[1:])
    if spec.weights_shape != grid:
        raise ValueError(
            f"spec {spec.name} carries {spec.weights_shape}-shaped weight "
            f"fields but the grid is {grid}")
    dev = x0.device
    scalar_k, gather_k, baked = _var_kernels(spec, dev, dtype)
    f = (baked if fields is None
         else torch.as_tensor(fields, device=dev).to(dtype))[None]
    x, mask, drive = _seed_and_drive(grid, bc, bc_value, source, dtype, x0)
    x, mask, drive = x[:, None], mask[None, None], drive[:, None]
    pad = _padding(spec)
    for _ in range(iterations):
        y = conv2d_apply(x, scalar_k, pad)
        g = conv2d_apply(x, gather_k, pad)                  # (B, V, *grid)
        y = y + torch.sum(g * f, dim=1, keepdim=True)
        x = y * mask + drive
    return x[:, 0]
