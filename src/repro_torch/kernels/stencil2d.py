"""K1: one direct 2D stencil step — the port of the TPU kernel
``kernels/stencil2d.py::stencil2d``.

``stencil2d`` dispatches on the device of ``x``: a CPU tensor goes through
``stencil2d_plain`` (the same arithmetic in plain PyTorch), a CUDA tensor
launches ``csrc/stencil2d.cu`` and raises if it cannot, and a ``meta``
tensor (a dry run) gets its output's shape only.  ``sweep`` is the one
step every plain version (this one, the fused kernel's and the 3D
kernel's) repeats.  Each call charges a counting
``launch.hlo_cost.CostCounter`` ``stencil_bytes`` and no flops, whatever
the device, as K2-K4 do.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.stencil import StencilSpec, WeightField
from repro_torch.kernels import _build
from repro_torch.launch.hlo_cost import kernel_cost

# Cells of one grid are indexed in int32.  The batch has no limit: the
# wrappers launch it in slices (_build.batch_slices).
MAX_CELLS = 2**31 - 1


def check_launch(B: int, H: int, W: int) -> None:
    """Raise on a shape the kernels' launch geometry cannot cover."""
    if H * W > MAX_CELLS:
        raise ValueError(f"a {H}x{W} grid exceeds the kernels' {MAX_CELLS} "
                         f"cells")


def resolve_fields(spec: StencilSpec, fields, device) -> torch.Tensor | None:
    """The (V, H, W) fp32 field stack the kernels read: ``fields`` if given,
    else the spec's baked values; None for an all-scalar spec."""
    if not spec.is_variable:
        return None
    if fields is None:
        fields = spec.field_stack()
    return torch.as_tensor(fields, device=device).to(torch.float32)


def check_operands(x: torch.Tensor, spec: StencilSpec,
                   fields: torch.Tensor | None, ndim: int = 2) -> None:
    """What the ``ndim``-D kernels and their plain versions take."""
    if spec.ndim != ndim:
        raise ValueError(f"the {ndim}D stencil kernels need a {ndim}D spec")
    if x.ndim != ndim + 1:
        dims = "H, W" if ndim == 2 else "Z, X, Y"
        raise ValueError(f"x must be (batch, {dims}), got {tuple(x.shape)}")
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    want = (spec.num_variable_taps, *x.shape[1:])
    if fields is not None and tuple(fields.shape) != want:
        raise ValueError(f"fields must be shaped {want}, got "
                         f"{tuple(fields.shape)}")


def stencil_bytes(x: torch.Tensor, spec: StencilSpec) -> int:
    """What a call of K1-K4 is charged, as JAX's analyser charges a Pallas
    ``custom-call`` its operands and result: x read and the result written
    once, and a variable spec's (V, *grid) fp32 field stack read once (the
    operands unpadded, as the port's kernels take them).  No flops: JAX
    counts only matrix products and convolutions, and a stencil's shifted
    adds are neither."""
    fields = (4 * spec.num_variable_taps * math.prod(x.shape[1:])
              if spec.is_variable else 0)
    return 2 * x.nbytes + fields


def meta_fields(fields) -> torch.Tensor | None:
    """``fields`` where it is a tensor (its shape to check on ``meta``),
    else None: an array or the spec's baked stack has nothing to check."""
    return fields if isinstance(fields, torch.Tensor) else None


def interior(grid: tuple[int, ...], device) -> torch.Tensor:
    """True off the Dirichlet shell of a grid of any rank."""
    m = torch.zeros(grid, dtype=torch.bool, device=device)
    m[tuple(slice(1, -1) for _ in grid)] = True
    return m


def sweep(x32: torch.Tensor, spec: StencilSpec, fields: torch.Tensor | None,
          inside: torch.Tensor | None, bc_value: float | None) -> torch.Tensor:
    """One fp32 stencil step on (B, *grid): zero padding outside the grid,
    taps summed in canonical order, the shell pinned when ``bc_value`` is
    set (``inside`` is then the :func:`interior` mask)."""
    grid = x32.shape[1:]
    r = spec.radius
    xp = F.pad(x32, (r,) * (2 * len(grid)))
    acc = None
    k = 0
    for off, w in spec.taps:
        term = xp[(slice(None),) + tuple(slice(r + o, r + o + n)
                                         for o, n in zip(off, grid))]
        if isinstance(w, WeightField):
            term = term * fields[k]
            k += 1
        else:
            term = term * float(np.float32(w))
        acc = term if acc is None else acc + term
    if bc_value is not None:
        acc = torch.where(inside, acc, float(np.float32(bc_value)))
    return acc


def stencil2d_plain(x: torch.Tensor, spec: StencilSpec, *,
                    bc_value: float | None = None,
                    fields: torch.Tensor | None = None) -> torch.Tensor:
    """K1's plain PyTorch version: one fp32 step, rounded to x's type."""
    fields = resolve_fields(spec, fields, x.device)
    check_operands(x, spec, fields)
    inside = interior(x.shape[1:], x.device) if bc_value is not None \
        else None
    return sweep(x.float(), spec, fields, inside, bc_value).to(x.dtype)


def _launcher():
    lib = _build.library("stencil2d")
    fn = lib.stencil2d_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(_build.Taps), ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def stencil2d(x: torch.Tensor, spec: StencilSpec, *,
              bc_value: float | None = None,
              fields: torch.Tensor | None = None) -> torch.Tensor:
    """Apply one stencil step to x: (batch, H, W).

    bc_value=None → raw stencil with zero padding; bc_value=v → one Jacobi
    step with the shell pinned to v.  ``fields`` overrides a variable
    spec's baked per-cell weights with a (V, H, W) stack.
    """
    with kernel_cost(0.0, stencil_bytes(x, spec)):
        if x.device.type == "cpu":
            return stencil2d_plain(x, spec, bc_value=bc_value, fields=fields)
        if x.device.type == "meta":
            check_operands(x, spec, meta_fields(fields))
            check_launch(*x.shape)
            return torch.empty_like(x)
        if x.device.type != "cuda":
            raise ValueError(f"stencil2d runs on cpu, cuda or meta, not "
                             f"{x.device}")
        return _launch(x, spec, bc_value, fields)


def _launch(x: torch.Tensor, spec: StencilSpec, bc_value, fields):
    """K1 on a CUDA tensor."""
    fields = resolve_fields(spec, fields, x.device)
    check_operands(x, spec, fields)
    if not x.is_contiguous() or (fields is not None
                                 and not fields.is_contiguous()):
        raise ValueError("stencil2d needs contiguous x and fields")
    B, H, W = x.shape
    check_launch(B, H, W)
    taps = _build.tap_table(spec)
    big = _build.big_taps(spec, x.device)
    lib, fn = _launcher()
    out = torch.empty_like(x)
    for b0, nb in _build.batch_slices(B):
        rc = fn(x[b0].data_ptr(),
                fields.data_ptr() if fields is not None else None,
                out[b0].data_ptr(), nb, H, W, spec.radius,
                _build.DTYPE_CODES[x.dtype], ctypes.byref(taps),
                big.data_ptr() if big is not None else None,
                int(bc_value is not None),
                0.0 if bc_value is None else bc_value,
                torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, rc, "stencil2d")
        _build.LAUNCHES["stencil2d"] += 1
    return out
