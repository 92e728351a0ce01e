"""K4: one direct 3D stencil step — the port of the TPU kernel
``kernels/stencil3d.py::stencil3d``.

``stencil3d`` dispatches on the device of ``x``: a CPU tensor goes through
``stencil3d_plain`` (the 2D kernels' ``sweep`` on a rank-3 grid: the same
arithmetic in plain PyTorch), a CUDA tensor launches ``csrc/stencil3d.cu``
and raises if it cannot, and a ``meta`` tensor gets its output's shape; a
call charges a counting ``launch.hlo_cost.CostCounter``
``stencil2d.stencil_bytes``.  That source holds two kernels, the cell kernel
and the Z-streaming one; ``stencil3d_kernel_for`` there picks one by the
tap table, Y and the batch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.stencil import StencilSpec
from repro_torch.kernels import _build
from repro_torch.kernels.stencil2d import (MAX_CELLS, check_operands,
                                           interior, meta_fields,
                                           resolve_fields, stencil_bytes,
                                           sweep)
from repro_torch.launch.hlo_cost import kernel_cost

# gridDim.y carries the Z planes.
MAX_DEPTH = 65_535
# csrc/stencil3d.cu's two kernels, by the codes of its K4_* enum.
KERNELS = {"cell": 1, "stream": 2}


def check_launch3(B: int, Z: int, X: int, Y: int) -> None:
    """Raise on a shape the kernel's launch geometry cannot cover: gridDim.y
    carries the Z planes and cells of one grid are indexed in int32 (the
    wrapper launches any batch in slices, _build.batch_slices)."""
    if Z > MAX_DEPTH:
        raise ValueError(f"depth {Z} must be at most {MAX_DEPTH}")
    if Z * X * Y > MAX_CELLS:
        raise ValueError(f"a {Z}x{X}x{Y} grid exceeds the kernel's "
                         f"{MAX_CELLS} cells")


def stencil3d_plain(x: torch.Tensor, spec: StencilSpec, *,
                    bc_value: float | None = None,
                    fields: torch.Tensor | None = None) -> torch.Tensor:
    """K4's plain PyTorch version: one fp32 step, rounded to x's type."""
    fields = resolve_fields(spec, fields, x.device)
    check_operands(x, spec, fields, ndim=3)
    inside = interior(x.shape[1:], x.device) if bc_value is not None \
        else None
    return sweep(x.float(), spec, fields, inside, bc_value).to(x.dtype)


def _library():
    lib = _build.library("stencil3d")
    if lib.stencil3d_launch.argtypes is None:
        lib.stencil3d_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(_build.Taps3), ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        lib.stencil3d_launch.restype = ctypes.c_int
        lib.stencil3d_kernel_for.argtypes = [ctypes.c_int] * 6
        lib.stencil3d_kernel_for.restype = ctypes.c_int
    return lib


def stencil3d(x: torch.Tensor, spec: StencilSpec, *,
              bc_value: float | None = None,
              fields: torch.Tensor | None = None,
              kernel: str | None = None) -> torch.Tensor:
    """Apply one 3D stencil step to x: (batch, Z, X, Y).

    bc_value=None → raw stencil with zero padding; bc_value=v → one Jacobi
    step with the shell (all six faces) pinned to v.  ``fields`` overrides
    a variable spec's baked per-cell weights with a (V, Z, X, Y) stack,
    shared by the batch.  ``kernel`` ("cell" or "stream", CUDA only) asks
    for one of the two kernels, to time one against the other; by default
    the shape picks it.  The streaming kernel needs x aligned to its 4-cell
    copies (16 bytes in fp32, 8 in bf16).
    """
    if kernel is not None and kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {list(KERNELS)}, got "
                         f"{kernel!r}")
    with kernel_cost(0.0, stencil_bytes(x, spec)):
        if x.device.type == "cpu":
            if kernel is not None:
                raise ValueError("kernel names a CUDA kernel; x is on the "
                                 "cpu")
            return stencil3d_plain(x, spec, bc_value=bc_value, fields=fields)
        if x.device.type == "meta":
            check_operands(x, spec, meta_fields(fields), ndim=3)
            check_launch3(*x.shape)
            return torch.empty_like(x)
        if x.device.type != "cuda":
            raise ValueError(f"stencil3d runs on cpu, cuda or meta, not "
                             f"{x.device}")
        return _launch(x, spec, bc_value, fields, kernel)


def _launch(x: torch.Tensor, spec: StencilSpec, bc_value, fields, kernel):
    """K4 on a CUDA tensor."""
    fields = resolve_fields(spec, fields, x.device)
    check_operands(x, spec, fields, ndim=3)
    if not x.is_contiguous() or (fields is not None
                                 and not fields.is_contiguous()):
        raise ValueError("stencil3d needs contiguous x and fields")
    B, Z, X, Y = x.shape
    check_launch3(B, Z, X, Y)
    taps = _build.tap_table(spec)
    big = _build.big_taps(spec, x.device)
    lib = _library()
    slices = _build.batch_slices(B)
    which = [KERNELS[kernel] if kernel is not None else
             lib.stencil3d_kernel_for(taps.n, spec.radius, nb, Z, X, Y)
             for _, nb in slices]
    # Y % 4 == 0 where the streaming kernel runs, so every slice of the
    # batch is aligned as x is.
    align = 4 * x.element_size()
    if KERNELS["stream"] in which and x.data_ptr() % align:
        raise ValueError(f"stencil3d: x must be {align}-byte aligned for "
                         f"the streaming kernel")
    out = torch.empty_like(x)
    for (b0, nb), k in zip(slices, which):
        rc = lib.stencil3d_launch(
            x[b0].data_ptr(),
            fields.data_ptr() if fields is not None else None,
            out[b0].data_ptr(), nb, Z, X, Y, spec.radius,
            _build.DTYPE_CODES[x.dtype], ctypes.byref(taps),
            big.data_ptr() if big is not None else None, k,
            int(bc_value is not None), 0.0 if bc_value is None else bc_value,
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, rc, "stencil3d")
        _build.LAUNCHES["stencil3d"] += 1
    return out
