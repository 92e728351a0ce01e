"""K2 and K3: ``fuse`` Jacobi steps per pass over device memory — the port of
the TPU kernel ``kernels/jacobi_fused.py::jacobi2d_fused_step`` in both of
its geometries (``rim="trapezoid"``: K2; ``rim="resident"``: K3).

Both geometries compute the same function: the shell pinned before the first
step and after each one (when there is a bc), zeros outside the grid, the
steps in fp32 and one rounding to x's type at the end of the pass.  So one
plain version, ``jacobi2d_fused_plain``, serves both.  ``jacobi2d_fused_step``
dispatches on the device of ``x``: a CPU tensor takes the plain version, a
CUDA tensor launches ``csrc/jacobi_fused.cu`` and raises if it cannot.

A trapezoid deeper than one CTA's shared memory holds (``trapezoid_passes``:
past fuse 53 at radius 1, 26 at radius 2) runs as several launches of the
deepest fuse that fits, which hand each other the grid in fp32 through
scratch buffers, so the result is still rounded to x's type once, as the TPU
kernel rounds it after its T steps.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.stencil import StencilSpec
from repro_torch.kernels import _build
from repro_torch.kernels.stencil2d import (check_launch, check_operands,
                                           interior, resolve_fields, sweep)
from repro_torch.kernels.tiling import (MAX_SMEM_BYTES, STATIC_SMEM_BYTES,
                                        resident_fits, resident_smem_bytes)

RIMS = ("trapezoid", "resident")

# Output tile of one trapezoid CTA (rows, cols).
TRAPEZOID_TILE = (64, 64)


def trapezoid_smem_bytes(fuse: int, r: int) -> int:
    """Shared memory of one trapezoid CTA: two fp32 buffers of the tile with
    its fuse*r-deep halo."""
    th, tw = TRAPEZOID_TILE
    halo = fuse * r
    return 2 * (th + 2 * halo) * (tw + 2 * halo) * 4


def trapezoid_passes(fuse: int, r: int) -> list[int]:
    """The steps of each launch a depth-``fuse`` trapezoid runs as: one
    launch while the tile and its fuse*r-deep halo fit one CTA's shared
    memory, else the fewest launches of at most the deepest fuse that fits,
    as even as they go.  Raises for a radius whose halo does not fit even
    at fuse 1."""
    deepest = 0
    while (trapezoid_smem_bytes(deepest + 1, r) + STATIC_SMEM_BYTES
           <= MAX_SMEM_BYTES):
        deepest += 1
    if deepest == 0:
        raise ValueError(
            f"a radius-{r} trapezoid tile needs "
            f"{trapezoid_smem_bytes(1, r)} bytes of shared memory at fuse 1, "
            f"past one CTA's {MAX_SMEM_BYTES}")
    n = -(-fuse // deepest)
    return [fuse // n + (i < fuse % n) for i in range(n)]


def _check_geometry(H: int, W: int, fuse: int, r: int, rim: str) -> None:
    """Raise on a schedule the kernels cannot run."""
    if rim not in RIMS:
        raise ValueError(f"unknown rim strategy {rim!r} "
                         f"(expected 'trapezoid' or 'resident')")
    if fuse < 1:
        raise ValueError("fuse must be >= 1")
    if rim == "resident":
        if not resident_fits((H, W), r):
            raise ValueError(
                f"rim='resident' needs the whole {H}x{W} grid in one CTA's "
                f"shared memory ({resident_smem_bytes((H, W), r)} bytes > "
                f"{MAX_SMEM_BYTES}); use rim='trapezoid' for grids this large")
    else:
        trapezoid_passes(fuse, r)


def jacobi2d_fused_plain(x: torch.Tensor, spec: StencilSpec, *, fuse: int,
                         bc_value: float | None = None,
                         fields: torch.Tensor | None = None) -> torch.Tensor:
    """K2's and K3's plain PyTorch version."""
    fields = resolve_fields(spec, fields, x.device)
    check_operands(x, spec, fields)
    y = x.float()
    inside = None
    if bc_value is not None:
        inside = interior(x.shape[1:], x.device)
        y = torch.where(inside, y, float(np.float32(bc_value)))
    for _ in range(fuse):
        y = sweep(y, spec, fields, inside, bc_value)
    return y.to(x.dtype)


def _launcher():
    lib = _build.library("jacobi_fused")
    fn = lib.jacobi_fused_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(_build.Taps), ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def jacobi2d_fused_step(x: torch.Tensor, spec: StencilSpec, *, fuse: int,
                        bc_value: float | None = None,
                        rim: str = "trapezoid",
                        fields: torch.Tensor | None = None) -> torch.Tensor:
    """``fuse`` Jacobi steps in one kernel pass.  x: (batch, H, W).

    With bc_value=None computes ``fuse`` raw zero-padded stencil steps.
    ``rim`` selects the geometry; "resident" needs the grid to fit one CTA
    (``tiling.resident_fits``); "trapezoid" takes any fuse, in several
    launches where its halo tile does not fit one CTA
    (``trapezoid_passes``).  ``fields`` overrides a variable spec's baked
    per-cell weights with a (V, H, W) stack.
    """
    H, W = x.shape[-2:]
    _check_geometry(H, W, fuse, spec.radius, rim)
    if x.device.type == "cpu":
        return jacobi2d_fused_plain(x, spec, fuse=fuse, bc_value=bc_value,
                                    fields=fields)
    if x.device.type != "cuda":
        raise ValueError(
            f"jacobi2d_fused_step runs on cpu or cuda, not {x.device}")
    fields = resolve_fields(spec, fields, x.device)
    check_operands(x, spec, fields)
    if not x.is_contiguous() or (fields is not None
                                 and not fields.is_contiguous()):
        raise ValueError("jacobi2d_fused_step needs contiguous x and fields")
    check_launch(*x.shape)
    B = x.shape[0]
    taps = _build.tap_table(spec)
    big = _build.big_taps(spec, x.device)
    lib, fn = _launcher()
    out = torch.empty_like(x)
    resident = rim == "resident"
    r = spec.radius
    if resident:
        passes, smem = [fuse], resident_smem_bytes((H, W), r)
    else:
        passes = trapezoid_passes(fuse, r)
        smem = trapezoid_smem_bytes(max(passes), r)
    # Between passes the grid stays fp32, in two scratch buffers taken in
    # turn: x -> s0 -> s1 -> s0 ... -> out.
    scratch = [torch.empty(x.shape, dtype=torch.float32, device=x.device)
               for _ in range(min(len(passes) - 1, 2))]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    src = x
    for i, steps in enumerate(passes):
        dst = out if i == len(passes) - 1 else scratch[i % 2]
        for b0, nb in _build.batch_slices(B):
            rc = fn(int(resident), src[b0].data_ptr(),
                    fields.data_ptr() if fields is not None else None,
                    dst[b0].data_ptr(), nb, H, W, *TRAPEZOID_TILE,
                    _build.DTYPE_CODES[src.dtype],
                    _build.DTYPE_CODES[dst.dtype], ctypes.byref(taps),
                    big.data_ptr() if big is not None else None, r, steps,
                    int(bc_value is not None),
                    0.0 if bc_value is None else bc_value, smem, stream)
            _build.check(lib, rc, f"jacobi2d_fused_step(rim={rim!r})")
            _build.LAUNCHES["jacobi2d_resident" if resident
                            else "jacobi2d_trapezoid"] += 1
        src = dst
    return out
