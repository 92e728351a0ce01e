"""K2 and K3: ``fuse`` Jacobi steps per pass over device memory — the port of
the TPU kernel ``kernels/jacobi_fused.py::jacobi2d_fused_step`` in both of
its geometries (``rim="trapezoid"``: K2; ``rim="resident"``: K3).

Both geometries compute the same function: the shell pinned before the first
step and after each one (when there is a bc), zeros outside the grid, the
steps in fp32 and one rounding to x's type at the end of the pass.  So one
plain version, ``jacobi2d_fused_plain``, serves both.  ``jacobi2d_fused_step``
dispatches on the device of ``x``: a CPU tensor takes the plain version, a
CUDA tensor launches one of ``csrc/jacobi_fused.cu``'s kernels and raises if
it cannot, and a ``meta`` tensor gets its output's shape once the schedule
is checked.  A call charges a counting ``launch.hlo_cost.CostCounter`` once
(``stencil2d.stencil_bytes``), however many passes it launches.

Which kernel runs is a dispatch by shape (``kernel_for``), or a name
(``kernel=``, to time one against another):

- ``resident_regs`` (K3): one CTA an instance with its cells in registers,
  each thread a patch of ``regs_patch`` rows and two columns, for the
  tables in the 3x3 window with an instance (``window_mask``: the 5-point
  star, the 3x3 box) on grids its 512 threads' patches cover.  It also
  takes a trapezoid request on such a grid, since both geometries give the
  same bits and it recomputes nothing (Table 1's launch: one 64x64 grid,
  fuse 4, and batches of them; tests/_torch_jacobi_sweep.py, PERF.md).
- ``resident_cta``: one CTA an instance with the grid in shared memory
  (``tiling.resident_cta_fits``), for the other one-CTA resident grids of
  at most 512 columns.
- ``resident_grid``: a resident grid past those, up to the JAX package's
  8 MiB (``tiling.resident_fits``): a cooperative launch of persistent CTAs
  with a grid-wide barrier a step.
- ``resident_smem``: the one-CTA kernel before the two above, by name only.
- ``stream`` (K2): a row-streaming wavefront, for the trapezoids where it
  is faster than the tile kernel: large launches, and deep fuses on grids
  of enough rows.  A fuse deeper than its shared memory holds
  (``trapezoid_passes``: past 37 at radius 1, 22 at radius 2) runs as
  several launches of the deepest fuse that fits, which hand each other
  the grid in fp32 through scratch buffers, so the result is still rounded
  to x's type once, as the TPU kernel rounds it after its T steps.
  ``stream_r0`` and ``stream_u1`` (by name only) are its variants with the
  radius a runtime value and with one level at a time.
- ``tile``: the trapezoid kernel before the stream one (a CTA a 64x64
  tile with its halo), for the other trapezoids: small launches at fuse
  1-3, deep fuses on grids of few rows.

Each launch adds one to ``_build.LAUNCHES[COUNTERS[kernel]]``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.stencil import StencilSpec
from repro_torch.kernels import _build
from repro_torch.kernels.stencil2d import (check_launch, check_operands,
                                           interior, meta_fields,
                                           resolve_fields, stencil_bytes,
                                           sweep)
from repro_torch.kernels.tiling import (MAX_SMEM_BYTES, RESIDENT_VMEM_BYTES,
                                        STATIC_SMEM_BYTES, resident_cta_fits,
                                        resident_fits, resident_smem_bytes,
                                        round_up)
from repro_torch.launch.hlo_cost import kernel_cost

RIMS = ("trapezoid", "resident")
# csrc/jacobi_fused.cu's kernels, by the codes of its K_* enum.
KERNELS = {"tile": 1, "stream": 2, "resident_smem": 3, "resident_regs": 4,
           "resident_grid": 5, "resident_cta": 6, "stream_r0": 7,
           "stream_u1": 8}
# The _build.LAUNCHES key each kernel counts its launches under: K2 and K3
# keep their names (the stream kernel's variants count as it), the other
# kernels their own.
COUNTERS = {"stream": "jacobi2d_trapezoid", "stream_r0": "jacobi2d_trapezoid",
            "stream_u1": "jacobi2d_trapezoid",
            "tile": "jacobi2d_trapezoid_tile",
            "resident_regs": "jacobi2d_resident",
            "resident_cta": "jacobi2d_resident_cta",
            "resident_smem": "jacobi2d_resident_smem",
            "resident_grid": "jacobi2d_resident_grid"}
STREAM_KERNELS = ("stream", "stream_r0", "stream_u1")

# The tile kernel's output tile (rows, cols); the stream kernel's strip of
# columns (one a thread) and its rows of shared memory a level: a ring of
# 2r + 2 slots with the first 2r mirrored after the last.
TILE = (64, 64)
STREAM_W = 256
# The stream kernel's launch, (below fuse STREAM_U, from it): the waves of
# CTAs its chunks of rows fill, and the fewest rows a chunk.  Below it a
# level or two are bound by memory's latency, so more chunks keep more rows
# in flight, as long as a CTA's own start stays a small part of its walk;
# from it one wave, of chunks as short as fill it: a CTA walks its rows and
# a fill of T (2r + 1) advances, and more CTAs than a wave holds would walk
# one after another (tests/_torch_jacobi_sweep.py).
STREAM_U = 4
STREAM_WAVES, STREAM_MIN_ROWS = (4, 1), (32, 1)
# The fewest cells a launch below fuse STREAM_U gives the stream kernel
# (kernel_for), by fuse.
STREAM_MIN_CELLS = {1: 1 << 24, 2: 1 << 22, 3: 1 << 22}
# The register kernel: at most 512 threads, each KC rows of two columns, KC
# the first of REGS_ROWS whose patches cover the grid (the fewest cells a
# thread, the most warps: on Table 1's grid KC 4 was the fastest,
# tests/_torch_jacobi_sweep.py), for the tap tables of the 3x3 window whose
# masks (bit 3 (dr + 1) + dc + 1) have an instance: the 5-point star, the
# box.
REGS_MAX_THREADS, REGS_ROWS = 512, (4, 8, 16)
REGS_MASKS = (0x0AA, 0x1FF)
# The cta kernel: as many rows of threads of one column each as 512 threads
# hold and the grid fills; its cells a thread come in groups of 8.
CTA_MAX_THREADS, CTA_GROUP = 512, 8
# The grid-wide kernel's tile (rows, cols).
GRID_TILE = (16, 64)


def trapezoid_smem_bytes(fuse: int, r: int) -> int:
    """Dynamic shared memory of one stream (K2) CTA: ``fuse`` levels' rings
    of 4r + 2 fp32 rows of STREAM_W, and r floats of padding each side."""
    return (fuse * (4 * r + 2) * STREAM_W + 2 * r) * 4


def tile_smem_bytes(fuse: int, r: int) -> int:
    """Shared memory of one tile CTA: two fp32 buffers of the tile with its
    fuse*r-deep halo."""
    th, tw = TILE
    halo = fuse * r
    return 2 * (th + 2 * halo) * (tw + 2 * halo) * 4


@functools.lru_cache(maxsize=None)
def deepest_fuse(kernel: str, r: int) -> int:
    """The deepest fuse one launch of a trapezoid kernel runs at radius r
    (0: none fits).  Cached: every launch asks."""
    smem = trapezoid_smem_bytes if kernel == "stream" else tile_smem_bytes
    deepest = 0
    while (smem(deepest + 1, r) + STATIC_SMEM_BYTES <= MAX_SMEM_BYTES
           and (kernel != "stream" or 2 * (deepest + 1) * r < STREAM_W)):
        deepest += 1
    return deepest


def trapezoid_passes(fuse: int, r: int, kernel: str = "stream") -> list[int]:
    """The steps of each launch a depth-``fuse`` trapezoid runs as: one
    launch while the kernel's shared memory holds the depth, else the
    fewest launches of at most the deepest fuse that fits, as even as they
    go.  Raises for a radius that does not fit even at fuse 1."""
    deepest = deepest_fuse(kernel, r)
    if deepest == 0:
        smem = trapezoid_smem_bytes if kernel == "stream" else tile_smem_bytes
        raise ValueError(
            f"a radius-{r} {kernel} trapezoid needs {smem(1, r)} bytes of "
            f"shared memory at fuse 1, past one CTA's {MAX_SMEM_BYTES}")
    n = -(-fuse // deepest)
    return [fuse // n + (i < fuse % n) for i in range(n)]


def window_mask(spec: StencilSpec) -> int | None:
    """The mask of a table whose taps all lie in the 3x3 window (bit
    3 (dr + 1) + dc + 1 a tap), else None."""
    mask = 0
    for (dr, dc), _ in spec.taps:
        if max(abs(dr), abs(dc)) > 1:
            return None
        mask |= 1 << (3 * (dr + 1) + dc + 1)
    return mask


def regs_patch(spec: StencilSpec, H: int,
               W: int) -> tuple[int, int] | None:
    """The register kernel's patch on an HxW grid: (rows of threads TY, rows
    a thread KC), for a CTA of round_up(ceil(W / 2), 32) x TY threads, each
    holding KC rows of two columns; None where it does not run: a table
    whose mask has no instance, or no KC of REGS_ROWS within
    REGS_MAX_THREADS."""
    if spec.ndim != 2 or window_mask(spec) not in REGS_MASKS:
        return None
    tx = round_up(-(-W // 2), 32)
    for kc in REGS_ROWS:
        ty = -(-H // kc)
        if tx * ty <= REGS_MAX_THREADS:
            return ty, kc
    return None


def cta_patch(H: int, W: int) -> tuple[int, int] | None:
    """The cta kernel's patch on an HxW grid: (rows of threads TY, cells a
    thread KC).  A CTA of round_up(W, 32) x TY threads, as many rows of
    threads as CTA_MAX_THREADS holds and the grid fills, each with the
    column cells TY rows apart, KC a multiple of 8; None past
    CTA_MAX_THREADS columns."""
    tx = round_up(W, 32)
    if tx > CTA_MAX_THREADS:
        return None
    ty = min(H, CTA_MAX_THREADS // tx)
    return ty, round_up(-(-H // ty), CTA_GROUP)


def stream_geometry(W: int, fuse: int,
                    r: int) -> tuple[int, int, int, int]:
    """(strip_w, strips, waves, min_rows) of a stream launch: the fewest
    strips of at most STREAM_W - 2 fuse r output columns, as even as they
    go; the kernel's launcher cuts the rows into as many chunks as
    ``waves`` waves of CTAs hold, each at least ``min_rows`` rows
    (STREAM_WAVES and STREAM_MIN_ROWS: the first below fuse STREAM_U, the
    second from it)."""
    strips = -(-W // (STREAM_W - 2 * fuse * r))
    deep = fuse >= STREAM_U
    return (-(-W // strips), strips, STREAM_WAVES[deep],
            STREAM_MIN_ROWS[deep])


def grid_smem_bytes(r: int) -> int:
    """Shared memory of one grid-wide CTA: its tile with an r-deep halo."""
    th, tw = GRID_TILE
    return (th + 2 * r) * (tw + 2 * r) * 4


def kernel_for(rim: str, spec: StencilSpec, fuse: int, B: int, H: int,
               W: int) -> str:
    """The kernel a launch of B HxW grids of ``spec`` takes by shape
    (KERNELS' names).  A resident grid goes to the register kernel where
    its patch covers the grid (``regs_patch``), else to the cta kernel where
    the grid fits one CTA, else to the grid-wide kernel.  A trapezoid goes
    to the register kernel where it runs, and otherwise to the stream
    kernel where it was faster than the tile kernel on the H100
    (tests/_torch_jacobi_sweep.py, PERF.md): below fuse STREAM_U from
    STREAM_MIN_CELLS[fuse] cells a launch; at a pass depth T of STREAM_U
    to 2 STREAM_U always; deeper where the grid's rows are at least 8
    times a pass's fill of T (2r + 1) rows; else, and wherever the stream
    kernel alone fits the radius, to the one that can run."""
    r = spec.radius
    if regs_patch(spec, H, W):
        return "resident_regs"
    if rim == "resident":
        if resident_cta_fits((H, W), r) and cta_patch(H, W):
            return "resident_cta"
        return "resident_grid"
    if not deepest_fuse("tile", r):
        return "stream"
    if fuse < STREAM_U:
        wide = B * H * W >= STREAM_MIN_CELLS[fuse]
    else:
        depth = max(trapezoid_passes(fuse, r))
        wide = depth <= 2 * STREAM_U or H >= 8 * depth * (2 * r + 1)
    return "stream" if wide else "tile"


def _check_geometry(H: int, W: int, fuse: int, r: int, rim: str) -> None:
    """Raise on a schedule the kernels cannot run: a resident grid where the
    JAX package raises, a trapezoid radius no kernel's shared memory holds
    at fuse 1."""
    if rim not in RIMS:
        raise ValueError(f"unknown rim strategy {rim!r} "
                         f"(expected 'trapezoid' or 'resident')")
    if fuse < 1:
        raise ValueError("fuse must be >= 1")
    if rim == "resident":
        if not resident_fits((H, W)):
            raise ValueError(
                f"rim='resident' needs the whole {H}x{W} grid in one VMEM "
                f"block (round_up(H, 8) * round_up(W, 128) * 4 bytes <= "
                f"{RESIDENT_VMEM_BYTES}, the JAX package's limit); use "
                f"rim='trapezoid' for grids this large")
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
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(_build.Taps), ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def _plan(kernel: str, fuse: int, spec: StencilSpec, H: int,
          W: int) -> tuple[list[int], tuple[int, int, int, int], int]:
    """(steps of each launch, geometry p0..p3, dynamic shared memory) of
    ``kernel`` on an HxW grid of ``spec``; raises where it cannot run."""
    r = spec.radius
    if kernel in STREAM_KERNELS or kernel == "tile":
        passes = trapezoid_passes(fuse, r, "tile" if kernel == "tile"
                                  else "stream")
        if kernel == "tile":
            return passes, (*TILE, 0, 0), tile_smem_bytes(max(passes), r)
        geom = stream_geometry(W, max(passes), r)
        return passes, geom, trapezoid_smem_bytes(max(passes), r)
    if kernel == "resident_grid":
        if grid_smem_bytes(r) + STATIC_SMEM_BYTES > MAX_SMEM_BYTES:
            raise ValueError(f"the grid-wide resident kernel's tile needs "
                             f"{grid_smem_bytes(r)} bytes of shared memory "
                             f"at radius {r}, past one CTA's {MAX_SMEM_BYTES}")
        return [fuse], (0, 0, 0, 0), grid_smem_bytes(r)
    if kernel == "resident_regs":
        patch = regs_patch(spec, H, W)
        if patch is None:
            raise ValueError(
                f"resident_regs takes no patch of a {H}x{W} grid of this "
                f"table (the 3x3 masks {[hex(m) for m in REGS_MASKS]}, at "
                f"most {REGS_MAX_THREADS} threads of {max(REGS_ROWS)}x2 "
                f"cells)")
        return [fuse], (*patch, 0, 0), 0   # the kernel sizes its own
    if not resident_cta_fits((H, W), r):
        raise ValueError(
            f"{kernel} needs the whole {H}x{W} grid in one CTA's shared "
            f"memory ({resident_smem_bytes((H, W), r)} bytes > "
            f"{MAX_SMEM_BYTES})")
    geom = (0, 0, 0, 0)
    if kernel == "resident_cta":
        patch = cta_patch(H, W)
        if patch is None:
            raise ValueError(f"resident_cta takes no patch of a {H}x{W} "
                             f"grid (at most {CTA_MAX_THREADS} columns)")
        geom = (*patch, 0, 0)
    return [fuse], geom, resident_smem_bytes((H, W), r)


def jacobi2d_fused_step(x: torch.Tensor, spec: StencilSpec, *, fuse: int,
                        bc_value: float | None = None,
                        rim: str = "trapezoid",
                        fields: torch.Tensor | None = None,
                        kernel: str | None = None) -> torch.Tensor:
    """``fuse`` Jacobi steps in one kernel pass.  x: (batch, H, W).

    With bc_value=None computes ``fuse`` raw zero-padded stencil steps.
    ``rim`` selects the geometry; "resident" takes the grids the JAX
    package takes (``tiling.resident_fits``); "trapezoid" takes any fuse,
    in several launches where its rings do not fit one CTA
    (``trapezoid_passes``).  ``fields`` overrides a variable spec's baked
    per-cell weights with a (V, H, W) stack.  ``kernel`` (one of KERNELS,
    CUDA only) asks for a kernel by name; by default ``kernel_for`` picks
    it by shape.
    """
    if kernel is not None and kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {list(KERNELS)}, got "
                         f"{kernel!r}")
    H, W = x.shape[-2:]
    _check_geometry(H, W, fuse, spec.radius, rim)
    with kernel_cost(0.0, stencil_bytes(x, spec)):
        if x.device.type == "cpu":
            if kernel is not None:
                raise ValueError("kernel names a CUDA kernel; x is on the "
                                 "cpu")
            return jacobi2d_fused_plain(x, spec, fuse=fuse,
                                        bc_value=bc_value, fields=fields)
        if x.device.type == "meta":
            check_operands(x, spec, meta_fields(fields))
            check_launch(*x.shape)
            _plan(kernel or kernel_for(rim, spec, fuse, x.shape[0], H, W),
                  fuse, spec, H, W)
            return torch.empty_like(x)
        if x.device.type != "cuda":
            raise ValueError(f"jacobi2d_fused_step runs on cpu, cuda or "
                             f"meta, not {x.device}")
        return _launch(x, spec, fuse, bc_value, rim, fields, kernel)


def _launch(x: torch.Tensor, spec: StencilSpec, fuse: int, bc_value, rim,
            fields, kernel):
    """K2 or K3 on a CUDA tensor: every pass of the schedule."""
    H, W = x.shape[-2:]
    fields = resolve_fields(spec, fields, x.device)
    check_operands(x, spec, fields)
    if not x.is_contiguous() or (fields is not None
                                 and not fields.is_contiguous()):
        raise ValueError("jacobi2d_fused_step needs contiguous x and fields")
    check_launch(*x.shape)
    B = x.shape[0]
    r = spec.radius
    if kernel is None:
        kernel = kernel_for(rim, spec, fuse, B, H, W)
    slices = _build.batch_slices(B)
    passes, geom, smem = _plan(kernel, fuse, spec, H, W)
    taps = _build.tap_table(spec)
    big = _build.big_taps(spec, x.device)
    lib, fn = _launcher()
    out = torch.empty_like(x)
    # Between passes the grid stays fp32, in two scratch buffers taken in
    # turn: x -> s0 -> s1 -> s0 ... -> out.  The grid-wide kernel keeps its
    # T steps' two fp32 grids in one buffer of its own, and its barrier's
    # counter, zeroed, in another.
    scratch = [torch.empty(x.shape, dtype=torch.float32, device=x.device)
               for _ in range(min(len(passes) - 1, 2))]
    grid_buf = bar = None
    if kernel == "resident_grid":
        if fuse > 1:
            grid_buf = torch.empty((2, slices[0][1], H, W),
                                   dtype=torch.float32, device=x.device)
        bar = torch.zeros(len(slices), dtype=torch.int64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    src = x
    for i, steps in enumerate(passes):
        dst = out if i == len(passes) - 1 else scratch[i % 2]
        for n, (b0, nb) in enumerate(slices):
            rc = fn(KERNELS[kernel], src[b0].data_ptr(),
                    fields.data_ptr() if fields is not None else None,
                    dst[b0].data_ptr(),
                    grid_buf.data_ptr() if grid_buf is not None else None,
                    bar[n:].data_ptr() if bar is not None else None, nb, H,
                    W, *geom, _build.DTYPE_CODES[src.dtype],
                    _build.DTYPE_CODES[dst.dtype], ctypes.byref(taps),
                    big.data_ptr() if big is not None else None, r, steps,
                    int(bc_value is not None),
                    0.0 if bc_value is None else bc_value, smem, stream)
            _build.check(lib, rc, f"jacobi2d_fused_step({kernel})")
            _build.LAUNCHES[COUNTERS[kernel]] += 1
        src = dst
    return out
