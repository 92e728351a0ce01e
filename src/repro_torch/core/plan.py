"""Unified stencil dispatch — one spec, every encoding, one entry point.

A ``StencilSpec`` + grid shape + boundary condition can be lowered through
any of the port's executable encodings:

  reference      plain shifted-add oracle              (core/reference.py)
  dense          N×N dense-layer matmul, BCs in-matrix (core/dense_encoding.py)
  conv           conv layer; 3D rides Conv2D channels  (core/conv_encoding.py)
  conv3d_native  true Conv3D (what the CS-1 lacked)    (core/conv_encoding.py)
  cuda           direct CUDA stencil kernels           (kernels/stencil2d.py,
                                                        kernels/stencil3d.py,
                                                        kernels/jacobi_fused.py)
  cuda_fused     temporally-blocked CUDA kernel        (kernels/jacobi_fused.py)
  halo           halo exchange on a tile mesh          (core/distributed.py,
                                                        parallel/halo.py)

``cuda``/``cuda_fused`` are the JAX package's ``pallas``/``pallas_fused``.

``backend="auto"`` picks from the measured tuned table (core/autotune.py)
where it holds an entry for the cell on this device, else via a small
analytic cost model: per-point FLOPs for the encoding (core/metrics.py),
bytes streamed per iteration, the device's vector/matmul throughput and
memory bandwidth, and the arithmetic-intensity boost temporal fusion buys.
``backend_support`` answers *which backends are legal* for a (spec, grid,
boundary mode) cell, with a reason when not.

Entry points run on the card: ``device=None`` means ``cuda`` and raises
where there is none.  Pass ``device="cpu"`` to run on the CPU, where the
kernel backends run their plain PyTorch versions.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.boundary import BoundaryMode, DirichletBC, runtime_bc_grids
from repro_torch.core.metrics import encoding_flops_per_point
from repro_torch.core.reference import apply_stencil
from repro_torch.core.stencil import StencilSpec

BACKENDS = (
    "reference",
    "dense",
    "conv",
    "conv3d_native",
    "cuda",
    "cuda_fused",
    "halo",
)

KERNEL_BACKENDS = ("cuda", "cuda_fused")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises where CUDA is asked for and absent:
    an entry point never drops quietly to the CPU.  ``meta`` stands for the
    card in a dry run: plans and solvers choose as they would there, and
    run shapes only (``launch/hlo_cost.py`` counts them)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in DEVICE_PROFILES:
        raise ValueError(f"repro_torch runs on cuda, cpu or meta, not "
                         f"{dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available here; pass device='cpu' to run on the CPU")
    return dev


def resolve_model_device(device=None) -> torch.device:
    """``resolve_device`` for the LM modules, which also take ``meta``: a
    model of shapes only, with no storage, for the dry run
    (``launch/dryrun.py``)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


# ---------------------------------------------------------------------------
# Support matrix
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BackendSupport:
    """Whether a backend can execute a cell, and if not, why not."""

    ok: bool
    reason: str = ""

    def __bool__(self) -> bool:
        return self.ok


def _no(reason: str) -> BackendSupport:
    return BackendSupport(False, reason)


_OK = BackendSupport(True)


def backend_support(
    backend: str,
    spec: StencilSpec,
    *,
    grid_shape: tuple[int, ...] | None = None,
    mode: BoundaryMode = BoundaryMode.MASK,
    bc: DirichletBC | float | None = 0.0,
    mesh=None,
) -> BackendSupport:
    """Is ``backend`` legal for this (spec, grid, mode, bc) cell?

    Returns a BackendSupport whose ``reason`` string is suitable for a test
    skip message — the conformance walk relies on this being exhaustive.
    ``mesh`` (a ``TileMesh`` or a bare (n_row, n_col) tuple) is the tiling
    ``halo`` would run on; None means one tile.
    """
    if backend not in BACKENDS:
        return _no(f"unknown backend {backend!r} (known: {BACKENDS})")
    nd = spec.ndim
    raw = bc is None
    variable = spec.is_variable
    scalar_bc = raw or isinstance(bc, (int, float)) or (
        isinstance(bc, DirichletBC) and isinstance(bc.value, (int, float))
    )

    if variable and grid_shape is not None and \
            spec.weights_shape != tuple(grid_shape):
        return _no(f"spec carries {spec.weights_shape}-shaped weight fields "
                   f"but the grid is {tuple(grid_shape)}")

    if backend == "reference":
        return _OK  # the oracle runs everywhere; mode is a no-op for it

    if backend == "dense":
        if raw:
            return _no("dense encoding folds BCs into identity matrix rows; "
                       "raw (bc=None) zero-pad semantics not expressible")
        if mode is not BoundaryMode.MATRIX:
            return _no("dense encoding applies BCs as identity matrix rows "
                       "(BoundaryMode.MATRIX only)")
        return _OK  # per-cell fields fold into the matrix columns for free

    if backend == "conv":
        if nd == 1:
            return _no("no 1D conv encoding (use dense or reference)")
        if variable and nd == 3:
            return _no("channels-trick Conv2D shares its band weights across "
                       "the X-Y plane; per-cell weight fields not "
                       "expressible (use conv3d_native, dense, or cuda)")
        if nd == 3 and mode is not BoundaryMode.MASK:
            return _no("3D channels-trick conv supports the mask trick only")
        if raw:
            return _no("conv encoding paths bake in the Dirichlet fixup")
        if mode is BoundaryMode.MATRIX:
            return _no("MATRIX mode is the dense encoding's BC scheme")
        if variable and mode is not BoundaryMode.MASK:
            return _no("the variable-coefficient gather trick bakes in the "
                       "mask fixup (BoundaryMode.MASK only)")
        if mode is BoundaryMode.PAD and spec.radius != 1:
            return _no("BoundaryMode.PAD reconstructs the shell only for "
                       "radius-1 stencils")
        return _OK

    if backend == "conv3d_native":
        if nd != 3:
            return _no("conv3d_native is the 3D-only Conv3D path")
        if raw:
            return _no("conv encoding paths bake in the Dirichlet fixup")
        if mode is not BoundaryMode.MASK:
            return _no("conv3d_native supports the mask trick only")
        return _OK  # variable taps ride the gather trick (one-hot channels)

    if backend == "halo":
        if nd != 2:
            return _no("halo-exchange distribution is 2D (distributed.py)")
        if raw:
            return _no("distributed jacobi bakes in the Dirichlet fixup")
        if mode is not BoundaryMode.MASK:
            return _no("distributed jacobi applies BCs via the mask trick")
        if not scalar_bc:
            return _no("distributed jacobi needs a scalar bc_value")
        tiling = _mesh_tiling(mesh)
        if tiling is None:
            return _no("halo distribution needs a mesh with >= 2 axes "
                       "(rows x cols)")
        if grid_shape is not None:
            n_row, n_col = tiling
            if grid_shape[0] % n_row or grid_shape[1] % n_col:
                return _no(f"grid {grid_shape} does not tile over the "
                           f"{n_row}x{n_col} device mesh")
        return _OK

    # cuda / cuda_fused
    if backend == "cuda_fused" and nd != 2:
        return _no("temporal fusion kernel is 2D only (jacobi_fused.py)")
    if nd not in (2, 3):
        return _no(f"no {nd}D CUDA kernel (stencil2d/stencil3d only)")
    if not raw and mode is not BoundaryMode.MASK:
        return _no("CUDA kernels fuse the mask trick in-kernel "
                   "(BoundaryMode.MASK only)")
    if not scalar_bc:
        return _no("CUDA kernels pin the shell to a scalar bc_value; "
                   "array-valued DirichletBC unsupported")
    return _OK


def _halo_fuse_legal(fuse: int, spec: StencilSpec,
                     grid_shape: tuple[int, ...], mesh) -> bool:
    """Whether a depth-``fuse`` halo schedule is executable on this cell:
    the exchanged depth ``radius*fuse`` cannot exceed the local tile extent
    (one exchange phase only reaches the adjacent tile)."""
    tiling = _mesh_tiling(mesh)
    if tiling is None:
        return False
    n_row, n_col = tiling
    if grid_shape[0] % n_row or grid_shape[1] % n_col:
        return False
    from repro_torch.core.distributed import max_halo_fuse
    return fuse <= max_halo_fuse(spec.radius, grid_shape[0] // n_row,
                                 grid_shape[1] // n_col)


def _mesh_tiling(mesh) -> tuple[int, int] | None:
    """(n_row, n_col) of the first two mesh axes; None if the mesh can't
    host a 2D tile decomposition.  Accepts a bare (n_row, n_col) tuple so
    cost-model callers (and tuned-table validation) can price a mesh shape
    without placing tiles."""
    if mesh is None:
        return 1, 1
    if isinstance(mesh, tuple):
        return (int(mesh[0]), int(mesh[1])) if len(mesh) >= 2 else None
    names = mesh.axis_names
    if len(names) < 2:
        return None
    return mesh.shape[names[0]], mesh.shape[names[1]]


# ---------------------------------------------------------------------------
# Cost model for backend="auto"
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Coarse per-device rates the auto cost model prices against."""

    kind: str
    vector_flops: float   # elementwise FLOP/s
    matmul_flops: float   # GEMM FLOP/s at the working precision
    mem_bw: float         # device memory bytes/s
    kernels_native: bool  # False => the kernel backends run plain PyTorch
    collective_bw: float  # bytes/s of a halo edge between tiles
    round_latency: float  # seconds of one halo exchange round


DEVICE_PROFILES = {
    # One CPU core (the JAX package's numbers); the kernel backends run
    # their plain versions there and are priced like interpreted Pallas.
    "cpu": DeviceProfile("cpu", 5e10, 2e11, 5e10, kernels_native=False,
                         collective_bw=1e9, round_latency=2.5e-6),
    # NVIDIA H100 SXM, data-sheet rates: 67 TFLOP/s fp32 outside the tensor
    # cores (fp32 matmul runs there too, TF32 being off) and 3.35 TB/s HBM3;
    # halo edges at NVLink 4's data-sheet 450 GB/s a direction.  A round
    # costs the 16 us a device operation measured on the H100 80GB HBM3 at
    # 700 W (chip_smoke.py's host-bound stencil tiers, PERF.md section 5).
    "cuda": DeviceProfile("cuda", 6.7e13, 6.7e13, 3.35e12,
                          kernels_native=True, collective_bw=4.5e11,
                          round_latency=16e-6),
}
# A dry run prices as the card.
DEVICE_PROFILES["meta"] = DEVICE_PROFILES["cuda"]

# The plain versions re-run every tap as its own PyTorch op — orders of
# magnitude off; the model only needs them to never win on the CPU.
_PLAIN_PENALTY = 1e4


def _resolve_fuse(iters: int) -> int:
    """The fuse depth cuda_fused actually runs at for ``iters`` (the same
    rule make_plan applies)."""
    return next((f for f in (8, 4, 2) if iters % f == 0), 1)


def estimate_seconds(
    backend: str,
    spec: StencilSpec,
    grid_shape: tuple[int, ...],
    iters: int,
    device: DeviceProfile,
    *,
    itemsize: int = 4,
    fuse: int | None = None,
    mesh_shape: tuple[int, int] | None = None,
) -> float:
    """Roofline-style time estimate for ``iters`` applications on one step.

    time = max(compute, memory) per iteration; temporal fusion divides the
    streamed bytes by the fuse depth but pays the trapezoid's rim
    recompute.  ``fuse=None`` prices the depth ``make_plan`` would resolve
    for ``iters``.

    For ``halo`` the model adds a communication term per exchange —
    perimeter bytes over ``collective_bw`` plus four round latencies —
    divided by the fuse depth, with the trapezoid rim recompute scaling the
    local compute.  ``mesh_shape`` is the (n_row, n_col) tiling the
    perimeter is measured against; None prices a 1x1 mesh (per-tile
    compute unchanged, latency floor still paid).
    """
    n = int(np.prod(grid_shape))
    n_var = spec.num_variable_taps
    # Read + write the grid once per iteration; per-cell weight fields add
    # one grid-sized read per varying tap on every streaming backend.
    stream = (2 + n_var) * n * itemsize

    if backend == "dense":
        flops = encoding_flops_per_point(spec, "dense", n_total=n)
        compute = flops * n / device.matmul_flops
        mem = (n * n * itemsize + 2 * n * itemsize) / device.mem_bw
    elif backend in ("conv", "conv3d_native"):
        if spec.is_variable:
            # Gather trick: direct-form MACs for the one-hot conv plus an
            # elementwise multiply + add + reduce per varying tap.
            flops = encoding_flops_per_point(spec, "direct") + 3 * n_var
        elif spec.ndim == 3 and backend == "conv":
            flops = encoding_flops_per_point(spec, "conv3d_channels",
                                             n_total=grid_shape[0])
        else:
            flops = encoding_flops_per_point(spec, "conv")
        compute = flops * n / device.vector_flops
        mem = stream / device.mem_bw
    else:  # reference / cuda / cuda_fused / halo: direct shifted adds
        from repro_torch.kernels.tiling import fuse_redundancy
        flops = encoding_flops_per_point(spec, "direct")
        compute = flops * n / device.vector_flops
        mem = stream / device.mem_bw
        if fuse is None:
            fuse = _resolve_fuse(iters) if backend == "cuda_fused" else 1
        if backend in KERNEL_BACKENDS and fuse > 1 and spec.ndim == 2:
            mem /= fuse  # fuse-depth fewer device-memory round-trips ...
            # ... at the price of recomputing the overlapping block rims
            compute *= fuse_redundancy(grid_shape, fuse, spec.radius)

    if backend == "halo":
        from repro_torch.kernels.tiling import (halo_exchange_bytes,
                                                halo_fuse_redundancy)
        n_row, n_col = mesh_shape or (1, 1)
        local = (grid_shape[0] // max(n_row, 1),
                 grid_shape[1] // max(n_col, 1))
        f = fuse if fuse and fuse > 1 else 1
        # Per-tile compute: each tile owns 1/(n_row*n_col) of the grid but
        # recomputes the trapezoid rim at depth f.
        shard = max(n_row * n_col, 1)
        per_iter = max(compute * halo_fuse_redundancy(local, f, spec.radius),
                       mem) / shard
        # A 1x1 mesh still runs the four (non-wrapping) rounds but moves no
        # neighbour data: latency floor only.
        wire_bytes = halo_exchange_bytes(local, f, spec.radius, itemsize) \
            if shard > 1 else 0
        comm_per_exchange = (wire_bytes / device.collective_bw
                             + 4 * device.round_latency)
        return per_iter * iters + (iters / f) * comm_per_exchange

    total = max(compute, mem) * iters
    if backend in KERNEL_BACKENDS and not device.kernels_native:
        total *= _PLAIN_PENALTY
    return total


def choose_backend(
    spec: StencilSpec,
    grid_shape: tuple[int, ...],
    *,
    mode: BoundaryMode = BoundaryMode.MASK,
    bc: DirichletBC | float | None = 0.0,
    iters: int = 1,
    device_kind: str = "cuda",
    mesh=None,
    fuse: int | None = None,
    dtype=torch.float32,
    tuned="default",
) -> tuple[str, dict[str, float]]:
    """Pick the cheapest supported backend; returns (name, cost table).

    Measured entries take priority over the roofline: when the tuned table
    (``tuned="default"``: the committed ``TUNED_stencil_cuda.json``; pass a
    ``TunedTable`` to override or ``None`` to disable) holds measurements
    for this (device, family, shape-bucket, dtype) cell, the returned cost
    table holds those *measured* per-backend seconds and the pick is their
    argmin; entries measured on the CPU through the plain versions
    (``interpreted``) never count.  When no entry applies the roofline is
    the explicit fallback, and a tie there goes to a kernel backend (on the
    card K4 and native Conv3D move the same bytes; the library call is the
    slower one).  ``reference`` is the cross-validation oracle, so auto only
    falls back to it when no real encoding supports the cell.  ``halo`` is
    a distribution strategy, not a local encoding, so it is only considered
    when a ``mesh`` is passed (a ``TileMesh`` or an (n_row, n_col) tuple).
    ``fuse`` prices the kernel and halo paths at an explicit temporal depth;
    None prices the depth make_plan itself would resolve for ``iters``.
    ``device_kind`` is the device type ("cuda" or "cpu").
    """
    device = DEVICE_PROFILES[device_kind]
    mesh_shape = _mesh_tiling(mesh) if mesh is not None else None

    # -- measured table first ---------------------------------------------
    from repro_torch.core import autotune
    table = autotune.resolve_table(tuned)
    if table is not None and len(table):
        cell = table.lookup_cell(autotune.device_kind(device_kind),
                                 autotune.spec_family(spec),
                                 tuple(grid_shape), autotune.dtype_key(dtype),
                                 mesh_shape=mesh_shape)
        measured: dict[str, float] = {}
        for e in cell:
            if e.interpreted or e.backend in measured and \
                    e.seconds(iters) >= measured[e.backend]:
                continue
            if e.backend == "halo" and mesh is None:
                continue
            if not backend_support(e.backend, spec, grid_shape=grid_shape,
                                   mode=mode, bc=bc, mesh=mesh):
                continue
            measured[e.backend] = e.seconds(iters)
        if measured:
            return min(measured, key=measured.__getitem__), measured

    # -- explicit roofline fallback ---------------------------------------
    costs: dict[str, float] = {}
    for b in BACKENDS:
        if b == "reference" or (b == "halo" and mesh is None) or \
                not backend_support(b, spec, grid_shape=grid_shape,
                                    mode=mode, bc=bc, mesh=mesh):
            continue
        costs[b] = estimate_seconds(
            b, spec, grid_shape, iters, device, fuse=fuse,
            mesh_shape=mesh_shape if b == "halo" else None)
    if not costs:
        # Oracle fallback: always legal, never preferred.
        costs["reference"] = estimate_seconds("reference", spec, grid_shape,
                                              iters, device)
    pick = min(costs, key=lambda b: (costs[b], b not in KERNEL_BACKENDS))
    return pick, costs


# ---------------------------------------------------------------------------
# Plan construction
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StencilPlan:
    """A prepared (batch, *grid) -> (batch, *grid) stencil executor.

    ``make_plan`` does the one-time work (backend choice, dense-matrix
    materialization, constants and baked fields placed on the device) so
    repeated calls pay only the execution.

    Beyond the input field, a plan may accept *runtime operands*:

      fields    (V, *grid) per-cell weight stack overriding the spec's baked
                values (canonical tap order, ``StencilSpec.field_stack``);
      source    additive interior term per iteration ((*grid) or
                (batch, *grid)) — the fixed-point form ``x <- M (S x + s) + g``;
      bc_value  Dirichlet value (scalar or full grid).

    ``operands`` names what this backend/mode combination supports; passing
    an unsupported operand raises.
    """

    spec: StencilSpec
    backend: str
    grid_shape: tuple[int, ...]
    mode: BoundaryMode
    iters: int
    fuse: int
    costs: dict[str, float]
    device: torch.device
    _fn: Callable[..., torch.Tensor]
    # Where the backend choice came from: "explicit" (caller named it),
    # "tuned" (a measured table entry) or "roofline" (the analytic model).
    source: str = "explicit"
    rim: str | None = None
    operands: frozenset = frozenset()

    @property
    def interpreted(self) -> bool:
        """A kernel backend on the CPU: it runs the plain versions (the JAX
        package's interpret mode), so its times are not the kernels'."""
        return self.backend in KERNEL_BACKENDS and \
            not DEVICE_PROFILES[self.device.type].kernels_native

    def __call__(self, x: torch.Tensor, *, fields=None, source=None,
                 bc_value=None) -> torch.Tensor:
        for name, val in (("fields", fields), ("source", source),
                          ("bc_value", bc_value)):
            if val is not None and name not in self.operands:
                sup = ", ".join(sorted(self.operands)) or "none"
                raise ValueError(
                    f"this {self.backend!r} plan takes no runtime {name} "
                    f"operand (supported here: {sup})")
        if fields is not None:
            want = (self.spec.num_variable_taps, *self.grid_shape)
            if tuple(fields.shape) != want:
                raise ValueError(
                    f"fields operand must be shaped {want} (tap-major stack "
                    f"over the variable taps), got {tuple(fields.shape)}")
        if x.device.type != self.device.type:
            raise ValueError(f"plan built for {self.device}, got a tensor "
                             f"on {x.device}")
        squeeze = x.ndim == self.spec.ndim
        if squeeze:
            x = x[None]
        if tuple(x.shape[1:]) != self.grid_shape:
            raise ValueError(
                f"plan built for grid {self.grid_shape}, got "
                f"{tuple(x.shape[1:])}")
        out = self._fn(x, fields, source, bc_value)
        return out[0] if squeeze else out


def _as_bc(bc: DirichletBC | float | None) -> DirichletBC | None:
    if bc is None or isinstance(bc, DirichletBC):
        return bc
    return DirichletBC(float(bc))


def _scalar_bc_value(bc: DirichletBC | None) -> float | None:
    if bc is None:
        return None
    if not isinstance(bc.value, (int, float)):
        raise ValueError("this backend needs a scalar Dirichlet value")
    return float(bc.value)


def _raw_reference(x, spec, iters, fields=None):
    for _ in range(iters):
        x = apply_stencil(x, spec, fields)
    return x


def _bc_reference(x, spec, bc, iters, fields=None, source=None,
                  bc_value=None, dtype=torch.float32):
    # Same math as jacobi_reference, batched; runtime operands ride the
    # mask-trick form directly: x <- mask * (S x + source) + bc_grid.
    grid = tuple(x.shape[1:])
    if bc_value is None:
        mask = bc.interior_mask(grid, dtype, x.device)
        bcg = bc.bc_grid(grid, dtype, x.device)
    else:
        mask, bcg = runtime_bc_grids(grid, bc_value, dtype, x.device)
    s = None if source is None else \
        torch.as_tensor(source, device=x.device).to(dtype)
    x = x * mask + bcg
    for _ in range(iters):
        y = apply_stencil(x, spec, fields)
        if s is not None:
            y = y + s
        x = y * mask + bcg
    return x


def make_plan(
    spec: StencilSpec,
    grid_shape: tuple[int, ...],
    *,
    backend: str = "auto",
    bc: DirichletBC | float | None = 0.0,
    mode: BoundaryMode = BoundaryMode.MASK,
    iters: int = 1,
    fuse: int | None = None,
    dtype=torch.float32,
    device=None,
    rim: str | None = None,
    tuned="default",
    mesh=None,
) -> StencilPlan:
    """Lower ``spec`` on ``grid_shape`` through one backend into a callable.

    backend="auto" routes through :func:`choose_backend`: a measured
    tuned-table entry (``tuned``) for this device supplies the whole
    schedule (backend, fuse depth, rim strategy) when one applies; the
    roofline is the fallback.  ``bc=None`` means raw zero-padded stencil
    application (no Dirichlet fixup) — only the reference and kernel
    backends can express it.  ``fuse`` and ``rim`` set the 2D kernel schedule: the fuse
    depth (iterations per pass) and the fusion geometry ("trapezoid" or
    "resident"; "resident" with no fuse runs all ``iters`` in one pass).
    ``device=None`` means the card.  ``mesh`` is the ``TileMesh``
    (``parallel/halo.py``) the ``halo`` backend splits the grid over, its
    tiles on ``device``'s type; None means one tile on ``device``.  For
    ``halo``, ``fuse`` is the deep-halo depth (one exchange per ``fuse``
    local iterations).
    """
    grid_shape = tuple(int(g) for g in grid_shape)
    if spec.ndim != len(grid_shape):
        raise ValueError(f"spec is {spec.ndim}D but grid is {len(grid_shape)}D")
    if spec.is_variable and spec.weights_shape != grid_shape:
        raise ValueError(
            f"spec carries {spec.weights_shape}-shaped weight fields but the "
            f"grid is {grid_shape}")
    if iters < 1:
        raise ValueError("iters must be >= 1")
    dev = resolve_device(device)
    bc = _as_bc(bc)

    costs: dict[str, float] = {}
    source = "explicit"
    if backend == "auto":
        backend, costs = choose_backend(spec, grid_shape, mode=mode, bc=bc,
                                        iters=iters, device_kind=dev.type,
                                        mesh=mesh, dtype=dtype, tuned=tuned)
        source = "roofline"
        # A measured entry carries the whole schedule, not just the backend:
        # inherit its fuse depth and rim strategy where the caller left them
        # open.
        from repro_torch.core import autotune
        entry = autotune.lookup_entry(
            tuned, spec, grid_shape, dtype, dev,
            mesh_shape=_mesh_tiling(mesh) if mesh is not None else None)
        if entry is not None and entry.backend == backend:
            source = "tuned"
            if fuse is None and entry.fuse > 1 and iters % entry.fuse == 0 \
                    and (backend != "halo"
                         or _halo_fuse_legal(entry.fuse, spec, grid_shape,
                                             mesh)):
                fuse = entry.fuse
            if rim is None:
                rim = entry.rim
    sup = backend_support(backend, spec, grid_shape=grid_shape, mode=mode,
                          bc=bc, mesh=mesh)
    if not sup:
        raise ValueError(f"backend {backend!r} unsupported here: {sup.reason}")

    # ``fuse`` is a hint for the 2D kernel paths (both scalar-bc and raw
    # execute in fuse-sized passes) and for halo (one deep-halo exchange per
    # ``fuse`` local iterations); every other backend, and the 3D kernel,
    # ignores it and the plan records fuse=1 so its metadata reflects what
    # actually runs.
    if backend == "halo":
        rim = None  # depth-vs-tile legality is make_halo_runner's check
        if fuse is None:
            fuse = 1
        elif iters % fuse:
            raise ValueError(f"iters={iters} not divisible by fuse={fuse}")
    elif backend not in KERNEL_BACKENDS or spec.ndim != 2:
        fuse, rim = 1, None
    else:
        if fuse is None:
            if rim == "resident":
                fuse = iters  # the whole chunk stays resident on chip
            else:
                fuse = _resolve_fuse(iters) if backend == "cuda_fused" else 1
        elif iters % fuse:
            raise ValueError(f"iters={iters} not divisible by fuse={fuse}")
        if rim is None and fuse > 1:
            rim = "trapezoid"
        if rim not in (None, "trapezoid", "resident"):
            raise ValueError(f"unknown rim strategy {rim!r} "
                             f"(expected 'trapezoid' or 'resident')")

    fn, operands = _build_fn(spec, grid_shape, backend, bc, mode, iters, fuse,
                             dtype, dev, rim, mesh)
    return StencilPlan(spec=spec, backend=backend, grid_shape=grid_shape,
                       mode=mode, iters=iters, fuse=fuse, costs=costs,
                       device=dev, _fn=fn, source=source, rim=rim,
                       operands=operands)


def _build_fn(spec, grid_shape, backend, bc, mode, iters, fuse, dtype, dev,
              rim, mesh=None):
    """One closure per backend; all share (batch, *grid) -> same semantics.

    Returns ``(fn, operands)``: ``fn(x, fields, source, bc_value)`` and the
    frozenset of runtime-operand names this cell supports (see StencilPlan).
    Baked per-cell fields go to the device once, here.
    """
    var_ops = frozenset(("fields",)) if spec.is_variable else frozenset()
    baked = None
    if spec.is_variable:
        baked = torch.as_tensor(spec.field_stack(), device=dev)

    def fields_or_baked(fields):
        return baked if fields is None else fields

    if backend == "reference":
        if bc is None:
            return (lambda x, fields, source, bc_value:
                    _raw_reference(x.to(dtype), spec, iters,
                                   fields_or_baked(fields)),
                    var_ops)
        return (lambda x, fields, source, bc_value:
                _bc_reference(x.to(dtype), spec, bc, iters,
                              fields_or_baked(fields), source, bc_value,
                              dtype),
                var_ops | {"source", "bc_value"})

    if backend == "dense":
        from repro_torch.core.dense_encoding import (build_dense_matrix,
                                                     dense_jacobi,
                                                     var_tap_indices)
        matrix = torch.as_tensor(build_dense_matrix(grid_shape, spec),
                                 device=dev).to(dtype)
        if spec.is_variable:
            matrix0 = torch.as_tensor(
                build_dense_matrix(grid_shape, spec, include_variable=False),
                device=dev).to(dtype)
            tap_k, flat_j, flat_i = (torch.as_tensor(a, device=dev)
                                     for a in var_tap_indices(grid_shape,
                                                              spec))
        nvar = spec.num_variable_taps

        def run_dense(x, fields, source, bc_value):
            x = x.to(dtype)
            if bc_value is None:
                x = bc.set_boundary(x, len(grid_shape))
                mask = bc.interior_mask(grid_shape, dtype, dev)
            else:
                mask, bcg = runtime_bc_grids(grid_shape, bc_value, dtype, dev)
                x = x * mask + bcg
            m = matrix
            if fields is not None:
                vals = torch.as_tensor(fields, device=dev).to(dtype)
                vals = vals.reshape(nvar, -1)
                m = matrix0.index_put((flat_j, flat_i), vals[tap_k, flat_i],
                                      accumulate=True)
            drive = None
            if source is not None:
                s = torch.as_tensor(source, device=dev).to(dtype)
                drive = torch.broadcast_to(s * mask, x.shape)
                drive = drive.reshape(x.shape[0], -1)
            return dense_jacobi(x, m, iters, drive)
        return run_dense, var_ops | {"source", "bc_value"}

    if backend in ("conv", "conv3d_native"):
        from repro_torch.core.conv_encoding import (conv_jacobi_2d,
                                                    conv_jacobi_3d_channels,
                                                    conv_jacobi_3d_native,
                                                    conv_var_jacobi)
        if spec.is_variable:
            return (lambda x, fields, source, bc_value:
                    conv_var_jacobi(x, spec, bc, iters, dtype=dtype,
                                    fields=fields_or_baked(fields),
                                    source=source, bc_value=bc_value),
                    frozenset(("fields", "source", "bc_value")))
        if spec.ndim == 3:
            jacobi = conv_jacobi_3d_channels if backend == "conv" \
                else conv_jacobi_3d_native
            return (lambda x, fields, source, bc_value:
                    jacobi(x, spec, bc, iters, dtype=dtype, source=source,
                           bc_value=bc_value),
                    frozenset(("source", "bc_value")))
        ops = frozenset(("source", "bc_value")) \
            if mode is BoundaryMode.MASK else frozenset()
        return (lambda x, fields, source, bc_value:
                conv_jacobi_2d(x, spec, bc, iters, mode, dtype=dtype,
                               source=source, bc_value=bc_value), ops)

    bc_value_s = _scalar_bc_value(bc)
    if backend == "halo":
        from repro_torch.core.distributed import make_halo_runner
        from repro_torch.parallel.halo import make_mesh
        if mesh is None:
            mesh = make_mesh((1, 1), ("halo_row", "halo_col"), devices=dev)
        off = sorted({str(d) for d in mesh.devices if d.type != dev.type})
        if off:
            raise ValueError(f"a plan on {dev} takes a mesh of {dev.type} "
                             f"tiles, not tiles on {', '.join(off)}")
        run = make_halo_runner(
            mesh, spec, H=grid_shape[0], W=grid_shape[1],
            bc_value=bc_value_s, iterations=iters,
            row_axis=mesh.axis_names[0], col_axis=mesh.axis_names[1],
            fuse=fuse)
        return (lambda x, fields, source, bc_value: run(x.to(dtype)),
                frozenset())

    if spec.ndim == 3:
        # K4, one pass per iteration, the baked fields on the device once;
        # as in the JAX package, no runtime operands.
        from repro_torch.kernels import jacobi3d, stencil3d
        if bc_value_s is not None:
            return (lambda x, fields, source, bc_value:
                    jacobi3d(x.to(dtype), spec, bc_value=bc_value_s,
                             iterations=iters, fields=baked),
                    frozenset())

        def run_raw3d(x, fields, source, bc_value):
            x = x.to(dtype)
            for _ in range(iters):
                x = stencil3d(x, spec, fields=baked)
            return x
        return run_raw3d, frozenset()

    # cuda / cuda_fused in 2D (backend_support has ruled out the rest)
    from repro_torch.kernels import jacobi2d, jacobi2d_fused_step, stencil2d
    rim = rim or "trapezoid"
    if bc_value_s is not None:
        return (lambda x, fields, source, bc_value:
                jacobi2d(x.to(dtype), spec, bc_value=bc_value_s,
                         iterations=iters, fuse=fuse, rim=rim,
                         fields=fields_or_baked(fields)),
                var_ops)
    if spec.is_variable:
        def run_raw2d_var(x, fields, source, bc_value):
            x, f = x.to(dtype), fields_or_baked(fields)
            for _ in range(iters):
                x = stencil2d(x, spec, fields=f)
            return x
        return run_raw2d_var, var_ops

    def run_raw2d(x, fields, source, bc_value):
        x = x.to(dtype)
        for _ in range(iters // fuse):
            x = jacobi2d_fused_step(x, spec, fuse=fuse, rim=rim)
        return x
    return run_raw2d, frozenset()


# ---------------------------------------------------------------------------
# One-shot convenience
# ---------------------------------------------------------------------------

def stencil_apply(
    spec: StencilSpec,
    x,
    *,
    backend: str = "auto",
    bc: DirichletBC | float | None = 0.0,
    mode: BoundaryMode = BoundaryMode.MASK,
    iters: int = 1,
    fuse: int | None = None,
    device=None,
    rim: str | None = None,
    mesh=None,
    tuned="default",
) -> torch.Tensor:
    """Apply ``iters`` stencil steps to ``x`` through any backend.

    ``x`` is (batch, *grid) or bare (*grid), a tensor or an array; it is
    moved to ``device`` (None: the card).  Semantics match
    ``jacobi_reference``: the Dirichlet shell is seeded, then each
    iteration applies the stencil and re-pins the shell (``bc=None`` skips
    both and iterates the raw zero-padded operator).  ``mesh`` is the tile
    mesh of ``backend="halo"`` (see :func:`make_plan`).  ``tuned`` is
    the measured table ``auto`` consults first: "default" (the committed
    table), a ``TunedTable``, or None for the roofline alone.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    if x.ndim not in (spec.ndim, spec.ndim + 1):
        raise ValueError(
            f"x.ndim={x.ndim} incompatible with a {spec.ndim}D spec "
            f"(expect grid or batch+grid)")
    grid_shape = tuple(x.shape[-spec.ndim:])
    plan = make_plan(spec, grid_shape, backend=backend, bc=bc, mode=mode,
                     iters=iters, fuse=fuse, dtype=x.dtype, device=dev,
                     rim=rim, mesh=mesh, tuned=tuned)
    return plan(x)
