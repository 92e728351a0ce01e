"""Iterative solver engine — the paper's time loop, run to convergence.

The paper's headline numbers are not one stencil application but a whole
Jacobi *solve* run to convergence (Table 1): thousands of timesteps with the
residual checked only periodically.  ``solve(spec, x0, ...)`` lowers the spec
through any ``make_plan`` backend and runs the loop:

  * the plan executes ``check_every`` stencil iterations per chunk (the hot
    loop — for the kernel backends, ``fuse`` iterations per kernel pass);
  * after each chunk the residual ``||x_{k+1} - x_k||`` (L2 or Linf, the
    paper's Jacobi criterion) is measured on the device;
  * the host syncs once per chunk (``active.any().item()``) to decide
    whether to run another.

The JAX package runs this loop as one ``lax.while_loop``; PyTorch has no
counterpart, so the chunk loop is Python with one host sync per chunk, and
the state it carries is the JAX loop's exactly.  Capturing the chunk in a
CUDA graph would remove its launch overhead; that is later work.

Batched mode is native: ``x0`` may carry a leading instance axis and
convergence is tracked *per instance*: an instance that converges is frozen
(its field stops updating, its history records NaN) while the rest keep
iterating, so a batched solve reproduces the per-instance results of
solving each problem alone.

Distribution rides the same entry point: ``backend="halo"`` with a tile
mesh (``parallel/halo.py::make_mesh``) runs each chunk as the halo-exchange
program of ``core/distributed.py``, and the residuals are computed on the
gathered global field.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import autotune
from repro_torch.core.boundary import BoundaryMode, DirichletBC
from repro_torch.core.plan import (
    DEVICE_PROFILES,
    KERNEL_BACKENDS,
    StencilPlan,
    _mesh_tiling,
    choose_backend,
    estimate_seconds,
    make_plan,
    resolve_device,
)
from repro_torch.core.stencil import StencilSpec

_FUSE_CANDIDATES = (16, 8, 4, 2, 1)
_DEFAULT_CHECK_EVERY = 16


def _any(active: torch.Tensor) -> bool:
    """Whether an instance is still iterating; on ``meta``, which holds no
    values, always: a dry run counts every chunk of ``max_iters``."""
    flag = active.any()
    return flag.device.type == "meta" or bool(flag.item())


@dataclasses.dataclass
class SolveResult:
    """Outcome of one :meth:`Solver.solve` call.

    For an unbatched ``x0`` (bare grid) the per-instance fields are Python
    scalars; for a batched ``x0`` they are numpy arrays over the instances.

    Attributes:
      x: final field, same shape as ``x0``, on the solver's device.
      iterations: stencil iterations actually run (a multiple of
        ``check_every``; frozen instances stop counting when they converge).
      converged: whether the residual criterion was met before ``max_iters``.
      residual: last measured residual (absolute update norm).
      residual_history: one row per executed chunk; entry ``k`` is the
        residual measured after chunk ``k`` (NaN for instances already
        frozen).  Empty for fixed-iteration solves.
      backend/fuse/check_every: what actually ran.
      wall_seconds: wall time of the solve call, ending in a device sync.
      est_seconds: the roofline model's estimate for the iterations run.
      costs: per-backend cost table when ``backend="auto"`` chose.
    """

    x: torch.Tensor
    iterations: int | np.ndarray
    converged: bool | np.ndarray
    residual: float | np.ndarray
    residual_history: np.ndarray
    backend: str
    fuse: int
    check_every: int
    wall_seconds: float
    est_seconds: float
    costs: dict[str, float]


def select_fuse(backend: str, spec: StencilSpec, grid_shape: tuple[int, ...],
                check_every: int, device_kind: str = "cuda", tuned="default",
                dtype=torch.float32, mesh=None) -> int | None:
    """Temporal fuse depth for one chunk: measured if tuned, else roofline.

    The 2D kernel paths and ``halo`` fuse; every other backend gets
    ``None`` (the plan records fuse=1).  A tuned-table entry for this cell
    on this device whose backend matches supplies the measured depth first
    (clamped to the largest divisor of ``check_every`` so chunk boundaries
    land on whole fused passes); the roofline prices the candidate depths
    otherwise.

    For ``halo`` the depth is also clamped to what the local tile can host
    (``max_halo_fuse``) on the (n_row, n_col) tiling of ``mesh``, tuned
    entries are matched mesh-exactly, and the roofline prices the
    communication term each depth divides.
    """
    halo = backend == "halo" and spec.ndim == 2
    if not halo and (backend not in KERNEL_BACKENDS or spec.ndim != 2):
        return None
    mesh_shape = deepest = None
    if halo:
        from repro_torch.core.distributed import max_halo_fuse
        mesh_shape = _mesh_tiling(mesh) if mesh is not None else None
        n_row, n_col = mesh_shape or (1, 1)
        if grid_shape[0] % n_row or grid_shape[1] % n_col:
            return None
        deepest = max_halo_fuse(spec.radius, grid_shape[0] // n_row,
                                grid_shape[1] // n_col)
    entry = autotune.lookup_entry(tuned, spec, grid_shape, dtype,
                                  device_kind, mesh_shape=mesh_shape)
    if entry is not None and entry.backend == backend and entry.fuse >= 1:
        f = min(entry.fuse, check_every)
        if deepest is not None:
            f = min(f, deepest)
        while check_every % f:
            f -= 1
        return f
    device = DEVICE_PROFILES[device_kind]
    candidates = [f for f in _FUSE_CANDIDATES if check_every % f == 0
                  and (deepest is None or f <= deepest)]
    return min(candidates,
               key=lambda f: estimate_seconds(backend, spec, grid_shape,
                                              check_every, device, fuse=f,
                                              mesh_shape=mesh_shape))


class Solver:
    """A prepared run-to-convergence executor for one (spec, grid, backend).

    Construction does all one-time work — backend choice, fuse-depth
    selection, plan building; repeated solves (parameter sweeps, batched
    workloads) pay only execution.

    Convergence: an instance is converged when

        ||x_{k+1} - x_k||  <=  atol + rtol * ||x_{k+1}||

    in the chosen norm (``"l2"`` or ``"linf"``), checked every
    ``check_every`` iterations.  ``rtol=None, atol=None`` disables checking
    entirely: the solve runs exactly ``max_iters`` iterations as one chunk
    (the benchmark / fixed-step mode).  ``device=None`` means the card.
    ``mesh`` is the tile mesh of ``backend="halo"`` (its tiles on
    ``device``'s type; see ``core.plan.make_plan``).  ``tuned`` names the measured table (core/autotune.py) that prices
    ``backend="auto"`` and the fuse depth and rim strategy before the
    roofline: "default" (the committed one), a ``TunedTable``, or None.
    """

    def __init__(
        self,
        spec: StencilSpec,
        grid_shape: tuple[int, ...],
        *,
        backend: str = "auto",
        bc: DirichletBC | float | None = 0.0,
        mode: BoundaryMode = BoundaryMode.MASK,
        rtol: float | None = 1e-5,
        atol: float | None = 0.0,
        norm: str = "l2",
        check_every: int | None = None,
        # iteration budget; the loop runs floor(max_iters / check_every)
        # whole chunks, so the budget rounds DOWN to a multiple of
        # check_every (a convergent solve never exceeds max_iters)
        max_iters: int = 10_000,
        fuse: int | None = None,
        dtype=torch.float32,
        device=None,
        tuned="default",
        mesh=None,
    ):
        if norm not in ("l2", "linf"):
            raise ValueError(f"norm must be 'l2' or 'linf', got {norm!r}")
        if max_iters < 1:
            raise ValueError("max_iters must be >= 1")
        if check_every is not None and check_every < 1:
            raise ValueError("check_every must be >= 1")
        self.spec = spec
        self.grid_shape = tuple(grid_shape)
        self.mode = mode
        self.norm = norm
        self.fixed = rtol is None and atol is None
        self.rtol = 0.0 if rtol is None else float(rtol)
        self.atol = 0.0 if atol is None else float(atol)
        if not self.fixed and self.rtol <= 0.0 and self.atol <= 0.0:
            raise ValueError(
                "unsatisfiable convergence criterion (rtol and atol both "
                "zero/None): set one > 0, or pass rtol=None, atol=None for "
                "fixed-iteration mode")
        self.max_iters = int(max_iters)
        self.dtype = dtype
        self.device = resolve_device(device)
        kind = self.device.type

        if self.fixed:
            # One chunk of exactly max_iters iterations; no residual pass.
            self.check_every = self.max_iters
        else:
            self.check_every = (min(_DEFAULT_CHECK_EVERY, self.max_iters)
                                if check_every is None
                                else min(int(check_every), self.max_iters))
        self.n_chunks = max(1, self.max_iters // self.check_every)

        self.costs: dict[str, float] = {}
        was_auto = backend == "auto"
        if was_auto:
            # Price the whole solve (max_iters), not one chunk, at a fuse
            # depth a check_every-sized chunk can actually run.
            pricing_fuse = fuse
            if pricing_fuse is None:
                pricing_fuse = select_fuse("cuda_fused", spec,
                                           self.grid_shape, self.check_every,
                                           kind, tuned=tuned, dtype=dtype)
            backend, self.costs = choose_backend(
                spec, self.grid_shape, mode=mode, bc=bc,
                iters=self.max_iters, device_kind=kind, mesh=mesh,
                fuse=pricing_fuse, dtype=dtype, tuned=tuned)
        if fuse is None:
            fuse = select_fuse(backend, spec, self.grid_shape,
                               self.check_every, kind, tuned=tuned,
                               dtype=dtype, mesh=mesh)
        self.mesh_shape = _mesh_tiling(mesh) if mesh is not None else None
        # A measured entry for this cell carries the rim strategy beside the
        # fuse depth select_fuse already took from it.
        entry = autotune.lookup_entry(tuned, spec, self.grid_shape, dtype,
                                      self.device,
                                      mesh_shape=self.mesh_shape)
        tuned_hit = entry is not None and entry.backend == backend
        # (an explicit fuse that does not divide check_every is rejected by
        # make_plan's iters/fuse divisibility check)
        self.plan: StencilPlan = make_plan(
            spec, self.grid_shape, backend=backend, bc=bc, mode=mode,
            iters=self.check_every, fuse=fuse, dtype=dtype,
            device=self.device, rim=entry.rim if tuned_hit else None,
            tuned=tuned, mesh=mesh)
        if was_auto:
            # The solver resolved "auto" itself (to price the whole solve),
            # so the plan saw an explicit backend name: restore where the
            # choice came from.
            self.plan.source = "tuned" if tuned_hit else "roofline"
        self.backend = self.plan.backend
        self.fuse = self.plan.fuse

    def _norm(self, v: torch.Tensor) -> torch.Tensor:
        # Accumulated in float64: a device reduces a batch of grids in
        # another order than a lone grid, and an fp32 norm would carry that
        # order into the convergence decision.  In float64 a batched solve
        # decides each instance as a lone solve does.
        return torch.linalg.vector_norm(
            v, ord=float("inf") if self.norm == "linf" else 2,
            dim=tuple(range(1, v.ndim)), dtype=torch.float64)

    def _loop(self, x0, fields, source, bc_value):
        """The chunked convergence loop; returns the JAX loop's final state
        (chunks run, x, active, res, iters, hist)."""
        plan, ce = self.plan, self.check_every
        b, dev = x0.shape[0], x0.device
        x = x0
        active = torch.ones((b,), dtype=torch.bool, device=dev)
        res = torch.full((b,), float("inf"), dtype=torch.float32, device=dev)
        iters = torch.zeros((b,), dtype=torch.int64, device=dev)
        hist = torch.full((self.n_chunks, b), float("nan"),
                          dtype=torch.float32, device=dev)
        nan = torch.tensor(float("nan"), device=dev)
        k = 0
        # One host sync per chunk: the loop condition.
        while k < self.n_chunks and _any(active):
            y = plan(x, fields=fields, source=source, bc_value=bc_value)
            err = self._norm(y - x)
            done = err <= self.atol + self.rtol * self._norm(y)
            keep = active.reshape((b,) + (1,) * (x.ndim - 1))
            x = torch.where(keep, y, x)              # frozen instances hold
            err = err.float()
            res = torch.where(active, err, res)
            hist[k] = torch.where(active, err, nan)
            iters += active.long() * ce
            active = active & ~done
            k += 1
        return k, x, active, res, iters, hist

    def _batched(self, x0) -> tuple[torch.Tensor, bool]:
        """x0 on the solver's device as (batch, *grid), and whether it came
        as a bare grid."""
        x0 = torch.as_tensor(x0, device=self.device).to(self.dtype)
        squeeze = x0.ndim == self.spec.ndim
        if squeeze:
            x0 = x0[None]
        if tuple(x0.shape[1:]) != self.grid_shape:
            raise ValueError(
                f"solver built for grid {self.grid_shape}, got "
                f"{tuple(x0.shape[1:])}")
        return x0, squeeze

    def run(self, x0, *, fields=None, source=None, bc_value=None):
        """``(x, iterations, converged, residual)`` as device tensors: the
        core of :meth:`solve` without the host copies, history or timing
        (the JAX package's trace-safe ``run``)."""
        x0, squeeze = self._batched(x0)
        b, dev = x0.shape[0], x0.device
        if self.fixed:
            x = self.plan(x0, fields=fields, source=source, bc_value=bc_value)
            iters = torch.full((b,), self.max_iters, dtype=torch.int64,
                               device=dev)
            converged = torch.zeros((b,), dtype=torch.bool, device=dev)
            res = torch.full((b,), float("nan"), device=dev)
        else:
            _, x, active, res, iters, _ = self._loop(
                x0, fields, source, bc_value)
            converged = ~active
        if squeeze:
            return x[0], iters[0], converged[0], res[0]
        return x, iters, converged, res

    def solve(self, x0, *, fields=None, source=None,
              bc_value=None) -> SolveResult:
        """Run the time loop from ``x0`` ((batch, *grid) or bare (*grid), a
        tensor or an array; moved to the solver's device)."""
        x0, squeeze = self._batched(x0)
        b = x0.shape[0]

        t0 = time.perf_counter()
        if self.fixed:
            x = self.plan(x0, fields=fields, source=source, bc_value=bc_value)
            self._sync()
            wall = time.perf_counter() - t0
            iterations = np.full((b,), self.max_iters, np.int64)
            converged = np.zeros((b,), bool)
            residual = np.full((b,), np.nan, np.float32)
            history = np.empty((0, b), np.float32)
        else:
            k, x, active, res, iters, hist = self._loop(
                x0, fields, source, bc_value)
            self._sync()
            wall = time.perf_counter() - t0
            iterations = iters.cpu().numpy()
            converged = ~active.cpu().numpy()
            residual = res.cpu().numpy()
            history = hist[:k].cpu().numpy()

        est = estimate_seconds(
            self.backend, self.spec, self.grid_shape,
            max(int(iterations.max()), 1), DEVICE_PROFILES[self.device.type],
            fuse=self.fuse, mesh_shape=self.mesh_shape)

        if squeeze:
            return SolveResult(
                x=x[0], iterations=int(iterations[0]),
                converged=bool(converged[0]), residual=float(residual[0]),
                residual_history=history[:, 0], backend=self.backend,
                fuse=self.fuse, check_every=self.check_every,
                wall_seconds=wall, est_seconds=est, costs=self.costs)
        return SolveResult(
            x=x, iterations=iterations, converged=converged,
            residual=residual, residual_history=history,
            backend=self.backend, fuse=self.fuse,
            check_every=self.check_every, wall_seconds=wall,
            est_seconds=est, costs=self.costs)

    __call__ = solve

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def solve(
    spec: StencilSpec,
    x0,
    *,
    backend: str = "auto",
    bc: DirichletBC | float | None = 0.0,
    mode: BoundaryMode = BoundaryMode.MASK,
    rtol: float | None = 1e-5,
    atol: float | None = 0.0,
    norm: str = "l2",
    check_every: int | None = None,
    max_iters: int = 10_000,
    fuse: int | None = None,
    device=None,
    fields=None,
    source=None,
    bc_value=None,
    tuned="default",
    mesh=None,
) -> SolveResult:
    """One-shot iterative solve: run ``spec``'s time loop from ``x0``.

    ``x0`` is (batch, *grid) or bare (*grid); see :class:`Solver` for the
    convergence criterion and :class:`SolveResult` for what comes back.
    Build a :class:`Solver` directly to reuse its plan over repeated solves.
    ``fields`` / ``source`` / ``bc_value`` are runtime plan operands
    (per-cell weights, additive source term, Dirichlet value).
    ``backend="halo"`` with a ``mesh`` runs each chunk on the tile mesh.
    """
    dev = resolve_device(device)
    x0 = torch.as_tensor(x0, device=dev)
    if x0.ndim not in (spec.ndim, spec.ndim + 1):
        raise ValueError(
            f"x0.ndim={x0.ndim} incompatible with a {spec.ndim}D spec "
            f"(expect grid or batch+grid)")
    grid_shape = tuple(x0.shape[-spec.ndim:])
    dtype = x0.dtype if x0.is_floating_point() else torch.float32
    solver = Solver(
        spec, grid_shape, backend=backend, bc=bc, mode=mode, rtol=rtol,
        atol=atol, norm=norm, check_every=check_every, max_iters=max_iters,
        fuse=fuse, dtype=dtype, device=dev, tuned=tuned, mesh=mesh)
    return solver.solve(x0, fields=fields, source=source, bc_value=bc_value)
