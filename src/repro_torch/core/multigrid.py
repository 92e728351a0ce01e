"""Geometric multigrid V-cycle composed from the stencil dispatch stack.

The paper's solves are plain Jacobi iteration: thousands of sweeps whose
convergence stalls as the grid grows (the smooth error modes contract like
``1 - O(h^2)``).  Multigrid smooths the high-frequency error on the fine
grid, restricts the residual to a coarser grid where the remaining smooth
error is high-frequency again, recurses, and prolongates the correction back
up.  A V-cycle costs a small constant number of fine-grid-equivalent stencil
sweeps yet contracts *all* error modes by a grid-independent factor.  This
is the JAX package's ``core/multigrid.py``.

Everything is built from the port's own primitives, so the whole hierarchy
rides the dispatcher:

  * smoothing on every level is a 1-iteration :func:`make_plan` of the
    level's spec (any backend, ``backend="auto"`` included; on the card
    ``cuda`` runs K1 in 2D and K4 in 3D);
  * restriction (full weighting) and prolongation (linear interpolation) are
    themselves ``StencilSpec``s (:func:`restriction_spec` /
    :func:`prolongation_spec`) applied through raw (``bc=None``) plans, with
    the even-index sampling / zero-stuffing around them;
  * the coarse-level operator is the re-discretized spec
    (:func:`coarsen_spec`): scalar taps transfer unchanged, per-cell weight
    fields are injected onto the coarse grid.

Formulation.  The engine solves the Jacobi fixed point ``u = S(u)`` with a
Dirichlet shell, exactly like ``core.solver.solve``.  On coarse levels the
plan's BC is 0 and the restricted residual enters as an additive per-cell
source ``g`` (``u <- mask*(S(u) + g) + bc``).  The residual of the Jacobi
form is the ``h^2``-scaled residual of the underlying second-order operator,
so each restriction multiplies it by ``(2h/h)^2 = 4`` before it becomes the
coarse right-hand side.

Red-black Gauss-Seidel (:func:`red_black_step`) is the default smoother:
two masked half-sweeps, each a full stencil application that commits only
one parity class.  For star stencils this is exact Gauss-Seidel.

Work accounting uses *fine-grid work units*: one unit is one stencil sweep
over the finest grid, so a level-``l`` sweep costs ``n_l / n_0`` units and a
plain Jacobi iteration costs exactly 1.

The cycle runs eagerly (PyTorch has no counterpart of the JAX package's
jitted cycle), with one host sync a cycle: the convergence check.  The
parity and interior masks live on the device, built once a level.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.boundary import BoundaryMode, DirichletBC
from repro_torch.core.plan import StencilPlan, make_plan, resolve_device
from repro_torch.core.stencil import StencilSpec, WeightField

# Jacobi-form residuals are h^2-scaled; standard coarsening (mesh ratio 2,
# second-order operator) rescales the coarse right-hand side by ratio^2.
_RHS_SCALE = 4.0

# Damping for the "jacobi" smoother: undamped Jacobi does not damp the
# checkerboard mode at all (its S-eigenvalue is -1); omega = 0.8 is the
# classic smoothing-optimal choice for the 2D 5-point Laplacian.
_JACOBI_OMEGA = 0.8


# ---------------------------------------------------------------------------
# Transfer operators as StencilSpecs
# ---------------------------------------------------------------------------

def restriction_spec(ndim: int) -> StencilSpec:
    """Full-weighting restriction: w(off) = 2^-(ndim + |off|_1) on the 3^ndim
    box.  Apply on the fine grid, then sample every other point."""
    taps = {}
    for idx in np.ndindex(*(3,) * ndim):
        off = tuple(i - 1 for i in idx)
        taps[off] = 2.0 ** -(ndim + sum(abs(o) for o in off))
    return StencilSpec(taps=taps, name=f"restrict{ndim}d")


def prolongation_spec(ndim: int) -> StencilSpec:
    """Linear-interpolation prolongation: w(off) = 2^-|off|_1 on the 3^ndim
    box.  Zero-stuff the coarse values onto the even fine indices, then
    apply on the fine grid.  Equals ``2^ndim`` times the restriction
    stencil."""
    taps = {}
    for idx in np.ndindex(*(3,) * ndim):
        off = tuple(i - 1 for i in idx)
        taps[off] = 2.0 ** -sum(abs(o) for o in off)
    return StencilSpec(taps=taps, name=f"prolong{ndim}d")


def coarse_shape(shape: tuple[int, ...]) -> tuple[int, ...]:
    """Shape of the next-coarser grid: the even-index points, (s+1)//2."""
    return tuple((s + 1) // 2 for s in shape)


def coarsen_spec(spec: StencilSpec) -> StencilSpec:
    """Re-discretize ``spec`` on the next-coarser grid.

    Constant-coefficient taps transfer unchanged (the Jacobi weights of a
    second-order operator are mesh-size free); per-cell weight fields are
    injected: sampled at the even fine indices the coarse points sit on.
    """
    if not spec.is_variable:
        return spec
    sample = (slice(None, None, 2),) * spec.ndim
    taps = {}
    for off, w in spec.taps:
        if isinstance(w, WeightField):
            taps[off] = WeightField(w.array[sample])
        else:
            taps[off] = w
    return StencilSpec(taps=taps, name=f"{spec.name}_coarse")


# ---------------------------------------------------------------------------
# Red-black Gauss-Seidel
# ---------------------------------------------------------------------------

def _parity_mask(shape: tuple[int, ...]) -> np.ndarray:
    """True on the red points: (sum of indices) even."""
    grids = np.indices(shape).sum(axis=0)
    return (grids % 2) == 0


def red_black_step(
    u: torch.Tensor,
    step,
    *,
    g: torch.Tensor | None = None,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """One red-black Gauss-Seidel sweep: two masked half-sweeps.

    ``step`` is any full-grid Jacobi update (e.g. a 1-iteration
    ``StencilPlan``); ``g`` an optional per-cell source added through
    ``mask`` (the interior mask) on coarse multigrid levels.  The red
    half-sweep commits the update on the even-parity points only, then the
    black half-sweep re-applies ``step`` to the half-updated field and
    commits the odd-parity points.  For star stencils red points read only
    black neighbours and vice versa, so this is exact Gauss-Seidel.
    """
    red = torch.as_tensor(_parity_mask(tuple(u.shape)), device=u.device)

    def half(v):
        y = step(v)
        if g is not None:
            y = y + (g if mask is None else mask * g)
        return y

    u = torch.where(red, half(u), u)
    return torch.where(red, u, half(u))


# ---------------------------------------------------------------------------
# The V-cycle engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MGResult:
    """Outcome of one :meth:`Multigrid.solve` call.

    Attributes:
      x: final field, shape ``grid_shape``, on the solver's device.
      cycles: V-cycles executed.
      converged: whether ``||plan(x) - x|| <= atol + rtol*||plan(x)||`` was
        met before ``max_cycles`` (the same criterion ``core.solver`` uses,
        measured with the fine-level 1-iteration plan, summed in fp32 as
        the JAX package sums it).
      residual: last measured residual (absolute update norm).
      residual_history: residual after each cycle, one entry per cycle.
      work_units: total fine-grid-equivalent stencil sweeps spent, the
        Jacobi-comparable cost (one plain Jacobi iteration = 1.0).
      work_per_cycle: work units one V-cycle costs (constant per hierarchy).
      level_shapes: grid shape of every level, finest first.
      backend: backend of the finest-level smoothing plan.
      wall_seconds: wall time of the solve call, ending in a device sync.
    """

    x: torch.Tensor
    cycles: int
    converged: bool
    residual: float
    residual_history: np.ndarray
    work_units: float
    work_per_cycle: float
    level_shapes: tuple[tuple[int, ...], ...]
    backend: str
    wall_seconds: float


class Multigrid:
    """A prepared geometric-multigrid V-cycle solver for one (spec, grid).

    Construction builds the level hierarchy (smoothing plans, transfer
    plans, interior and parity masks) through ``make_plan``, so every level
    rides the dispatcher.

    Arguments mirror :class:`core.solver.Solver` where they overlap:

      spec/grid_shape/bc: the fine-level problem, ``u = S(u)`` with a
        Dirichlet shell (scalar or ``DirichletBC``).
      smoother: ``"rb"`` (red-black Gauss-Seidel, default) or ``"jacobi"``
        (damped, omega=0.8); undamped Jacobi is not a smoother.
      nu_pre/nu_post: smoothing sweeps before/after the coarse correction.
      min_size: stop coarsening once the next level would drop below this
        extent in any dimension; the coarsest level is solved by
        ``coarse_iters`` smoothing sweeps (cheap: the grid is tiny).
      backend: backend for every level's smoothing plan ("auto" prices each
        level separately).
      transfer_backend: backend for the restriction/prolongation plans
        (raw bc=None application; "cuda" runs K2 in 2D and K4 in 3D).
      rtol/atol/norm/max_cycles: convergence control, same criterion as the
        solver engine but checked once per V-cycle.  ``rtol=None,
        atol=None`` runs exactly ``max_cycles`` cycles.
      device: where it runs; None means the card.
    """

    def __init__(
        self,
        spec: StencilSpec,
        grid_shape: tuple[int, ...],
        *,
        bc: DirichletBC | float = 0.0,
        smoother: str = "rb",
        nu_pre: int = 2,
        nu_post: int = 2,
        min_size: int = 5,
        coarse_iters: int = 64,
        backend: str = "auto",
        transfer_backend: str = "reference",
        rtol: float | None = 1e-5,
        atol: float | None = 0.0,
        norm: str = "l2",
        max_cycles: int = 50,
        dtype=torch.float32,
        device=None,
    ):
        if smoother not in ("rb", "jacobi"):
            raise ValueError(f"smoother must be 'rb' or 'jacobi', got "
                             f"{smoother!r}")
        if norm not in ("l2", "linf"):
            raise ValueError(f"norm must be 'l2' or 'linf', got {norm!r}")
        if min(grid_shape) < min_size:
            raise ValueError(
                f"grid {tuple(grid_shape)} is already below min_size="
                f"{min_size}; use core.solver.solve directly")
        if nu_pre < 0 or nu_post < 0 or nu_pre + nu_post == 0:
            raise ValueError("need at least one smoothing sweep per level")
        self.spec = spec
        self.grid_shape = tuple(grid_shape)
        self.bc = bc if isinstance(bc, DirichletBC) else DirichletBC(float(bc))
        self.smoother = smoother
        self.nu_pre, self.nu_post = int(nu_pre), int(nu_post)
        self.coarse_iters = int(coarse_iters)
        self.fixed = rtol is None and atol is None
        self.rtol = 0.0 if rtol is None else float(rtol)
        self.atol = 0.0 if atol is None else float(atol)
        if not self.fixed and self.rtol <= 0.0 and self.atol <= 0.0:
            raise ValueError(
                "unsatisfiable convergence criterion (rtol and atol both "
                "zero/None): set one > 0, or pass rtol=None, atol=None for "
                "fixed-cycle mode")
        self.norm = norm
        self.max_cycles = int(max_cycles)
        self.dtype = dtype
        self.device = dev = resolve_device(device)

        # -- level hierarchy ------------------------------------------------
        shapes = [self.grid_shape]
        while min(coarse_shape(shapes[-1])) >= min_size:
            shapes.append(coarse_shape(shapes[-1]))
        self.level_shapes = tuple(shapes)
        nlev = len(shapes)

        specs = [spec]
        for _ in range(nlev - 1):
            specs.append(coarsen_spec(specs[-1]))

        plan_kw = dict(mode=BoundaryMode.MASK, iters=1, dtype=dtype,
                       device=dev)
        # Smoothing plans: the fine level carries the real BC, coarse levels
        # solve the error equation with a zero shell.
        self.plans: list[StencilPlan] = [
            make_plan(specs[l], shapes[l], backend=backend,
                      bc=self.bc if l == 0 else 0.0, **plan_kw)
            for l in range(nlev)
        ]
        # Transfer plans live on the fine grid of each level pair, applied
        # raw (bc=None): zero-pad semantics make restriction/prolongation
        # exact adjoints (up to the 2^ndim stencil scale).
        nd = spec.ndim
        self._restrict_plans = [
            make_plan(restriction_spec(nd), shapes[l], backend=transfer_backend,
                      bc=None, **plan_kw)
            for l in range(nlev - 1)
        ]
        self._prolong_plans = [
            make_plan(prolongation_spec(nd), shapes[l],
                      backend=transfer_backend, bc=None, **plan_kw)
            for l in range(nlev - 1)
        ]
        self._masks = [DirichletBC(0.0).interior_mask(s, dtype, dev)
                       for s in shapes]
        self._reds = [torch.as_tensor(_parity_mask(s), device=dev)
                      for s in shapes]
        self.backend = self.plans[0].backend

        # -- work accounting (fine-grid sweep equivalents) -------------------
        n0 = float(np.prod(self.grid_shape))
        ratio = [float(np.prod(s)) / n0 for s in shapes]
        sweeps = 2.0 if smoother == "rb" else 1.0  # rb = two half-sweeps
        per_cycle = 0.0
        for l in range(nlev - 1):
            per_cycle += ((self.nu_pre + self.nu_post) * sweeps  # smoothing
                          + 1.0      # residual
                          + 2.0      # restriction + prolongation stencils
                          ) * ratio[l]
        per_cycle += self.coarse_iters * sweeps * ratio[-1]
        per_cycle += 1.0  # the per-cycle convergence-check application
        self.work_per_cycle = per_cycle

    # -- building blocks ----------------------------------------------------

    def _smooth(self, l: int, u: torch.Tensor, g: torch.Tensor | None):
        plan, mask, red = self.plans[l], self._masks[l], self._reds[l]

        def step(v):
            y = plan(v)
            if g is not None:
                y = y + mask * g
            return y

        if self.smoother == "jacobi":
            return (1.0 - _JACOBI_OMEGA) * u + _JACOBI_OMEGA * step(u)
        u = torch.where(red, step(u), u)
        return torch.where(red, u, step(u))

    def _residual(self, l: int, u: torch.Tensor, g: torch.Tensor | None):
        plan, mask = self.plans[l], self._masks[l]
        y = plan(u)
        if g is not None:
            y = y + mask * g
        return mask * (y - u)

    def _restrict(self, l: int, r: torch.Tensor) -> torch.Tensor:
        sample = (slice(None, None, 2),) * self.spec.ndim
        return self._restrict_plans[l](r)[sample]

    def _prolong(self, l: int, e: torch.Tensor) -> torch.Tensor:
        stuff = (slice(None, None, 2),) * self.spec.ndim
        full = torch.zeros(self.level_shapes[l], dtype=e.dtype,
                           device=e.device)
        full[stuff] = e
        return self._prolong_plans[l](full)

    def _vcycle(self, l: int, u: torch.Tensor, g: torch.Tensor | None):
        for _ in range(self.nu_pre):
            u = self._smooth(l, u, g)
        if l == len(self.level_shapes) - 1:
            for _ in range(self.coarse_iters - self.nu_pre):
                u = self._smooth(l, u, g)
            return u
        r = self._residual(l, u, g)
        gc = self._masks[l + 1] * (_RHS_SCALE * self._restrict(l, r))
        ec = self._vcycle(l + 1, torch.zeros(self.level_shapes[l + 1],
                                             dtype=u.dtype, device=u.device),
                          gc)
        u = u + self._masks[l] * self._prolong(l, ec)
        for _ in range(self.nu_post):
            u = self._smooth(l, u, g)
        return u

    def _check(self, u: torch.Tensor) -> torch.Tensor:
        """(||plan(u) - u||, ||plan(u)||) as one device tensor, in fp32 as
        the JAX package sums them."""
        y = self.plans[0](u)

        def gnorm(v):
            v = v.float()
            if self.norm == "linf":
                return v.abs().max()
            return torch.sqrt(torch.sum(v * v))

        return torch.stack((gnorm(y - u), gnorm(y)))

    # -- public API ----------------------------------------------------------

    def solve(self, x0) -> MGResult:
        """Run V-cycles from ``x0`` (bare grid, shape ``grid_shape``; a
        tensor or an array, moved to the solver's device)."""
        x0 = torch.as_tensor(x0, device=self.device).to(self.dtype)
        if tuple(x0.shape) != self.grid_shape:
            raise ValueError(
                f"multigrid built for grid {self.grid_shape}, got "
                f"{tuple(x0.shape)} (batched multigrid is not supported: "
                f"solve instances one at a time)")
        t0 = time.perf_counter()
        u = self.bc.set_boundary(x0, self.spec.ndim)
        history: list[float] = []
        converged = False
        work = 0.0
        residual = float("inf")
        cycles = 0
        for _ in range(self.max_cycles):
            u = self._vcycle(0, u, None)
            cycles += 1
            work += self.work_per_cycle
            # The one host sync a cycle: the convergence decision.
            residual, ref = self._check(u).tolist()
            history.append(residual)
            if not self.fixed and residual <= self.atol + self.rtol * ref:
                converged = True
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        return MGResult(
            x=u, cycles=cycles, converged=converged, residual=residual,
            residual_history=np.asarray(history, np.float32),
            work_units=work, work_per_cycle=self.work_per_cycle,
            level_shapes=self.level_shapes, backend=self.backend,
            wall_seconds=wall)

    __call__ = solve


def multigrid_solve(
    spec: StencilSpec,
    x0,
    *,
    bc: DirichletBC | float = 0.0,
    **kwargs,
) -> MGResult:
    """One-shot multigrid solve of ``u = S(u)`` with a Dirichlet shell.

    ``x0`` is a bare grid; see :class:`Multigrid` for the knobs and
    :class:`MGResult` for what comes back.  Build a :class:`Multigrid`
    directly to amortize hierarchy construction over repeated solves.
    """
    x0 = torch.as_tensor(x0)
    if x0.ndim != spec.ndim:
        raise ValueError(
            f"x0.ndim={x0.ndim} != spec.ndim={spec.ndim} (multigrid takes a "
            f"bare grid; batched solves are not supported)")
    mg = Multigrid(spec, tuple(x0.shape), bc=bc, **kwargs)
    return mg.solve(x0)
