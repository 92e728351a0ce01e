"""Differentiable solves — the adjoint (reverse) solve as an autograd Function.

The JAX package's ``core/adjoint.py``, where it is a ``custom_vjp``.

``Solver`` runs the fixed-point iteration

    x <- M (S_w x + s) + g

(M = interior mask, S_w = the stencil, s = source, g = Dirichlet shell) in
a chunked loop that autograd could only differentiate by recording every
iteration: O(iterations) memory.  The implicit function theorem says that
is not needed: at a *converged* fixed point x*, the VJP of x* against a
cotangent x̄ is itself a stencil solve with the transposed operator,

    μ = M (S_w^T μ + x̄)          (the adjoint solve)
    λ = x̄ + S_w^T μ              (one raw transposed application)

after which every input gradient is a cheap pointwise expression:

    w̄_k   = Σ_b μ_b ⊙ shift(x*_b, off_k)     (per-cell weight fields)
    s̄     = μ   (summed over batch if the source was shared)
    v̄/ḡ  = λ ⊙ (1 − M)  (boundary value; summed to a scalar if v was)
    x̄0    = 0   (the fixed point forgets its initialisation)

The adjoint solve reuses the *same* solver machinery — transposed spec via
tap reflection, source = x̄, bc = 0, through the shared plan cache — so the
backward pass inherits the forward's backend, convergence criteria and
batching, and memory stays O(1) in the iteration count (only x* and the
operands are saved for the backward pass).

Transposition: with (S_w x)[i] = Σ_k w_k[i] · x[i + off_k] (fields indexed
at the output cell, zero-filled reads — ``reference.apply_stencil``), the
transpose is ⟨S x, u⟩ = ⟨x, S^T u⟩ with

    (S^T u)[j] = Σ_k w_k[j − off_k] · u[j − off_k],

i.e. each tap reflects to offset −off_k and a per-cell field becomes its own
shift by −off_k (zero-filled).  Offset negation is a bijection, so the
transposed spec is again a valid ``StencilSpec``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.boundary import BoundaryMode, DirichletBC
from repro_torch.core.reference import apply_stencil, shift
from repro_torch.core.stencil import StencilSpec, WeightField

# Backends whose plans take the runtime operands the VJP needs (fields /
# source / bc_value) end to end.  The CUDA kernel backends bake the
# Dirichlet value in as a static scalar and take no source operand (as the
# JAX package's Pallas paths), so they can run a forward solve but not host
# the adjoint.
DIFF_BACKENDS = ("reference", "dense", "conv", "conv3d_native")


# ---------------------------------------------------------------------------
# Spec transposition
# ---------------------------------------------------------------------------

def _shift_np(a: np.ndarray, off: tuple[int, ...]) -> np.ndarray:
    """result[i] = a[i + off], zero-filled (numpy twin of reference.shift)."""
    out = np.zeros_like(a)
    src, dst = [], []
    for n, o in zip(a.shape, off):
        if abs(o) >= n:
            return out
        src.append(slice(o, n) if o >= 0 else slice(0, n + o))
        dst.append(slice(0, n - o) if o >= 0 else slice(-o, n))
    out[tuple(dst)] = a[tuple(src)]
    return out


def transpose_spec(spec: StencilSpec) -> StencilSpec:
    """The adjoint operator S^T as a StencilSpec (tap reflection).

    Scalar taps keep their weight at the negated offset; per-cell weight
    fields are shifted by the negated offset (zero-filled) so the field is
    again indexed at the *output* cell.  Transposing twice round-trips.
    """
    taps = []
    for off, w in spec.taps:
        noff = tuple(-o for o in off)
        if isinstance(w, WeightField):
            taps.append((noff, WeightField(_shift_np(w.array, noff))))
        else:
            taps.append((noff, w))
    return StencilSpec(taps=tuple(taps), name=f"{spec.name}^T")


def transpose_fields(spec: StencilSpec, fields: torch.Tensor) -> torch.Tensor:
    """Map a (V, *grid) runtime field stack of ``spec`` onto the canonical
    tap order of ``transpose_spec(spec)`` (differentiable).

    ``StencilSpec`` sorts its taps canonically, so tap k of the transposed
    spec is generally *not* the reflection of tap k of ``spec``; this
    permutes accordingly.
    """
    shifted = {}
    for k, off in enumerate(spec.variable_offsets):
        neg = tuple(-o for o in off)
        shifted[neg] = shift(fields[k], neg)
    t_offs = _transposed_spec(spec).variable_offsets
    return torch.stack([shifted[tuple(off)] for off in t_offs])


# ---------------------------------------------------------------------------
# Cached solver construction
# ---------------------------------------------------------------------------

class _Cfg(NamedTuple):
    """The static settings of one differentiable solve."""
    spec: StencilSpec
    grid_shape: tuple[int, ...]
    backend: str
    rtol: float | None
    atol: float | None
    norm: str
    check_every: int | None
    max_iters: int


@functools.lru_cache(maxsize=512)
def _transposed_spec(spec: StencilSpec) -> StencilSpec:
    return transpose_spec(spec)


def _solver_for(cfg: _Cfg, transposed: bool):
    # Solver construction and reuse ride the shared plan cache: conv and
    # reference solves land on a bucketed entry, so the forward and adjoint
    # solves of one offset family share one solver.
    from repro_torch.core.plan_cache import default_plan_cache
    spec = _transposed_spec(cfg.spec) if transposed else cfg.spec
    mode = (BoundaryMode.MATRIX if cfg.backend == "dense"
            else BoundaryMode.MASK)
    return default_plan_cache().solver(
        spec, cfg.grid_shape, backend=cfg.backend, bc=DirichletBC(0.0),
        mode=mode, rtol=cfg.rtol, atol=cfg.atol, norm=cfg.norm,
        check_every=cfg.check_every, max_iters=cfg.max_iters)


# ---------------------------------------------------------------------------
# The fixed point as an autograd Function
# ---------------------------------------------------------------------------

def _kind(a):
    """(rank, dtype or None) of an operand, None for None: all the backward
    needs of an operand it does not save."""
    if a is None:
        return None
    return np.ndim(a), a.dtype if torch.is_tensor(a) else None


class _SolveFP(torch.autograd.Function):
    """x* of (cfg, fields, source, bc_value, x0), x0 batched; its backward is
    one adjoint solve (module docstring)."""

    @staticmethod
    def forward(ctx, cfg, fields, source, bc_value, x0):
        x, _, _, _ = _solver_for(cfg, False).run(
            x0, fields=fields, source=source, bc_value=bc_value)
        # O(1) residuals: the converged solution and the fields, nothing
        # proportional to the iteration count; of the other operands only
        # their rank and type.
        ctx.cfg = cfg
        ctx.kinds = tuple(map(_kind, (fields, source, bc_value, x0)))
        ctx.save_for_backward(fields if torch.is_tensor(fields) else None, x)
        return x

    @staticmethod
    def backward(ctx, g):
        cfg, spec = ctx.cfg, ctx.cfg.spec
        fields, xstar = ctx.saved_tensors
        k_fields, k_source, k_bc, k_x0 = ctx.kinds
        need_f, need_s, need_bc, need_x0 = ctx.needs_input_grad[1:]
        d_fields = d_source = d_bc = None
        d_x0 = torch.zeros_like(xstar, dtype=k_x0[1]) if need_x0 else None
        if not (need_f or need_s or need_bc):
            return None, d_fields, d_source, d_bc, d_x0

        tfields = None if fields is None else transpose_fields(spec, fields)
        # μ = M (S^T μ + x̄): the same masked fixed-point iteration with the
        # transposed spec, source = cotangent, boundary value 0.
        g = g.to(xstar.dtype)
        mu, _, _, _ = _solver_for(cfg, True).run(
            torch.zeros_like(xstar), fields=tfields, source=g)

        if need_f:
            # w̄_k = Σ_b μ_b ⊙ shift(x*_b, off_k), in the *forward* spec's
            # canonical variable-tap order (the layout of the fields
            # operand).
            d_fields = torch.stack([
                torch.sum(mu * shift(xstar, off), dim=0)
                for off in spec.variable_offsets]).to(k_fields[1])
        if need_s:
            d_source = mu if k_source[0] == xstar.ndim else mu.sum(dim=0)
            d_source = d_source.to(k_source[1])
        if need_bc:
            # λ = x̄ + S^T μ (one raw transposed application; μ is zero on
            # the shell, so the masked and unmasked S^T μ agree inside).
            lam = g + apply_stencil(mu, _transposed_spec(spec), tfields)
            shell = 1.0 - DirichletBC(0.0).interior_mask(
                cfg.grid_shape, xstar.dtype, xstar.device)
            lam_shell = lam * shell
            d_bc = (lam_shell.sum() if k_bc[0] == 0
                    else lam_shell.sum(dim=0)).to(k_bc[1])
        return None, d_fields, d_source, d_bc, d_x0


# ---------------------------------------------------------------------------
# Public entry point
# ---------------------------------------------------------------------------

def _on_device(name: str, a, dev: torch.device):
    """``a`` as a tensor on ``dev``: arrays and numbers are placed there; a
    tensor elsewhere raises (nothing is copied quietly)."""
    if a is None or (not torch.is_tensor(a) and np.ndim(a) == 0):
        return a
    if not torch.is_tensor(a):
        return torch.as_tensor(np.asarray(a), device=dev)
    if a.device.type != dev.type or dev.index not in (None,
                                                      a.device.index):
        raise ValueError(
            f"{name} is on {a.device} but the plan cache runs on {dev}; "
            f"move it there (or set a cache on {a.device})")
    return a


def implicit_solve(
    spec: StencilSpec,
    x0,
    *,
    fields=None,
    source=None,
    bc_value=0.0,
    backend: str = "auto",
    rtol: float | None = 1e-6,
    atol: float | None = 0.0,
    norm: str = "l2",
    check_every: int | None = None,
    max_iters: int = 10_000,
) -> torch.Tensor:
    """Run ``spec``'s fixed point to convergence, differentiably.

    Returns the converged field (same shape as ``x0``: (batch, *grid) or
    bare).  Unlike :func:`core.solver.solve` this is a differentiable
    function of its operands — ``torch.autograd.grad`` through it runs one
    adjoint solve (module docstring) instead of recording the loop, so
    gradient memory is O(1) in the iteration count:

      fields    (V, *grid) per-cell weight stack for a variable spec
                (canonical tap order; ``spec.field_stack()`` for the baked
                values) — gradient: the weight-field sensitivities;
      source    additive interior term, (*grid) shared or (batch, *grid);
      bc_value  Dirichlet value: a number, a 0-d tensor or a full grid;
      x0        initialisation — gradient is exactly zero (a converged
                fixed point forgets where it started).

    The solve runs on the default plan cache (``default_plan_cache()``,
    the card unless set otherwise); tensor operands must already be on its
    device.  ``backend`` must take runtime operands (``DIFF_BACKENDS``);
    "auto" picks conv for 2D/3D, dense for small 1D grids, reference
    otherwise.  ``rtol=None, atol=None`` runs exactly ``max_iters``
    iterations (the gradient is exact for the *converged* fixed point, so
    run to convergence before trusting it).
    """
    from repro_torch.core.plan_cache import default_plan_cache
    dev = default_plan_cache().device
    x0 = _on_device("x0", x0, dev)
    if x0.ndim not in (spec.ndim, spec.ndim + 1):
        raise ValueError(
            f"x0.ndim={x0.ndim} incompatible with a {spec.ndim}D spec "
            f"(expect grid or batch+grid)")
    squeeze = x0.ndim == spec.ndim
    if squeeze:
        x0 = x0[None]
    grid_shape = tuple(x0.shape[1:])

    if backend == "auto":
        if spec.ndim in (2, 3):
            backend = "conv"
        elif int(np.prod(grid_shape)) <= 64 * 64:
            backend = "dense"
        else:
            backend = "reference"
    if backend not in DIFF_BACKENDS:
        raise ValueError(
            f"backend {backend!r} cannot host a differentiable solve (its "
            f"plan lacks runtime operands); pick one of {DIFF_BACKENDS}")

    fields = _on_device("fields", fields, dev)
    if fields is not None:
        want = (spec.num_variable_taps, *grid_shape)
        if tuple(fields.shape) != want:
            raise ValueError(
                f"fields operand must be shaped {want}, got "
                f"{tuple(fields.shape)}")
    source = _on_device("source", source, dev)
    bc_value = _on_device("bc_value", bc_value, dev)

    cfg = _Cfg(spec=spec, grid_shape=grid_shape, backend=backend,
               rtol=rtol, atol=atol, norm=norm, check_every=check_every,
               max_iters=max_iters)
    x = _SolveFP.apply(cfg, fields, source, bc_value, x0)
    return x[0] if squeeze else x
