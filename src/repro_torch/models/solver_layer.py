"""Learned-stencil solver layer: the differentiable solve as a model family —
the port of the JAX package's ``models/solver_layer.py``.

A module whose forward pass runs ``core.adjoint.implicit_solve`` to
convergence and whose parameters are the stencil itself: a (V, *grid) stack
of per-cell tap weights (``taps``) plus a scalar Dirichlet boundary value
(``bc``).  Gradients flow through the converged fixed point via the adjoint
solve (O(1) memory in the iteration count), so the layer trains under the
same ``train.train_step.make_train_step`` and AdamW as the LM.

The batch contract is ``{"source": (B, *grid), "target": (B, *grid)}`` —
learn the operator (e.g. a heterogeneous-diffusion kappa field) whose
steady states match observed solutions.  The loss is plain MSE against the
target steady state; ``make_train_step`` takes :func:`solver_loss_fn` when
``model.cfg.family == "solver"``.

A solver layer computes in float32 whatever the train step's compute dtype:
fixed-point convergence thresholds are meaningless in bf16, and the whole
parameter set is a few grids, not a transformer.  Its solves run on the
default plan cache, whose device must be the layer's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.core.adjoint import DIFF_BACKENDS, implicit_solve
from repro_torch.core.plan import resolve_device
from repro_torch.core.stencil import StencilSpec, heterogeneous_jacobi
from repro_torch.models.layers import ParamDef, param_dims


@dataclasses.dataclass(frozen=True)
class SolverLayerConfig:
    """Duck-typed stand-in for ``ModelConfig`` (family="solver").

    Carries only what the training stack reads off ``model.cfg`` (arch /
    family / sharding_profile / source) plus the solve settings.
    """

    arch: str = "learned-stencil"
    family: str = "solver"
    grid: tuple[int, ...] = (32, 32)
    backend: str = "conv"              # must be in DIFF_BACKENDS
    rtol: float | None = 1e-5
    atol: float | None = 0.0
    max_iters: int = 500
    check_every: int | None = None
    init_weight: float = 0.25          # uniform-diffusion start (2D: 4 × 0.25)
    sharding_profile: str = "tp"
    # JAX's provenance note without its tracker tag
    source: str = "adjoint solve as a trainable layer"

    def __post_init__(self):
        if self.backend not in DIFF_BACKENDS:
            raise ValueError(
                f"solver layer needs a differentiable backend "
                f"{DIFF_BACKENDS}, got {self.backend!r}")
        if len(self.grid) < 1:
            raise ValueError("solver layer needs a non-empty grid shape")

    @property
    def is_causal_lm(self) -> bool:
        return False


def template_spec(cfg: SolverLayerConfig) -> StencilSpec:
    """The static spec the solve runs through.

    A uniform heterogeneous-Jacobi spec: every face tap is a per-cell
    ``WeightField``, so the plan streams all V taps as one runtime operand
    and the baked values are never read once ``fields=`` is passed.
    """
    return heterogeneous_jacobi(np.ones(cfg.grid), name="learned-stencil")


def _grid_dims(cfg: SolverLayerConfig) -> tuple[str, ...]:
    """JAX's: the row dim may shard over data (the one grid dim with a
    rule); the others replicate."""
    return ("grid_row", "grid_col", "grid_depth")[:len(cfg.grid)]


def solver_table(cfg: SolverLayerConfig) -> dict:
    """The layer's parameters, JAX's table (both fp32 whatever the model
    dtype)."""
    V = template_spec(cfg).num_variable_taps
    return {
        "taps": ParamDef((V, *cfg.grid), ("taps", *_grid_dims(cfg)),
                         scale=f"const:{cfg.init_weight}"),
        "bc": ParamDef((), (), scale="zero"),
    }


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"solver layers have no {what} — they map source fields to "
        f"steady states, not token streams")


class SolverLayer(nn.Module):
    """The solver family's model (``model_zoo.build`` for family "solver"):
    ``forward(batch)`` -> (steady state, aux 0), differentiable in ``taps``
    and ``bc``."""

    def __init__(self, cfg: SolverLayerConfig, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.spec = template_spec(cfg)
        for name, pd in solver_table(cfg).items():
            self.register_parameter(name, nn.Parameter(
                pd.init(None, torch.float32, dev)))

    @property
    def dtype(self) -> torch.dtype:
        return self.taps.dtype

    @property
    def device(self) -> torch.device:
        return self.taps.device

    def forward(self, batch: dict):
        """(B, *grid) source -> converged steady state (B, *grid), and a
        zero aux loss.

        ``taps`` rides into the solve as the runtime fields operand, ``bc``
        as the Dirichlet value.  The solve starts from zeros: the fixed
        point forgets x0 anyway (its gradient is exactly zero), so there is
        nothing to learn about the initialisation.
        """
        source = batch["source"]
        if not torch.is_tensor(source):
            source = torch.as_tensor(np.asarray(source), device=self.device)
        source = source.float()
        cfg = self.cfg
        sol = implicit_solve(
            self.spec, torch.zeros_like(source), fields=self.taps.float(),
            source=source, bc_value=self.bc.float(), backend=cfg.backend,
            rtol=cfg.rtol, atol=cfg.atol, check_every=cfg.check_every,
            max_iters=cfg.max_iters)
        return sol, torch.zeros((), dtype=torch.float32, device=self.device)

    def dims(self) -> dict:
        """The parameters' logical dim names (JAX's ``api.dims()``)."""
        return param_dims(solver_table(self.cfg))

    def cache_dims(self) -> dict:
        """No cache: JAX's solver api gives {}."""
        return {}

    def prefill(self, *args, **kwargs):
        raise _unsupported("prefill")

    def decode_step(self, *args, **kwargs):
        raise _unsupported("decode step")

    def cache_shapes(self, *args, **kwargs):
        raise _unsupported("KV cache")


def solver_loss_fn(model: SolverLayer, batch: dict):
    """(MSE against the target steady state, {"mse", "aux"}): the solver
    family's loss, in float32."""
    pred, aux = model(batch)
    target = batch["target"]
    if not torch.is_tensor(target):
        target = torch.as_tensor(np.asarray(target), device=pred.device)
    mse = torch.mean(torch.square(pred - target.float()))
    return mse, {"mse": mse, "aux": aux}
