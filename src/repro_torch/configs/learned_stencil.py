"""learned-stencil — the solver family's config (the JAX package's
``configs/learned_stencil.py``).

Not an LM architecture: ``family="solver"`` routes ``model_zoo.build`` to
the differentiable-solve layer (models/solver_layer.py), whose parameters
are a per-cell stencil weight stack plus a scalar Dirichlet value.  It is
deliberately *not* in ``list_archs()`` — the arch-iteration tests exercise
the token-stream contract (prefill/decode), which a solver does not have.
"""
from repro_torch.configs import base
from repro_torch.models.solver_layer import SolverLayerConfig


def full() -> SolverLayerConfig:
    return SolverLayerConfig(
        grid=(32, 32),
        backend="conv",
        rtol=1e-5,
        max_iters=500,
    )


def smoke() -> SolverLayerConfig:
    # Small odd-ish grid, capped iterations: a train step in well under a
    # second on the CPU while still converging far enough for useful
    # gradients.
    return SolverLayerConfig(
        grid=(12, 14),
        backend="conv",
        rtol=1e-5,
        max_iters=200,
    )


base.register("learned-stencil", full, smoke)
