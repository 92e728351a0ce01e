"""Family-dispatched model construction — the port of the JAX package's
``models/model_zoo.py``.

``build(cfg)`` returns the model whose methods stand for JAX's ``ModelApi``
(``forward``, ``prefill``, ``decode_step``, ``cache_shapes``,
``init_cache``); in PyTorch the parameters live in the module instead of
being passed in.  The dense, moe, ssm and hybrid families are ported
(``transformer.FAMILIES``), and the solver family (``family="solver"``,
``models/solver_layer.py``); the others raise
(``transformer.check_family``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import resolve_device
from repro_torch.models.transformer import Transformer


def build(cfg: ModelConfig, *, device=None, dtype=torch.bfloat16,
          generator: torch.Generator | None = None) -> Transformer:
    """The model of ``cfg`` on ``device`` (None: the card; raises without
    one), its weights drawn from ``generator`` with JAX's distributions
    (seed 0 on the device if None), in place: beside the model at most one
    draw piece (``layers.DRAW_PIECE``).  A solver-family config gets a
    ``SolverLayer``: fp32 parameters from JAX's constant rules, whatever
    ``dtype`` and ``generator`` say."""
    if cfg.family == "solver":
        # Learned-stencil layer: forward = a differentiable fixed-point
        # solve; parameters = the stencil weights.
        from repro_torch.models.solver_layer import SolverLayer
        return SolverLayer(cfg, device=device)
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev, dtype=dtype)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model.init_weights(generator)
    return model
