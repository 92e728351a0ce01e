"""Family-dispatched model construction — the port of the JAX package's
``models/model_zoo.py``.

``build(cfg)`` returns the model whose methods stand for JAX's ``ModelApi``
(``forward``, ``prefill``, ``decode_step``, ``cache_shapes``,
``init_cache``); in PyTorch the parameters live in the module instead of
being passed in.  The families of ``transformer.FAMILIES`` (dense, moe,
ssm, hybrid, vlm) build a ``Transformer``, the encdec family an
``encdec.EncDec``, and the solver family (``family="solver"``) a
``models/solver_layer.SolverLayer``.  ``batch_inputs`` picks the batch's
entries that the family's ``forward`` and ``prefill`` take besides the
tokens, as JAX's ``ModelApi`` passes them.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import resolve_model_device
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import StackedModel, Transformer


def model_class(cfg: ModelConfig) -> type[StackedModel]:
    """``EncDec`` for the encdec family, else ``Transformer`` (which raises
    on a family it does not run)."""
    return EncDec if cfg.family == "encdec" else Transformer


def batch_inputs(cfg: ModelConfig, batch: dict) -> dict:
    """The keyword arguments of the model's ``forward`` and ``prefill``
    besides the tokens: ``enc_frames`` (encdec), else ``positions`` and
    ``vision_embeds`` where the batch has them."""
    if cfg.family == "encdec":
        return {"enc_frames": batch["enc_frames"]}
    return {k: batch[k] for k in ("positions", "vision_embeds") if k in batch}


def build(cfg: ModelConfig, *, device=None, dtype=torch.bfloat16,
          generator: torch.Generator | None = None) -> StackedModel:
    """The model of ``cfg`` on ``device`` (None: the card; raises without
    one), its weights drawn from ``generator`` with JAX's distributions
    (seed 0 on the device if None), in place: beside the model at most one
    draw piece (``layers.DRAW_PIECE``).  A solver-family config gets a
    ``SolverLayer``: fp32 parameters from JAX's constant rules, whatever
    ``dtype`` and ``generator`` say.  On ``meta`` the model has shapes
    and no storage, and nothing is drawn (the dry run's model)."""
    if cfg.family == "solver":
        # Learned-stencil layer: forward = a differentiable fixed-point
        # solve; parameters = the stencil weights.
        from repro_torch.models.solver_layer import SolverLayer
        return SolverLayer(cfg, device=device)
    dev = resolve_model_device(device)
    model = model_class(cfg)(cfg, device=dev, dtype=dtype)
    if dev.type == "meta":
        return model
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model.init_weights(generator)
    return model
