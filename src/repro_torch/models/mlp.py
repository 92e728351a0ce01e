"""Dense FFN variants, gated (SwiGLU/GeGLU) and ungated (squared-ReLU,
GELU) — the port of the JAX package's ``models/mlp.py``.  Weights keep
JAX's (d_in, d_out) layout, so a JAX parameter tree loads as it is."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.plan import resolve_device
from repro_torch.models.layers import ACTIVATIONS, ParamDef


def mlp_table(d_model: int, d_ff: int, gated: bool) -> dict:
    t = {
        "up": ParamDef((d_model, d_ff)),
        "down": ParamDef((d_ff, d_model)),
    }
    if gated:
        t["gate"] = ParamDef((d_model, d_ff))
    return t


class MLP(nn.Module):
    """``device=None`` means the card (``core.plan.resolve_device``)."""

    def __init__(self, d_model: int, d_ff: int, activation: str, gated: bool,
                 *, device=None, dtype=torch.float32):
        super().__init__()
        self.activation = activation
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.up = nn.Parameter(torch.empty(d_model, d_ff, **kw))
        self.down = nn.Parameter(torch.empty(d_ff, d_model, **kw))
        self.gate = (nn.Parameter(torch.empty(d_model, d_ff, **kw))
                     if gated else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = ACTIVATIONS[self.activation]
        up = x @ self.up
        h = act(x @ self.gate) * up if self.gate is not None else act(up)
        return (h.to(x.dtype) @ self.down).to(x.dtype)
