"""Dense FFN variants, gated (SwiGLU/GeGLU) and ungated (squared-ReLU,
GELU) — the port of the JAX package's ``models/mlp.py``.  Weights keep
JAX's (d_in, d_out) layout, so a JAX parameter tree loads as it is;
``mlp_apply`` runs one shard's slice of them under a sharder."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.plan import resolve_model_device
from repro_torch.models.layers import ACTIVATIONS, ParamDef
from repro_torch.parallel.sharding import row_product


def mlp_table(d_model: int, d_ff: int, gated: bool) -> dict:
    t = {
        "up": ParamDef((d_model, d_ff), ("embed", "dff")),
        "down": ParamDef((d_ff, d_model), ("dff", "embed")),
    }
    if gated:
        t["gate"] = ParamDef((d_model, d_ff), ("embed", "dff"))
    return t


class MLP(nn.Module):
    """``device=None`` means the card (``core.plan.resolve_device``)."""

    def __init__(self, d_model: int, d_ff: int, activation: str, gated: bool,
                 *, device=None, dtype=torch.float32):
        super().__init__()
        self.activation = activation
        kw = dict(device=resolve_model_device(device), dtype=dtype)
        self.up = nn.Parameter(torch.empty(d_model, d_ff, **kw))
        self.down = nn.Parameter(torch.empty(d_ff, d_model, **kw))
        self.gate = (nn.Parameter(torch.empty(d_model, d_ff, **kw))
                     if gated else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(x, self.up, self.gate, self.down, self.activation)


def mlp_apply(x: torch.Tensor, up: torch.Tensor, gate, down: torch.Tensor,
              activation: str, partial: bool = False) -> torch.Tensor:
    """The FFN on x (..., D) with the weights given: the whole layer's, or
    under a sharder one shard's columns of ``up``/``gate`` and the same rows
    of ``down`` (``dff`` over the model axis, tp), whose outputs are partial
    sums that the caller adds over the shards (JAX's constraint of h to
    (batch, seq, dff)): with ``partial`` in fp32, for
    ``sharding.psum_rounded``."""
    act = ACTIVATIONS[activation]
    u = x @ up
    h = (act(x @ gate) * u if gate is not None else act(u)).to(x.dtype)
    out = row_product(h, down, partial)
    return out if partial else out.to(x.dtype)
