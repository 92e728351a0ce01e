"""Shared model-layer primitives and the declarative parameter tables — the
port of the JAX package's ``models/layers.py``.

Parameters are declared once as ``ParamDef(shape, dims, scale, dtype)``
tables, as in JAX: the same table yields the initialized tensors and the
logical-dims tree (``param_dims``) that ``parallel/sharding.Sharder``
reads.  :func:`init_params` and ``ParamDef.fill`` draw them from an
explicit ``torch.Generator`` with JAX's distributions (not its numbers: the
two generators differ).  A leaf whose ``dtype`` is set keeps it whatever
the model's type (the Mamba2 mixer's ``A_log``, ``D`` and ``dt_bias``, the
MoE router: fp32 in every model).
Stacked layer tables keep JAX's quirk: ``stack_tables`` prefixes the layer
axis, and the ``"fan_in"`` rule then reads ``shape[0]``, so every stacked
layer weight has std ``1/sqrt(n_layers)``, also where ``fill`` draws one
layer's slice of the leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F


# Random draws are made in pieces of at most this many fp32 numbers along
# a leaf's leading axis, so initialising a model in place needs no more
# than one piece (256 MB) beside the model.
DRAW_PIECE = 1 << 26


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """A parameter's shape, its logical dim names (one a dim, or None; the
    sharding rules' keys), and its init rule: ``"fan_in"`` (normal, std
    1/sqrt(shape[0])), a float (normal, that std), ``"one"``, ``"zero"`` or
    ``"const:<v>"`` (every entry v: the solver layer's stencil weights start
    at a known-stable operator, not at noise).  The constant rules draw
    nothing from the generator.  ``dtype`` None means the model's."""
    shape: tuple[int, ...]
    dims: tuple[str | None, ...]
    scale: float | str = "fan_in"
    dtype: torch.dtype | None = None

    def init(self, generator: torch.Generator, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
        out = torch.empty(self.shape, dtype=self.dtype or dtype,
                          device=device)
        self.fill(out, generator)
        return out

    @torch.no_grad()
    def fill(self, out: torch.Tensor, generator: torch.Generator) -> None:
        """Write the rule into ``out``: the whole leaf, or the slice of it
        at an index of its leading (stacked) axes; the std is the whole
        leaf's.  Random rules draw fp32 on the generator's device, as JAX
        draws in fp32, ``DRAW_PIECE`` numbers at most at a time along
        ``out``'s leading axis, each cast into ``out`` as it is copied."""
        if self.scale == "zero":
            out.zero_()
            return
        if self.scale == "one":
            out.fill_(1.0)
            return
        if isinstance(self.scale, str) and self.scale.startswith("const:"):
            out.fill_(float(self.scale[6:]))
            return
        if self.scale == "fan_in":
            s = 1.0 / math.sqrt(max(1, self.shape[0]))
        else:
            s = float(self.scale)
        rows = out if out.dim() else out.view(1)
        step = max(1, DRAW_PIECE // max(1, rows[0].numel()))
        for start in range(0, rows.shape[0], step):
            piece = rows[start:start + step]
            # One draw alive at a time: it is freed before the next.
            piece.copy_(torch.randn(piece.shape, generator=generator,
                                    device=generator.device,
                                    dtype=torch.float32).mul_(s))


def init_params(table: Mapping[str, Any], generator: torch.Generator,
                dtype: torch.dtype, device: torch.device) -> dict:
    """Materialize a (nested) ParamDef table into tensors, in the table's
    order, all from one generator; ``dtype`` for the leaves that set none."""
    out: dict = {}
    for path, pd in flatten(table):
        set_path(out, path, pd.init(generator, dtype, device))
    return out


def param_dims(table: Mapping[str, Any]) -> dict:
    """The table's tree of logical dim names (JAX's ``param_dims``)."""
    out: dict = {}
    for path, pd in flatten(table):
        set_path(out, path, pd.dims)
    return out


def param_shapes(table: Mapping[str, Any], dtype: torch.dtype) -> dict:
    """The table's tree of stand-ins: empty ``meta`` tensors of each
    leaf's shape, in ``dtype`` unless the leaf pins its own (JAX's
    ``ShapeDtypeStruct``s)."""
    out: dict = {}
    for path, pd in flatten(table):
        set_path(out, path, torch.empty(pd.shape, dtype=pd.dtype or dtype,
                                        device="meta"))
    return out


def stack_tables(table: Mapping[str, Any], n: int,
                 dim_name: str = "layers") -> dict:
    """Prefix every ParamDef with a leading stacked-layers dim (named
    None: it never shards; ``dim_name`` is unused, as in JAX)."""
    out: dict = {}
    for path, pd in flatten(table):
        set_path(out, path, ParamDef((n, *pd.shape), (None, *pd.dims),
                                     pd.scale, pd.dtype))
    return out


def flatten(table, prefix=()) -> list[tuple[tuple[str, ...], Any]]:
    """[(path, leaf)] of a nested dict, in insertion order."""
    items = []
    for k, v in table.items():
        if isinstance(v, Mapping):
            items.extend(flatten(v, (*prefix, k)))
        else:
            items.append(((*prefix, k), v))
    return items


def set_path(tree: dict, path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """JAX's: fp32 mean and population variance, ``rsqrt(var + eps)``, the
    weight and bias in fp32, then the cast back to x's type."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integers.

    Rotates pairs (x[..., :d/2], x[..., d/2:]) — the HF 'split-half'
    convention used by all assigned LM archs.
    """
    hd = x.shape[-1]
    freqs = _freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., None].float() * freqs             # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _freqs(hd: int, theta: float, device) -> torch.Tensor:
    """``rope_freqs`` rounded to fp32 on the host, then put on ``device``
    (a constant: no cast runs on the device)."""
    return torch.from_numpy(rope_freqs(hd, theta).astype(np.float32)).to(
        device)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL, arXiv:2409.12191).

    positions: (3, batch, seq) — temporal, height and width position ids.
    The head_dim/2 frequency slots are cut into contiguous ``sections``
    (summing to hd/2), and section i takes its angles from position channel
    i; then the split-half rotation of ``apply_rope``.  Where the three
    channels are equal (text tokens) it is ``apply_rope``.
    """
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"mrope sections {sections} must sum to {hd // 2}")
    freqs = _freqs(hd, theta, x.device)                  # (hd/2,)
    angles_all = positions[..., None].float() * freqs         # (3, B, S, hd/2)
    parts, start = [], 0
    for i, s in enumerate(sections):
        parts.append(angles_all[i, ..., start:start + s])
        start += s
    angles = torch.cat(parts, dim=-1)                         # (B, S, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


ACTIVATIONS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": lambda x: torch.square(F.relu(x)),  # squared ReLU
}
