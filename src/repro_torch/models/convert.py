"""The weights bridge: a JAX parameter tree into the port's model.

``from_jax_params(cfg, params)`` takes the JAX package's nested param dict
as numpy arrays — ``embed``, ``final_norm``, ``lm_head`` and ``layers/
{attn_norm, attn/{wq, wk, wv, wo, q_norm, k_norm}, mlp_norm, mlp/{up,
gate, down}}`` stacked on a leading layer axis — and returns the port's
model holding the same numbers.  Nothing here imports JAX: convert a JAX
tree with ``jax.tree.map(np.asarray, params)`` first.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import resolve_device
from repro_torch.models.layers import flatten
from repro_torch.models.transformer import Transformer


def from_jax_params(cfg: ModelConfig, params: dict, *, device=None,
                    dtype: torch.dtype | None = None) -> Transformer:
    """The model of ``cfg`` with JAX's numbers; ``dtype`` defaults to the
    tree's (bf16 arrays arrive from numpy as ml_dtypes' bfloat16 and are
    read through float32, which holds them exactly)."""
    dev = resolve_device(device)
    leaves = flatten(params)
    if dtype is None:
        dtype = (torch.float32 if np.asarray(leaves[0][1]).dtype
                 == np.float32 else torch.bfloat16)
    tree: dict = {}
    for path, value in leaves:
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = torch.from_numpy(
            np.array(value, dtype=np.float32)).to(dev, dtype)
    model = Transformer(cfg, device=dev, dtype=dtype)
    model.load_params(tree)
    return model
