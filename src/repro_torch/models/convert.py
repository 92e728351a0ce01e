"""The weights bridge: JAX parameter trees and train states into the port,
and the port's named tensors back into JAX's layout.

``from_jax_params(cfg, params)`` takes the JAX package's nested param dict
as numpy arrays — ``embed``, ``final_norm``, ``lm_head`` and ``layers/
{attn_norm, attn/{wq, wk, wv, wo, q_norm, k_norm}, mlp_norm, mlp/{up,
gate, down}}`` stacked on a leading layer axis — and returns the port's
model holding the same numbers.  ``from_jax_state`` carries a JAX train
state ({params, m, v, step}) into the port's (``train.train_step``), so both
packages can start from the same numbers at any step; ``to_jax_tree`` goes
the other way for comparisons.  ``from_jax_solver_params`` and
``to_jax_solver_params`` do the same for the solver family's ``{"taps",
"bc"}``.  Nothing here imports JAX: convert a JAX tree with
``jax.tree.map(np.asarray, tree)`` first.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import resolve_device
from repro_torch.models.layers import flatten, set_path
from repro_torch.models.solver_layer import SolverLayer, SolverLayerConfig
from repro_torch.models.transformer import Transformer, model_table
from repro_torch.train.train_step import init_train_state


def _as_f32(value) -> np.ndarray:
    """bf16 arrays arrive from numpy as ml_dtypes' bfloat16; float32 holds
    them exactly."""
    return np.array(value, dtype=np.float32)


def from_jax_params(cfg: ModelConfig, params: dict, *, device=None,
                    dtype: torch.dtype | None = None) -> Transformer:
    """The model of ``cfg`` with JAX's numbers; ``dtype`` defaults to the
    tree's."""
    dev = resolve_device(device)
    leaves = flatten(params)
    if dtype is None:
        dtype = (torch.float32 if np.asarray(leaves[0][1]).dtype
                 == np.float32 else torch.bfloat16)
    tree: dict = {}
    for path, value in leaves:
        set_path(tree, path, torch.from_numpy(_as_f32(value)).to(dev, dtype))
    model = Transformer(cfg, device=dev, dtype=dtype)
    model.load_params(tree)
    return model


def named_arrays(cfg: ModelConfig, tree: dict) -> dict[str, np.ndarray]:
    """A JAX-layout tree as {port parameter name: fp32 array}, the stacked
    layer axis split into ``layers.<i>.…``."""
    out = {}
    for path, value in flatten(tree):
        value = _as_f32(value)
        if path[0] == "layers":
            for i in range(cfg.n_layers):
                out[".".join(("layers", str(i), *path[1:]))] = value[i]
        else:
            out[".".join(path)] = value
    return out


def to_jax_tree(cfg: ModelConfig, named: dict) -> dict:
    """{port parameter name: tensor} back into JAX's nested layout (fp32
    numpy, layers stacked), in ``model_table``'s order."""
    tree: dict = {}
    for path, _ in flatten(model_table(cfg)):
        if path[0] == "layers":
            value = np.stack([
                named[".".join(("layers", str(i), *path[1:]))]
                .detach().float().cpu().numpy()
                for i in range(cfg.n_layers)])
        else:
            value = named[".".join(path)].detach().float().cpu().numpy()
        set_path(tree, path, value)
    return tree


def from_jax_state(model: Transformer, state: dict) -> dict:
    """The port's train state from JAX's {params, m, v, step} (numpy): the
    fp32 master ``model`` takes JAX's params, and m, v and step follow."""
    out = init_train_state(model)
    with torch.no_grad():
        for key in ("params", "m", "v"):
            for name, value in named_arrays(model.cfg, state[key]).items():
                out[key][name].copy_(torch.from_numpy(value))
    out["step"] = torch.tensor(int(state["step"]), dtype=torch.int32)
    return out


def from_jax_solver_params(cfg: SolverLayerConfig, params: dict, *,
                           device=None) -> SolverLayer:
    """The solver layer of ``cfg`` holding JAX's ``{"taps", "bc"}`` (numpy,
    fp32)."""
    model = SolverLayer(cfg, device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            value = torch.from_numpy(_as_f32(params[name]))
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{name}: JAX's shape {tuple(value.shape)} "
                                 f"is not the layer's {tuple(p.shape)}")
            p.copy_(value)
    return model


def to_jax_solver_params(model: SolverLayer) -> dict:
    """A solver layer's parameters as JAX's ``{"taps", "bc"}`` (fp32
    numpy)."""
    return {name: p.detach().float().cpu().numpy()
            for name, p in model.named_parameters()}
