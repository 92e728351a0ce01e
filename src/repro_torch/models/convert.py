"""The weights bridge: JAX parameter trees and train states into the port,
and the port's named tensors back into JAX's layout.

``from_jax_params(cfg, params)`` takes the JAX package's nested param dict
as numpy arrays — ``embed``, ``final_norm``, ``lm_head`` and the layer
lists stacked on leading axes (``transformer.stacked_axes``: dense
``layers/{attn_norm, attn/{wq, wk, wv, wo, q_norm, k_norm}, mlp_norm,
mlp/{up, gate, down}}`` on (n_layers,); moe the same with ``moe/{router,
up, gate, down, shared/{up, gate, down}}`` in place of ``mlp``; ssm
``layers/{norm, mixer/…}``; hybrid ``layers`` on (groups, attn_every),
``tail_layers`` and the one ``shared_attn``; vlm the dense tree; encdec
``embed``, ``dec_pos``, ``enc_layers/{ln1/{w, b}, attn/{wq, wk, wv, wo},
ln2, mlp/{up, down}}`` on (n_enc_layers,), ``dec_layers/{ln1, self_attn,
ln2, cross_attn, ln3, mlp}`` on (n_layers,), ``enc_ln``, ``dec_ln`` and
``lm_head``) — and returns the port's model (``model_zoo.model_class``:
a ``Transformer`` or an ``EncDec``) holding the same numbers, each leaf in
its parameter's type (the
Mamba2 mixer's ``A_log``, ``D`` and ``dt_bias`` and the MoE router fp32 in
every model).  ``from_jax_state`` carries a JAX train
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
from repro_torch.models.model_zoo import model_class
from repro_torch.models.solver_layer import SolverLayer, SolverLayerConfig
from repro_torch.models.transformer import StackedModel
from repro_torch.train.train_step import init_train_state


def _as_f32(value) -> np.ndarray:
    """bf16 arrays arrive from numpy as ml_dtypes' bfloat16; float32 holds
    them exactly."""
    return np.array(value, dtype=np.float32)


def from_jax_params(cfg: ModelConfig, params: dict, *, device=None,
                    dtype: torch.dtype | None = None) -> StackedModel:
    """The model of ``cfg`` with JAX's numbers; ``dtype`` defaults to the
    type of the tree's ``embed`` (the model's type; a leaf that pins its
    own keeps it).  Every leaf is carried in fp32, which holds bf16
    exactly, and cast to its parameter's type as it is copied in."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = (torch.float32 if np.asarray(params["embed"]).dtype
                 == np.float32 else torch.bfloat16)
    tree: dict = {}
    for path, value in flatten(params):
        set_path(tree, path, torch.from_numpy(_as_f32(value)).to(dev))
    model = model_class(cfg)(cfg, device=dev, dtype=dtype)
    model.load_params(tree)
    return model


def named_arrays(cfg: ModelConfig, tree: dict) -> dict[str, np.ndarray]:
    """A JAX-layout tree as {port parameter name: fp32 array}, the stacked
    layer axes split into ``layers.<i>.…`` (the hybrid's
    ``layers.<g>.<i>.…``, encdec's ``enc_layers.<i>.…``)."""
    axes = model_class(cfg).param_axes(cfg)
    out = {}
    for path, value in flatten(tree):
        value = _as_f32(value)
        if path[0] in axes:
            for idx in np.ndindex(*axes[path[0]]):
                out[".".join((path[0], *map(str, idx), *path[1:]))] = \
                    value[idx]
        else:
            out[".".join(path)] = value
    return out


def to_jax_tree(cfg: ModelConfig, named: dict) -> dict:
    """{port parameter name: tensor} back into JAX's nested layout (fp32
    numpy, layer lists stacked), in the parameter table's order."""
    cls = model_class(cfg)
    axes = cls.param_axes(cfg)
    tree: dict = {}
    for path, _ in flatten(cls.param_table(cfg)):
        if path[0] in axes:
            shape = axes[path[0]]
            value = np.stack([
                named[".".join((path[0], *map(str, idx), *path[1:]))]
                .detach().float().cpu().numpy()
                for idx in np.ndindex(*shape)])
            value = value.reshape(*shape, *value.shape[1:])
        else:
            value = named[".".join(path)].detach().float().cpu().numpy()
        set_path(tree, path, value)
    return tree


def from_jax_state(model: StackedModel, state: dict) -> dict:
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
