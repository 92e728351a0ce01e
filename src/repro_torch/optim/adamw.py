"""AdamW with fp32 states and fp32 master params, global-norm clipping —
the port of the JAX package's ``optim/adamw.py`` as plain functions on dicts
of tensors (not ``torch.optim.AdamW``, which orders the arithmetic
differently).

The arithmetic and its order are JAX's: the step direction is
``m̂ / (sqrt(v̂) + eps) + weight_decay * p``, with the bias corrections and
the warmup-cosine ``schedule`` in fp32.  ``apply_update`` updates params,
m and v in place, where JAX returns new arrays: at qwen3-0.6b's width each
of the three is 3 GB, so a copy would cost as much again.  The step counter
and the schedule stay on the host (a 0-dim int32 tensor), so a step reads
nothing back from the card.
"""
from __future__ import annotations

import dataclasses
import math

import torch


_HOST = torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio, in fp32 (0-dim)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    decay_steps = max(1.0, cfg.total_steps - cfg.warmup_steps)
    t = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params_f32: dict) -> dict:
    """{"params", "m", "v", "step"}: m and v fp32 zeros beside each param,
    step a 0-dim int32 on the host."""
    return {
        "params": params_f32,
        "m": {n: torch.zeros_like(p, dtype=torch.float32)
              for n, p in params_f32.items()},
        "v": {n: torch.zeros_like(p, dtype=torch.float32)
              for n, p in params_f32.items()},
        "step": torch.zeros((), dtype=torch.int32),
    }


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    total = sum(torch.sum(torch.square(t.float())) for t in tree.values())
    return torch.sqrt(total)


def _update_leaf(p, m, v, g, scale, lr, bc1, bc2, cfg: AdamWConfig) -> None:
    """One leaf's (or one slice's) AdamW step, in place."""
    b1, b2 = cfg.b1, cfg.b2
    g = g.float() * scale
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_(((1 - b2) * g).mul_(g))
    del g
    # m̂ / (sqrt(v̂) + eps) + wd * p, each op rounded as in JAX, with at
    # most two temporaries of the leaf's size at a time (a 256,000-row
    # embedding's are 5.9 GB each).
    denom = (v / bc2).sqrt_().add_(cfg.eps)
    step_dir = (m / bc1).div_(denom)
    step_dir.add_(torch.mul(p, cfg.weight_decay, out=denom))
    del denom
    p.sub_(step_dir.mul_(lr))


def _opt_slices(sharder, dims: dict, params: dict):
    """{name: [(slices, owner device)]}: each parameter's distinct
    ``opt_spec`` slices (ZeRO-1), each with the device of the first shard
    that holds it."""
    from repro_torch.parallel.sharding import local_slices
    mesh = sharder.mesh
    out = {}
    for name, p in params.items():
        spec = sharder.opt_spec(dims[name], tuple(p.shape))
        seen: dict = {}
        for c, dev in zip(mesh.coords(), mesh.devices):
            sl = local_slices(spec, tuple(p.shape), mesh, c)
            seen.setdefault(tuple((s.start, s.stop) for s in sl), (sl, dev))
        out[name] = list(seen.values())
    return out


@torch.no_grad()
def apply_update(state: dict, grads: dict, cfg: AdamWConfig, *,
                 sharder=None, dims: dict | None = None):
    """One AdamW step; ``grads`` match ``state["params"]`` by name (any float
    dtype).  Updates the state in place and returns (state, {"grad_norm",
    "lr"}).

    With a ``sharder`` of more than one shard (and ``dims``, the
    parameters' logical dims by name), ZeRO-1: the step runs on each
    parameter's distinct ``opt_spec`` slices, each on its owner shard's
    device (a view where that is the state's), and the updated slices are
    written back; the grad norm sums each distinct slice once."""
    step = state["step"] + 1
    if sharder is None or sharder.trivial:
        gnorm = global_norm(grads)
        pieces = {name: [((slice(None),) * p.dim(), p.device)]
                  for name, p in state["params"].items()}
    else:
        pieces = _opt_slices(sharder, dims, state["params"])
        total = 0
        for name, slices in pieces.items():
            for sl, dev in slices:
                part = torch.sum(torch.square(grads[name][sl].to(dev).float()))
                total = total + part.to(grads[name].device)
        gnorm = torch.sqrt(total)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    bc1 = 1 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1 - cfg.b2 ** step.to(torch.float32)
    for name, p in state["params"].items():
        for sl, dev in pieces[name]:
            leaves = [t[sl] for t in (p, state["m"][name], state["v"][name])]
            local = [t.to(dev) for t in leaves]
            # lr and the bias corrections are host scalars; the clip scale
            # follows the slice only onto another card.
            _update_leaf(*local, grads[name][sl].to(dev),
                         scale if scale.device in (dev, _HOST)
                         else scale.to(dev), lr, bc1, bc2, cfg)
            for t, u in zip(leaves, local):
                if u is not t:      # the slice went to another device
                    t.copy_(u)
    state["step"] = step
    return state, {"grad_norm": gnorm, "lr": lr}
