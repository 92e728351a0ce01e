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


@torch.no_grad()
def apply_update(state: dict, grads: dict, cfg: AdamWConfig):
    """One AdamW step; ``grads`` match ``state["params"]`` by name (any float
    dtype).  Updates the state in place and returns (state, {"grad_norm",
    "lr"})."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    for name, p in state["params"].items():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].float() * scale
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
    state["step"] = step
    return state, {"grad_norm": gnorm, "lr": lr}
