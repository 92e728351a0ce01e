"""GPipe-style pipeline parallelism — the port of the JAX package's
``parallel/pipeline.py``.

Layers split into S contiguous stages, stage s on the device of its
coordinate on ``stage_axis`` of a ``TileMesh``.  Microbatches stream
through the GPipe schedule: T = M + S - 1 ticks, stage s working on
microbatch t - s at tick t; bubble fraction (S - 1) / T.  JAX runs the
schedule under ``shard_map``, every stage every tick (a bubble's result
discarded), and passes each stage's output on with ``ppermute``; here one
process runs each tick's working stages in order, a bubble runs nothing,
and the hand-off is a ``.to()`` onto the next stage's device.  The last
stage commits microbatch t - (S - 1) at tick t; the outputs are then
copied to the caller's device (JAX replicates them to every stage with a
psum; one controller needs one copy).

Every step is an ordinary PyTorch op, so autograd runs back through the
schedule (the hand-offs transpose to copies the other way), and the same
function serves a train step (``train.train_step.pipelined_loss_fn``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.launch import hlo_cost


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def hand_off(y: torch.Tensor, device) -> torch.Tensor:
    """A stage's output onto the next stage's device: JAX's ``ppermute``,
    counted by a ``launch.hlo_cost.CostCounter`` as one
    ``collective-permute`` (on one device the copy is no copy at all)."""
    with hlo_cost.quiet():
        out = y.to(device)
    if hlo_cost.counting():
        n = hlo_cost.nbytes(y)
        hlo_cost.collective("collective-permute", n, n, grad_of=out)
    return out


def gpipe(stage_fn: Callable, mesh, stage_axis: str, n_microbatches: int):
    """Returns ``pipelined(params_stacked, x)``: ``stage_fn(stage_params,
    x_mb) -> y_mb`` (same shape) run as a pipeline of S =
    ``mesh.shape[stage_axis]`` stages over ``n_microbatches`` microbatches.

    x: (batch, ...) with batch divisible by n_microbatches; params_stacked:
    a tree of tensors whose leading dim is S (``split_stages``); stage s
    gets ``p[s]`` on its device.
    """
    S = mesh.shape[stage_axis]
    M = n_microbatches
    devices = [mesh.device_at({stage_axis: s}) for s in range(S)]

    def pipelined(params_stacked, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by microbatches {M}")
        x_mb = x.reshape(M, B // M, *x.shape[1:])
        local = [_tree_map(lambda p, s=s: p[s].to(devices[s]),
                           params_stacked) for s in range(S)]
        inbox: list = [None] * S          # what each stage takes this tick
        outs: list = [None] * M
        for t in range(M + S - 1):
            nxt: list = [None] * S
            for s in range(S):
                mb = t - s
                if not 0 <= mb < M:
                    continue              # a bubble
                inp = x_mb[mb].to(devices[0]) if s == 0 else inbox[s]
                y = stage_fn(local[s], inp)
                if s + 1 < S:
                    nxt[s + 1] = hand_off(y, devices[s + 1])
                else:
                    outs[mb] = y                           # the commit
            inbox = nxt
        out = torch.stack(outs).to(x.device)
        return out.reshape(B, *out.shape[2:])

    return pipelined


def split_stages(stacked_params, n_stages: int):
    """(L, ...) stacked layer params -> (S, L/S, ...) stage-stacked."""
    def resh(p):
        L = p.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers not divisible into {n_stages} "
                             f"stages")
        return p.reshape(n_stages, L // n_stages, *p.shape[1:])
    return _tree_map(resh, stacked_params)
