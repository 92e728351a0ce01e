"""Mixture-of-Experts FFN — the port of the JAX package's ``models/moe.py``:
GShard top-k routing with a capacity per expert, tokens processed in groups
of ``group_size``, a wave of groups at a time.

Within a group: the router's softmax in fp32, the top-k experts of each
token (ties to the lower expert index, as ``jax.lax.top_k``), gate weights
renormalised over the k, each (token, slot)'s position within its expert in
GShard's priority order (slot-major, then token order), and the slots past
``capacity`` dropped.  Two dispatch modes, as in JAX:

- ``"einsum"`` (GShard's one-hot): ``combine`` (G, S, E, C) holds each
  token's gate weight in its kept slots, ``dispatch = combine > 0`` in the
  compute type, and the experts' inputs and the output are products with
  them (JAX's ``gsec,gsd->egcd`` and ``gsec,egcd->gsd``, in the compute
  type).  ``combine`` is written by a scatter of the k gate weights, not
  by JAX's three-operand einsum, so no (G, S, k, E, C) tensor is formed;
  each token's k experts differ, so the einsum's sum over k has one term
  and the two agree bit for bit;
- ``"scatter"``: each kept (token, slot) adds its activation into its
  expert's row of a buffer one row longer than E * C (dropped slots go to
  the last row, which is cut off), and gathers the expert's output back,
  weighted by its gate in fp32.

Each wave runs under ``torch.utils.checkpoint`` while autograd records
(JAX's ``jax.checkpoint`` on the scan body): the backward keeps a wave's
input and runs its routing and experts again.  The Switch auxiliary loss is
E * mean over waves of sum_e (mean router prob) * (top-1 fraction).  JAX
runs no Pallas kernel here and the port launches none: the products are
``torch.bmm``/``torch.matmul`` in the compute type (fp32 sums; TF32 stays
off), the routing in fp32.

``MoE`` holds one layer's parameters (JAX's ``moe_table``: the router fp32
in every model) and calls :func:`moe_apply`, which takes them as a dict, as
JAX's does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.plan import resolve_model_device
from repro_torch.models.layers import ACTIVATIONS, ParamDef
from repro_torch.models.mlp import MLP, mlp_apply
from repro_torch.parallel.sharding import (all_gather, axes_size,
                                           block_start, psum, psum_rounded,
                                           row_product, spec_axes)

DISPATCH_MODES = ("einsum", "scatter")


def moe_table(d_model: int, n_experts: int, d_ff: int,
              n_shared: int = 0) -> dict:
    t = {
        "router": ParamDef((d_model, n_experts), ("embed", "experts"),
                           dtype=torch.float32),
        "up": ParamDef((n_experts, d_model, d_ff),
                       ("experts", "embed", "expert_dff")),
        "gate": ParamDef((n_experts, d_model, d_ff),
                         ("experts", "embed", "expert_dff")),
        "down": ParamDef((n_experts, d_ff, d_model),
                         ("experts", "expert_dff", "embed")),
    }
    if n_shared:
        t["shared"] = {
            "up": ParamDef((d_model, n_shared * d_ff), ("embed", "dff")),
            "gate": ParamDef((d_model, n_shared * d_ff), ("embed", "dff")),
            "down": ParamDef((n_shared * d_ff, d_model), ("dff", "embed")),
        }
    return t


def expert_capacity(group_size: int, top_k: int, capacity_factor: float,
                    n_experts: int) -> int:
    """Slots per expert in a group (JAX's ``moe.py:147``)."""
    return max(4, int(group_size * top_k * capacity_factor / n_experts))


def wave_layout(tokens: int, group_size: int,
                n_waves: int) -> tuple[int, int, int]:
    """(group size, waves, groups a wave) for ``tokens`` tokens, as JAX's
    ``moe_apply``: the group is at most the tokens, which it must divide,
    and the waves the largest count up to ``n_waves`` that divides the
    groups."""
    gs = min(group_size, tokens)
    if tokens % gs:
        raise ValueError(f"tokens={tokens} not divisible by group_size={gs}")
    n_groups = tokens // gs
    waves = min(n_waves, n_groups)
    while n_groups % waves:
        waves -= 1
    return gs, waves, n_groups // waves


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, equal values
    in ascending index order (``jax.lax.top_k``'s rule; ``torch.topk``
    promises no order for ties): a stable descending sort."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def route(xg: torch.Tensor, router: torch.Tensor, k: int, capacity: int):
    """One wave's routing.  xg: (G, S, D) -> (probs (G, S, E) fp32, gate
    weights (G, S, k) fp32 with the dropped slots 0, expert_idx (G, S, k),
    pos (G, S, k) each slot's place in its expert, keep = pos < capacity).
    Positions follow GShard's priority: slot-major, then token order."""
    G, S, _ = xg.shape
    E = router.shape[1]
    probs = torch.softmax(xg.float() @ router.float(), dim=-1)
    gate_vals, expert_idx = top_k(probs, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    # A running count per expert down the slot-major order; a slot's
    # position is the count before it, at its own expert.  The one-hot is
    # laid out (G, E, k*S) so that the count runs down the innermost axis:
    # torch's scan down an outer axis is the slow one on the card (over
    # half of a full-depth prefill's device time).
    order = expert_idx.transpose(1, 2).reshape(G, 1, k * S)
    flat = (order == torch.arange(E, device=xg.device)[:, None]).to(
        torch.int32)
    before = flat.cumsum(dim=-1, dtype=torch.int32) - flat
    pos = before.gather(1, order).view(G, k, S).transpose(1, 2)
    keep = pos < capacity
    return probs, gate_vals * keep, expert_idx, pos, keep


def _expert_ffn(params: dict, xin: torch.Tensor,
                activation: str) -> torch.Tensor:
    """xin: (E, G, C, D) -> (E, G, C, D), in xin's type."""
    E, G, C, D = xin.shape
    x2 = xin.reshape(E, G * C, D)
    up = torch.bmm(x2, params["up"])
    gate = torch.bmm(x2, params["gate"])
    h = (ACTIVATIONS[activation](gate) * up).to(xin.dtype)
    return torch.bmm(h, params["down"]).to(xin.dtype).view(E, G, C, D)


def _group_moe(params: dict, xg: torch.Tensor, k: int, capacity: int,
               activation: str, dispatch_mode: str = "einsum",
               e0: int = 0, routes: list | None = None,
               partial: bool = False):
    """One wave of groups.  xg: (G, S, D) -> (out (G, S, D), me (E,), ce
    (E,)): the output and the aux loss's mean router prob and top-1
    fraction per expert.  ``params``' experts are experts e0.. of the
    router's E (all of them unsharded; one model shard's block under
    expert parallelism, ``moe_sharded``, whose ``out`` is then the partial
    sum over that block, in fp32 with ``partial``, for
    ``sharding.psum_rounded``).  ``routes``: a list that gets the routing
    (expert_idx, keep, each (G, S, k); the router probs (G, S, E))."""
    G, S, D = xg.shape
    E = params["up"].shape[0]          # the experts here: e0 .. e0 + E
    C = capacity
    probs, gate_vals, expert_idx, pos, keep = route(xg, params["router"], k,
                                                    C)
    if routes is not None:
        routes.append((expert_idx, keep, probs))
    # Each kept slot's row of these experts' (E * C) slots; dropped ones,
    # and other shards' experts' ones, the extra row E * C.
    slot = (expert_idx - e0) * C + pos
    slot = torch.where(keep & (slot >= 0) & (slot < E * C), slot, E * C)
    if dispatch_mode == "scatter":
        gsk = slot.reshape(G, S * k, 1).expand(G, S * k, D)
        xk = xg[:, :, None, :].expand(G, S, k, D).reshape(G, S * k, D)
        buf = torch.zeros(G, E * C + 1, D, dtype=xg.dtype, device=xg.device)
        buf = buf.scatter_add(1, gsk, xk)
        xin = buf[:, :-1].reshape(G, E, C, D).transpose(0, 1)
        eout = _expert_ffn(params, xin, activation)          # (E, G, C, D)
        flat = F.pad(eout.transpose(0, 1).reshape(G, E * C, D), (0, 0, 0, 1))
        picked = flat.gather(1, gsk).view(G * S, k, D)
        out = torch.bmm(gate_vals.reshape(G * S, 1, k), picked.float())
        out = out.view(G, S, D)
    elif dispatch_mode == "einsum":
        # combine[g, s, e * C + c]: the token's gate weight in that slot.
        combine = torch.zeros(G, S, E * C + 1, dtype=gate_vals.dtype,
                              device=xg.device).scatter(
            -1, slot, gate_vals)[..., :-1]
        dispatch = (combine > 0).to(xg.dtype)
        xin = (dispatch.transpose(1, 2) @ xg).view(G, E, C, D)
        eout = _expert_ffn(params, xin.transpose(0, 1), activation)
        out = row_product(combine.to(xg.dtype), eout.transpose(0, 1).reshape(
            G, E * C, D), partial)
    else:
        raise ValueError(f"dispatch_mode must be one of {DISPATCH_MODES}, "
                         f"got {dispatch_mode!r}")
    me = probs.mean(dim=(0, 1))
    # The top-1 one-hot as a comparison (F.one_hot runs other ops on each
    # device, so a counted step would differ between them).
    top1 = expert_idx[..., 0, None] == torch.arange(probs.shape[-1],
                                                    device=xg.device)
    ce = top1.float().mean(dim=(0, 1))
    return (out if partial else out.to(xg.dtype)), me, ce


def moe_apply(params: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, group_size: int = 1024,
              activation: str = "silu", n_waves: int = 16,
              dispatch_mode: str = "einsum", routes: list | None = None):
    """x: (B, S, D) -> (out (B, S, D), aux loss scalar fp32).  ``params``:
    ``moe_table``'s leaves as tensors; ``routes``: a list that gets each
    wave's routing in order (``_group_moe``; without autograd, since a
    checkpointed wave routes again in the backward)."""
    B, S, D = x.shape
    E = params["router"].shape[1]
    gs, waves, G = wave_layout(B * S, group_size, n_waves)
    capacity = expert_capacity(gs, top_k, capacity_factor, E)
    remat = torch.is_grad_enabled()
    outs, stats = [], []
    for xg in x.reshape(waves, G, gs, D).unbind(0):
        args = (params, xg, top_k, capacity, activation, dispatch_mode, 0,
                routes)
        out, me, ce = (checkpoint(_group_moe, *args, use_reentrant=False)
                       if remat else _group_moe(*args))
        outs.append(out)
        stats.append((me * ce).sum())
    aux = E * torch.stack(stats).mean()
    out = torch.stack(outs).reshape(B, S, D)
    if "shared" in params:
        sh = params["shared"]
        up = x @ sh["up"]
        h = (ACTIVATIONS[activation](x @ sh["gate"]) * up).to(x.dtype)
        out = out + (h @ sh["down"]).to(x.dtype)
    return out, aux


class MoE(nn.Module):
    """One layer's experts (``moe_table``'s leaves; ``shared`` an ``MLP``
    of n_shared * d_ff when there are shared experts).  ``device=None``
    means the card (``core.plan.resolve_device``).  ``routes``: None, or
    a list that each forward's routing is appended to (``moe_apply``)."""

    routes: list | None = None

    def __init__(self, d_model: int, n_experts: int, d_ff: int,
                 n_shared: int = 0, *, top_k: int,
                 capacity_factor: float = 1.25, activation: str = "silu",
                 n_waves: int = 16, dispatch_mode: str = "einsum",
                 device=None, dtype=torch.float32):
        super().__init__()
        if dispatch_mode not in DISPATCH_MODES:
            raise ValueError(f"dispatch_mode must be one of "
                             f"{DISPATCH_MODES}, got {dispatch_mode!r}")
        self.top_k, self.capacity_factor = top_k, capacity_factor
        self.activation, self.n_waves = activation, n_waves
        self.dispatch_mode = dispatch_mode
        kw = dict(device=resolve_model_device(device), dtype=dtype)
        E, D, Fe = n_experts, d_model, d_ff
        self.router = nn.Parameter(torch.empty(
            D, E, device=kw["device"], dtype=torch.float32))
        self.up = nn.Parameter(torch.empty(E, D, Fe, **kw))
        self.gate = nn.Parameter(torch.empty(E, D, Fe, **kw))
        self.down = nn.Parameter(torch.empty(E, Fe, D, **kw))
        self.shared = (MLP(D, n_shared * Fe, activation, True, **kw)
                       if n_shared else None)

    def params(self) -> dict:
        p = {n: getattr(self, n) for n in ("router", "up", "gate", "down")}
        if self.shared is not None:
            p["shared"] = {n: getattr(self.shared, n)
                           for n in ("up", "gate", "down")}
        return p

    def forward(self, x: torch.Tensor, group_size: int):
        """x: (B, S, D) -> (out, aux) with groups of ``group_size``."""
        return moe_apply(self.params(), x, top_k=self.top_k,
                         capacity_factor=self.capacity_factor,
                         group_size=group_size, activation=self.activation,
                         n_waves=self.n_waves,
                         dispatch_mode=self.dispatch_mode,
                         routes=self.routes)


def moe_sharded(pieces: list, xs: list, sharder, batch_entry, *,
                seq_entry=None, expert_entry, shared_entry=None, top_k: int,
                capacity_factor: float = 1.25, group_size: int = 1024,
                activation: str = "silu", n_waves: int = 16,
                dispatch_mode: str = "einsum", routes: list | None = None):
    """Expert parallelism: ``moe_apply`` on a mesh, one shard-local program
    a coordinate (``models/transformer.ShardedMoE``'s FFN).  ``xs``: each
    shard's block of x (B, S, D), laid by ``batch_entry`` and
    ``seq_entry``; ``pieces``: each shard's view of the layer's
    parameters, ``router`` whole (D, E), ``up``/``gate``/``down`` its block
    of experts (laid by ``expert_entry``: the experts over model, tp), and
    ``shared`` (with shared experts) its dff columns of ``up``/``gate`` and
    rows of ``down`` (``shared_entry``).  -> (out, aux) a shard each.

    JAX's global wave layout: x gathered over its shards and cut
    (waves, G, group size, D) over all B * S tokens, as unsharded, so the
    group size, the capacity, the dropped tokens and the aux loss's means
    are the unsharded run's; the G groups of a wave split over the batch
    axes where the ``moe_groups`` rule divides them (G >= 2), else every
    data row runs all of them.  Each shard routes its groups with the
    whole router (every shard of a data row on the same rows of x, so the
    same expert ids and keep mask a token), runs the FFN of its own
    experts on their slots (``_group_moe``'s expert window) and combines
    them weighted by the gates: a partial sum, added over the expert axes
    (JAX's all-to-all pair written out).  The groups' outputs are then
    gathered over the batch axes and each shard keeps its block.  Waves run
    under ``torch.utils.checkpoint`` while autograd records, all shards of
    a wave in one.  The shared experts are the dense tp MLP: dff-parallel,
    ``down`` row-parallel and summed over its axes.  ``routes``: as
    ``moe_apply``'s, each wave's shards in shard order, each holding its
    own groups."""
    mesh = sharder.mesh
    coords = mesh.coords()
    full = all_gather(all_gather(xs, mesh, spec_axes(batch_entry), 0),
                      mesh, spec_axes(seq_entry), 1)
    B, S, D = full[0].shape
    E = pieces[0]["router"].shape[1]
    gs, waves, G = wave_layout(B * S, group_size, n_waves)
    C = expert_capacity(gs, top_k, capacity_factor, E)
    gentry = sharder.spec(("moe_groups",), (G,))[0]
    Gl = G // axes_size(mesh, spec_axes(gentry))
    xw = []
    for k, x in enumerate(full):
        g0 = block_start(mesh, coords[k], gentry, G)
        xw.append(x.reshape(waves, G, gs, D)[:, g0:g0 + Gl])
    e0 = [block_start(mesh, c, expert_entry, E) for c in coords]
    partial = bool(spec_axes(expert_entry))

    def wave(xgs):
        res = [_group_moe(p, xg, top_k, C, activation, dispatch_mode, e,
                          routes, partial) for p, xg, e in zip(pieces, xgs,
                                                               e0)]
        return tuple([r[i] for r in res] for i in range(3))

    remat = torch.is_grad_enabled()
    outs, mes, ces = [], [], []
    for w in range(waves):
        xgs = [x[w] for x in xw]
        o, me, ce = (checkpoint(wave, xgs, use_reentrant=False) if remat
                     else wave(xgs))
        outs.append(o)
        mes.append(me)
        ces.append(ce)
    # Partial sums over this shard's experts, added over the expert axes.
    outs = psum_rounded([torch.stack(o) for o in zip(*outs)], mesh,
                        spec_axes(expert_entry), xs[0].dtype)
    outs = all_gather(outs, mesh, spec_axes(gentry), 1)
    ng = axes_size(mesh, spec_axes(gentry))
    me = psum([torch.stack(m) for m in zip(*mes)], mesh, spec_axes(gentry))
    ce = psum([torch.stack(c) for c in zip(*ces)], mesh, spec_axes(gentry))
    aux = [E * ((m / ng) * (c / ng)).sum(dim=-1).mean()
           for m, c in zip(me, ce)]
    out = []
    for k, o in enumerate(outs):
        b0 = block_start(mesh, coords[k], batch_entry, B)
        s0 = block_start(mesh, coords[k], seq_entry, S)
        Bl, Sl = xs[k].shape[:2]
        out.append(o.reshape(B, S, D)[b0:b0 + Bl, s0:s0 + Sl])
    if "shared" in pieces[0]:
        dff = spec_axes(shared_entry)
        sh = psum_rounded([mlp_apply(x, p["shared"]["up"],
                                     p["shared"]["gate"],
                                     p["shared"]["down"], activation,
                                     partial=bool(dff))
                           for x, p in zip(xs, pieces)], mesh, dff,
                          xs[0].dtype)
        out = [o + s for o, s in zip(out, sh)]
    return out, aux
