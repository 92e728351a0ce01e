"""Mamba2 / SSD (state-space duality, arXiv:2405.21060) block — the port of
the JAX package's ``models/ssm.py``.

The chunked SSD algorithm: within chunks of Q tokens the recurrence is
computed as masked-decay matrix products; across chunks a loop carries the
(H, P, N) state in fp32.  ngroups=1 (both SSM archs).  The depthwise causal
convs are ``core.conv1d``'s, the stencil engine's 1D causal encoding; the
decode step carries their K-1 left halo as recurrent state.  JAX runs no
Pallas kernel here, and the port launches none: plain PyTorch.

Rounding follows JAX's: x, B and C stream in the compute type; dt, the
decays and every sum stay fp32 (JAX's ``preferred_element_type``).  A
product of bf16 operands is exact in fp32, so the port rounds each operand
to the compute type where JAX does and contracts in fp32 (TF32 off).

``Mamba2Mixer`` holds one layer's parameters (JAX's ``mamba2_table``:
``A_log``, ``D`` and ``dt_bias`` fp32 in every model) and calls the plain
functions ``mamba2_apply`` (full sequence) and ``mamba2_decode`` (one
token), which take the parameters as a dict, as JAX's do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.conv1d import causal_conv1d, causal_conv1d_update
from repro_torch.core.plan import resolve_model_device
from repro_torch.models.layers import ParamDef, rms_norm
from repro_torch.parallel.sharding import (all_gather, block_start, psum,
                                           psum_rounded, row_product,
                                           spec_axes)


def mamba2_table(d_model: int, d_inner: int, n_heads: int, d_state: int,
                 d_conv: int) -> dict:
    f32 = torch.float32
    return {
        "z_proj": ParamDef((d_model, d_inner), ("embed", "conv_channels")),
        "x_proj": ParamDef((d_model, d_inner), ("embed", "conv_channels")),
        "bc_proj": ParamDef((d_model, 2 * d_state), ("embed", None)),
        "dt_proj": ParamDef((d_model, n_heads), ("embed", "ssm_heads")),
        "conv_w": ParamDef((d_conv, d_inner),
                           ("conv_kernel", "conv_channels"), scale=0.5),
        "conv_b": ParamDef((d_inner,), ("conv_channels",), scale="zero"),
        "bc_conv_w": ParamDef((d_conv, 2 * d_state), ("conv_kernel", None),
                              scale=0.5),
        "bc_conv_b": ParamDef((2 * d_state,), (None,), scale="zero"),
        "A_log": ParamDef((n_heads,), ("ssm_heads",), scale="zero",
                          dtype=f32),
        "D": ParamDef((n_heads,), ("ssm_heads",), scale="one", dtype=f32),
        "dt_bias": ParamDef((n_heads,), ("ssm_heads",), scale="zero",
                            dtype=f32),
        "norm_w": ParamDef((d_inner,), ("conv_channels",), scale="one"),
        "out_proj": ParamDef((d_inner, d_model), ("conv_channels", "embed")),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))
    (``F.softplus`` returns x itself past a threshold instead)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _ssd_chunk(state, xdt, dA, Bc, Cc):
    """One chunk of the SSD scan.  state: (B, H, P, N) fp32; xdt (B, Q, H, P)
    and Bc, Cc (B, Q, N) in the compute type; dA (B, Q, H) fp32.  Returns
    (new state, y (B, Q, H, P) fp32)."""
    Q = dA.shape[1]
    cdtype = xdt.dtype
    cum = torch.cumsum(dA, dim=1)                            # (B, Q, H)
    total = cum[:, -1]                                       # (B, H)

    # Intra-chunk: y[i] = sum_{j<=i} (C_i . B_j) exp(seg_ij) xdt_j, where
    # seg_ij = dA_{j+1} + ... + dA_i.  CB and the decay matrix L are rounded
    # to the compute type, and the three-operand product summed in fp32.
    CB = torch.einsum("bin,bjn->bij", Cc.float(), Bc.float())
    # The reference (src/repro/models/ssm.py:53-60) departs from this twice.
    # (1) It takes seg_ij as cum_i - cum_j: near the diagonal, where the
    # decay matters, that is a small difference of two sums that reach
    # 10^2-10^3 within a 256-token chunk at random init, so in fp32 the
    # decay carries errors of 1e-5-1e-4 of itself.  Here each seg_ij is
    # summed over its own segment (a cumsum down i of dA_i masked to
    # i > j), so its rounding is relative to itself.  (2) It exponentiates
    # every (i, j) and masks after: above the diagonal cum_i - cum_j is a
    # sum of positive -dt*A terms, which passes fp32's exp range within a
    # 256-token chunk, so the forward keeps a 0 there but the gradient is
    # 0 * inf = NaN.  Here the mask comes first, and the masked entries are
    # exp(-inf) = 0, whose gradient is 0.
    causal = torch.ones(Q, Q, dtype=torch.bool, device=dA.device).tril()
    seg = torch.cumsum(torch.where(causal.tril(-1)[None, :, :, None],
                                   dA[:, :, None, :], 0.0), dim=1)
    L = torch.exp(seg.masked_fill(~causal[None, :, :, None], -torch.inf))
    M = CB.to(cdtype).float()[..., None] * L.to(cdtype).float()
    y_diag = torch.einsum("bijh,bjhp->bihp", M, xdt.float())

    # Inter-chunk: the carried state's contribution to every position.
    y_off = torch.einsum("bin,bhpn->bihp", Cc.float(),
                         state) * torch.exp(cum)[..., None]

    # state' = state exp(total) + sum_j B_j xdt_j exp(seg_{Q-1, j}); the
    # last row of L is that decay to the chunk's end.
    decay_to_end = L[:, -1]                                  # (B, Q, H)
    new_state = state * torch.exp(total)[:, :, None, None] + torch.einsum(
        "bjhp,bjn->bhpn", xdt.float() * decay_to_end[..., None], Bc.float())
    return new_state, y_diag + y_off


def ssd_scan(xdt, dA, B, C, chunk: int, state0=None):
    """Chunked SSD.  xdt: (B, L, H, P); dA: (B, L, H) fp32; B/C: (B, L, N).

    Returns (y (B, L, H, P) fp32, final state (B, H, P, N) fp32).  While
    autograd records, each chunk runs under ``torch.utils.checkpoint`` (JAX's
    ``jax.checkpoint`` on the scan body): the backward keeps a chunk's
    inputs and runs its forward again.
    """
    Bb, L, H, P = xdt.shape
    N = B.shape[-1]
    if L % chunk:
        # Ragged tail: zero-pad (xdt = 0 adds nothing; dA = 0 decays by
        # exp(0) = 1), so the final state is unaffected; y is sliced back.
        pad = chunk - L % chunk
        padt = lambda t: F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        y, final = ssd_scan(padt(xdt), padt(dA), padt(B), padt(C), chunk,
                            state0)
        return y[:, :L], final
    state = (torch.zeros(Bb, H, P, N, dtype=torch.float32, device=xdt.device)
             if state0 is None else state0.float())
    remat = torch.is_grad_enabled()
    ys = []
    for s in range(0, L, chunk):
        args = (state, xdt[:, s:s + chunk], dA[:, s:s + chunk],
                B[:, s:s + chunk], C[:, s:s + chunk])
        state, y = (checkpoint(_ssd_chunk, *args, use_reentrant=False)
                    if remat else _ssd_chunk(*args))
        ys.append(y)
    return torch.cat(ys, dim=1), state


def _project(params: dict, x: torch.Tensor):
    """x (B, L, D) -> z, the conv's x channels and B|C (silu, compute
    type), and dt (fp32, before its bias): the channels those of the
    parameters given (a layer's, or one shard's block)."""
    dt_ = x.dtype
    z = (x @ params["z_proj"]).to(dt_)
    xc = (x @ params["x_proj"]).to(dt_)
    bc = (x @ params["bc_proj"]).to(dt_)
    dt = x.float() @ params["dt_proj"].float()
    # The stencil engine's causal convs.
    xc = F.silu(causal_conv1d(xc, params["conv_w"],
                              params["conv_b"]).float()).to(dt_)
    bc = F.silu(causal_conv1d(bc, params["bc_conv_w"],
                              params["bc_conv_b"]).float()).to(dt_)
    return z, xc, bc, dt


def _scan(params: dict, xc, bc, dt, head_dim: int, chunk: int,
          initial_state=None):
    """The SSD over xc's C // head_dim heads (``params``' A_log, D and
    dt_bias the same heads) -> (y (B, L, C) in xc's type, final state
    fp32)."""
    Bb, L, C = xc.shape
    A = -torch.exp(params["A_log"].float())                       # (H,)
    dt = softplus(dt + params["dt_bias"].float())                 # (B, L, H)
    xh = xc.reshape(Bb, L, C // head_dim, head_dim)
    Bmat, Cmat = torch.chunk(bc, 2, dim=-1)                       # (B, L, N)
    xdt = (xh.float() * dt[..., None]).to(xc.dtype)
    y, final = ssd_scan(xdt, dt * A, Bmat, Cmat, chunk,
                        state0=initial_state)
    y = y + params["D"].float()[None, None, :, None] * xh.float()
    return y.reshape(Bb, L, C).to(xc.dtype), final


def mamba2_apply(params: dict, x: torch.Tensor, *, n_heads: int,
                 head_dim: int, d_state: int, chunk: int, initial_state=None,
                 return_state: bool = False):
    """Full-sequence Mamba2 block.  x: (B, L, D) -> (B, L, D) (and the final
    SSD state, fp32, with ``return_state``)."""
    dt_ = x.dtype
    z, xc, bc, dt = _project(params, x)
    y, final = _scan(params, xc, bc, dt, head_dim, chunk, initial_state)
    # Gated RMSNorm, then the output projection.
    y = rms_norm((y.float() * F.silu(z.float())).to(dt_), params["norm_w"])
    out = (y @ params["out_proj"]).to(dt_)
    if return_state:
        return out, final
    return out


def _project_token(params: dict, x_t: torch.Tensor, cache: dict):
    """One token's z, conv'd x channels and B|C (fp32, as JAX's decode
    keeps them), dt (the projection rounded to the compute type, as
    JAX's) and the new conv halos."""
    dt_ = x_t.dtype
    z = (x_t @ params["z_proj"]).to(dt_)
    xc = (x_t @ params["x_proj"]).to(dt_)
    bc = (x_t @ params["bc_proj"]).to(dt_)
    dt = (x_t @ params["dt_proj"]).float()
    conv_x, xc = causal_conv1d_update(cache["conv_x"], xc, params["conv_w"],
                                      params["conv_b"])
    conv_bc, bc = causal_conv1d_update(cache["conv_bc"], bc,
                                       params["bc_conv_w"],
                                       params["bc_conv_b"])
    return (z, F.silu(xc.float()), F.silu(bc.float()), dt,
            {"conv_x": conv_x, "conv_bc": conv_bc})


def _step(params: dict, xc, bc, dt, state, head_dim: int):
    """One token's SSD update over xc's heads -> (y (B, C) fp32, the new
    state (B, H, P, N) fp32)."""
    Bb, C = xc.shape
    A = -torch.exp(params["A_log"].float())
    dt = softplus(dt + params["dt_bias"].float())                 # (B, H)
    xh = xc.reshape(Bb, C // head_dim, head_dim)
    Bv, Cv = torch.chunk(bc, 2, dim=-1)                           # (B, N)
    decay = torch.exp(dt * A)                                     # (B, H)
    state = state.float() * decay[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xh, Bv)
    y = torch.einsum("bhpn,bn->bhp", state, Cv)
    y = y + params["D"].float()[None, :, None] * xh
    return y.reshape(Bb, C), state


def mamba2_decode(params: dict, x_t: torch.Tensor, cache: dict, *,
                  n_heads: int, head_dim: int, d_state: int):
    """One-token decode.  x_t: (B, D); cache: {conv_x, conv_bc, state}.
    Returns (out (B, D), new cache), as JAX's (which rounds the dt
    projection to the compute type here, and keeps the conv outputs fp32)."""
    dt_ = x_t.dtype
    z, xc, bc, dt, new = _project_token(params, x_t, cache)
    y, state = _step(params, xc, bc, dt, cache["state"], head_dim)
    y = rms_norm((y * F.silu(z.float())).to(dt_), params["norm_w"])
    out = (y @ params["out_proj"]).to(dt_)
    return out, {**new, "state": state.to(cache["state"].dtype)}


def _gated_norm_out(mesh, ys, zs, norm_w, out_proj, chan, gathered,
                    d_inner: int, dt_: torch.dtype, eps: float = 1e-6):
    """The gated RMSNorm and the row-parallel ``out_proj``, in the compute
    type ``dt_``, of each shard's y and z (..., channels), their channels
    the shard's block of ``conv_channels`` (laid by ``chan``) or, where
    ``gathered``, all d_inner.  The norm's mean square runs over the whole
    d_inner: a block's sum of squares is added over the channel axes
    before the rsqrt.  ``out_proj``'s rows are the shard's block, so the
    products are partial sums, added over the same axes in fp32 and rounded
    once (``sharding.psum_rounded``)."""
    gs = [(y.float() * F.silu(z.float())).to(dt_) for y, z in zip(ys, zs)]
    ss = [torch.sum(torch.square(g.float()), dim=-1, keepdim=True)
          for g in gs]
    if not gathered:
        ss = psum(ss, mesh, spec_axes(chan))
    outs = []
    for k, (g, s) in enumerate(zip(gs, ss)):
        if gathered and spec_axes(chan):
            c0 = block_start(mesh, mesh.coords()[k], chan, d_inner)
            g = g[..., c0:c0 + norm_w[k].shape[0]]
        y = (g.float() * torch.rsqrt(s / d_inner + eps)
             * norm_w[k].float()).to(dt_)
        outs.append(row_product(y, out_proj[k], bool(spec_axes(chan))))
    return psum_rounded(outs, mesh, chan, dt_)


def mamba2_sharded(pieces: list, hs: list, mesh, *, chan, heads,
                   n_heads: int, head_dim: int, d_state: int, chunk: int,
                   return_state: bool = False):
    """``mamba2_apply`` on a mesh, one shard-local program a coordinate:
    ``hs`` each shard's (B_l, L, D) rows, ``pieces`` each shard's view of
    the mixer's parameters (``mamba2_table``): ``z_proj``, ``x_proj``,
    ``conv_w``, ``conv_b``, ``norm_w`` and ``out_proj``'s rows its block of
    ``conv_channels`` (laid by ``chan``), ``dt_proj``, ``A_log``, ``D`` and
    ``dt_bias`` its block of ``ssm_heads`` (``heads``), ``bc_proj`` and the
    ``bc_conv`` taps whole (their dims are None), so every shard projects
    and convolves B and C itself.  The SSD is independent a head: where
    the channels and the heads split alike (tp: both over model, d_inner /
    model = whole heads) each shard scans its heads, and the gated norm
    and ``out_proj`` add their partial sums over the channel axes
    (``_gated_norm_out``).  Where the two resolve to different specs (the
    divisibility fallback: heads whole, channels split) each shard gathers
    z and the conv's output over the channel axes and scans every head.
    -> each shard's out (and with ``return_state`` its final SSD state, its
    heads' or all)."""
    gathered = spec_axes(chan) != spec_axes(heads)
    zs, xcs, bcs, dts = zip(*(_project(p, x) for p, x in zip(pieces, hs)))
    if gathered:
        zs = all_gather(zs, mesh, spec_axes(chan), -1)
        xcs = all_gather(xcs, mesh, spec_axes(chan), -1)
    ys, finals = zip(*(_scan(p, xc, bc, dt, head_dim, chunk)
                       for p, xc, bc, dt in zip(pieces, xcs, bcs, dts)))
    out = _gated_norm_out(mesh, ys, zs, [p["norm_w"] for p in pieces],
                          [p["out_proj"] for p in pieces], chan, gathered,
                          n_heads * head_dim, hs[0].dtype)
    return (out, list(finals)) if return_state else out


def mamba2_decode_sharded(pieces: list, xts: list, caches: list, mesh, *,
                          chan, heads, n_heads: int, head_dim: int,
                          d_state: int, headdim=None):
    """``mamba2_decode`` on a mesh (``mamba2_sharded``'s layout): ``xts``
    each shard's (B_l, D) token rows, ``caches`` each shard's pieces of
    the layer's cache (``conv_x`` its channel block, ``conv_bc`` whole,
    ``state`` its heads, or every head where the heads do not split as the
    channels do).  -> (each shard's out (B_l, D), each shard's new cache
    pieces).

    ``headdim``: the state's spec entry on its head dim (``ssm_headdim``,
    over data under ``state_over_data``).  Where it shards, each shard
    updates the (B, H_l, P_l, N) block of the state it holds from its
    P_l slice of the token's x heads (its channel block, or all channels,
    as above), and the outputs y (B, H_l, P_l) are all-gathered over
    those axes before the gated norm: the norm's sum of squares and
    ``out_proj``'s partial products then run over the channel block and
    add over the channel axes alone, as without the flag.  (Adding the
    partial products over data too would move D values a shard instead of
    d_inner / model: more at every arch's widths.)"""
    gathered = spec_axes(chan) != spec_axes(heads)
    zs, xcs, bcs, dts, new = zip(*(_project_token(p, x, c) for p, x, c
                                   in zip(pieces, xts, caches)))
    if gathered:
        zs = all_gather(zs, mesh, spec_axes(chan), -1)
        xcs = all_gather(xcs, mesh, spec_axes(chan), -1)
    split = spec_axes(headdim)
    ys = []
    for k, (p, xc, bc, dt, c, n) in enumerate(zip(pieces, xcs, bcs, dts,
                                                  caches, new)):
        Pl = c["state"].shape[2]
        if split:
            Bb, C = xc.shape
            p0 = block_start(mesh, mesh.coords()[k], headdim, head_dim)
            xc = xc.reshape(Bb, C // head_dim, head_dim)[..., p0:p0 + Pl]
            xc = xc.reshape(Bb, -1)
        y, state = _step(p, xc, bc, dt, c["state"], Pl)
        ys.append(y)
        n["state"] = state.to(c["state"].dtype)
    if split:
        ys = [y.reshape(y.shape[0], -1, c["state"].shape[2])
              for y, c in zip(ys, caches)]
        ys = [y.reshape(y.shape[0], -1) for y in
              all_gather(ys, mesh, split, 2)]
    out = _gated_norm_out(mesh, ys, zs, [p["norm_w"] for p in pieces],
                          [p["out_proj"] for p in pieces], chan, gathered,
                          n_heads * head_dim, xts[0].dtype)
    return out, list(new)


def mamba2_cache_shapes(batch: int, n_heads: int, head_dim: int,
                        d_state: int, d_conv: int, d_inner: int,
                        dtype: torch.dtype) -> dict:
    """{name: (shape, dtype)} of one layer's decode cache (``state`` fp32)."""
    return {
        "conv_x": ((batch, d_conv - 1, d_inner), dtype),
        "conv_bc": ((batch, d_conv - 1, 2 * d_state), dtype),
        "state": ((batch, n_heads, head_dim, d_state), torch.float32),
    }


def mamba2_cache_dims() -> dict:
    return {
        "conv_x": ("batch", "conv_kernel", "conv_channels"),
        "conv_bc": ("batch", "conv_kernel", None),
        "state": ("batch", "ssm_heads", "ssm_headdim", "ssm_state"),
    }


class Mamba2Mixer(nn.Module):
    """One layer's ``mamba2_table`` parameters, each in its ParamDef's type
    (the model's where it sets none).  ``device=None`` means the card."""

    def __init__(self, d_model: int, d_inner: int, n_heads: int,
                 head_dim: int, d_state: int, d_conv: int, chunk: int, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.kw = dict(n_heads=n_heads, head_dim=head_dim, d_state=d_state)
        self.chunk = chunk
        dev = resolve_model_device(device)
        for name, pd in mamba2_table(d_model, d_inner, n_heads, d_state,
                                     d_conv).items():
            self.register_parameter(name, nn.Parameter(torch.empty(
                pd.shape, device=dev, dtype=pd.dtype or dtype)))

    def params(self) -> dict:
        return dict(self.named_parameters(recurse=False))

    def forward(self, h: torch.Tensor, return_state: bool = False):
        return mamba2_apply(self.params(), h, chunk=self.chunk,
                            return_state=return_state, **self.kw)

    def decode(self, h_t: torch.Tensor, cache: dict):
        return mamba2_decode(self.params(), h_t, cache, **self.kw)
