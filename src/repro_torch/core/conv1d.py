"""Causal depthwise 1D convolution through the stencil engine's encoding —
the port of the JAX package's ``core/conv1d.py``.

The d_conv=4 depthwise causal conv inside every Mamba2 block (mamba2-370m,
zamba2-1.2b) is a 1D stencil.  As in JAX it is applied as shifted adds,
with causality as an explicit left halo of K-1 zeros; in decode the halo is
the recurrent conv state.  JAX computes it outside any Pallas kernel, and
so does the port: plain PyTorch, summed in fp32 in JAX's tap order and cast
back, so the fp32 result is JAX's bit for bit (its op-by-op run; under
``jit`` XLA fuses the adds into FMAs).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def causal_conv1d(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None = None) -> torch.Tensor:
    """x: (batch, seq, channels); weight: (K, channels) depthwise taps.

    out[b, t, c] = sum_k w[k, c] * x[b, t - (K-1) + k, c]   (zero left-pad)
    """
    K, seq = weight.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0)).float()
    w = weight.float()
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(K):
        out = out + pad[:, k:k + seq] * w[k]
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def causal_conv1d_update(state: torch.Tensor, x_t: torch.Tensor,
                         weight: torch.Tensor,
                         bias: torch.Tensor | None = None):
    """Single-token decode step.

    state: (batch, K-1, channels), the left halo (the last K-1 inputs);
    x_t: (batch, channels), the new input.  Returns (new_state, out_t).
    The window's sum is JAX's einsum: fused multiply-adds in tap order from
    0, then the bias.
    """
    window = torch.cat([state, x_t[:, None, :]], dim=1)     # (B, K, C)
    wf, w = window.float(), weight.float()
    out = torch.zeros(x_t.shape, dtype=torch.float32, device=x_t.device)
    for k in range(weight.shape[0]):
        out = torch.addcmul(out, wf[:, k], w[k])
    if bias is not None:
        out = out + bias.float()
    return window[:, 1:].to(state.dtype), out.to(x_t.dtype)
