"""K7: the attention forward that also writes the row logsumexp — the port of
the TPU kernel ``kernels/flash_attention_bwd.py::_flash_fwd`` — and
``flash_attention_trainable``, the op the transformer calls.

``flash_fwd`` dispatches on the device of ``q``: a CPU tensor goes through
``flash_fwd_plain`` (``flash_attention.online_softmax_plain``, the TPU
kernels' arithmetic over their own blocks, ``layout``), a CUDA tensor
launches ``csrc/flash_attention.cu`` with its lse output on and raises if it
cannot.

The backward kernels (K8 ``_dq_kernel``, K9 ``_dkv_kernel``) are the next
slice (ROADMAP queue 2 item 6).  Until then ``flash_attention_trainable``
runs the forward only and raises where a gradient would be needed: it never
returns a wrong one.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import launch, online_softmax_plain


def flash_fwd_plain(q, k, v, *, causal: bool = True, block_q: int = 512,
                    block_k: int = 512, kv_offset: int = 0):
    """K7's plain PyTorch version: (out (B, Sq, H, hd), lse (B, H, Sq))."""
    return online_softmax_plain(q, k, v, causal=causal, block_q=block_q,
                                block_k=block_k, kv_offset=kv_offset)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, block_q: int = 512, block_k: int = 512,
              kv_offset: int = 0):
    """q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd) -> (out (B, Sq, H, hd) in
    q's type, lse (B, H, Sq) fp32)."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, block_q=block_q,
                               block_k=block_k, kv_offset=kv_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cpu or cuda, not {q.device}")
    return launch(q, k, v, causal=causal, kv_offset=kv_offset, with_lse=True,
                  name="flash_fwd")


def flash_attention_trainable(q, k, v, causal: bool = True,
                              block_q: int = 512, block_k: int = 512,
                              kv_offset: int = 0) -> torch.Tensor:
    """The forward of the JAX package's custom_vjp op (K7).  Raises when
    autograd would need its backward."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention_trainable has no backward yet: the flash "
            "backward kernels K8/K9 come with the training slice (ROADMAP "
            "queue 2 item 6); run under torch.no_grad() or use "
            "attn_impl='xla'")
    return flash_fwd(q, k, v, causal=causal, block_q=block_q,
                     block_k=block_k, kv_offset=kv_offset)[0]
