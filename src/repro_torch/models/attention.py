"""GQA attention in plain PyTorch — the port of the JAX package's
``models/attention.py``: the q-chunked softmax for prefill (``attention``)
and the cached single-token form for decode (``decode_attention``).

This is the ``attn_impl="xla"`` path of the transformer and the yardstick
that the flash kernels (``kernels/flash_attention*.py``) are held to.  Two
layouts, as in JAX: the grouped einsum (no K/V broadcast) and, with
``shard_heads=True``, K/V broadcast to every query head first.  Scores are
taken in fp32 from inputs in their own dtype (a bf16 x bf16 product is exact
in fp32, so casting the operands up is JAX's ``preferred_element_type``),
and never materialize past one (B, H, q_chunk, Skv) block.
"""
from __future__ import annotations

import torch

MASK_VALUE = -1e30


def _repeat_kv(k: torch.Tensor, H: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd) broadcasting each KV head to its
    group."""
    B, S, KV, hd = k.shape
    return k[:, :, :, None].expand(B, S, KV, H // KV, hd).reshape(B, S, H, hd)


def _causal_mask(q_pos0: int, C: int, kv_pos: torch.Tensor) -> torch.Tensor:
    qp = q_pos0 + torch.arange(C, device=kv_pos.device)[:, None]
    return kv_pos[None, :] <= qp


def _chunk_attn_full(q, k, v, q_pos0, kv_pos, causal, scale):
    """q: (B,C,H,hd); k/v: (B,S,H,hd) (already head-broadcast)."""
    scores = torch.einsum("bchd,bshd->bhcs", q.float(), k.float()) * scale
    if causal:
        mask = _causal_mask(q_pos0, q.shape[1], kv_pos)
        scores = torch.where(mask[None, None], scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhcs,bshd->bchd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def _chunk_attn_grouped(q, k, v, q_pos0, kv_pos, causal, scale):
    """q: (B,C,KV,G,hd); k/v: (B,S,KV,hd) (no broadcast materialized)."""
    scores = torch.einsum("bckgh,bskh->bkgcs", q.float(), k.float()) * scale
    if causal:
        mask = _causal_mask(q_pos0, q.shape[1], kv_pos)
        scores = torch.where(mask[None, None, None], scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgcs,bskh->bckgh", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_chunk: int = 1024, kv_offset: int = 0,
              shard_heads: bool = False) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd) -> (B, Sq, H, hd).

    kv token j sits at position j + kv_offset; query token i at position i.
    """
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    scale = hd ** -0.5
    kv_pos = torch.arange(k.shape[1], device=q.device) + kv_offset

    if shard_heads:
        k, v = _repeat_kv(k, H), _repeat_kv(v, H)
        qx = q
        chunk_fn = _chunk_attn_full
    else:
        qx = q.reshape(B, Sq, KV, H // KV, hd)
        chunk_fn = _chunk_attn_grouped

    if Sq % q_chunk:
        q_chunk = next(c for c in range(min(q_chunk, Sq), 0, -1)
                       if Sq % c == 0)
    outs = [chunk_fn(qx[:, i:i + q_chunk], k, v, i, kv_pos, causal, scale)
            for i in range(0, Sq, q_chunk)]
    return torch.cat(outs, dim=1).reshape(B, Sq, H, hd)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: int) -> torch.Tensor:
    """Single-step decode.  q: (B, 1, H, hd); caches: (B, S_max, KV, hd).

    Grouped einsum (no KV broadcast: decode is cache-bandwidth-bound).
    kv_len masks the valid prefix (cache slots >= kv_len are ignored).
    """
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    scale = hd ** -0.5
    qg = q.reshape(B, KV, H // KV, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg.float(),
                          k_cache.float()) * scale
    pos = torch.arange(k_cache.shape[1], device=q.device)
    scores = torch.where(pos[None, None, None, :] < kv_len, scores,
                         MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", probs.to(v_cache.dtype),
                       v_cache).to(q.dtype)
    return out.reshape(B, 1, H, hd)
