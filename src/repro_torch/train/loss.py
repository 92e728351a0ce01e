"""Sequence-chunked softmax cross-entropy — the port of the JAX package's
``train/loss.py`` on one device (no vocab sharding).

The full (tokens x vocab) logits never materialize: the tokens are cut into
``n_chunks`` chunks, each run under ``torch.utils.checkpoint`` (JAX's
``jax.checkpoint`` inside a ``lax.scan``), so one (T / n_chunks, V) fp32
logits block is live at a time and the backward recomputes each chunk's
logits instead of storing them.  At qwen3-0.6b's training shape (4 x 2048
tokens, V = 151,936) a block is 1024 x 151,936 x 4 B = 0.62 GB.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def chunk_count(tokens: int, n_chunks: int) -> int:
    """JAX's rule: ``n_chunks`` if it divides the token count, else the
    largest divisor below it."""
    return next(c for c in range(n_chunks, 0, -1) if tokens % c == 0)


def _chunk_nll(h: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
               valid_vocab: int | None) -> torch.Tensor:
    """Summed nll of one chunk: h (t, D) in the compute type, w (V, D) fp32,
    y (t,) -> fp32 scalar."""
    logits = F.linear(h.float(), w)
    if valid_vocab is not None and valid_vocab < w.shape[0]:
        ids = torch.arange(w.shape[0], device=logits.device)
        logits = torch.where(ids < valid_vocab, logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    correct = logits.gather(1, y.long()[:, None])[:, 0]
    return torch.sum(lse - correct)


def chunked_xent(lm_head: torch.Tensor, hidden: torch.Tensor,
                 labels: torch.Tensor, *, n_chunks: int = 8,
                 valid_vocab: int | None = None) -> torch.Tensor:
    """lm_head: (V, D); hidden: (B, S, D); labels: (B, S) -> mean nll (fp32).

    The logits are taken in fp32 from the operands' values (bf16 operands
    are exact in fp32, so this is JAX's ``preferred_element_type=float32``);
    ``valid_vocab`` masks the padded vocab rows (``ModelConfig.
    padded_vocab``) to -1e30.  The head is cast to fp32 once, outside the
    chunks, so each chunk's backward adds into one fp32 gradient.
    """
    B, S, D = hidden.shape
    T = B * S
    n = chunk_count(T, n_chunks)
    h = hidden.reshape(n, T // n, D)
    y = labels.reshape(n, T // n)
    w = lm_head.float()
    acc = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n):
        acc = acc + checkpoint(_chunk_nll, h[c], w, y[c], valid_vocab,
                               use_reentrant=False)
    return acc / T
