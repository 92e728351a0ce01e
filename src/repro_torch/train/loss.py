"""Vocab-sharded, sequence-chunked softmax cross-entropy — the port of the
JAX package's ``train/loss.py``.

The full (tokens x vocab) logits never materialize: the tokens are cut into
``n_chunks`` chunks, each run under ``torch.utils.checkpoint`` (JAX's
``jax.checkpoint`` inside a ``lax.scan``), so one (T / n_chunks, V) fp32
logits block is live at a time and the backward recomputes each chunk's
logits instead of storing them.  At qwen3-0.6b's training shape (4 x 2048
tokens, V = 151,936) a block is 1024 x 151,936 x 4 B = 0.62 GB.

Under a sharder (``parallel/sharding.py``) the hidden arrives as a
``Sharded``: each shard chunks its own tokens, and where the lm_head's
vocab rides an axis the tokens leave free (``tp``: vocab over model) each
shard holds a (chunk, V / model) logits block, combined across the vocab
shards by their max, their sum of exp and the owning shard's correct
logit (``sp``, whose tokens take the model axis, gathers the whole head,
as JAX's one-axis-once rule does); a chunk of every shard runs under one
checkpoint.  The loss is the global token mean: each token block counted
once, by the shards at index 0 on the axes the tokens leave free.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.parallel.sharding import (PartitionSpec, Sharded,
                                           block_start, local_view, pmax,
                                           psum, shard, spec_axes)

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


def chunked_xent(lm_head: torch.Tensor, hidden, labels: torch.Tensor, *,
                 sharder=None, n_chunks: int = 8,
                 valid_vocab: int | None = None) -> torch.Tensor:
    """lm_head: (V, D); hidden: (B, S, D); labels: (B, S) -> mean nll (fp32).

    The logits are taken in fp32 from the operands' values (bf16 operands
    are exact in fp32, so this is JAX's ``preferred_element_type=float32``);
    ``valid_vocab`` masks the padded vocab rows (``ModelConfig.
    padded_vocab``) to -1e30.  The head is cast to fp32 once, outside the
    chunks, so each chunk's backward adds into one fp32 gradient.
    ``hidden`` a ``Sharded`` (a sharded forward's): ``sharded_xent``.
    """
    if isinstance(hidden, Sharded):
        return sharded_xent(lm_head, hidden, labels, sharder,
                            n_chunks=n_chunks, valid_vocab=valid_vocab)
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


def _shard_chunk_nll(hs, ws, ys, v0s, vocab, mesh, valid_vocab):
    """Summed nll of one chunk on every shard: hs (t, D), ws (V or V /
    vocab ways, D) fp32 starting at row v0s[k], ys (t,) global ids; the
    vocab shards combined over ``vocab``."""
    logits = []
    for h, w, v0 in zip(hs, ws, v0s):
        lg = F.linear(h.float(), w)
        if valid_vocab is not None:
            ids = v0 + torch.arange(w.shape[0], device=lg.device)
            lg = torch.where(ids < valid_vocab, lg, NEG_INF)
        logits.append(lg)
    if not vocab:
        return [_chunk_nll_of(lg, y) for lg, y in zip(logits, ys)]
    # The max only steadies the exponent: detached, as logsumexp's is.
    top = pmax([lg.detach().amax(dim=-1) for lg in logits], mesh, vocab)
    sums = psum([torch.exp(lg - t[:, None]).sum(dim=-1)
                 for lg, t in zip(logits, top)], mesh, vocab)
    correct = []
    for lg, y, v0 in zip(logits, ys, v0s):
        local = y.long() - v0
        hit = (local >= 0) & (local < lg.shape[1])
        picked = lg.gather(1, local.clamp(0, lg.shape[1] - 1)[:, None])[:, 0]
        correct.append(torch.where(hit, picked, 0.0))
    correct = psum(correct, mesh, vocab)
    return [torch.sum(t + torch.log(s) - c)
            for t, s, c in zip(top, sums, correct)]


def _chunk_nll_of(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    lse = torch.logsumexp(logits, dim=-1)
    return torch.sum(lse - logits.gather(1, y.long()[:, None])[:, 0])


def sharded_xent(lm_head: torch.Tensor, hidden: Sharded,
                 labels: torch.Tensor, sharder, *, n_chunks: int = 8,
                 valid_vocab: int | None = None) -> torch.Tensor:
    """``chunked_xent`` of a sharded forward's hidden (B, S, D), laid
    (batch, seq, None), against global labels (B, S): the mean nll, fp32,
    on the lm_head's device."""
    mesh = hidden.mesh
    tok_spec = PartitionSpec(*hidden.spec[:2])
    used = {a for e in tok_spec for a in spec_axes(e)}
    hspec = sharder.spec(("vocab", "embed"), tuple(lm_head.shape))
    ws, wspec = local_view(lm_head.float(), hspec, mesh,
                           keep=tuple({"model"} - used))
    vocab = spec_axes(wspec[0])
    coords = mesh.coords()
    v0s = [block_start(mesh, c, wspec[0], lm_head.shape[0]) for c in coords]
    D = lm_head.shape[1]
    hs = [h.reshape(-1, D) for h in hidden.pieces]
    ys = [y.reshape(-1) for y in shard(labels, tok_spec, mesh)]
    T = hs[0].shape[0]
    n = chunk_count(T, n_chunks)
    c = T // n
    total = [0.0] * len(hs)
    for i in range(n):
        nll = checkpoint(_shard_chunk_nll, [h[i * c:(i + 1) * c] for h in hs],
                         ws, [y[i * c:(i + 1) * c] for y in ys], v0s, vocab,
                         mesh, valid_vocab, use_reentrant=False)
        total = [a + b for a, b in zip(total, nll)]
    # Each token block once: the shards at index 0 on the free axes.
    free = [j for j, a in enumerate(mesh.axis_names) if a not in used]
    acc = torch.zeros((), dtype=torch.float32, device=lm_head.device)
    for coord, t in zip(coords, total):
        if all(coord[j] == 0 for j in free):
            acc = acc + t.to(lm_head.device)
    return acc / labels.numel()
