"""Serving steps — the port of the JAX package's ``train/serve_step.py``:
prefill (prompt -> cache + first greedy token) and decode (one token
against the cache), on one device or, given a ``Sharder`` of more than one
shard, on its mesh: the model's sharded ``prefill`` and ``decode_step``
(the family's shard program), the logits over the vocab shards
and the greedy argmax taken across them (``sharded_argmax``).
"""
from __future__ import annotations

import torch

from repro_torch.models.model_zoo import batch_inputs
from repro_torch.models.transformer import StackedModel, mask_pad_logits
from repro_torch.parallel.sharding import (PartitionSpec, Sharded,
                                           all_gather, block_start,
                                           spec_axes)


def _sharder(sharder):
    return None if sharder is None or sharder.trivial else sharder


def sharded_argmax(logits: Sharded) -> torch.Tensor:
    """The greedy token (B,) of logits (B, V) laid (batch, vocab): each
    shard's max and its global index, gathered over the vocab shards in
    order, the first largest kept (``torch.argmax``'s tie rule on the whole
    row), then the rows gathered over the batch shards."""
    mesh, spec = logits.mesh, logits.spec
    V = logits.shape[1]
    vals, idx = [], []
    for coord, piece in zip(mesh.coords(), logits.pieces):
        v, i = piece.max(dim=-1)
        vals.append(v[:, None])
        idx.append((i + block_start(mesh, coord, spec[1], V))[:, None])
    vocab = spec_axes(spec[1])
    vals = all_gather(vals, mesh, vocab, 1)
    idx = all_gather(idx, mesh, vocab, 1)
    best = [i.gather(1, v.argmax(dim=1, keepdim=True))[:, 0]
            for v, i in zip(vals, idx)]
    return Sharded(best, PartitionSpec(spec[0]), (logits.shape[0],),
                   mesh).gather()


def make_prefill_step(model: StackedModel, max_len: int, *, sharder=None):
    """prefill_step(batch) -> (first greedy token (B,), cache); the batch
    holds the tokens and the family's inputs (``model_zoo.batch_inputs``:
    a vlm's ``positions`` and ``vision_embeds``, encdec's
    ``enc_frames``).  Under a sharder the cache is ``Sharded`` pieces."""
    sharder = _sharder(sharder)

    @torch.no_grad()
    def prefill_step(batch: dict):
        kw = {} if sharder is None else {"sharder": sharder}
        last_hidden, cache = model.prefill(batch["tokens"], max_len,
                                           **batch_inputs(model.cfg, batch),
                                           **kw)
        if sharder is not None:
            run = model.sharded(sharder)
            return sharded_argmax(run.logits(last_hidden.pieces,
                                             last_hidden.spec[0])), cache
        logits = mask_pad_logits(model.logits(last_hidden), model.cfg)
        return torch.argmax(logits, dim=-1), cache

    return prefill_step


def make_decode_step(model: StackedModel, kv_len: int, *, sharder=None):
    """kv_len: the cache fill before this step (JAX compiles one step per
    value; here it is a plain argument)."""
    sharder = _sharder(sharder)

    @torch.no_grad()
    def decode_step(token: torch.Tensor, cache: dict):
        if sharder is not None:
            logits, cache = model.decode_step(token, cache, kv_len,
                                              sharder=sharder)
            return sharded_argmax(logits), cache
        logits, cache = model.decode_step(token, cache, kv_len)
        return torch.argmax(logits, dim=-1), cache

    return decode_step


def greedy_generate(model: StackedModel, batch: dict, *, steps: int,
                    max_len: int, sharder=None) -> torch.Tensor:
    """Prefill + ``steps - 1`` greedy decodes: (B, steps) token ids."""
    token, cache = make_prefill_step(model, max_len, sharder=sharder)(batch)
    S = batch["tokens"].shape[1]
    out = [token]
    for i in range(steps - 1):
        token, cache = make_decode_step(model, S + i, sharder=sharder)(
            token, cache)
        out.append(token)
    return torch.stack(out, dim=1)
