"""Serving steps — the port of the JAX package's ``train/serve_step.py``:
prefill (prompt -> cache + first greedy token) and decode (one token
against the cache), on one device with no sharder.
"""
from __future__ import annotations

import torch

from repro_torch.models.model_zoo import batch_inputs
from repro_torch.models.transformer import StackedModel, mask_pad_logits


def make_prefill_step(model: StackedModel, max_len: int):
    """prefill_step(batch) -> (first greedy token (B,), cache); the batch
    holds the tokens and the family's inputs (``model_zoo.batch_inputs``:
    a vlm's ``positions`` and ``vision_embeds``, encdec's
    ``enc_frames``)."""
    @torch.no_grad()
    def prefill_step(batch: dict):
        last_hidden, cache = model.prefill(batch["tokens"], max_len,
                                           **batch_inputs(model.cfg, batch))
        logits = mask_pad_logits(model.logits(last_hidden), model.cfg)
        return torch.argmax(logits, dim=-1), cache

    return prefill_step


def make_decode_step(model: StackedModel, kv_len: int):
    """kv_len: the cache fill before this step (JAX compiles one step per
    value; here it is a plain argument)."""
    @torch.no_grad()
    def decode_step(token: torch.Tensor, cache: dict):
        logits, cache = model.decode_step(token, cache, kv_len)
        return torch.argmax(logits, dim=-1), cache

    return decode_step


def greedy_generate(model: StackedModel, batch: dict, *, steps: int,
                    max_len: int) -> torch.Tensor:
    """Prefill + ``steps - 1`` greedy decodes: (B, steps) token ids."""
    token, cache = make_prefill_step(model, max_len)(batch)
    S = batch["tokens"].shape[1]
    out = [token]
    for i in range(steps - 1):
        token, cache = make_decode_step(model, S + i)(token, cache)
        out.append(token)
    return torch.stack(out, dim=1)
