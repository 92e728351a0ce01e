"""Inputs, the decode-against-forward check and planted faults shared by
the vlm and encdec tests, ``tests/_torch_vlm_encdec_noise.py`` and
``chip_smoke.py``'s phases 30-32 (no JAX here)."""
import contextlib

import numpy as np
import torch

from repro_torch.models import encdec as E
from repro_torch.models import transformer as T


def grid_positions(batch: int, seq: int, n_vision: int,
                   width: int) -> np.ndarray:
    """(3, batch, seq) int64 M-RoPE ids by Qwen2-VL's rule for a prompt
    whose first ``n_vision`` tokens are a patch grid ``width`` wide: vision
    token i at (0, i // width, i % width), text token j after it at
    offset + j on all three channels, the offset one past the grid's
    largest id (32 for a 32 x 32 grid)."""
    rows = -(-n_vision // width)
    i = np.arange(n_vision)
    vision = np.stack([np.zeros_like(i), i // width, i % width])
    text = max(rows, width) + np.arange(seq - n_vision)
    pos = np.concatenate([vision, np.broadcast_to(text, (3, len(text)))],
                         axis=1)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None],
                                                (3, batch, seq)))


def family_inputs(cfg, batch, seq, seed, device, dtype, n_vision=None,
                  width=32) -> dict:
    """The inputs besides the tokens, drawn from ``seed`` on ``device``: a
    vlm's vision prefix (normal, the token embeddings' std of 1) and its
    grid ids (``n_vision`` tokens, default the config's, on a grid
    ``width`` wide), or encdec's frames (normal)."""
    g = torch.Generator(device=device).manual_seed(seed)
    if cfg.family == "encdec":
        return {"enc_frames": torch.randn(batch, cfg.enc_len, cfg.d_model,
                                          generator=g,
                                          device=device).to(dtype)}
    nv = cfg.n_vision_tokens if n_vision is None else n_vision
    return {"vision_embeds": torch.randn(batch, nv, cfg.d_model, generator=g,
                                         device=device).to(dtype),
            "positions": torch.as_tensor(
                grid_positions(batch, seq, nv, width), device=device)}


def decode_positions(prompt: np.ndarray, n_decoded: int) -> np.ndarray:
    """The prompt's (3, B, S) ids followed by those decode gives the next
    ``n_decoded`` tokens: the cache fill kv_len = S + i on every channel
    (the JAX package's ``decode_step``)."""
    _, B, S = prompt.shape
    after = np.broadcast_to(S + np.arange(n_decoded), (3, B, n_decoded))
    return np.concatenate([prompt, after], axis=2)


def sections_swapped(sections: tuple[int, ...]) -> tuple[int, ...]:
    """M-RoPE's sections with the first two exchanged (a fault that keeps
    their sum): (16, 24, 24) -> (24, 16, 24)."""
    return (sections[1], sections[0], *sections[2:])


@contextlib.contextmanager
def cross_attention_causal():
    """Every attention with a ``kv_source`` runs causal (a fault of the
    decoder's cross-attention)."""
    orig = T.Attention.forward

    def forward(self, x, positions=None, *, causal=True, kv_source=None,
                use_rope=True):
        return orig(self, x, positions, causal=causal or kv_source is not None,
                    kv_source=kv_source, use_rope=use_rope)

    T.Attention.forward = forward
    try:
        yield
    finally:
        T.Attention.forward = orig


@contextlib.contextmanager
def sinusoid_shifted():
    """The encoder's sinusoid table one position late (row t holds t + 1)."""
    orig = E._sinusoid
    E._sinusoid = lambda length, d: orig(length + 1, d)[1:]
    try:
        yield
    finally:
        E._sinusoid = orig


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|, in float64."""
    a, b = a.double(), b.double().to(a.device)
    return float((a - b).abs().max() / b.abs().max())


def decode_vs_forward(model, prompts, steps, inputs, positions=None, *,
                      tokens=None, prefill_model=None, fault=None,
                      forward_fault=None, keep=False):
    """Prefill ``prompts`` (B, S), then ``steps`` decode steps, each held
    to the train-mode forward over the tokens so far at its last position.
    ``inputs``: the family's other inputs (``vision_embeds`` or
    ``enc_frames``); ``positions`` the prompt's (3, B, S) M-RoPE ids, which
    the forward extends with kv_len on every channel (``decode_positions``).
    The tokens fed are the decode's greedy ones, or ``tokens`` (B, steps)
    where given.  The prefill runs on ``prefill_model`` and under
    ``fault`` (a context manager), the forward under ``forward_fault``,
    where given: the planted faults.
    Returns {"errs": per step ``rel`` of the logits, "tokens": those fed,
    and with ``keep`` "decode" and "forward": the logits on the CPU}; the
    logits are cut to the vocab."""
    cfg = model.cfg
    V = cfg.vocab_size
    B, S = prompts.shape
    pos = None
    if positions is not None:
        pos = torch.as_tensor(decode_positions(
            np.asarray(positions.cpu()), steps), device=prompts.device)

    def kw(n):
        return dict(inputs) if pos is None else {**inputs,
                                                 "positions": pos[..., :n]}

    with fault() if fault is not None else contextlib.nullcontext():
        h, cache = (prefill_model or model).prefill(prompts, S + steps + 1,
                                                    **kw(S))
    with torch.no_grad():
        tok = torch.argmax(T.mask_pad_logits(model.logits(h), cfg), -1)
    seq, out = prompts, {"errs": [], "tokens": [], "decode": [],
                         "forward": []}
    for i in range(steps):
        if tokens is not None:
            tok = tokens[:, i]
        seq = torch.cat([seq, tok[:, None]], dim=1)
        out["tokens"].append(tok)
        logits, cache = model.decode_step(tok, cache, S + i)
        with torch.no_grad(), (forward_fault() if forward_fault is not None
                               else contextlib.nullcontext()):
            hidden, _ = model(seq, remat=False, **kw(S + i + 1))
            want = model.logits(hidden[:, -1])
        out["errs"].append(rel(logits[:, :V], want[:, :V]))
        if keep:
            out["decode"].append(logits[:, :V].cpu())
            out["forward"].append(want[:, :V].cpu())
        tok = torch.argmax(logits, -1)
        del hidden, want
    out["tokens"] = torch.stack(out["tokens"], dim=1)
    return out
