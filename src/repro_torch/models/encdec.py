"""Whisper-style encoder-decoder backbone (arXiv:2212.04356) — the port of
the JAX package's ``models/encdec.py``.

The conv frontend is a stub, as in the JAX package: the batch carries
precomputed frame embeddings (``enc_frames``, (B, enc_len, D)).  Encoder:
bidirectional attention blocks without rope, a GELU MLP, layer norms,
sinusoid positions added to the frames.  Decoder: causal self-attention,
cross-attention on the encoder output, a GELU MLP, learned positions
(``dec_pos``, 32768 rows).  The attention is ``transformer.Attention`` with
JAX's switches (``causal``, ``kv_source``, ``use_rope``): with
``attn_impl="flash"`` the encoder's self-attention and the decoder's cross
attention run the CUDA kernels K7 (forward) and K8/K9 (backward)
non-causal, the cross one at Sq = the decoder's length and Skv = enc_len.

Parameters keep JAX's tree (``encdec_table``): ``embed``, ``dec_pos``,
``enc_layers/{ln1/{w, b}, attn/{wq, wk, wv, wo}, ln2, mlp/{up, down}}``
stacked on (n_enc_layers,), ``dec_layers/{ln1, self_attn, ln2,
cross_attn, ln3, mlp}`` on (n_layers,), ``enc_ln``, ``dec_ln`` and
``lm_head``; the module holds one block a layer (``enc_layers.<i>.…``).
The cache is JAX's: {"self": {"k", "v"} (n_layers, B, max_len, KV, hd),
"cross_k", "cross_v" (n_layers, B, enc_len, KV, hd)}; ``decode_step``
writes the new token's self-attention entries in place.

Frames are cast to the model's type before the sinusoid is added (JAX adds
it in the frames' type and leaves the products to promote; with frames of
the model's type, as every caller here passes, the two agree).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import resolve_device
from repro_torch.models.attention import decode_attention
from repro_torch.models.layers import ParamDef, layer_norm, stack_tables
from repro_torch.models.mlp import MLP, mlp_table
from repro_torch.models.transformer import (Attention, StackedModel,
                                            attn_table, mask_pad_logits)

MAX_DEC_POSITIONS = 32768


def _ln(d: int) -> dict:
    return {"w": ParamDef((d,), ("embed",), scale="one"),
            "b": ParamDef((d,), ("embed",), scale="zero")}


def enc_block_table(cfg: ModelConfig) -> dict:
    return {
        "ln1": _ln(cfg.d_model),
        "attn": attn_table(cfg),
        "ln2": _ln(cfg.d_model),
        "mlp": mlp_table(cfg.d_model, cfg.d_ff, gated=False),
    }


def dec_block_table(cfg: ModelConfig) -> dict:
    return {
        "ln1": _ln(cfg.d_model),
        "self_attn": attn_table(cfg),
        "ln2": _ln(cfg.d_model),
        "cross_attn": attn_table(cfg),
        "ln3": _ln(cfg.d_model),
        "mlp": mlp_table(cfg.d_model, cfg.d_ff, gated=False),
    }


def encdec_table(cfg: ModelConfig) -> dict:
    D, V = cfg.d_model, cfg.padded_vocab
    return {
        "embed": ParamDef((V, D), ("vocab", "embed"), scale=1.0),
        "dec_pos": ParamDef((MAX_DEC_POSITIONS, D), (None, "embed"),
                            scale=0.02),
        "enc_layers": stack_tables(enc_block_table(cfg), cfg.n_enc_layers),
        "dec_layers": stack_tables(dec_block_table(cfg), cfg.n_layers),
        "enc_ln": _ln(D),
        "dec_ln": _ln(D),
        "lm_head": ParamDef((V, D), ("vocab", "embed")),
    }


def encdec_axes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The leading axes on which JAX stacks each layer list of the tree."""
    return {"enc_layers": (cfg.n_enc_layers,), "dec_layers": (cfg.n_layers,)}


def _sinusoid(length: int, d: int) -> np.ndarray:
    """JAX's table as written (numpy float64, then fp32), its divisor
    max(1, d//2 - 1) included."""
    pos = np.arange(length)[:, None]
    dim = np.arange(d // 2)[None, :]
    inv = np.exp(-np.log(10000.0) * dim / max(1, d // 2 - 1))
    ang = pos * inv
    return np.concatenate([np.sin(ang), np.cos(ang)],
                          axis=1).astype(np.float32)


class LayerNorm(nn.Module):
    """The ``{w, b}`` of a layer norm (``layers.layer_norm``)."""

    def __init__(self, d: int, eps: float, **kw):
        super().__init__()
        self.eps = eps
        self.w = nn.Parameter(torch.empty(d, **kw))
        self.b = nn.Parameter(torch.empty(d, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.w, self.b, self.eps)


class EncBlock(nn.Module):
    """Bidirectional attention without rope and the GELU MLP, each after a
    layer norm and with the residual (JAX's ``encode`` body)."""

    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, cfg.norm_eps, **kw)
        self.attn = Attention(cfg, **kw)
        self.ln2 = LayerNorm(cfg.d_model, cfg.norm_eps, **kw)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.activation, False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, _ = self.attn(self.ln1(x), causal=False, use_rope=False)
        x = x + a
        return x + self.mlp(self.ln2(x))


class DecBlock(nn.Module):
    """Causal self-attention, cross-attention on the encoder output, the
    GELU MLP (JAX's ``_dec_block``)."""

    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, cfg.norm_eps, **kw)
        self.self_attn = Attention(cfg, **kw)
        self.ln2 = LayerNorm(cfg.d_model, cfg.norm_eps, **kw)
        self.cross_attn = Attention(cfg, **kw)
        self.ln3 = LayerNorm(cfg.d_model, cfg.norm_eps, **kw)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.activation, False, **kw)

    def forward(self, x: torch.Tensor, enc_out: torch.Tensor):
        """Train/prefill form: -> (x, self (k, v), cross (k, v))."""
        a, self_kv = self.self_attn(self.ln1(x), causal=True, use_rope=False)
        x = x + a
        a, cross_kv = self.cross_attn(self.ln2(x), causal=False,
                                      kv_source=enc_out, use_rope=False)
        x = x + a
        return x + self.mlp(self.ln3(x)), self_kv, cross_kv

    def decode(self, x, k_cache, v_cache, cross_k, cross_v, kv_len: int):
        """One token: x (B, 1, D); the self cache written at ``kv_len`` in
        place; the cross query projected with fp32 sums and rounded once,
        then attention over the whole ``enc_len`` cache."""
        x = x + self.self_attn.decode(self.ln1(x), k_cache, v_cache, kv_len)
        h = self.ln2(x)
        p = self.cross_attn
        D = h.shape[-1]
        q = (h.float() @ p.wq.float().reshape(D, -1)).to(h.dtype)
        out = decode_attention(q.view(*h.shape[:2], *p.wq.shape[1:]),
                               cross_k, cross_v, cross_k.shape[1])
        a = (out.reshape(*h.shape[:2], -1).float()
             @ p.wo.float().reshape(-1, D)).to(h.dtype)
        x = x + a
        return x + self.mlp(self.ln3(x))


class EncDec(StackedModel):
    """The encoder-decoder of the encdec family, with ``Transformer``'s
    methods: ``forward`` -> (hidden, aux = 0), ``prefill``, ``decode_step``,
    ``logits``, ``cache_shapes``, ``cache_dims``, ``init_cache``,
    ``init_weights`` (drawn in place) and ``load_params``."""

    param_table = staticmethod(encdec_table)
    param_axes = staticmethod(encdec_axes)

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.arch}: EncDec runs the encdec family, "
                             f"not {cfg.family!r}")
        self.cfg = cfg
        kw = dict(device=resolve_device(device), dtype=dtype)
        V, D = cfg.padded_vocab, cfg.d_model
        self.embed = nn.Parameter(torch.empty(V, D, **kw))
        self.dec_pos = nn.Parameter(torch.empty(MAX_DEC_POSITIONS, D, **kw))
        self.enc_layers = nn.ModuleList(EncBlock(cfg, **kw)
                                        for _ in range(cfg.n_enc_layers))
        self.dec_layers = nn.ModuleList(DecBlock(cfg, **kw)
                                        for _ in range(cfg.n_layers))
        self.enc_ln = LayerNorm(D, cfg.norm_eps, **kw)
        self.dec_ln = LayerNorm(D, cfg.norm_eps, **kw)
        self.lm_head = nn.Parameter(torch.empty(V, D, **kw))

    def encode(self, frames: torch.Tensor, *,
               remat: bool = True) -> torch.Tensor:
        """frames (B, enc_len, D) -> (B, enc_len, D); with ``remat`` each
        layer under ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint``
        of the scan body)."""
        T, D = frames.shape[1:]
        x = frames.to(self.dtype)
        x = x + torch.as_tensor(_sinusoid(T, D), device=x.device).to(
            x.dtype)[None]
        for layer in self.enc_layers:
            x = (checkpoint(layer, x, use_reentrant=False) if remat
                 else layer(x))
        return self.enc_ln(x)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        S = tokens.shape[1]
        return self.embed[tokens] + self.dec_pos[:S][None]

    def decode_train(self, tokens: torch.Tensor, enc_out: torch.Tensor, *,
                     remat: bool = True) -> torch.Tensor:
        """Teacher-forced decoder pass -> final hidden (B, S, D)."""
        x = self._embed(tokens)

        def run(layer, x):
            return layer(x, enc_out)[0]

        for layer in self.dec_layers:
            x = (checkpoint(run, layer, x, use_reentrant=False) if remat
                 else run(layer, x))
        return self.dec_ln(x)

    def forward(self, tokens: torch.Tensor, enc_frames: torch.Tensor, *,
                remat: bool = True, sharder=None):
        """Train-mode forward: (final hidden (B, S, D), aux loss 0).  A
        ``sharder`` of more than one shard raises ``NotImplementedError``
        (``StackedModel.sharded``): the encdec family runs on a 1 x 1
        mesh."""
        self.sharded(sharder)
        enc_out = self.encode(enc_frames, remat=remat)
        hidden = self.decode_train(tokens, enc_out, remat=remat)
        return hidden, torch.zeros((), device=hidden.device)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int,
                enc_frames: torch.Tensor, *, sharder=None):
        """Encode, then the teacher-forced decoder over the prompt: (last
        hidden (B, D), cache: the self k/v padded to ``max_len``, the cross
        k/v at enc_len, a layer each)."""
        self.sharded(sharder)
        B, S = tokens.shape
        if S > max_len:
            raise ValueError(f"prompt of {S} tokens exceeds max_len "
                             f"{max_len}")
        enc_out = self.encode(enc_frames, remat=False)
        cache = self.init_cache(B, max_len)
        x = self._embed(tokens)
        for i, layer in enumerate(self.dec_layers):
            x, (k, v), (ck, cv) = layer(x, enc_out)
            cache["self"]["k"][i, :, :S] = k
            cache["self"]["v"][i, :, :S] = v
            cache["cross_k"][i] = ck
            cache["cross_v"][i] = cv
        return self.dec_ln(x)[:, -1], cache

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: dict, kv_len: int, *,
                    sharder=None):
        """One decode step.  token: (B,); kv_len: the self cache's fill.
        Returns (logits (B, V) fp32 with the padded vocab masked, cache,
        updated in place)."""
        self.sharded(sharder)
        x = self.embed[token[:, None]] + self.dec_pos[kv_len][None, None]
        for i, layer in enumerate(self.dec_layers):
            x = layer.decode(x, cache["self"]["k"][i], cache["self"]["v"][i],
                             cache["cross_k"][i], cache["cross_v"][i],
                             kv_len)
        x = self.dec_ln(x)
        return mask_pad_logits(self.logits(x[:, 0]), self.cfg), cache

    def cache_shapes(self, batch: int, max_len: int) -> dict:
        """The cache's tree (JAX's layout) of (shape, dtype) leaves."""
        cfg, dt = self.cfg, self.dtype
        L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        self_kv = ((L, batch, max_len, KV, hd), dt)
        cross = ((L, batch, cfg.enc_len, KV, hd), dt)
        return {"self": {"k": self_kv, "v": self_kv},
                "cross_k": cross, "cross_v": cross}

    def cache_dims(self) -> dict:
        """The cache's logical dim names (JAX's ``encdec_cache_dims``)."""
        kv = (None, "batch", "kv_seq", "kv_heads", "head_dim")
        cross = (None, "batch", "enc_seq", "kv_heads", "head_dim")
        return {"self": {"k": kv, "v": kv}, "cross_k": cross,
                "cross_v": cross}
