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

On a mesh (``sharder=`` of more than one shard) the entry points run
``ShardedEncDec``: the encoder whole on every model shard, the decoder's
sequence split as the profile says.

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
from repro_torch.core.plan import resolve_model_device
from repro_torch.models.attention import decode_attention
from repro_torch.models.layers import ParamDef, layer_norm, stack_tables
from repro_torch.models.mlp import MLP, mlp_table
from repro_torch.models.transformer import (Attention, ShardProgram,
                                            StackedModel, attn_table,
                                            mask_pad_logits)
from repro_torch.parallel.sharding import (PartitionSpec, Sharded, psum,
                                           psum_rounded, shard, spec_axes)

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


def encdec_table(cfg: ModelConfig,
                 max_dec_positions: int = MAX_DEC_POSITIONS) -> dict:
    D, V = cfg.d_model, cfg.padded_vocab
    return {
        "embed": ParamDef((V, D), ("vocab", "embed"), scale=1.0),
        "dec_pos": ParamDef((max_dec_positions, D), (None, "embed"),
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

    def shard_program(self) -> type:
        return ShardedEncDec

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.arch}: EncDec runs the encdec family, "
                             f"not {cfg.family!r}")
        self.cfg = cfg
        kw = dict(device=resolve_model_device(device), dtype=dtype)
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
        """Train-mode forward: (final hidden (B, S, D), aux loss 0); under
        a ``sharder`` of more than one shard ``ShardedEncDec``'s, the
        hidden a ``Sharded``."""
        run = self.sharded(sharder)
        if run is not None:
            return run.forward(tokens, enc_frames, remat=remat)
        enc_out = self.encode(enc_frames, remat=remat)
        hidden = self.decode_train(tokens, enc_out, remat=remat)
        return hidden, torch.zeros((), device=hidden.device)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int,
                enc_frames: torch.Tensor, *, sharder=None):
        """Encode, then the teacher-forced decoder over the prompt: (last
        hidden (B, D), cache: the self k/v padded to ``max_len``, the cross
        k/v at enc_len, a layer each); sharded as ``forward``."""
        run = self.sharded(sharder)
        if run is not None:
            return run.prefill(tokens, max_len, enc_frames)
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
        updated in place); under a sharder the cache is ``prefill``'s and
        the logits a ``Sharded``."""
        run = self.sharded(sharder)
        if run is not None:
            return run.decode_step(token, cache, kv_len)
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


class ShardedEncDec(ShardProgram):
    """The encdec family on a mesh (JAX's ``encode``, ``decode_train``,
    ``encdec_prefill`` and ``encdec_decode_step`` with a sharder), on
    ``ShardProgram``'s attention, MLP, embedding and logits.  ``enc_seq``
    has no rule, so the encoder runs whole on every model shard (its batch
    rows over data); the decoder's sequence splits as the residual
    stream's (``sp``: over model where model divides it, else whole), its
    self-attention causal at each block's offset against k and v gathered
    along the sequence, its cross-attention each block's queries on the
    whole encoder output.  Decode: the self cache on ``kv_seq`` over model
    (flash-decoding, as the dense family's), the cross cache on
    ``enc_seq``, whole on every model shard."""

    def _ln(self, name: str, xs: list) -> list:
        w, b = self.w(name + ".w")[0], self.w(name + ".b")[0]
        return [layer_norm(x, w[k], b[k], self.cfg.norm_eps)
                for k, x in enumerate(xs)]

    def _encode(self, frames: torch.Tensor, remat: bool) -> list:
        """Each shard's batch rows of the encoder output (B_l, enc_len,
        D)."""
        B, T, D = frames.shape
        fspec = self.sharder.spec(("batch", "enc_seq", "embed"), (B, T, D))
        spec = PartitionSpec(fspec[0], fspec[1])
        sin = torch.as_tensor(_sinusoid(T, D), device=frames.device)
        xs = [x.to(self.model.dtype) + sin.to(self.model.dtype)[None]
              for x in shard(frames, spec, self.mesh)]
        none = [None] * self.n

        def layer(i, xs):
            pre = f"enc_layers.{i}."
            a, _ = self._attn(pre + "attn.", self._ln(pre + "ln1", xs), none,
                              spec, causal=False, use_rope=False)
            xs = [x + o for x, o in zip(xs, a)]
            m = self._mlp(pre + "mlp.", self._ln(pre + "ln2", xs))
            return [x + o for x, o in zip(xs, m)]

        for i in range(self.cfg.n_enc_layers):
            xs = (checkpoint(layer, i, xs, use_reentrant=False) if remat
                  else layer(i, xs))
        return self._ln("enc_ln", xs)

    def _dec_embed(self, tokens: torch.Tensor, spec, p0: int = 0) -> list:
        """The token embeddings plus ``dec_pos`` at each shard's positions
        (p0 onwards)."""
        xs = self._embed(tokens, spec)
        pos, _ = self.w("dec_pos")
        return [x + pos[k][p0 + self.start(k, spec[1], tokens.shape[1]):]
                [:x.shape[1]][None] for k, x in enumerate(xs)]

    def _dec_block(self, i: int, xs: list, enc: list, spec):
        """-> (xs, self (k, v), cross (k, v)), each shard's."""
        pre = f"dec_layers.{i}."
        none = [None] * self.n
        a, self_kv = self._attn(pre + "self_attn.", self._ln(pre + "ln1", xs),
                                none, spec, use_rope=False)
        xs = [x + o for x, o in zip(xs, a)]
        a, cross_kv = self._attn(pre + "cross_attn.",
                                 self._ln(pre + "ln2", xs), none, spec,
                                 causal=False, kv_src=enc, use_rope=False)
        xs = [x + o for x, o in zip(xs, a)]
        m = self._mlp(pre + "mlp.", self._ln(pre + "ln3", xs))
        return [x + o for x, o in zip(xs, m)], self_kv, cross_kv

    def forward(self, tokens: torch.Tensor, enc_frames: torch.Tensor, *,
                remat: bool = True):
        """-> (final hidden, a ``Sharded`` (B, S, D), aux 0); with
        ``remat`` each encoder and decoder layer under
        ``torch.utils.checkpoint`` across all the shards."""
        B, S = tokens.shape
        spec = self.layout(B, S)
        enc = self._encode(enc_frames, remat)
        xs = self._dec_embed(tokens, spec)

        def layer(i, xs):
            return self._dec_block(i, xs, enc, spec)[0]

        for i in range(self.cfg.n_layers):
            xs = (checkpoint(layer, i, xs, use_reentrant=False) if remat
                  else layer(i, xs))
        xs = self._ln("dec_ln", xs)
        return (Sharded(xs, PartitionSpec(spec[0], spec[1], None),
                        (B, S, self.cfg.d_model), self.mesh),
                torch.zeros((), device=self.model.device))

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int,
                enc_frames: torch.Tensor):
        """-> (last hidden, a ``Sharded`` (B, D); cache {"self": {"k",
        "v"}, "cross_k", "cross_v"} of ``Sharded`` leaves)."""
        B, S = tokens.shape
        if S > max_len:
            raise ValueError(f"prompt of {S} tokens exceeds max_len "
                             f"{max_len}")
        spec = self.layout(B, S)
        enc = self._encode(enc_frames, remat=False)
        cache = self._cache(B, max_len)
        xs = self._dec_embed(tokens, spec)
        for i in range(self.cfg.n_layers):
            xs, self_kv, (ck, cv) = self._dec_block(i, xs, enc, spec)
            self._write_kv(cache["self"], i, self_kv, S)
            for name, t in (("cross_k", ck), ("cross_v", cv)):
                for piece, v in zip(cache[name].pieces, t):
                    piece[i].copy_(v)
        last = self._last(xs, spec, lambda t: self._ln("dec_ln", t))
        return (Sharded(last, PartitionSpec(spec[0], None),
                        (B, self.cfg.d_model), self.mesh), cache)

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: dict, kv_len: int):
        """One token against a ``prefill`` cache (the self cache written in
        place) -> (logits, a ``Sharded`` (B, V) fp32, the cache).  The cross
        query is projected with fp32 sums and rounded once, its output
        likewise, as unsharded."""
        B = token.shape[0]
        D = self.cfg.d_model
        spec = PartitionSpec(self.sharder.spec(("batch",), (B,))[0], None)
        xs = self._dec_embed(token[:, None], spec, kv_len)
        none = [None] * self.n
        for i in range(self.cfg.n_layers):
            pre = f"dec_layers.{i}."
            a = self._attn_decode(pre + "self_attn.",
                                  self._ln(pre + "ln1", xs), none,
                                  cache["self"]["k"], cache["self"]["v"], i,
                                  kv_len)
            xs = [x + o for x, o in zip(xs, a)]
            hs = self._ln(pre + "ln2", xs)
            wq, qspec = self.w(pre + "cross_attn.wq")
            wo, _ = self.w(pre + "cross_attn.wo")
            part = []
            for k, h in enumerate(hs):
                q = (h.float() @ wq[k].float().reshape(D, -1)).to(h.dtype)
                q = q.view(*h.shape[:2], *wq[k].shape[1:])
                _, sel = self._heads(k, qspec, q.shape[2])
                ck = cache["cross_k"].pieces[k][i][:, :, sel]
                cv = cache["cross_v"].pieces[k][i][:, :, sel]
                out = decode_attention(q, ck, cv, ck.shape[1])
                part.append(out.reshape(*h.shape[:2], -1).float()
                            @ wo[k].float().reshape(-1, D))
            a = psum_rounded(part, self.mesh, spec_axes(qspec[1]),
                             hs[0].dtype)
            xs = [x + o for x, o in zip(xs, a)]
            m = self._mlp(pre + "mlp.", self._ln(pre + "ln3", xs))
            xs = [x + o for x, o in zip(xs, m)]
        xs = self._ln("dec_ln", xs)
        return self.logits([x[:, 0] for x in xs], spec[0]), cache
