"""Decoder-only transformer, dense family — the port of the JAX package's
``models/transformer.py`` for ``family == "dense"``.

Modes, as in JAX: train-mode ``forward`` (full-sequence causal, no cache,
layer groups under checkpoint), ``prefill`` (full sequence, returns the KV
cache padded to ``max_len``) and ``decode_step`` (one token against the
cache).  ``cfg.attn_impl`` picks the full-sequence attention: ``"flash"``
runs the CUDA kernels (``kernels/flash_attention_bwd.
flash_attention_trainable``, blocks 512 x 512, as ``transformer.py:168``:
K7 forward, K8/K9 backward), ``"xla"`` the plain PyTorch
``models/attention.attention``.  The port runs on one device and has no
sharder, so the field alone picks the path.  Decode attention is
``decode_attention`` on both (JAX runs no Pallas kernel there).

Parameters keep the JAX layouts (wq (D, H, hd), wo (H, hd, D), lm_head
(V, D), ...) so ``models/convert.py`` loads a JAX tree as it is; one
``DenseBlock`` module holds one layer of JAX's stacked ``layers`` tree.
The cache is JAX's: {"k", "v"} of shape (n_layers, B, max_len, KV, hd).
``decode_step`` writes the new token's k/v into it in place (JAX returns an
updated copy) and returns it.

The other LM families (moe, ssm, hybrid, vlm, encdec) raise: they come
with the LM-families item of ROADMAP queue 1.  The solver family
(``family="solver"``) is no transformer: ``model_zoo.build`` sends it to
``models/solver_layer.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import resolve_device
from repro_torch.kernels.flash_attention_bwd import flash_attention_trainable
from repro_torch.models.attention import attention, decode_attention
from repro_torch.models.layers import (ParamDef, apply_rope, flatten,
                                       init_params, rms_norm, stack_tables)
from repro_torch.models.mlp import MLP, mlp_table

FAMILIES = ("dense",)


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.arch}: family {cfg.family!r} is not a transformer the "
            f"port runs yet (the LM-families item of ROADMAP queue 1); it "
            f"runs {FAMILIES}, and family 'solver' through "
            f"model_zoo.build")


# ---------------------------------------------------------------------------
# Parameter tables (JAX's, for the initializer and the weights bridge)
# ---------------------------------------------------------------------------

def attn_table(cfg: ModelConfig) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    t = {
        "wq": ParamDef((D, H, hd)),
        "wk": ParamDef((D, KV, hd)),
        "wv": ParamDef((D, KV, hd)),
        "wo": ParamDef((H, hd, D)),
    }
    if cfg.qk_norm:
        t["q_norm"] = ParamDef((hd,), scale="one")
        t["k_norm"] = ParamDef((hd,), scale="one")
    return t


def block_table(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    return {
        "attn_norm": ParamDef((D,), scale="one"),
        "attn": attn_table(cfg),
        "mlp_norm": ParamDef((D,), scale="one"),
        "mlp": mlp_table(D, cfg.d_ff, cfg.gated_mlp),
    }


def model_table(cfg: ModelConfig) -> dict:
    check_family(cfg)
    D, V = cfg.d_model, cfg.padded_vocab
    return {
        "embed": ParamDef((V, D), scale=1.0),
        "final_norm": ParamDef((D,), scale="one"),
        "lm_head": ParamDef((V, D)),
        "layers": stack_tables(block_table(cfg), cfg.n_layers),
    }


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """q/k/v/o projections, qk_norm, rope, and the flash/plain switch."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.wq = nn.Parameter(torch.empty(D, H, hd, **kw))
        self.wk = nn.Parameter(torch.empty(D, KV, hd, **kw))
        self.wv = nn.Parameter(torch.empty(D, KV, hd, **kw))
        self.wo = nn.Parameter(torch.empty(H, hd, D, **kw))
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.empty(hd, **kw))
            self.k_norm = nn.Parameter(torch.empty(hd, **kw))
        else:
            self.q_norm = self.k_norm = None

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor):
        B, S, D = x.shape
        q = (x @ self.wq.reshape(D, -1)).view(B, S, *self.wq.shape[1:])
        k = (x @ self.wk.reshape(D, -1)).view(B, S, *self.wk.shape[1:])
        v = (x @ self.wv.reshape(D, -1)).view(B, S, *self.wv.shape[1:])
        if self.q_norm is not None:
            q = rms_norm(q, self.q_norm, self.cfg.norm_eps)
            k = rms_norm(k, self.k_norm, self.cfg.norm_eps)
        q = apply_rope(q, positions, self.cfg.rope_theta)
        k = apply_rope(k, positions, self.cfg.rope_theta)
        return q, k, v

    def _out(self, o: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        B, S = o.shape[:2]
        return (o.reshape(B, S, -1) @ self.wo.reshape(-1, x.shape[-1])
                ).to(x.dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """Full-sequence causal attention.  x: (B, S, D) -> (out, (k, v))."""
        q, k, v = self._qkv(x, positions)
        if self.cfg.attn_impl == "flash":
            out = flash_attention_trainable(q, k, v, True, 512, 512, 0)
        elif self.cfg.attn_impl == "xla":
            out = attention(q, k, v, causal=True, q_chunk=self.cfg.q_chunk)
        else:
            raise ValueError(f"attn_impl must be 'xla' or 'flash', got "
                             f"{self.cfg.attn_impl!r}")
        return self._out(out, x), (k, v)

    def decode(self, x: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, kv_len: int, positions: torch.Tensor):
        """One token.  x: (B, 1, D); caches (B, S_max, KV, hd), written at
        ``kv_len`` in place."""
        q, k, v = self._qkv(x, positions)
        k_cache[:, kv_len] = k[:, 0]
        v_cache[:, kv_len] = v[:, 0]
        out = decode_attention(q, k_cache, v_cache, kv_len + 1)
        return self._out(out, x)


class DenseBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = cfg.norm_eps
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.attn_norm = nn.Parameter(torch.empty(cfg.d_model, **kw))
        self.attn = Attention(cfg, **kw)
        self.mlp_norm = nn.Parameter(torch.empty(cfg.d_model, **kw))
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.activation, cfg.gated_mlp,
                       **kw)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """Train/prefill form: -> (x, (k, v))."""
        a, kv = self.attn(rms_norm(x, self.attn_norm, self.eps), positions)
        x = x + a
        return x + self.mlp(rms_norm(x, self.mlp_norm, self.eps)), kv

    def decode(self, x, k_cache, v_cache, kv_len, positions):
        x = x + self.attn.decode(rms_norm(x, self.attn_norm, self.eps),
                                 k_cache, v_cache, kv_len, positions)
        return x + self.mlp(rms_norm(x, self.mlp_norm, self.eps))


class Transformer(nn.Module):
    """The dense decoder.  Its methods are the port's ``ModelApi``
    (``forward``, ``prefill``, ``decode_step``, ``cache_shapes``,
    ``init_cache``); the parameters live in the module.  ``device=None``
    means the card, as for every entry point (``core.plan.resolve_device``);
    the modules below take the same rule."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        kw = dict(device=resolve_device(device), dtype=dtype)
        V, D = cfg.padded_vocab, cfg.d_model
        self.embed = nn.Parameter(torch.empty(V, D, **kw))
        self.final_norm = nn.Parameter(torch.empty(D, **kw))
        self.lm_head = nn.Parameter(torch.empty(V, D, **kw))
        self.layers = nn.ModuleList(DenseBlock(cfg, **kw)
                                    for _ in range(cfg.n_layers))

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- weights -----------------------------------------------------------

    @torch.no_grad()
    def load_params(self, tree: dict) -> None:
        """Copy a JAX-layout parameter tree (stacked ``layers``) in."""
        n = 0
        for path, value in flatten(tree):
            value = torch.as_tensor(value)
            if path[0] == "layers":
                for i, layer in enumerate(self.layers):
                    _param(layer, path[1:]).copy_(value[i])
            else:
                _param(self, path).copy_(value)
            n += 1
        if n != len(flatten(model_table(self.cfg))):
            raise ValueError(f"parameter tree has {n} leaves, the model "
                             f"{len(flatten(model_table(self.cfg)))}")

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Draw every parameter with JAX's rules (``model_table``)."""
        self.load_params(init_params(model_table(self.cfg), generator,
                                     self.dtype, self.device))

    # -- forward modes -----------------------------------------------------

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens]

    def _default_positions(self, tokens: torch.Tensor) -> torch.Tensor:
        B, S = tokens.shape
        return torch.arange(S, device=tokens.device).expand(B, S)

    def _run_layers(self, x: torch.Tensor, positions: torch.Tensor,
                    start: int, stop: int) -> torch.Tensor:
        for layer in self.layers[start:stop]:
            x, _ = layer(x, positions)
        return x

    def forward(self, tokens: torch.Tensor, positions=None, *,
                remat: bool = True):
        """Train-mode forward: (final hidden (B, S, D), aux loss 0).

        With ``remat`` each group of ``cfg.remat_group`` layers (1 where the
        group does not divide ``n_layers``, as JAX's ``_run_layers``) runs
        under ``torch.utils.checkpoint``: the backward keeps one residual a
        group and runs the group's forward again, flash kernel included.
        """
        x = self._embed(tokens)
        if positions is None:
            positions = self._default_positions(tokens)
        n, g = len(self.layers), self.cfg.remat_group
        if not remat:
            x = self._run_layers(x, positions, 0, n)
        else:
            g = g if g > 1 and n % g == 0 else 1
            for start in range(0, n, g):
                x = checkpoint(self._run_layers, x, positions, start,
                               start + g, use_reentrant=False)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return x, torch.zeros((), device=x.device)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int, positions=None):
        """Process a prompt: (last-position hidden (B, D), cache)."""
        B, S = tokens.shape
        if S > max_len:
            raise ValueError(f"prompt of {S} tokens exceeds max_len "
                             f"{max_len}")
        x = self._embed(tokens)
        if positions is None:
            positions = self._default_positions(tokens)
        cache = self.init_cache(B, max_len)
        for i, layer in enumerate(self.layers):
            x, (k, v) = layer(x, positions)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return x[:, -1], cache

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: dict, kv_len: int):
        """One decode step.  token: (B,); kv_len: the cache fill.  Returns
        (logits (B, V) fp32, cache, updated in place)."""
        B = token.shape[0]
        x = self._embed(token[:, None])
        pos = torch.full((B, 1), kv_len, device=token.device)
        for i, layer in enumerate(self.layers):
            x = layer.decode(x, cache["k"][i], cache["v"][i], kv_len, pos)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return mask_pad_logits(self.logits(x[:, 0]), self.cfg), cache

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """hidden (..., D) @ lm_head.T in fp32, as JAX's
        ``preferred_element_type=float32``: bf16 operands are exact in fp32,
        so the product is theirs with fp32 sums and fp32 logits, never
        rounded to bf16."""
        return F.linear(hidden.float(), self.lm_head.float())

    # -- caches ------------------------------------------------------------

    def cache_shapes(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": shape, "v": shape}

    def init_cache(self, batch: int, max_len: int) -> dict:
        return {name: torch.zeros(shape, dtype=self.dtype, device=self.device)
                for name, shape in self.cache_shapes(batch, max_len).items()}


def _param(module: nn.Module, path) -> torch.Tensor:
    for p in path[:-1]:
        module = getattr(module, p)
    t = getattr(module, path[-1])
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"no parameter {'/'.join(path)}")
    return t


def mask_pad_logits(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """-1e30 on the padded vocab rows (see ModelConfig.padded_vocab)."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(ids < cfg.vocab_size, logits, -1e30)
