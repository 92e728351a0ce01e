"""Decoder-only transformer, the dense, moe, ssm, hybrid and vlm families —
the port of the JAX package's ``models/transformer.py`` for ``family`` in
``FAMILIES``, and what the LM models share (``StackedModel``, ``Attention``,
which ``models/encdec.py`` reuses).

Modes, as in JAX: train-mode ``forward`` (full-sequence causal, no cache,
layer groups under checkpoint), ``prefill`` (full sequence, returns the
cache, attention's padded to ``max_len``) and ``decode_step`` (one token
against the cache).  ``cfg.attn_impl`` picks the full-sequence attention:
``"flash"`` runs the CUDA kernels (``kernels/flash_attention_bwd.
flash_attention_trainable``, blocks 512 x 512, as ``transformer.py:168``:
K7 forward, K8/K9 backward), ``"xla"`` the plain PyTorch
``models/attention.attention``; the field alone picks the path, on one
device and, with ``sharder=``, on every shard of a mesh (the family's
``ShardProgram``, tp or sp profile; JAX keeps XLA attention under a
sharder only so that its HLO cost stays visible).  Decode attention is
``decode_attention`` on both (JAX runs no Pallas kernel there).

The families:

- dense: ``layers``, one ``DenseBlock`` a layer;
- vlm (qwen2-vl-2b): the dense stack, with the stub vision tower's patch
  embeddings (``vision_embeds``, (B, nv, D)) in place of the first nv
  token embeddings and M-RoPE (``layers.apply_mrope``) on (3, B, S)
  ``positions``: arange on every channel by default, and ``kv_len`` on
  every channel in decode (JAX's ``decode_step``);
- moe (qwen3-moe-30b-a3b, moonshot-v1-16b-a3b): ``layers``, one
  ``DenseBlock`` a layer whose FFN is ``models/moe.MoE`` (parameters under
  ``moe``), in groups of ``cfg.moe_group_size`` tokens in train and
  prefill and of min(``cfg.moe_group_size``, B) in decode, as JAX's
  ``dense_block``; ``forward`` returns the sum of the layers' aux losses;
- ssm (mamba2-370m): ``layers``, one ``MambaBlock`` a layer (rms-norm, then
  the ``models/ssm.py`` mixer, plus the residual); no attention, so no
  kernel of K1-K9 and ``attn_impl`` does not apply;
- hybrid (zamba2-1.2b): ``layers`` in G = n_layers // attn_every groups of
  attn_every ``MambaBlock``s, each group followed by ``shared_attn``, one
  ``DenseBlock`` whose parameters all G applications use (their gradients
  add up), then ``tail_layers``, the n_layers % attn_every left over.

Parameters keep the JAX layouts (wq (D, H, hd), wo (H, hd, D), lm_head
(V, D), the experts' (E, D, F), ...) so ``models/convert.py`` loads a JAX
tree as it is: JAX stacks each layer list on leading axes
(``stacked_axes``: (n_layers,), or the hybrid's (G, attn_every) and
(rem,)), the port holds one block a layer
(``layers.<g>.<i>.…`` in the hybrid).  ``init_weights`` draws each layer's
slice of a stacked leaf straight into that layer's parameter (JAX's std
rule for the whole leaf), so a model initialises in place beside no
second copy of itself.  The caches are JAX's: dense and moe {"k", "v"}
(n_layers, B, max_len, KV, hd); ssm {"conv_x", "conv_bc", "state"}
stacked over layers, ``state`` fp32; hybrid {"groups": the Mamba caches on
(G, attn_every), "attn": {"k", "v"} (G, B, max_len, KV, hd), "tail": on
(rem,)}.  ``decode_step`` writes the new token's entries into the cache in
place (JAX returns an updated copy) and returns it.

The encdec family (whisper-tiny) is ``models/encdec.EncDec`` and the solver
family (``family="solver"``) ``models/solver_layer.py``: ``model_zoo.build``
sends each there.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import resolve_model_device
from repro_torch.kernels.flash_attention_bwd import flash_attention_trainable
from repro_torch.models.attention import (MASK_VALUE, attention,
                                          decode_attention)
from repro_torch.models.layers import (ParamDef, apply_mrope, apply_rope,
                                       flatten, param_dims, rms_norm,
                                       stack_tables)
from repro_torch.models.mlp import MLP, mlp_apply, mlp_table
from repro_torch.models.moe import MoE, moe_sharded, moe_table
from repro_torch.models.ssm import (Mamba2Mixer, mamba2_cache_dims,
                                    mamba2_cache_shapes,
                                    mamba2_decode_sharded, mamba2_sharded,
                                    mamba2_table)
from repro_torch.parallel.sharding import (PartitionSpec, Sharded,
                                           all_gather, axes_size,
                                           block_start, local_view, pmax,
                                           psum, psum_rounded, row_product,
                                           shard, spec_axes, zeros_pieces)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.arch}: family {cfg.family!r} is not a decoder-only "
            f"transformer; this module runs {FAMILIES}, and "
            f"model_zoo.build sends 'encdec' to models/encdec.py and "
            f"'solver' to models/solver_layer.py")


# ---------------------------------------------------------------------------
# Parameter tables (JAX's, for the initializer and the weights bridge)
# ---------------------------------------------------------------------------

def attn_table(cfg: ModelConfig) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    t = {
        "wq": ParamDef((D, H, hd), ("embed", "heads", "head_dim")),
        "wk": ParamDef((D, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((D, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((H, hd, D), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        t["q_norm"] = ParamDef((hd,), ("head_dim",), scale="one")
        t["k_norm"] = ParamDef((hd,), ("head_dim",), scale="one")
    return t


def block_table(cfg: ModelConfig, kind: str = "dense") -> dict:
    D = cfg.d_model
    if kind == "mamba":
        return {
            "norm": ParamDef((D,), ("embed",), scale="one"),
            "mixer": mamba2_table(D, cfg.d_inner, cfg.n_ssm_heads,
                                  cfg.ssm_state, cfg.d_conv),
        }
    t = {
        "attn_norm": ParamDef((D,), ("embed",), scale="one"),
        "attn": attn_table(cfg),
        "mlp_norm": ParamDef((D,), ("embed",), scale="one"),
    }
    if kind == "moe":
        t["moe"] = moe_table(D, cfg.n_experts, cfg.d_ff_expert,
                             cfg.n_shared_experts)
    else:
        t["mlp"] = mlp_table(D, cfg.d_ff, cfg.gated_mlp)
    return t


def stacked_axes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The leading axes on which JAX stacks each layer list of the tree."""
    check_family(cfg)
    if cfg.family == "hybrid":
        groups, rem = divmod(cfg.n_layers, cfg.attn_every)
        out = {"layers": (groups, cfg.attn_every)}
        if rem:
            out["tail_layers"] = (rem,)
        return out
    return {"layers": (cfg.n_layers,)}


def model_table(cfg: ModelConfig) -> dict:
    D, V = cfg.d_model, cfg.padded_vocab
    t = {
        "embed": ParamDef((V, D), ("vocab", "embed"), scale=1.0),
        "final_norm": ParamDef((D,), ("embed",), scale="one"),
        "lm_head": ParamDef((V, D), ("vocab", "embed")),
    }
    kind = {"dense": "dense", "vlm": "dense", "moe": "moe"}.get(cfg.family,
                                                              "mamba")
    for name, axes in stacked_axes(cfg).items():
        table = block_table(cfg, kind)
        for n in reversed(axes):
            table = stack_tables(table, n)
        t[name] = table
    if cfg.family == "hybrid":
        t["shared_attn"] = block_table(cfg)   # one block, reused
    return t


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def _rope(cfg: ModelConfig, x: torch.Tensor, positions) -> torch.Tensor:
    """JAX's ``_rope``: M-RoPE where the config has sections, else rope, or
    nothing where ``positions`` is None."""
    if cfg.m_rope_sections is not None:
        return apply_mrope(x, positions, cfg.rope_theta, cfg.m_rope_sections)
    if positions is None:
        return x
    return apply_rope(x, positions, cfg.rope_theta)


def project_qkv(cfg: ModelConfig, x: torch.Tensor, wq, wk, wv, q_norm,
                k_norm, positions, kv_source=None, use_rope: bool = True):
    """q, k, v (B, S, heads, hd) of x with the weights given (the layer's,
    or one shard's q heads), then qk_norm and rope (JAX's ``attn_apply``
    up to the attention)."""
    src = x if kv_source is None else kv_source
    D = x.shape[-1]
    q = (x @ wq.reshape(D, -1)).view(*x.shape[:2], *wq.shape[1:])
    k = (src @ wk.reshape(D, -1)).view(*src.shape[:2], *wk.shape[1:])
    v = (src @ wv.reshape(D, -1)).view(*src.shape[:2], *wv.shape[1:])
    if q_norm is not None:
        q = rms_norm(q, q_norm, cfg.norm_eps)
        k = rms_norm(k, k_norm, cfg.norm_eps)
    if use_rope and kv_source is None:
        q = _rope(cfg, q, positions)
        k = _rope(cfg, k, positions)
    return q, k, v


def attend(cfg: ModelConfig, q, k, v, causal: bool,
           q_offset: int = 0) -> torch.Tensor:
    """Full-sequence attention as ``cfg.attn_impl`` picks it: ``"flash"``
    the trainable kernels (K7, K8/K9; blocks 512 x 512), ``"xla"`` the
    plain ``attention``.  Query i sits at position ``q_offset + i`` and key
    j at j (a sequence shard's queries, ``ShardProgram``): the kernels'
    ``kv_offset``, the plain version's ``kv_offset=-q_offset``."""
    if cfg.attn_impl == "flash":
        return flash_attention_trainable(q, k.contiguous(), v.contiguous(),
                                         causal, 512, 512, q_offset)
    if cfg.attn_impl == "xla":
        return attention(q, k, v, causal=causal, q_chunk=cfg.q_chunk,
                         kv_offset=-q_offset)
    raise ValueError(f"attn_impl must be 'xla' or 'flash', got "
                     f"{cfg.attn_impl!r}")


class Attention(nn.Module):
    """q/k/v/o projections, qk_norm, rope, and the flash/plain switch; JAX's
    ``attn_apply`` switches: ``causal``, ``kv_source`` (cross-attention: k
    and v projected from it) and ``use_rope`` (rope only where it is set
    and there is no ``kv_source``)."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kw = dict(device=resolve_model_device(device), dtype=dtype)
        self.wq = nn.Parameter(torch.empty(D, H, hd, **kw))
        self.wk = nn.Parameter(torch.empty(D, KV, hd, **kw))
        self.wv = nn.Parameter(torch.empty(D, KV, hd, **kw))
        self.wo = nn.Parameter(torch.empty(H, hd, D, **kw))
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.empty(hd, **kw))
            self.k_norm = nn.Parameter(torch.empty(hd, **kw))
        else:
            self.q_norm = self.k_norm = None

    def _qkv(self, x: torch.Tensor, positions, kv_source=None,
             use_rope: bool = True):
        return project_qkv(self.cfg, x, self.wq, self.wk, self.wv,
                           self.q_norm, self.k_norm, positions, kv_source,
                           use_rope)

    def _out(self, o: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        B, S = o.shape[:2]
        return (o.reshape(B, S, -1) @ self.wo.reshape(-1, x.shape[-1])
                ).to(x.dtype)

    def forward(self, x: torch.Tensor, positions=None, *,
                causal: bool = True, kv_source=None, use_rope: bool = True):
        """Full-sequence attention.  x: (B, S, D); ``kv_source`` (B, T, D)
        or None (self-attention) -> (out, (k, v))."""
        q, k, v = self._qkv(x, positions, kv_source, use_rope)
        return self._out(attend(self.cfg, q, k, v, causal), x), (k, v)

    def decode(self, x: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, kv_len: int, positions=None):
        """One token.  x: (B, 1, D); caches (B, S_max, KV, hd), written at
        ``kv_len`` in place; ``positions`` None: no rope (``_rope``)."""
        q, k, v = self._qkv(x, positions)
        k_cache[:, kv_len] = k[:, 0]
        v_cache[:, kv_len] = v[:, 0]
        out = decode_attention(q, k_cache, v_cache, kv_len + 1)
        return self._out(out, x)


class DenseBlock(nn.Module):
    """Attention and an FFN, each after an rms-norm and with the residual:
    the dense ``MLP`` or, with ``moe``, the experts (JAX's
    ``dense_block``)."""

    def __init__(self, cfg: ModelConfig, *, moe: bool = False, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = cfg.norm_eps
        self.group_size = cfg.moe_group_size
        kw = dict(device=resolve_model_device(device), dtype=dtype)
        self.attn_norm = nn.Parameter(torch.empty(cfg.d_model, **kw))
        self.attn = Attention(cfg, **kw)
        self.mlp_norm = nn.Parameter(torch.empty(cfg.d_model, **kw))
        if moe:
            self.moe = MoE(cfg.d_model, cfg.n_experts, cfg.d_ff_expert,
                           cfg.n_shared_experts, top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor,
                           activation=cfg.activation, n_waves=cfg.moe_waves,
                           dispatch_mode=cfg.moe_dispatch, **kw)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.activation,
                           cfg.gated_mlp, **kw)

    def _ffn(self, x: torch.Tensor, group_size: int):
        """-> (x + FFN(norm(x)), the aux loss or None)."""
        h = rms_norm(x, self.mlp_norm, self.eps)
        if hasattr(self, "moe"):
            m, aux = self.moe(h, group_size)
            return x + m, aux
        return x + self.mlp(h), None

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """Train/prefill form: -> (x, (k, v), aux or None)."""
        a, kv = self.attn(rms_norm(x, self.attn_norm, self.eps), positions)
        x, aux = self._ffn(x + a, self.group_size)
        return x, kv, aux

    def decode(self, x, k_cache, v_cache, kv_len, positions):
        x = x + self.attn.decode(rms_norm(x, self.attn_norm, self.eps),
                                 k_cache, v_cache, kv_len, positions)
        # One token a row: the group is at most the batch (JAX's
        # min(moe_group_size, B * 1)).
        return self._ffn(x, min(self.group_size, x.shape[0] * x.shape[1]))[0]


class MambaBlock(nn.Module):
    """rms-norm, the Mamba2 mixer, the residual (JAX's ``mamba_block``)."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = cfg.norm_eps
        self.d_conv = cfg.d_conv
        kw = dict(device=resolve_model_device(device), dtype=dtype)
        self.norm = nn.Parameter(torch.empty(cfg.d_model, **kw))
        self.mixer = Mamba2Mixer(cfg.d_model, cfg.d_inner, cfg.n_ssm_heads,
                                 cfg.ssm_head_dim, cfg.ssm_state, cfg.d_conv,
                                 cfg.ssm_chunk, **kw)

    def forward(self, x: torch.Tensor, positions=None):
        """Train form: -> (x, None, None), as ``DenseBlock``'s (x, kv,
        aux); ``positions`` is not used."""
        return x + self.mixer(rms_norm(x, self.norm, self.eps)), None, None

    def prefill(self, x: torch.Tensor):
        """-> (x, this layer's cache): the final SSD state, and the conv
        halo, the last K-1 *pre-conv* projections (fp32 sums, then cast)."""
        h = rms_norm(x, self.norm, self.eps)
        y, final = self.mixer(h, return_state=True)
        tail = h[:, -(self.d_conv - 1):].float()
        p = self.mixer
        return x + y, {"conv_x": (tail @ p.x_proj.float()).to(x.dtype),
                       "conv_bc": (tail @ p.bc_proj.float()).to(x.dtype),
                       "state": final}

    def decode(self, x: torch.Tensor, cache: dict) -> torch.Tensor:
        """x: (B, 1, D); ``cache``'s tensors are overwritten in place."""
        y, new = self.mixer.decode(rms_norm(x, self.norm, self.eps)[:, 0],
                                   cache)
        for name, t in new.items():
            cache[name].copy_(t)
        return x + y[:, None]


class StackedModel(nn.Module):
    """What the LM models share (``Transformer``, ``models/encdec.EncDec``):
    parameters named after a JAX-layout table (``param_table``) whose layer
    lists JAX stacks on leading axes (``param_axes``) and the module holds
    one block a layer (``<list>.<i>.…``, the hybrid's ``layers.<g>.<i>.…``);
    the weights' loader and initializer, the fp32 logits, the cache's
    zeros.  ``device=None`` means the card, as for every entry point
    (``core.plan.resolve_device``); the modules below take the same rule."""

    @staticmethod
    def param_table(cfg: ModelConfig) -> dict:
        raise NotImplementedError

    @staticmethod
    def param_axes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
        raise NotImplementedError

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _slots(self, path):
        """(module, the rest of the path) for each layer of a stacked
        leaf, or [(self, path)]."""
        axes = self.param_axes(self.cfg)
        if path[0] not in axes:
            return [(self, path)]
        return [(self.get_submodule(".".join((path[0], *map(str, idx)))),
                 path[1:]) for idx in np.ndindex(*axes[path[0]])]

    @torch.no_grad()
    def load_params(self, tree: dict) -> None:
        """Copy a JAX-layout parameter tree (layer lists stacked on
        ``param_axes``) in, each leaf cast to its parameter's type."""
        n = 0
        for path, value in flatten(tree):
            slots = self._slots(path)
            value = torch.as_tensor(value).reshape(
                len(slots), *_param(*slots[0]).shape)
            for (module, rest), v in zip(slots, value):
                _param(module, rest).copy_(v)
            n += 1
        want = len(flatten(self.param_table(self.cfg)))
        if n != want:
            raise ValueError(f"parameter tree has {n} leaves, the model "
                             f"{want}")

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Draw every parameter with JAX's rules (``param_table``), in the
        table's order, straight into the module: a stacked leaf one layer's
        slice at a time (its std the stacked leaf's, JAX's rule), so the
        draw beside the model is one piece (``ParamDef.fill``), never a
        second model."""
        for path, pd in flatten(self.param_table(self.cfg)):
            for module, rest in self._slots(path):
                pd.fill(_param(module, rest), generator)

    def dims(self) -> dict:
        """The parameters' logical dim names in JAX's layout (layer lists
        stacked, their leading dims None): JAX's ``api.dims()``."""
        return param_dims(self.param_table(self.cfg))

    def param_dims_by_name(self) -> dict[str, tuple]:
        """{name in ``named_parameters``: its logical dims}: a stacked
        leaf's dims without the stacked axes, for each layer."""
        axes = self.param_axes(self.cfg)
        out = {}
        for path, pd in flatten(self.param_table(self.cfg)):
            if path[0] not in axes:
                out[".".join(path)] = pd.dims
                continue
            n = len(axes[path[0]])
            for idx in np.ndindex(*axes[path[0]]):
                out[".".join((path[0], *map(str, idx), *path[1:]))] = \
                    pd.dims[n:]
        return out

    def shard_program(self) -> type:
        """The family's shard program (a ``ShardProgram``)."""
        raise NotImplementedError

    def sharded(self, sharder):
        """The shard program that runs this model under ``sharder`` (the
        family's ``shard_program``), or None where there is no sharder or
        its mesh has one shard: then the unsharded path runs, its kernels
        and launches unchanged."""
        if sharder is None or sharder.trivial:
            return None
        return self.shard_program()(self, sharder)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """hidden (..., D) @ lm_head.T in fp32, as JAX's
        ``preferred_element_type=float32``: bf16 operands are exact in fp32,
        so the product is theirs with fp32 sums and fp32 logits, never
        rounded to bf16."""
        return F.linear(hidden.float(), self.lm_head.float())

    def init_cache(self, batch: int, max_len: int) -> dict:
        def zeros(tree):
            return {name: (zeros(leaf) if isinstance(leaf, dict) else
                           torch.zeros(leaf[0], dtype=leaf[1],
                                       device=self.device))
                    for name, leaf in tree.items()}
        return zeros(self.cache_shapes(batch, max_len))


class Transformer(StackedModel):
    """The decoder of the ``FAMILIES``.  Its methods are the port's
    ``ModelApi`` (``forward``, ``prefill``, ``decode_step``, ``cache_shapes``,
    ``cache_dims``, ``init_cache``); the parameters live in the module."""

    param_table = staticmethod(model_table)
    param_axes = staticmethod(stacked_axes)

    def shard_program(self) -> type:
        return SHARD_PROGRAMS[self.cfg.family]

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        kw = dict(device=resolve_model_device(device), dtype=dtype)
        V, D = cfg.padded_vocab, cfg.d_model
        self.embed = nn.Parameter(torch.empty(V, D, **kw))
        self.final_norm = nn.Parameter(torch.empty(D, **kw))
        self.lm_head = nn.Parameter(torch.empty(V, D, **kw))
        if cfg.family in ("dense", "vlm", "moe"):
            block = lambda: DenseBlock(cfg, moe=cfg.family == "moe", **kw)
        else:
            block = lambda: MambaBlock(cfg, **kw)

        def blocks(axes):
            if len(axes) == 1:
                return nn.ModuleList(block() for _ in range(axes[0]))
            return nn.ModuleList(blocks(axes[1:]) for _ in range(axes[0]))

        for name, axes in stacked_axes(cfg).items():
            setattr(self, name, blocks(axes))
        if cfg.family == "hybrid":
            self.shared_attn = DenseBlock(cfg, **kw)

    # -- forward modes -----------------------------------------------------

    def _embed(self, tokens: torch.Tensor, vision_embeds=None):
        """The token embeddings, the first nv replaced by ``vision_embeds``
        (B, nv, D) where given (JAX's ``_embed``)."""
        x = self.embed[tokens]
        if vision_embeds is not None:
            nv = vision_embeds.shape[1]
            x = torch.cat([vision_embeds.to(x.dtype), x[:, nv:]], dim=1)
        return x

    def _default_positions(self, tokens: torch.Tensor) -> torch.Tensor:
        """arange(S) a row; on all three channels, (3, B, S), for M-RoPE."""
        B, S = tokens.shape
        pos = torch.arange(S, device=tokens.device).expand(B, S)
        if self.cfg.m_rope_sections is not None:
            pos = pos.expand(3, B, S)
        return pos

    @staticmethod
    def _run_blocks(x: torch.Tensor, aux: torch.Tensor,
                    positions: torch.Tensor, blocks):
        """-> (x, aux plus the blocks' aux losses)."""
        for block in blocks:
            x, _, a = block(x, positions)
            if a is not None:
                aux = aux + a
        return x, aux

    def _run_layers(self, x, aux, positions, blocks, remat: bool,
                    group: int):
        """``blocks`` in order, -> (x, aux); with ``remat`` each run of
        ``group`` (1 where it does not divide their number, as JAX's
        ``_run_layers``) under ``torch.utils.checkpoint``, which returns
        the aux sum beside x so that its gradient reaches the run."""
        if not remat:
            return self._run_blocks(x, aux, positions, blocks)
        n = len(blocks)
        g = group if group > 1 and n % group == 0 else 1
        for start in range(0, n, g):
            x, aux = checkpoint(self._run_blocks, x, aux, positions,
                                blocks[start:start + g], use_reentrant=False)
        return x, aux

    def forward(self, tokens: torch.Tensor, positions=None, *,
                vision_embeds=None, remat: bool = True, sharder=None):
        """Train-mode forward: (final hidden (B, S, D), aux loss: the sum
        of the MoE layers' Switch losses, 0 in the other families).
        ``positions`` (B, S), or (3, B, S) for M-RoPE, default
        ``_default_positions``; ``vision_embeds`` (vlm) take the first
        positions.

        With ``remat`` the dense, moe and ssm families run each group of
        ``cfg.remat_group`` layers under ``torch.utils.checkpoint``: the
        backward keeps one residual a group and runs the group's forward
        again, flash kernel included.  The hybrid checkpoints each group
        of Mamba blocks with its shared attention, and its tail a layer at
        a time, as JAX does.  Inside a Mamba block each SSD chunk is
        checkpointed as well (``models/ssm.ssd_scan``), and inside an MoE
        layer each wave (``models/moe.moe_apply``).
        """
        run = self.sharded(sharder)
        if run is not None:
            return run.forward(tokens, positions,
                               vision_embeds=vision_embeds, remat=remat)
        x = self._embed(tokens, vision_embeds)
        if positions is None:
            positions = self._default_positions(tokens)
        aux = torch.zeros((), device=x.device)
        if self.cfg.family == "hybrid":
            # Each group and the shared block after it: one checkpoint.
            seq = [b for g in self.layers for b in (*g, self.shared_attn)]
            x, aux = self._run_layers(x, aux, positions, seq, remat,
                                      self.cfg.attn_every + 1)
            if hasattr(self, "tail_layers"):
                x, aux = self._run_layers(x, aux, positions,
                                          list(self.tail_layers), remat, 1)
        else:
            x, aux = self._run_layers(x, aux, positions, list(self.layers),
                                      remat, self.cfg.remat_group)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return x, aux

    def _schedule(self):
        """The blocks in the order a forward runs them, each with its cache
        slot: (block, subtree of the cache or None for its root, index on
        that subtree's stacked axes).  The hybrid's shared block comes
        once a group, at the group's slot of the attention cache."""
        if self.cfg.family != "hybrid":
            return [(b, None, i) for i, b in enumerate(self.layers)]
        out = []
        for g, group in enumerate(self.layers):
            out += [(b, "groups", (g, i)) for i, b in enumerate(group)]
            out.append((self.shared_attn, "attn", g))
        return out + [(b, "tail", i) for i, b in
                      enumerate(getattr(self, "tail_layers", ()))]

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int, positions=None, *,
                vision_embeds=None, sharder=None):
        """Process a prompt: (last-position hidden (B, D), cache);
        ``positions`` and ``vision_embeds`` as ``forward``'s."""
        run = self.sharded(sharder)
        if run is not None:
            return run.prefill(tokens, max_len, positions,
                               vision_embeds=vision_embeds)
        B, S = tokens.shape
        if S > max_len:
            raise ValueError(f"prompt of {S} tokens exceeds max_len "
                             f"{max_len}")
        x = self._embed(tokens, vision_embeds)
        if positions is None:
            positions = self._default_positions(tokens)
        cache = self.init_cache(B, max_len)
        for block, key, idx in self._schedule():
            slot = cache[key] if key else cache
            if isinstance(block, DenseBlock):
                x, (k, v), _ = block(x, positions)
                slot["k"][idx, :, :S] = k
                slot["v"][idx, :, :S] = v
            else:
                x, layer_cache = block.prefill(x)
                for name, t in layer_cache.items():
                    slot[name][idx] = t
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return x[:, -1], cache

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: dict, kv_len: int, *,
                    sharder=None):
        """One decode step.  token: (B,); kv_len: the cache fill.  Returns
        (logits (B, V) fp32, cache, updated in place); under a sharder of
        more than one shard the cache is ``prefill``'s and the logits a
        ``Sharded``."""
        run = self.sharded(sharder)
        if run is not None:
            return run.decode_step(token, cache, kv_len)
        B = token.shape[0]
        x = self._embed(token[:, None])
        pos = torch.full((B, 1), kv_len, device=token.device)
        if self.cfg.m_rope_sections is not None:
            pos = pos.expand(3, B, 1)   # kv_len on every channel, as JAX
        for block, key, idx in self._schedule():
            slot = cache[key] if key else cache
            if isinstance(block, DenseBlock):
                x = block.decode(x, slot["k"][idx], slot["v"][idx], kv_len,
                                 pos)
            else:
                x = block.decode(x, {name: t[idx]
                                     for name, t in slot.items()})
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return mask_pad_logits(self.logits(x[:, 0]), self.cfg), cache

    # -- caches ------------------------------------------------------------

    def _cache_layout(self) -> dict:
        """{subtree of the cache (None: its root): (the per-layer kind,
        "attn" or "mamba", stacked on these axes)}."""
        axes = stacked_axes(self.cfg)
        if self.cfg.family in ("dense", "vlm", "moe"):
            return {None: ("attn", axes["layers"])}
        if self.cfg.family == "ssm":
            return {None: ("mamba", axes["layers"])}
        out = {"groups": ("mamba", axes["layers"]),
               "attn": ("attn", axes["layers"][:1])}
        if "tail_layers" in axes:
            out["tail"] = ("mamba", axes["tail_layers"])
        return out

    def _from_layout(self, per_layer: dict, stack) -> dict:
        out = {key: stack(per_layer[kind], axes)
               for key, (kind, axes) in self._cache_layout().items()}
        return out.pop(None) if None in out else out

    def cache_shapes(self, batch: int, max_len: int) -> dict:
        """The cache's tree (JAX's layout) of (shape, dtype) leaves."""
        cfg, dt = self.cfg, self.dtype
        per_layer = {
            "attn": attn_cache_shapes(cfg, batch, max_len, dt),
            "mamba": mamba2_cache_shapes(batch, cfg.n_ssm_heads,
                                         cfg.ssm_head_dim, cfg.ssm_state,
                                         cfg.d_conv, cfg.d_inner, dt)}
        return self._from_layout(per_layer, _stack)

    def cache_dims(self) -> dict:
        """The cache's logical dim names (JAX's ``cache_dims``)."""
        per_layer = {"attn": attn_cache_dims(), "mamba": mamba2_cache_dims()}
        return self._from_layout(per_layer, lambda dims, axes: {
            k: (None,) * len(axes) + d for k, d in dims.items()})


def attn_cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                      dtype: torch.dtype) -> dict:
    """One attention layer's k and v cache: (shape, dtype) leaves."""
    kv = ((batch, max_len, cfg.n_kv_heads, cfg.head_dim), dtype)
    return {"k": kv, "v": kv}


def attn_cache_dims() -> dict:
    return {name: ("batch", "kv_seq", "kv_heads", "head_dim")
            for name in ("k", "v")}


def _stack(shapes: dict, axes: tuple[int, ...]) -> dict:
    return {name: ((*axes, *shape), dt) for name, (shape, dt) in shapes.items()}


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


# ---------------------------------------------------------------------------
# Shard programs: the families on a mesh
# ---------------------------------------------------------------------------

def kv_heads_for(h0: int, n: int, group: int):
    """The kv heads that q heads [h0, h0 + n) read, in the layout the
    attention takes (q head i of the shard reads kv head i // (its q heads
    / its kv heads)): whole groups, a slice; a part of one group, that
    head; a shard that splits a group (phi3-medium-14b's 10 heads a shard
    at G = 4), one kv head a q head (an index, a group of 1)."""
    if n % group == 0:
        return slice(h0 // group, (h0 + n) // group)
    if group % n == 0:
        return slice(h0 // group, h0 // group + 1)
    return torch.tensor([(h0 + i) // group for i in range(n)])


def _decode_partial(q, k_cache, v_cache, lo: int, kv_len: int):
    """One cache shard's flash-decoding partial: q (B, 1, H, hd), the shard
    (B, L, KV, hd) holding positions lo.. -> (max, sum of exp, unnormalized
    output) over its positions below kv_len, fp32, (B, KV, G, ...)."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(),
                     k_cache.float()) * hd ** -0.5
    pos = lo + torch.arange(k_cache.shape[1], device=q.device)
    s = torch.where(pos < kv_len, s, MASK_VALUE)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return m, p.sum(dim=-1), torch.einsum("bkgs,bskh->bkgh", p,
                                          v_cache.float())


class ShardProgram:
    """What the families' shard programs share (JAX's ``forward``,
    ``prefill`` and ``decode_step`` with a sharder): one shard-local
    program a mesh coordinate, every shard driven by this one process,
    each on its device, the collectives those of ``parallel/sharding.py``.
    What each profile's rules imply for the parameters (``Sharder.spec``
    of their dims) is explicit here:

    - the residual stream x (batch, seq, D): batch over data, seq over
      model in ``sp``, D whole;
    - weights at use (``sharding.local_view``): pieces over the model
      axis where their spec says so, every other axis gathered (``sp``'s
      embed dim over data);
    - ``tp``: wq column-parallel (heads), wk/wv whole, wo row-parallel and
      its partial sums added over model; the MLP's gate/up column-parallel
      (dff), down row-parallel, summed over model (the row-parallel partial
      products in fp32, added in fp32 and rounded once, as JAX's f32
      all-reduce: ``sharding.psum_rounded``); the embedding
      vocab-parallel (each shard's rows, zeros elsewhere, summed over
      model); where a dim does not divide its axis it replicates, as JAX;
    - ``sp``: every layer weight whole, each shard's queries attend to k
      and v all-gathered along the sequence with its offset;
    - inside a shard attention is ``attend``: ``cfg.attn_impl`` as on one
      device, handed the shard's q heads and the kv heads they read
      (``kv_heads_for``), or with ``sp`` its sequence offset (the kernels'
      ``kv_offset``);
    - decode: the kv cache sharded on kv_seq over model (where model
      divides max_len, else whole on every shard, as JAX), the new k and v
      written into the shard that owns position kv_len, attention
      flash-decoding: each shard's partial (max, sum, output) over its
      positions, combined by their log-sum-exp.

    Here: the embedding, the norms, a shard's attention (full-sequence and
    decode), the dense MLP, the logits, the caches and the three modes
    (``forward``, ``prefill``, ``decode_step`` over ``_schedule``); each
    family adds its blocks (``ShardedDense``, ``ShardedMoE``,
    ``ShardedSSM``, ``ShardedHybrid``, ``encdec.ShardedEncDec``).

    The parameters stay in the model (on its device); a shard's piece is a
    slice ``.to()`` its device, so on one device it is a view, and
    autograd adds every shard's and replica's gradient into the
    parameter: the sum over the mesh axes its spec leaves unused.

    ``state_over_data`` (batch-1 decode, where the batch cannot shard over
    data) changes only the caches' layout: the kv caches on kv_seq over
    ("model", "data") (the model axis major; the flash-decoding combine
    runs over both), the SSD state's head dim over data
    (``models/ssm.mamba2_decode_sharded``).  No activation rule changes,
    so forward and prefill run as without it; a prefill lays its cache by
    the flag's specs, as a decode takes it."""

    def __init__(self, model: StackedModel, sharder):
        self.model, self.cfg, self.sharder = model, model.cfg, sharder
        self.mesh = sharder.mesh
        self.coords = self.mesh.coords()
        self.n = len(self.coords)
        self.dims = model.param_dims_by_name()
        self.params = dict(model.named_parameters())

    # -- pieces ------------------------------------------------------------

    def w(self, name: str):
        """(a weight's local pieces at use, the spec they follow)."""
        p = self.params[name]
        return local_view(p, self.sharder.spec(self.dims[name],
                                               tuple(p.shape)), self.mesh)

    def start(self, k: int, entry, size: int) -> int:
        return block_start(self.mesh, self.coords[k], entry, size)

    def layout(self, B: int, S: int) -> PartitionSpec:
        """The residual stream's (batch, seq) spec."""
        xs = self.sharder.spec(("batch", "seq", "embed"),
                               (B, S, self.cfg.d_model))
        return PartitionSpec(xs[0], xs[1])

    def _norm(self, name: str, xs: list) -> list:
        w, _ = self.w(name)
        return [rms_norm(x, w[k], self.cfg.norm_eps)
                for k, x in enumerate(xs)]

    def _seq_block(self, xs: list, spec, S: int) -> list:
        """Each shard's block of the sequence (its spec[1]) of whole
        sequences (B_l, S, ...)."""
        if not spec_axes(spec[1]):
            return xs
        Sl = S // axes_size(self.mesh, spec_axes(spec[1]))
        return [x[:, self.start(k, spec[1], S):][:, :Sl]
                for k, x in enumerate(xs)]

    def _embed(self, tokens: torch.Tensor, spec,
               vision_embeds=None) -> list:
        """Each shard's rows of the token embeddings, the first nv
        positions replaced by ``vision_embeds`` (B, nv, D) where given,
        before the sequence is split (JAX's ``_embed``)."""
        E, espec = self.w("embed")
        vocab = spec_axes(espec[0])
        # The whole sequence first where the vocab shards' sum or the
        # vision prefix needs it, then each shard's block.
        whole = spec_axes(spec[1]) and (vocab or vision_embeds is not None)
        ids = shard(tokens, PartitionSpec(spec[0], None) if whole else spec,
                    self.mesh)
        if not vocab:
            xs = [E[k][t] for k, t in enumerate(ids)]
        else:
            # Vocab-parallel: each shard looks up the tokens its rows
            # hold, zeros elsewhere, and the model axis adds them up.
            V, Vl = self.cfg.padded_vocab, E[0].shape[0]
            parts = []
            for k, t in enumerate(ids):
                local = t - self.start(k, espec[0], V)
                hit = (local >= 0) & (local < Vl)
                parts.append(torch.where(hit[..., None],
                                         E[k][local.clamp(0, Vl - 1)], 0))
            xs = psum(parts, self.mesh, vocab)
        if vision_embeds is not None:
            nv = vision_embeds.shape[1]
            ve = shard(vision_embeds, PartitionSpec(spec[0], None, None),
                       self.mesh)
            xs = [torch.cat([v.to(x.dtype), x[:, nv:]], dim=1)
                  for v, x in zip(ve, xs)]
        return self._seq_block(xs, spec, tokens.shape[1]) if whole else xs

    def _positions(self, positions: torch.Tensor, spec) -> list:
        """Each shard's position ids: (B, S), or M-RoPE's (3, B, S) split
        on its last two axes."""
        if positions.dim() == 3:
            spec = PartitionSpec(None, *spec)
        return shard(positions, spec, self.mesh)

    def _cache(self, B: int, max_len: int) -> dict:
        """Zeros of the model's cache tree (``cache_shapes``), each leaf a
        ``Sharded`` laid by its ``cache_dims``' spec."""
        def build(shapes, dims):
            if isinstance(dims, dict):
                return {k: build(shapes[k], dims[k]) for k in dims}
            shape, dtype = shapes
            spec = self.sharder.spec(dims, shape)
            return Sharded(zeros_pieces(shape, spec, self.mesh, dtype), spec,
                           shape, self.mesh)
        return build(self.model.cache_shapes(B, max_len),
                     self.model.cache_dims())

    # -- attention and the MLP ---------------------------------------------

    def _qkv(self, pre: str, hs: list, pos: list, kv_src=None,
             use_rope: bool = True):
        cfg = self.cfg
        wq, qspec = self.w(pre + "wq")
        wk, wv = self.w(pre + "wk")[0], self.w(pre + "wv")[0]
        norms = ((self.w(pre + "q_norm")[0], self.w(pre + "k_norm")[0])
                 if cfg.qk_norm else ([None] * self.n, [None] * self.n))
        src = kv_src or [None] * self.n
        qkv = [project_qkv(cfg, h, wq[k], wk[k], wv[k], norms[0][k],
                           norms[1][k], pos[k], src[k], use_rope)
               for k, h in enumerate(hs)]
        return [list(t) for t in zip(*qkv)], qspec

    def _out(self, pre: str, outs: list, hs: list, qspec) -> list:
        """wo row-parallel where the heads shard: partial sums added over
        the model axis."""
        wo, _ = self.w(pre + "wo")
        D = self.cfg.d_model
        heads = spec_axes(qspec[1])
        part = [row_product(o.reshape(*o.shape[:2], -1), wo[k].reshape(-1, D),
                            bool(heads)) for k, o in enumerate(outs)]
        return psum_rounded(part, self.mesh, heads, hs[0].dtype)

    def _heads(self, k: int, qspec, n_local: int):
        """(first q head of shard k, the kv heads those read)."""
        if not spec_axes(qspec[1]):
            return 0, slice(None)
        cfg = self.cfg
        h0 = self.start(k, qspec[1], cfg.n_heads)
        return h0, kv_heads_for(h0, n_local,
                                cfg.n_heads // cfg.n_kv_heads)

    def _attn(self, pre: str, hs: list, pos: list, spec, causal=True,
              kv_src=None, use_rope: bool = True):
        """Full-sequence attention of each shard's rows: its q heads on the
        kv heads they read, its queries at their sequence offset against k
        and v gathered along the sequence; with ``kv_src`` (each shard's
        whole encoder output) cross-attention.  -> (outputs summed over
        the head shards, (k, v) each shard's, gathered)."""
        (q, k_, v), qspec = self._qkv(pre, hs, pos, kv_src, use_rope)
        seq = spec_axes(spec[1]) if kv_src is None else ()
        S = hs[0].shape[1] * axes_size(self.mesh, spec_axes(spec[1]))
        if seq:
            k_ = all_gather(k_, self.mesh, seq, 1)
            v = all_gather(v, self.mesh, seq, 1)
        outs = []
        for k in range(self.n):
            _, sel = self._heads(k, qspec, q[k].shape[2])
            off = self.start(k, spec[1], S) if seq else 0
            outs.append(attend(self.cfg, q[k], k_[k][:, :, sel],
                               v[k][:, :, sel], causal, off))
        return self._out(pre, outs, hs, qspec), (k_, v)

    def _mlp(self, pre: str, hs: list) -> list:
        up, uspec = self.w(pre + "up")
        down, _ = self.w(pre + "down")
        gate = (self.w(pre + "gate")[0] if pre + "gate" in self.params
                else [None] * self.n)
        dff = spec_axes(uspec[1])
        outs = [mlp_apply(h, up[k], gate[k], down[k], self.cfg.activation,
                          partial=bool(dff)) for k, h in enumerate(hs)]
        return psum_rounded(outs, self.mesh, dff, hs[0].dtype)

    def _block_of(self, t: torch.Tensor, leaf: Sharded, k: int):
        """Shard k's block of ``t``, a layer's entry of cache ``leaf``:
        ``t`` as it is, but cut to the piece's block along each dim where
        it holds the whole (the SSD state's head dim, over data under
        ``state_over_data``)."""
        piece = leaf.pieces[k].shape[-t.dim():]
        for d, (n, size) in enumerate(zip(piece, t.shape)):
            if n != size:
                entry = leaf.spec[len(leaf.spec) - t.dim() + d]
                t = t.narrow(d, self.start(k, entry, size), n)
        return t

    def _write_kv(self, cache: dict, idx, kv, S: int) -> None:
        """A prefill's (k, v), each shard's over the whole prompt, into the
        cache's pieces at layer slot ``idx``: each shard the positions it
        holds."""
        for name, full in zip(("k", "v"), kv):
            c = cache[name]
            L = c.pieces[0].shape[-3]
            for k in range(self.n):
                lo = self.start(k, c.spec[-3], c.shape[-3])
                hi = min(lo + L, S)
                if hi > lo:
                    c.pieces[k][idx][:, :hi - lo] = full[k][:, lo:hi]

    def _attn_decode(self, pre: str, hs: list, pos: list, kc: Sharded,
                     vc: Sharded, idx, kv_len: int) -> list:
        """One token's self-attention against layer slot ``idx`` of a
        ``prefill`` cache: the new k and v written into the shard that owns
        position kv_len, then flash-decoding over the kv_seq shards (or each
        head shard's whole cache) -> outputs summed over the head shards."""
        cfg, mesh = self.cfg, self.mesh
        (q, k_new, v_new), qspec = self._qkv(pre, hs, pos)
        heads = spec_axes(qspec[1])
        entry, max_len = kc.spec[-3], kc.shape[-3]
        L = kc.pieces[0].shape[-3]
        los = [self.start(k, entry, max_len) for k in range(self.n)]
        ks = [p[idx] for p in kc.pieces]
        vs = [p[idx] for p in vc.pieces]
        for k in range(self.n):
            if los[k] <= kv_len < los[k] + L:
                ks[k][:, kv_len - los[k]] = k_new[k][:, 0]
                vs[k][:, kv_len - los[k]] = v_new[k][:, 0]
        outs = []
        if spec_axes(entry):
            kv_axes = spec_axes(entry)
            qa = all_gather(q, mesh, heads, 2) if heads else q
            parts = [_decode_partial(qa[k], ks[k], vs[k], los[k], kv_len + 1)
                     for k in range(self.n)]
            top = pmax([p[0] for p in parts], mesh, kv_axes)
            scale = [torch.exp(p[0] - t) for p, t in zip(parts, top)]
            tot = psum([p[1] * w for p, w in zip(parts, scale)], mesh,
                       kv_axes)
            acc = psum([p[2] * w[..., None] for p, w in zip(parts, scale)],
                       mesh, kv_axes)
            for k in range(self.n):
                o = (acc[k] / tot[k][..., None]).to(q[k].dtype)
                o = o.reshape(o.shape[0], 1, cfg.n_heads, cfg.head_dim)
                h0, _ = self._heads(k, qspec, q[k].shape[2])
                outs.append(o[:, :, h0:h0 + q[k].shape[2]])
        else:
            for k in range(self.n):
                _, sel = self._heads(k, qspec, q[k].shape[2])
                outs.append(decode_attention(q[k], ks[k][:, :, sel],
                                             vs[k][:, :, sel], kv_len + 1))
        return self._out(pre, outs, hs, qspec)

    # -- the modes ----------------------------------------------------------

    def _schedule(self) -> list:
        """The blocks in the order a forward runs them: (kind, parameter
        prefix, cache subtree or None for its root, index on its stacked
        axes); a family's ``_<kind>_block`` and ``_<kind>_decode`` run
        them."""
        raise NotImplementedError

    def _remat_runs(self, remat: bool) -> list:
        """The schedule cut into the runs that each go under one
        checkpoint: groups of ``cfg.remat_group`` blocks (1 where it does
        not divide their number), as the unsharded ``_run_layers``."""
        blocks = self._schedule()
        g = self.cfg.remat_group
        g = g if remat and g > 1 and len(blocks) % g == 0 else 1
        return [blocks[i:i + g] for i in range(0, len(blocks), g)]

    def _inputs(self, tokens, positions, vision_embeds=None):
        spec = self.layout(*tokens.shape)
        if positions is None:
            positions = self.model._default_positions(tokens)
        return (spec, self._positions(positions, spec),
                self._embed(tokens, spec, vision_embeds))

    def _run(self, xs, aux, pos, spec, run):
        for kind, pre, _, _ in run:
            xs, a, _ = getattr(self, f"_{kind}_block")(pre, xs, pos, spec)
            if a is not None:
                aux = aux + a
        return xs, aux

    def forward(self, tokens: torch.Tensor, positions=None, *,
                vision_embeds=None, remat: bool = True):
        """-> (final hidden, a ``Sharded`` (B, S, D), aux: the MoE layers'
        aux losses summed, else 0); with ``remat`` each run of
        ``_remat_runs`` under ``torch.utils.checkpoint`` across all the
        shards at once."""
        B, S = tokens.shape
        spec, pos, xs = self._inputs(tokens, positions, vision_embeds)
        aux = torch.zeros((), device=self.model.device)
        for run in self._remat_runs(remat):
            if remat:
                xs, aux = checkpoint(self._run, xs, aux, pos, spec, run,
                                     use_reentrant=False)
            else:
                xs, aux = self._run(xs, aux, pos, spec, run)
        xs = self._norm("final_norm", xs)
        return (Sharded(xs, PartitionSpec(spec[0], spec[1], None),
                        (B, S, self.cfg.d_model), self.mesh), aux)

    def _last(self, xs: list, spec, final) -> list:
        """The last position of each shard's batch rows, gathered from the
        sequence shard that holds it, through ``final`` (the final norm)."""
        last = [x[:, -1:] for x in xs]
        seq = spec_axes(spec[1])
        if seq:
            last = all_gather(last, self.mesh, seq, 1)
        return final([t[:, -1] for t in last])

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int, positions=None,
                *, vision_embeds=None):
        """-> (last-position hidden, a ``Sharded`` (B, D); the cache: the
        model's tree with ``Sharded`` leaves, each shard's pieces)."""
        B, S = tokens.shape
        if S > max_len:
            raise ValueError(f"prompt of {S} tokens exceeds max_len "
                             f"{max_len}")
        spec, pos, xs = self._inputs(tokens, positions, vision_embeds)
        cache = self._cache(B, max_len)
        for kind, pre, key, idx in self._schedule():
            slot = cache[key] if key else cache
            xs, _, layer = getattr(self, f"_{kind}_block")(
                pre, xs, pos, spec, want_cache=True)
            if kind == "mamba":
                for name, pieces in layer.items():
                    for k, t in enumerate(pieces):
                        slot[name].pieces[k][idx].copy_(
                            self._block_of(t, slot[name], k))
            else:
                self._write_kv(slot, idx, layer, S)
        last = self._last(xs, spec, lambda t: self._norm("final_norm", t))
        return (Sharded(last, PartitionSpec(spec[0], None),
                        (B, self.cfg.d_model), self.mesh), cache)

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: dict, kv_len: int):
        """One token against a ``prefill`` cache (written in place) ->
        (logits, a ``Sharded`` (B, V) fp32 over the vocab shards, the
        cache)."""
        B = token.shape[0]
        spec = PartitionSpec(self.sharder.spec(("batch",), (B,))[0], None)
        xs = self._embed(token[:, None], spec)
        pos = torch.full((B, 1), kv_len, device=token.device)
        if self.cfg.m_rope_sections is not None:
            pos = pos.expand(3, B, 1)   # kv_len on every channel, as JAX
        pos = self._positions(pos, spec)
        for kind, pre, key, idx in self._schedule():
            slot = cache[key] if key else cache
            xs = getattr(self, f"_{kind}_decode")(pre, xs, pos, spec, slot,
                                                  idx, kv_len)
        xs = self._norm("final_norm", xs)
        return self.logits([x[:, 0] for x in xs], spec[0]), cache

    @torch.no_grad()
    def logits(self, hs: list, batch_entry) -> "Sharded":
        """hidden (B, D) pieces @ lm_head.T in fp32 over the vocab shards,
        the padded rows masked: a ``Sharded`` (B, V)."""
        W, wspec = self.w("lm_head")
        V, Vl = self.cfg.padded_vocab, W[0].shape[0]
        out = []
        for k, h in enumerate(hs):
            logits = F.linear(h.float(), W[k].float())
            if self.cfg.padded_vocab != self.cfg.vocab_size:
                ids = self.start(k, wspec[0], V) + torch.arange(
                    Vl, device=logits.device)
                logits = torch.where(ids < self.cfg.vocab_size, logits, -1e30)
            out.append(logits)
        B = hs[0].shape[0] * axes_size(self.mesh, spec_axes(batch_entry))
        return Sharded(out, PartitionSpec(batch_entry, wspec[0]), (B, V),
                       self.mesh)


class ShardedDense(ShardProgram):
    """The dense and vlm families on a mesh: one ``DenseBlock`` a layer,
    attention and the FFN each after an rms-norm with the residual.  The
    vlm's ``vision_embeds`` take the first positions before the sequence
    splits (``_embed``) and its (3, B, S) M-RoPE ids split on their last
    axis (``_positions``); decode gives the new token kv_len on all three
    channels."""

    def _schedule(self) -> list:
        return [("dense", f"layers.{i}.", None, i)
                for i in range(self.cfg.n_layers)]

    def _ffn(self, pre: str, hs: list, spec, group_size: int):
        """-> (each shard's FFN output, the aux loss or None)."""
        return self._mlp(pre + "mlp.", hs), None

    def _dense_block(self, pre: str, xs: list, pos: list, spec,
                     want_cache: bool = False):
        """-> (xs, aux or None, (k, v) each shard's over the prompt)."""
        a, kv = self._attn(pre + "attn.", self._norm(pre + "attn_norm", xs),
                           pos, spec)
        xs = [x + o for x, o in zip(xs, a)]
        m, aux = self._ffn(pre, self._norm(pre + "mlp_norm", xs), spec,
                           self.cfg.moe_group_size)
        return [x + o for x, o in zip(xs, m)], aux, kv

    def _dense_decode(self, pre: str, xs: list, pos: list, spec, slot: dict,
                      idx, kv_len: int) -> list:
        a = self._attn_decode(pre + "attn.",
                              self._norm(pre + "attn_norm", xs), pos,
                              slot["k"], slot["v"], idx, kv_len)
        xs = [x + o for x, o in zip(xs, a)]
        # One token a row: the group is at most the batch (JAX's
        # min(moe_group_size, B * 1)).
        B = xs[0].shape[0] * axes_size(self.mesh, spec_axes(spec[0]))
        m, _ = self._ffn(pre, self._norm(pre + "mlp_norm", xs), spec,
                         min(self.cfg.moe_group_size, B))
        return [x + o for x, o in zip(xs, m)]


class ShardedMoE(ShardedDense):
    """The moe family on a mesh: the dense program's attention, embedding
    and head, and the experts' FFN expert-parallel
    (``models/moe.moe_sharded``): the experts over model, the groups of
    JAX's global wave layout over data where they divide, the routing
    with the whole router on every shard, the combine's partial sums added
    over model; the shared experts dff-parallel.  The aux loss is the
    unsharded run's (the same groups, waves and means).  ``routes``: None,
    or a dict that gets each layer's routing, {parameter prefix: list}
    (``moe_sharded``'s order)."""

    routes: dict | None = None

    def _ffn(self, pre: str, hs: list, spec, group_size: int):
        cfg, mesh = self.cfg, self.mesh
        router, rspec = self.w(pre + "moe.router")
        # The whole fp32 router on every shard (1 MB at 2048 x 128),
        # gathered from its column pieces.
        router = all_gather(router, mesh, spec_axes(rspec[1]), 1)
        pieces = [{"router": r} for r in router]
        for name in ("up", "gate", "down"):
            ws, espec = self.w(pre + "moe." + name)
            for p, t in zip(pieces, ws):
                p[name] = t
        shared_entry = None
        if cfg.n_shared_experts:
            for name in ("up", "gate", "down"):
                ws, sspec = self.w(pre + "moe.shared." + name)
                if name == "up":
                    shared_entry = sspec[1]
                for p, t in zip(pieces, ws):
                    p.setdefault("shared", {})[name] = t
        out, aux = moe_sharded(
            pieces, hs, self.sharder, spec[0], seq_entry=spec[1],
            expert_entry=espec[0], shared_entry=shared_entry,
            top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
            group_size=group_size, activation=cfg.activation,
            n_waves=cfg.moe_waves, dispatch_mode=cfg.moe_dispatch,
            routes=None if self.routes is None else
            self.routes.setdefault(pre, []))
        return out, aux[0].to(self.model.device)


class ShardedSSM(ShardProgram):
    """The ssm family on a mesh: one ``MambaBlock`` a layer, its mixer
    head-sharded (``models/ssm.mamba2_sharded``: the channels and the
    heads over model, ``out_proj`` row-parallel, the gated norm's sum of
    squares added over model, B and C projected whole on every shard).
    Where the sequence splits (``sp``) a block gathers it, scans it whole
    and keeps its block.  Decode: the conv state on ``conv_channels``, the
    SSD state on ``ssm_heads`` (``mamba2_cache_dims``)."""

    def _schedule(self) -> list:
        return [("mamba", f"layers.{i}.", None, i)
                for i in range(self.cfg.n_layers)]

    def _mixer(self, pre: str):
        """(each shard's view of the mixer's parameters, the channel and
        head spec entries)."""
        names = mamba2_table(1, 1, 1, 1, 1)
        pieces = [{} for _ in range(self.n)]
        specs = {}
        for name in names:
            ws, specs[name] = self.w(pre + "mixer." + name)
            for p, t in zip(pieces, ws):
                p[name] = t
        return pieces, specs["z_proj"][1], specs["dt_proj"][1]

    def _ssm_kw(self) -> dict:
        cfg = self.cfg
        return dict(n_heads=cfg.n_ssm_heads, head_dim=cfg.ssm_head_dim,
                    d_state=cfg.ssm_state)

    def _mamba_block(self, pre: str, xs: list, pos, spec,
                     want_cache: bool = False):
        """-> (xs, None, with ``want_cache`` {conv_x, conv_bc, state} each
        shard's: the last K-1 pre-conv projections and the final state)."""
        cfg = self.cfg
        hs = self._norm(pre + "norm", xs)
        seq = spec_axes(spec[1])
        if seq:
            hs = all_gather(hs, self.mesh, seq, 1)
        pieces, chan, heads = self._mixer(pre)
        ys = mamba2_sharded(pieces, hs, self.mesh, chan=chan, heads=heads,
                            chunk=cfg.ssm_chunk, return_state=want_cache,
                            **self._ssm_kw())
        layer = None
        if want_cache:
            ys, finals = ys
            layer = {"conv_x": [], "conv_bc": [], "state": finals}
            for h, p in zip(hs, pieces):
                tail = h[:, -(cfg.d_conv - 1):].float()
                layer["conv_x"].append((tail @ p["x_proj"].float()).to(
                    h.dtype))
                layer["conv_bc"].append((tail @ p["bc_proj"].float()).to(
                    h.dtype))
        if seq:
            ys = self._seq_block(ys, spec, hs[0].shape[1])
        return [x + y for x, y in zip(xs, ys)], None, layer

    def _mamba_decode(self, pre: str, xs: list, pos, spec, slot: dict, idx,
                      kv_len: int) -> list:
        hs = self._norm(pre + "norm", xs)
        pieces, chan, heads = self._mixer(pre)
        caches = [{name: slot[name].pieces[k][idx] for name in slot}
                  for k in range(self.n)]
        ys, new = mamba2_decode_sharded(pieces, [h[:, 0] for h in hs],
                                        caches, self.mesh, chan=chan,
                                        heads=heads,
                                        headdim=slot["state"].spec[-2],
                                        **self._ssm_kw())
        # Every shard has read its cache before any is written (shards on
        # one device share a replicated piece).
        for c, n in zip(caches, new):
            for name, t in n.items():
                c[name].copy_(t)
        return [x + y[:, None] for x, y in zip(xs, ys)]


class ShardedHybrid(ShardedSSM, ShardedDense):
    """The hybrid family on a mesh: ``ShardedSSM``'s Mamba blocks, and the
    one shared ``DenseBlock`` (``shared_attn``) after each group on the
    dense tp program; its parameters' gradients add up over every use and
    every shard.  Each group and its shared block run under one
    checkpoint, the tail a layer at a time, as unsharded."""

    def _schedule(self) -> list:
        cfg = self.cfg
        out = []
        for g in range(cfg.n_layers // cfg.attn_every):
            out += [("mamba", f"layers.{g}.{i}.", "groups", (g, i))
                    for i in range(cfg.attn_every)]
            out.append(("dense", "shared_attn.", "attn", g))
        return out + [("mamba", f"tail_layers.{i}.", "tail", i)
                      for i in range(cfg.n_layers % cfg.attn_every)]

    def _remat_runs(self, remat: bool) -> list:
        blocks = self._schedule()
        if not remat:
            return [blocks]
        g = self.cfg.attn_every + 1
        n = (self.cfg.n_layers // self.cfg.attn_every) * g
        return ([blocks[i:i + g] for i in range(0, n, g)]
                + [[b] for b in blocks[n:]])


SHARD_PROGRAMS = {"dense": ShardedDense, "vlm": ShardedDense,
                  "moe": ShardedMoE, "ssm": ShardedSSM,
                  "hybrid": ShardedHybrid}
