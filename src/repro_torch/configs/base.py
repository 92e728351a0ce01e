"""ModelConfig — the port's own copy of the JAX package's ``configs/base.py``
(one dataclass for every architecture family), with ``padded_vocab``,
``param_count``, ``active_param_count``, ``register``, ``get_config`` and ``list_archs``.

Full-size configs live in ``repro_torch/configs/<arch_id>.py``; every arch
also has ``smoke()``, a reduced same-family config for CPU tests.  Every
arch of ``list_archs()`` is registered (dense: nemotron-4-15b, glm4-9b,
qwen3-0.6b, phi3-medium-14b; ssm: mamba2-370m; hybrid: zamba2-1.2b; moe:
qwen3-moe-30b-a3b, moonshot-v1-16b-a3b; vlm: qwen2-vl-2b; encdec:
whisper-tiny).  The solver family's ``learned-stencil``
(``configs/learned_stencil.py``) registers too, but is not an arch of
``list_archs()``.
"""
from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                    # dense | moe | ssm | hybrid | vlm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    activation: str = "silu"       # silu (SwiGLU) | relu2 | gelu
    gated_mlp: bool = True
    qk_norm: bool = False
    rope_theta: float = 1e4
    m_rope_sections: tuple[int, ...] | None = None
    norm_eps: float = 1e-5

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 1024
    moe_waves: int = 16
    moe_dispatch: str = "einsum"   # einsum (GShard one-hot) | scatter

    # SSM (Mamba2)
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256

    # hybrid (Zamba2): a single shared attention block applied every k layers
    attn_every: int = 0

    # enc-dec (Whisper): n_layers is the decoder depth
    n_enc_layers: int = 0
    enc_len: int = 0

    # VLM (Qwen2-VL): number of stub vision-patch embeddings prepended
    n_vision_tokens: int = 0

    # execution
    attn_impl: str = "xla"         # xla (plain PyTorch) | flash (CUDA K7)
    q_chunk: int = 1024
    remat_group: int = 1
    sharding_profile: str = "tp"   # tp | sp
    source: str = ""               # provenance note [source; verified-tier]

    @property
    def padded_vocab(self) -> int:
        """The vocab padded to a multiple of 128 (the JAX package shards the
        embedding, lm_head and logits over a 16-wide axis).  Rows beyond
        vocab_size are masked in the argmax (``mask_pad_logits``)."""
        m = 128
        return (self.vocab_size + m - 1) // m * m

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_causal_lm(self) -> bool:
        return self.family in ("dense", "moe", "ssm", "hybrid", "vlm")

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        D, V = self.d_model, self.vocab_size
        emb = V * D * 2  # untied embed + lm_head

        def attn(nh=self.n_heads, nkv=self.n_kv_heads, hd=self.head_dim):
            return D * hd * (nh + 2 * nkv) + nh * hd * D

        def mlp(dff=self.d_ff, gated=self.gated_mlp):
            return D * dff * (3 if gated else 2)

        def mamba():
            di, N, H = self.d_inner, self.ssm_state, self.n_ssm_heads
            return (2 * D * di + D * 2 * N + D * H
                    + self.d_conv * (di + 2 * N) + 3 * H + di + di * D)
        if self.family in ("dense", "vlm"):
            blocks = self.n_layers * (attn() + mlp() + 2 * D)
        elif self.family == "moe":
            expert = 3 * D * self.d_ff_expert
            shared = 3 * D * self.d_ff_expert * self.n_shared_experts
            blocks = self.n_layers * (
                attn() + self.n_experts * expert + shared
                + D * self.n_experts + 2 * D)
        elif self.family == "ssm":
            blocks = self.n_layers * (mamba() + D)
        elif self.family == "hybrid":
            blocks = self.n_layers * (mamba() + D) + (attn() + mlp() + 2 * D)
        elif self.family == "encdec":
            enc = self.n_enc_layers * (attn() + mlp(gated=False) + 4 * D)
            dec = self.n_layers * (2 * attn() + mlp(gated=False) + 6 * D)
            blocks = enc + dec
        else:
            raise ValueError(self.family)
        return emb + blocks + D

    def active_param_count(self) -> int:
        """Active params per token (= param_count for non-MoE)."""
        if self.family != "moe":
            return self.param_count()
        expert = 3 * self.d_model * self.d_ff_expert
        inactive = self.n_layers * (self.n_experts - self.top_k) * expert
        return self.param_count() - inactive


_REGISTRY: dict[str, dict] = {}


def register(arch_id: str, full, smoke):
    _REGISTRY[arch_id] = {"full": full, "smoke": smoke}


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in _REGISTRY:
        if arch_id not in list_archs():
            raise ValueError(f"unknown arch {arch_id!r}; known: "
                             f"{list_archs()}")
        importlib.import_module(
            f"repro_torch.configs.{arch_id.replace('-', '_')}")
    entry = _REGISTRY[arch_id]
    return entry["smoke" if smoke else "full"]()


def list_archs() -> list[str]:
    return [
        "nemotron-4-15b", "glm4-9b", "qwen3-0.6b", "phi3-medium-14b",
        "qwen2-vl-2b", "zamba2-1.2b", "moonshot-v1-16b-a3b",
        "qwen3-moe-30b-a3b", "whisper-tiny", "mamba2-370m",
    ]
