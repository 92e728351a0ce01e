"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

The backbone only, as in the JAX package: the vision tower is a stub, and
the batch carries precomputed patch embeddings (``vision_embeds``) that take
the first ``n_vision_tokens`` sequence positions, and 3-channel M-RoPE
position ids (``positions``, (3, B, S)).
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        arch="qwen2-vl-2b", family="vlm",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
        d_ff=8960, vocab_size=151936,
        activation="silu", gated_mlp=True,
        rope_theta=1e6, m_rope_sections=(16, 24, 24),
        n_vision_tokens=1024,
        remat_group=4,
        sharding_profile="sp",
        source="[arXiv:2409.12191; hf]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="qwen2-vl-2b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=512,
        activation="silu", gated_mlp=True,
        m_rope_sections=(2, 3, 3), n_vision_tokens=8, q_chunk=16,
        sharding_profile="sp",
    )


register("qwen2-vl-2b", full, smoke)
