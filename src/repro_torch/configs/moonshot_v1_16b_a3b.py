"""moonshot-v1-16b-a3b [moe] — Moonlight: 64 experts top-6 + 2 shared experts
[hf:moonshotai/Moonlight-16B-A3B; hf].

Homogeneous-MoE approximation, as in the JAX package's copy: Moonlight's
first dense layer is modeled as MoE like the rest, so every layer is alike.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        arch="moonshot-v1-16b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=0, vocab_size=163840,
        activation="silu", gated_mlp=True,
        rope_theta=5e4,
        n_experts=64, top_k=6, d_ff_expert=1408, n_shared_experts=2,
        remat_group=4,
        sharding_profile="tp",
        source="[hf:moonshotai/Moonlight-16B-A3B; hf]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="moonshot-v1-16b-a3b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=0, vocab_size=512,
        activation="silu", gated_mlp=True,
        n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=2,
        moe_group_size=64, capacity_factor=8.0, q_chunk=16,
        sharding_profile="tp",
    )


register("moonshot-v1-16b-a3b", full, smoke)
