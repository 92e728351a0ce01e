"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, qk_norm [hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        arch="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=0, vocab_size=151936,
        activation="silu", gated_mlp=True, qk_norm=True,
        rope_theta=1e6,
        n_experts=128, top_k=8, d_ff_expert=768,
        remat_group=4,
        sharding_profile="tp",
        source="[hf:Qwen/Qwen3-30B-A3B; hf]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="qwen3-moe-30b-a3b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=0, vocab_size=512,
        activation="silu", gated_mlp=True, qk_norm=True,
        n_experts=8, top_k=2, d_ff_expert=32,
        moe_group_size=64, capacity_factor=8.0, q_chunk=16,
        sharding_profile="tp",
    )


register("qwen3-moe-30b-a3b", full, smoke)
