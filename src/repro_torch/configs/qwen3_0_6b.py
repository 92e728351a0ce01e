"""qwen3-0.6b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        arch="qwen3-0.6b", family="dense",
        n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=3072, vocab_size=151936,
        activation="silu", gated_mlp=True, qk_norm=True,
        rope_theta=1e6,
        remat_group=4,
        sharding_profile="tp",
        source="[hf:Qwen/Qwen3-8B; hf]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="qwen3-0.6b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=512,
        activation="silu", gated_mlp=True, qk_norm=True, q_chunk=16,
        sharding_profile="tp",
    )


register("qwen3-0.6b", full, smoke)
