"""glm4-9b [dense] — RoPE, GQA kv=2 [hf:THUDM/glm-4-9b; hf]."""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        arch="glm4-9b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
        d_ff=13696, vocab_size=151552,
        activation="silu", gated_mlp=True,
        rope_theta=1e4,
        remat_group=4,
        sharding_profile="tp",
        source="[hf:THUDM/glm-4-9b; hf]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="glm4-9b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=512,
        activation="silu", gated_mlp=True, q_chunk=16,
        sharding_profile="tp",
    )


register("glm4-9b", full, smoke)
