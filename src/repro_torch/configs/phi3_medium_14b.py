"""phi3-medium-14b [dense] — RoPE SwiGLU GQA [arXiv:2404.14219; unverified].

40 heads / 10 kv heads do not divide the 16-wide model axis, so this arch
uses the sequence-parallel profile: activations seq-shard over the model
axis, weights ZeRO-shard over data (DESIGN §5, parallel/sharding.py).
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        arch="phi3-medium-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, head_dim=128,
        d_ff=17920, vocab_size=100352,
        activation="silu", gated_mlp=True,
        rope_theta=1e4,
        remat_group=4,
        sharding_profile="sp",
        source="[arXiv:2404.14219; unverified]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="phi3-medium-14b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=5, n_kv_heads=5, head_dim=16,
        d_ff=96, vocab_size=512,
        activation="silu", gated_mlp=True, q_chunk=16,
        sharding_profile="sp",
    )


register("phi3-medium-14b", full, smoke)
