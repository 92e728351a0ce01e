"""nemotron-4-15b [dense] — GQA, squared-ReLU [arXiv:2402.16819; unverified]."""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        arch="nemotron-4-15b", family="dense",
        n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=24576, vocab_size=256000,
        activation="relu2", gated_mlp=False,
        rope_theta=1e4,
        remat_group=4,
        sharding_profile="tp",
        source="[arXiv:2402.16819; unverified]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="nemotron-4-15b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
        activation="relu2", gated_mlp=False, q_chunk=16,
        sharding_profile="tp",
    )


register("nemotron-4-15b", full, smoke)
