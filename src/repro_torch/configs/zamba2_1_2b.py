"""zamba2-1.2b [hybrid] — Mamba2 backbone + one shared attention block applied
every 6 layers [arXiv:2411.15242; hf].

38 Mamba2 layers; the shared transformer block (MHA 32 heads + SwiGLU MLP)
reuses one parameter set across its 6 applications (groups of 6 layers, with
a 2-layer tail).  A paper-technique carrier: its causal conv1d is the
stencil engine's 1D causal encoding (``core/conv1d.py``).
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        arch="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, vocab_size=32000,
        activation="silu", gated_mlp=True,
        rope_theta=1e4,
        ssm_state=64, d_conv=4, expand=2, ssm_head_dim=64,
        attn_every=6,
        sharding_profile="tp",
        source="[arXiv:2411.15242; hf]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="zamba2-1.2b-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512,
        activation="silu", gated_mlp=True,
        ssm_state=16, d_conv=4, expand=2, ssm_head_dim=32, ssm_chunk=8,
        attn_every=2, q_chunk=16,
        sharding_profile="tp",
    )


register("zamba2-1.2b", full, smoke)
