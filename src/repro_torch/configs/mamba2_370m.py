"""mamba2-370m [ssm] — SSD, attention-free [arXiv:2405.21060; unverified].

Paper-technique carrier: the depthwise causal conv1d in every block is the
stencil engine's 1D causal encoding (``core/conv1d.py``).
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        arch="mamba2-370m", family="ssm",
        n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, head_dim=0,
        d_ff=0, vocab_size=50280,
        ssm_state=128, d_conv=4, expand=2, ssm_head_dim=64,
        remat_group=4,
        sharding_profile="tp",
        source="[arXiv:2405.21060; unverified]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="mamba2-370m-smoke", family="ssm",
        n_layers=3, d_model=64, n_heads=0, n_kv_heads=0, head_dim=0,
        d_ff=0, vocab_size=512,
        ssm_state=16, d_conv=4, expand=2, ssm_head_dim=32, ssm_chunk=8,
        sharding_profile="tp",
    )


register("mamba2-370m", full, smoke)
