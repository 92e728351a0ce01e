"""whisper-tiny [audio] — enc-dec, conv frontend stubbed [arXiv:2212.04356;
unverified].

The batch carries precomputed frame embeddings (``enc_frames``, (B, 1500,
d_model): the conv stem is a stub, as in the JAX package); enc_len=1500
frames (30 s at Whisper's 2x-strided 50 Hz).  n_layers is the decoder
depth; the decoder position table (``models/encdec.py``) has 32768 rows.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        arch="whisper-tiny", family="encdec",
        n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
        d_ff=1536, vocab_size=51865,
        activation="gelu", gated_mlp=False,
        n_enc_layers=4, enc_len=1500,
        sharding_profile="sp",
        source="[arXiv:2212.04356; unverified]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch="whisper-tiny-smoke", family="encdec",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512,
        activation="gelu", gated_mlp=False,
        n_enc_layers=2, enc_len=24, q_chunk=16,
        sharding_profile="sp",
    )


register("whisper-tiny", full, smoke)
