"""Architecture configs of the port (the JAX package's ``repro/configs``,
copied): ``get_config(arch_id)`` returns the full-size config, ``smoke=True``
the reduced same-family one used by CPU tests; ``learned-stencil`` is the
solver family's (registered, but not in ``list_archs()``), and
``JACOBI_CONFIGS`` the paper's own benchmark configurations."""
from repro_torch.configs import (  # noqa: F401  (registers)
    glm4_9b,
    learned_stencil,
    mamba2_370m,
    moonshot_v1_16b_a3b,
    nemotron_4_15b,
    phi3_medium_14b,
    qwen2_vl_2b,
    qwen3_0_6b,
    qwen3_moe_30b_a3b,
    whisper_tiny,
    zamba2_1_2b,
)
from repro_torch.configs.base import ModelConfig, get_config, list_archs
from repro_torch.configs.jacobi import JACOBI_CONFIGS, JacobiConfig

__all__ = ["ModelConfig", "get_config", "list_archs", "JacobiConfig",
           "JACOBI_CONFIGS"]
