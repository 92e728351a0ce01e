"""Architecture configs of the port (the JAX package's ``repro/configs``,
copied): ``get_config(arch_id)`` returns the full-size config, ``smoke=True``
the reduced same-family one used by CPU tests."""
from repro_torch.configs import qwen3_0_6b  # noqa: F401  (registers)
from repro_torch.configs.base import ModelConfig, get_config, list_archs

__all__ = ["ModelConfig", "get_config", "list_archs"]
