"""The fault-tolerant training runtime (``ft``), ported from the JAX
package's ``runtime/``."""
from repro_torch.runtime.ft import (FTConfig, InjectedFailure, StepStats,
                                    run_training)

__all__ = ["FTConfig", "InjectedFailure", "StepStats", "run_training"]
