"""Checkpointing (``checkpoint``), ported from the JAX package's
``checkpoint/``: the same ``.npz`` files and manifest."""
from repro_torch.checkpoint.checkpoint import Checkpointer

__all__ = ["Checkpointer"]
