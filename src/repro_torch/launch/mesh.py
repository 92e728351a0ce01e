"""Mesh construction — the port of the JAX package's ``launch/mesh.py``.

Functions, not module constants: importing this module touches no device.
A mesh is a ``parallel.halo.TileMesh`` (named axes, a ``torch.device`` a
shard); one process drives every shard (``parallel/sharding.py``).  Each
function takes an explicit device list (any ``torch.device``, ``"cpu"`` or
``"meta"`` included, so the production shapes build without a card);
without one the shards go round-robin on the visible CUDA devices, as
``parallel.halo.make_mesh`` places them, and it raises where there is none.
"""
from __future__ import annotations

import torch

from repro_torch.parallel.halo import TileMesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         devices=None) -> TileMesh:
    """16 x 16 ("data", "model"), or 2 x 16 x 16 ("pod", "data",
    "model") with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_host_mesh(model: int = 1, devices=None) -> TileMesh:
    """(n // model, model) ("data", "model") over the n devices given, or
    the visible CUDA devices; ``model`` falls back to 1 where it does not
    divide n (JAX's rule).  One card gives the 1 x 1 mesh."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_host_mesh spans the CUDA devices by default and none "
                "is available here; pass devices=['cpu'] * n to mesh the "
                "CPU")
        devices = [torch.device("cuda", k)
                   for k in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    devices = list(devices)
    n = len(devices)
    if n % model:
        model = 1
    return make_mesh((n // model, model), ("data", "model"), devices)
