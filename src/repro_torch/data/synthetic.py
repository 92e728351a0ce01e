"""Deterministic synthetic token batches and stencil tiles — the port of the
JAX package's ``data/synthetic.py``.

Each row of a batch comes from numpy's counter-based Philox generator keyed
on (seed, step, row), so every host draws only its slice and a restarted
run, on any host count, reproduces the same global batch.  The numbers are
JAX's bit for bit: the same numpy calls, handed to torch.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.plan import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234


def host_slice(global_batch: int, n_hosts: int,
               host_id: int) -> tuple[int, int]:
    per = global_batch // n_hosts
    return host_id * per, per


def token_batch(cfg: DataConfig, step: int, n_hosts: int = 1,
                host_id: int = 0, *, device=None) -> dict:
    """{tokens, labels}, int32 (per-host batch, seq_len), for this host's
    slice of the global batch, on ``device`` (None: the card)."""
    start, per = host_slice(cfg.global_batch, n_hosts, host_id)
    rows = []
    for b in range(start, start + per):
        rng = np.random.Generator(
            np.random.Philox(key=cfg.seed + step * 1_000_003 + b))
        rows.append(rng.integers(0, cfg.vocab_size, cfg.seq_len + 1,
                                 dtype=np.int32))
    arr = torch.from_numpy(np.stack(rows)).to(resolve_device(device))
    return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}


def batches(cfg: DataConfig, n_steps: int, n_hosts: int = 1,
            host_id: int = 0, *, device=None) -> Iterator[dict]:
    for step in range(n_steps):
        yield token_batch(cfg, step, n_hosts, host_id, device=device)


def stencil_tiles(grid: tuple[int, ...], n_steps: int, seed: int = 0,
                  batch: int = 1, *, device=None) -> Iterator[torch.Tensor]:
    """Stream of per-step stencil tiles (the paper's N-per-step
    decomposition): fp32 (batch, *grid) on ``device`` (None: the card)."""
    dev = resolve_device(device)
    for step in range(n_steps):
        rng = np.random.Generator(np.random.Philox(key=seed + step))
        tile = rng.standard_normal((batch, *grid)).astype(np.float32)
        yield torch.from_numpy(tile).to(dev)
