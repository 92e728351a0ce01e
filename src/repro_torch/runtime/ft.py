"""The fault-tolerant training runtime — the port of the JAX package's
``runtime/ft.py``, with its restart semantics:

  * step-granular checkpointing (async flush, atomic replace, keep-N), in
    the JAX package's file format (``checkpoint/checkpoint.py``);
  * restart from the latest checkpoint on any failure: a run killed and
    restarted ends on the state an uninterrupted run ends on, bit for bit,
    where the step itself is deterministic;
  * failure injection for tests (raise at a chosen step);
  * straggler tracking: a per-step wall-time EWMA, and a step slower than
    ``straggler_factor`` times it is flagged (one host: recorded, not
    evicted).

Where the JAX package waits for the step with ``jax.block_until_ready`` on
the loss, the port synchronises the loss's card before it reads the host
clock.  Where the JAX package restores a checkpoint in place of
``init_state()``, the port calls ``init_state()`` and restores into it
(``Checkpointer.restore(into=...)``): the port's train state shares its
tensors with the model it trains, and the copy keeps it so.
``checkpoint_dir=None`` runs the same loop without checkpoints.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.checkpoint.checkpoint import Checkpointer


@dataclasses.dataclass
class FTConfig:
    checkpoint_dir: str | None
    checkpoint_every: int = 50
    keep: int = 3
    async_save: bool = True
    straggler_factor: float = 3.0
    fail_at_step: int | None = None     # failure injection (tests)


@dataclasses.dataclass
class StepStats:
    step: int
    seconds: float
    is_straggler: bool
    metrics: dict


class InjectedFailure(RuntimeError):
    pass


def _block_until_ready(value: Any) -> None:
    """Wait for the card ``value`` (a tensor, or a dict of them) lies on."""
    leaves = value.values() if isinstance(value, dict) else (value,)
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)


def run_training(
    train_step: Callable[[Any, Any], tuple[Any, dict]],
    init_state: Callable[[], Any],
    batch_for_step: Callable[[int], Any],
    n_steps: int,
    ft: FTConfig,
    on_step: Callable[[StepStats], None] | None = None,
    checkpointer: Checkpointer | None = None,
) -> tuple[Any, list[StepStats]]:
    """Drive training with checkpoint/restart.  Returns (state, stats).

    Restart semantics: if a checkpoint exists in ft.checkpoint_dir, training
    resumes from it (the caller decides whether that is a cold start or a
    post-failure restart — the runtime does not care, which is the point).
    ``checkpointer``: one to use in place of a new one on
    ``ft.checkpoint_dir`` (its ``events`` then stay with the caller).
    """
    ckpt = checkpointer
    if ckpt is None and ft.checkpoint_dir is not None:
        ckpt = Checkpointer(ft.checkpoint_dir, keep=ft.keep)
    state = init_state()
    start_step = 0
    restored = ckpt.restore_latest(into=state) if ckpt is not None else None
    if restored is not None:
        start_step, state = restored
        start_step = int(start_step)

    stats: list[StepStats] = []
    ewma = None
    for step in range(start_step, n_steps):
        if ft.fail_at_step is not None and step == ft.fail_at_step:
            if ckpt is not None:
                ckpt.wait()
            raise InjectedFailure(f"injected failure at step {step}")
        batch = batch_for_step(step)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        # materialize to time the step honestly
        _block_until_ready(metrics.get("loss", metrics))
        dt = time.perf_counter() - t0
        ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        straggler = dt > ft.straggler_factor * ewma and step > start_step + 2
        st = StepStats(step, dt, straggler,
                       {k: float(v) for k, v in metrics.items()})
        stats.append(st)
        if on_step:
            on_step(st)
        if ckpt is not None and ((step + 1) % ft.checkpoint_every == 0
                                 or step + 1 == n_steps):
            ckpt.save(step + 1, state, blocking=not ft.async_save)
    if ckpt is not None:
        ckpt.wait()
    return state, stats
