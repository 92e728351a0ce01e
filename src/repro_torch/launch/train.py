"""Training launcher: AdamW steps of the LM through the fault-tolerant
runtime (``runtime/ft.py``) — the port of the JAX package's
``launch/train.py``, with its checkpoint, restart and failure-injection
options, on ``make_host_mesh()`` with a ``Sharder`` of the config's profile
(``launch.serve.host_sharder``; one card is the 1 x 1 mesh, where the
unsharded step runs).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --global-batch 4 --seq-len 2048 --steps 5           # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --device cpu --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
        --global-batch 4 --seq-len 2048 --steps 5           # or zamba2-1.2b
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch moonshot-v1-16b-a3b --smoke --device cpu --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-vl-2b \\
        --global-batch 4 --seq-len 2048 --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \\
        --global-batch 16 --seq-len 448 --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --device cpu --steps 6 --checkpoint-dir artifacts/ck \\
        --checkpoint-every 3 --fail-at-step 4   # dies at step 4; run it
                                                # again without the flag

The fp32 master weights are random, drawn from ``--seed`` with JAX's
distributions; each step's batch is ``data.synthetic.token_batch`` (JAX's
numbers); the forward and backward compute in bf16 with layer groups under
checkpoint (the Mamba2 blocks' SSD chunks too).  ``--attn-impl flash``
(the default) runs attention through the CUDA kernels: K7 forward (once in
the forward and once more in the recompute, a layer or, for zamba2-1.2b, a
use of its shared block) and K8/K9 backward; ``xla`` through plain
PyTorch.  mamba2-370m has no attention and launches no kernel.  The moe
archs (qwen3-moe-30b-a3b, moonshot-v1-16b-a3b) add their layers' aux loss
(weight 0.01) and route in bf16 as JAX's step does; at full depth their
train state (16 B a parameter) passes one card's 80 GB, so
``train(dataclasses.replace(cfg, n_layers=4), ...)`` is how a caller cuts
their depth (``chip_smoke.py`` phase 29).  qwen2-vl-2b's batch carries
zeros for its vision embeddings and whisper-tiny's for its frames, as the
JAX launcher's (``launch.serve.stub_inputs``, bf16).  With zero vision
embeddings the vision rows of qwen2-vl's residual stay exactly zero, and
rms_norm's derivative there (rsqrt(eps)) makes their gradient overflow
past about 16 layers, so at full depth the gradients are NaN, as the JAX
package's are (ROADMAP §3); ``train(..., inputs=...)`` takes embeddings
drawn otherwise (``chip_smoke.py`` phase 30).  On the
card each step is timed with CUDA events; on the CPU with the host clock,
and the output says which.  The first step pays the kernel build and the allocator's growth.

As the JAX launcher does, the CLI checkpoints the train state (fp32
params, m, v and the step; 12 B a parameter) into ``--checkpoint-dir``
(default ``artifacts/ckpt``) every ``--checkpoint-every`` steps and at the
last, and a run finding a checkpoint there resumes from it:
``--fail-at-step N`` raises ``runtime.ft.InjectedFailure`` before step N,
and the next run picks up from the latest checkpoint.  Step i's batch is
``token_batch(data, i)`` and the schedule runs over ``--steps`` whether or
not the run was restarted, so a restarted run ends on the uninterrupted
run's state and loss, bit for bit (``final loss`` prints it exactly).
``train()`` checkpoints only when given ``checkpoint_dir``.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import sys

import torch

from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import resolve_device
from repro_torch.data.synthetic import DataConfig, token_batch
from repro_torch.kernels import _build
from repro_torch.launch.serve import _Clock, host_sharder, stub_inputs
from repro_torch.models.model_zoo import build
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.sharding import Sharder
from repro_torch.runtime.ft import FTConfig, run_training
from repro_torch.train.train_step import init_train_state, make_train_step


def train(cfg: ModelConfig, *, steps: int, global_batch: int, seq_len: int,
          lr: float = 3e-4, device=None, seed: int = 0, log_every: int = 0,
          inputs: dict | None = None, checkpoint_dir: str | None = None,
          checkpoint_every: int = 10,
          fail_at_step: int | None = None,
          sharder: Sharder | None = None) -> dict:
    """Run train steps up to ``steps`` from fp32 masters drawn from
    ``seed``, through ``runtime.ft.run_training``; returns one record a
    step run (loss, nll, lr, grad_norm, ms, tokens/s and the kernel
    launches of that step), the peak device memory, the step the run
    started from and the checkpoints' events.  Prints a line every
    ``log_every`` steps (0: never).  ``inputs``: the batch's entries
    besides the tokens and labels, the same every step (a vlm's
    ``vision_embeds`` and ``positions``, encdec's ``enc_frames``), default
    ``stub_inputs``.  ``checkpoint_dir``: checkpoint there every
    ``checkpoint_every`` steps and at the last (the newest three kept),
    and resume from the latest one found; ``fail_at_step`` raises
    ``InjectedFailure`` before that step.  ``sharder``: the mesh to train
    on, default ``launch.serve.host_sharder``."""
    dev = resolve_device(device)
    model = build(cfg, device=dev, dtype=torch.float32,
                  generator=torch.Generator(device=dev).manual_seed(seed))
    opt = AdamWConfig(lr=lr, total_steps=steps,
                      warmup_steps=max(1, steps // 10))
    if sharder is None:
        sharder = host_sharder(cfg, dev)
    train_step = make_train_step(model, opt, sharder=sharder)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch)
    if inputs is None:
        inputs = stub_inputs(cfg, global_batch, seq_len,
                             dtype=torch.bfloat16, device=dev)
    clock = _Clock(dev)
    ft = FTConfig(checkpoint_dir=checkpoint_dir,
                  checkpoint_every=checkpoint_every,
                  fail_at_step=fail_at_step)
    ckpt = (Checkpointer(checkpoint_dir, keep=ft.keep)
            if checkpoint_dir is not None else None)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    records, timed = [], {}

    def timed_step(state, batch):
        before = collections.Counter(_build.LAUNCHES)
        t0 = clock.start()
        state, metrics = train_step(state, batch)
        timed["ms"] = clock.ms_since(t0)
        timed["launches"] = dict(_build.LAUNCHES - before)
        return state, metrics

    def on_step(st):
        ms = timed["ms"]
        rec = {"step": st.step + 1, "ms": ms,
               "tokens_per_s": global_batch * seq_len / (ms * 1e-3),
               **st.metrics, "launches": timed["launches"]}
        records.append(rec)
        if log_every and rec["step"] % log_every == 0:
            flag = " STRAGGLER" if st.is_straggler else ""
            print(f"step {rec['step']:5d} loss={rec['loss']:.4f} "
                  f"nll={rec['nll']:.4f} lr={rec['lr']:.2e} "
                  f"gnorm={rec['grad_norm']:.3f} {ms:.1f}ms "
                  f"{rec['tokens_per_s']:.0f} tok/s{flag}", flush=True)

    state = init_train_state(model)
    state, _ = run_training(
        timed_step, lambda: state,
        lambda i: {**token_batch(data, i, device=dev), **inputs},
        steps, ft, on_step=on_step, checkpointer=ckpt)
    result = {
        "arch": cfg.arch, "attn_impl": cfg.attn_impl,
        "global_batch": global_batch, "seq_len": seq_len,
        "mesh": dict(zip(sharder.mesh.axis_names, sharder.mesh.shape)),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "clock": "cuda events" if dev.type == "cuda" else "host",
        "start_step": records[0]["step"] - 1 if records else steps,
        "steps": records,
        "checkpoints": ckpt.events if ckpt is not None else [],
    }
    if dev.type == "cuda":
        result["peak_memory_GB"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default="artifacts/ckpt")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--attn-impl", choices=("xla", "flash"), default="flash")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_config(args.arch, smoke=args.smoke),
                              attn_impl=args.attn_impl)
    print(f"{cfg.arch}: {args.global_batch}x{args.seq_len} tokens a step, "
          f"attn_impl={cfg.attn_impl}", flush=True)
    r = train(cfg, steps=args.steps, global_batch=args.global_batch,
              seq_len=args.seq_len, lr=args.lr, device=args.device,
              seed=args.seed, log_every=args.log_every,
              checkpoint_dir=args.checkpoint_dir,
              checkpoint_every=args.checkpoint_every,
              fail_at_step=args.fail_at_step)
    if r["start_step"]:
        print(f"resumed from step {r['start_step']} "
              f"({args.checkpoint_dir})")
    for ev in r["checkpoints"]:
        secs = ", ".join(f"{k} {ev[k]:.3f}" for k in
                         ("host_copy_s", "write_s", "read_s", "seconds")
                         if k in ev)
        print(f"checkpoint {ev['op']} step {ev['step']}: "
              f"{ev['bytes'] / 1e9:.3f} GB ({secs} s)")
    total = collections.Counter()
    for rec in r["steps"]:
        total.update(rec["launches"])
    print(f"on {r['device']} (timed by {r['clock']})")
    if "peak_memory_GB" in r:
        print(f"peak device memory {r['peak_memory_GB']:.3f} GB")
    print(f"kernel launches {dict(total)}")
    losses = [rec["loss"] for rec in r["steps"]]
    if losses:
        print(f"done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
        print(f"final loss {losses[-1]!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
