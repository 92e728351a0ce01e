"""Serving launcher: batched prefill + greedy decode — the port of the JAX
package's ``launch/serve.py``, on ``make_host_mesh()`` with a ``Sharder``
of the config's profile, as JAX's: one card is the 1 x 1 mesh, where the
unsharded path runs.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --batch 4 --prompt-len 2048 --tokens 32            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --smoke --device cpu --dtype float32 --prompt-len 32 --tokens 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        --batch 4 --prompt-len 2048 --tokens 32            # or mamba2-370m
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-moe-30b-a3b --batch 4 --prompt-len 2048 --tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-2b \\
        --batch 4 --prompt-len 2048 --tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
        --batch 16 --prompt-len 224 --tokens 32

Weights are random, drawn from ``--seed`` with JAX's distributions; prompts
are token ids from ``numpy.random.default_rng(seed)``; there is no
tokenizer.  Every family of ``transformer.FAMILIES`` serves: dense
(qwen3-0.6b), moe (qwen3-moe-30b-a3b and moonshot-v1-16b-a3b: K7 once a
layer in a prefill, 61.1 and 57.8 GB of bf16 weights at full depth), ssm
(mamba2-370m: no attention, so no kernel of K1-K9 and ``--attn-impl``
does not apply), hybrid (zamba2-1.2b: its shared attention block, six
times a prefill), vlm (qwen2-vl-2b: K7 once a layer) and encdec
(whisper-tiny: K7 once an encoder layer and twice a decoder layer, self
and cross).  The stub frontends' inputs are zeros as the JAX package's
launchers build them (``stub_inputs``), unless ``serve`` is given
``inputs``.  ``--attn-impl`` sets the config's
``attn_impl`` (``flash``: the prefill attention runs the CUDA kernel K7;
``xla``: plain PyTorch).  On the
card the prefill and the decode loop are timed with CUDA events after one
untimed warm-up (kernel build, library load); on the CPU with the host
clock, and the output says which.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import resolve_device
from repro_torch.kernels import _build
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model_zoo import build
from repro_torch.parallel.sharding import Sharder
from repro_torch.train.serve_step import make_decode_step, make_prefill_step

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def stub_inputs(cfg: ModelConfig, batch: int, seq_len: int, *,
                dtype: torch.dtype, device) -> dict:
    """The stub frontends' inputs as the JAX package's launchers build them
    (zeros in the compute type, bf16 there): encdec's ``enc_frames`` (B,
    enc_len, D), a vlm's ``vision_embeds`` (B, min(n_vision_tokens, S),
    D); {} for the other families."""
    if cfg.family == "encdec":
        shape = (batch, cfg.enc_len, cfg.d_model)
        return {"enc_frames": torch.zeros(shape, dtype=dtype, device=device)}
    if cfg.family == "vlm":
        shape = (batch, min(cfg.n_vision_tokens, seq_len), cfg.d_model)
        return {"vision_embeds": torch.zeros(shape, dtype=dtype,
                                             device=device)}
    return {}


class _Clock:
    """CUDA events on the card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms_since(self, start) -> float:
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        return (time.perf_counter() - start) * 1e3


def host_sharder(cfg: ModelConfig, device: torch.device) -> Sharder:
    """JAX's launchers' sharder: ``Sharder(make_host_mesh(),
    cfg.sharding_profile)``, over the visible CUDA devices (one card gives
    the 1 x 1 mesh, and the unsharded path runs) or, for the CPU, over the
    one CPU device."""
    mesh = make_host_mesh(devices=None if device.type == "cuda"
                          else [device])
    return Sharder(mesh, profile=cfg.sharding_profile)


def serve(cfg: ModelConfig, *, batch: int, prompt_len: int, tokens: int,
          device=None, dtype: torch.dtype = torch.bfloat16,
          seed: int = 0, model=None, inputs: dict | None = None,
          sharder: Sharder | None = None) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then decode
    ``tokens`` greedy tokens; returns the generated ids, the timings and
    the kernel launches of the timed prefill and decode.  ``model``, a
    model of ``cfg`` already built, is served as it is (on its own device,
    in its own type) in place of one drawn from ``seed``.  ``inputs``: the
    batch's entries besides the tokens (a vlm's ``positions`` and
    ``vision_embeds``, encdec's ``enc_frames``), default ``stub_inputs``.
    ``sharder``: the mesh to serve on, default ``host_sharder``."""
    if model is None:
        dev = resolve_device(device)
        model = build(cfg, device=dev, dtype=dtype,
                      generator=torch.Generator(device=dev).manual_seed(seed))
    dev = model.device
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len)), device=dev)
    max_len = prompt_len + tokens + 1
    if sharder is None:
        sharder = host_sharder(cfg, dev)
    prefill = make_prefill_step(model, max_len, sharder=sharder)
    if inputs is None:
        inputs = stub_inputs(cfg, batch, prompt_len, dtype=model.dtype,
                             device=dev)
    batch_in = {"tokens": prompts, **inputs}

    # Untimed warm-up: kernel build, cuBLAS handles, allocator growth.
    token, cache = prefill(batch_in)
    make_decode_step(model, prompt_len, sharder=sharder)(token, cache)
    del token, cache

    clock = _Clock(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = collections.Counter(_build.LAUNCHES)
    t0 = clock.start()
    token, cache = prefill(batch_in)
    prefill_ms = clock.ms_since(t0)
    prefill_launches = dict(_build.LAUNCHES - before)
    before = collections.Counter(_build.LAUNCHES)
    out = [token]
    t0 = clock.start()
    for i in range(tokens):
        token, cache = make_decode_step(model, prompt_len + i,
                                        sharder=sharder)(token, cache)
        out.append(token)
    decode_ms = clock.ms_since(t0) / max(tokens, 1)
    result = {
        "arch": cfg.arch, "attn_impl": cfg.attn_impl,
        "dtype": str(model.dtype).split(".")[1], "batch": batch,
        "prompt_len": prompt_len, "tokens": tokens,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "clock": "cuda events" if dev.type == "cuda" else "host",
        "mesh": dict(zip(sharder.mesh.axis_names, sharder.mesh.shape)),
        "prefill_ms": prefill_ms,
        "prefill_tokens_per_s": batch * prompt_len / (prefill_ms * 1e-3),
        "decode_ms_per_token": decode_ms,
        "prefill_launches": prefill_launches,
        "decode_launches": dict(_build.LAUNCHES - before),
        "generated": torch.stack(out, dim=1),
    }
    if dev.type == "cuda":
        result["peak_memory_GB"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--attn-impl", choices=("xla", "flash"), default="flash")
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="bfloat16")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_config(args.arch, smoke=args.smoke),
                              attn_impl=args.attn_impl)
    r = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
              tokens=args.tokens, device=args.device,
              dtype=DTYPES[args.dtype], seed=args.seed)
    B, S = args.batch, args.prompt_len
    print(f"{r['arch']} on {r['device']} ({r['dtype']}, attn_impl="
          f"{r['attn_impl']}, timed by {r['clock']})")
    print(f"prefill {B}x{S}: {r['prefill_ms']:.3f} ms "
          f"({r['prefill_tokens_per_s']:.0f} tok/s); kernel launches "
          f"{r['prefill_launches']}")
    print(f"decode: {r['decode_ms_per_token']:.3f} ms/token")
    print("seq0:", r["generated"][0].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
