"""Serving example on the PyTorch port: batched prefill + greedy decode
against the KV/SSM cache, timing per-token latency, at demo size (the
arch's smoke config).  The port of examples/serve_lm.py.

  PYTHONPATH=src python examples/torch_serve_lm.py --arch qwen3-0.6b
  PYTHONPATH=src python examples/torch_serve_lm.py --arch mamba2-370m \\
      --device cpu --tokens 16

Weights are drawn from seed 0 on the device; ``launch/serve.py`` serves
the full-width configs.
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build
    from repro_torch.train.serve_step import (make_decode_step,
                                              make_prefill_step)

    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg = get_config(args.arch, smoke=True)
    model = build(cfg, device=dev, dtype=torch.float32)
    rng = np.random.default_rng(0)
    B, S = args.batch, args.prompt_len
    max_len = S + args.tokens + 1
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (B, S)), device=dev)}
    if cfg.family == "encdec":
        batch["enc_frames"] = torch.as_tensor(
            rng.standard_normal((B, cfg.enc_len, cfg.d_model)),
            dtype=torch.float32, device=dev)
    if cfg.family == "vlm":
        nv = min(cfg.n_vision_tokens, S)
        batch["vision_embeds"] = torch.as_tensor(
            rng.standard_normal((B, nv, cfg.d_model)), dtype=torch.float32,
            device=dev)

    t0 = time.perf_counter()
    token, cache = make_prefill_step(model, max_len)(batch)
    sync()
    t_prefill = time.perf_counter() - t0
    print(f"{args.arch}: prefill {B}x{S} in {t_prefill*1e3:.0f} ms "
          f"({B*S/t_prefill:.0f} tok/s) on {dev}")

    out = [token]
    t0 = time.perf_counter()
    for i in range(args.tokens):
        token, cache = make_decode_step(model, S + i)(token, cache)
        out.append(token)
    sync()
    dt = (time.perf_counter() - t0) / max(args.tokens, 1)
    print(f"decode: {dt*1e3:.1f} ms/token ({B/dt:.0f} tok/s batched)")
    ids = torch.stack(out, dim=1)
    print("generated token ids (seq 0):", ids[0].tolist())
    return ids


if __name__ == "__main__":
    main()
