"""Pipeline-parallel dry run — the port of the JAX package's
``launch/dryrun_pp.py``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_pp [--out DIR]

qwen3-0.6b at full width, B 256 x L 4096 tokens in 8 microbatches, its 28
layers in 2 GPipe stages on the multi-pod mesh's ``pod`` axis
(``parallel/pipeline.gpipe``), each stage's layers under checkpoint, then
the mean square of the output: the forward and loss of JAX's step,
traced on ``meta`` and counted (``launch/hlo_cost.py``).  It writes
``<out>/pipeline__train_4k__pod2x16x16.json`` and prints the hand-offs'
count and bytes.

The counts differ from JAX's in two ways, both the port's schedule:
  * JAX runs every stage every tick under ``shard_map`` and ppermutes
    once a tick, M + S - 1 = 9 times (a bubble's result discarded); the
    port runs no bubble and hands off only real microbatches, M·(S-1) = 8
    of 32 x 4096 x 1024 bf16 (268 MB each);
  * JAX's stage shards its microbatch over the data axis (GSPMD); the
    port runs each stage whole on the device of its ``pod`` coordinate.
The record holds the program's totals (both stages), not per-device
figures.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

B, L, M = 256, 4096, 8          # batch, sequence, microbatches


def run(out_dir: str = "artifacts/dryrun") -> dict:
    from torch.utils.checkpoint import checkpoint

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import native_meta_kernels
    from repro_torch.launch.hlo_cost import CostCounter
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.model_zoo import build
    from repro_torch.parallel.pipeline import gpipe

    cfg = dataclasses.replace(get_config("qwen3-0.6b"), attn_impl="flash")
    mesh = make_production_mesh(multi_pod=True, devices=["meta"] * 512)
    S = mesh.shape["pod"]
    with native_meta_kernels():
        model = build(cfg, device="meta", dtype=torch.bfloat16)
        template = model.layers[0]
        names = [n for n, _ in template.named_parameters()]
        # The layers' weights stage-stacked (S, n_layers / S, ...): the
        # step's arguments, as JAX's ``staged`` stand-ins.
        staged = {n: torch.empty((S, cfg.n_layers // S,
                                  *template.get_parameter(n).shape),
                                 dtype=torch.bfloat16, device="meta")
                  for n in names}
        tokens = torch.empty((B, L), dtype=torch.int32, device="meta")

        def layer(p, x, pos):
            return torch.func.functional_call(template, p, (x, pos))[0]

        def stage_fn(p: dict, x: torch.Tensor) -> torch.Tensor:
            pos = torch.arange(L, device=x.device).expand(x.shape[0], L)
            for j in range(p[names[0]].shape[0]):
                x = checkpoint(layer, {n: p[n][j] for n in names}, x, pos,
                               use_reentrant=False)
            return x

        pipe = gpipe(stage_fn, mesh, "pod", n_microbatches=M)

        def step(staged, embed, tokens):
            x = embed[tokens].to(torch.bfloat16)
            out = pipe(staged, x)
            return torch.mean(out.float() ** 2)

        t0 = time.time()
        with torch.no_grad(), CostCounter() as counter:
            step(staged, model.embed, tokens)
        trace_s = time.time() - t0
    cost = counter.result()
    rec = {
        "mode": f"pipeline(pod={S} stages), each stage whole on its device",
        "arch": "qwen3-0.6b", "batch": B, "seq": L, "microbatches": M,
        "compile_s": round(trace_s, 1),
        "memory_analysis": {"temp_bytes": int(counter.peak_live_bytes)},
        "hlo_cost": cost,
        "status": "OK",
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "pipeline__train_4k__pod2x16x16.json"),
              "w") as f:
        json.dump(rec, f, indent=1)
    cp = cost["collectives"]["collective-permute"]
    print(f"[dryrun_pp] OK trace={rec['compile_s']}s "
          f"permute_count={cp['count']:.0f} "
          f"permute_bytes={cp['operand_bytes']:.3e}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="artifacts/dryrun")
    run(ap.parse_args(argv).out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
