"""fp32 rounding of the vlm and encdec families against float64, at
``chip_smoke.py`` phase 32's sizes: the readings phase 32's bounds come
from.

    PYTHONPATH=src python tests/_torch_vlm_encdec_noise.py --card   # H100
    PYTHONPATH=src python tests/_torch_vlm_encdec_noise.py          # CPU

For qwen2-vl-2b and whisper-tiny (the same weights, seeds and inputs as
phase 32), one JSON line each with:

- (a) decode against the train-mode forward: the fp32 reading per step
  (flash, as phase 32 runs it), the float64 one (xla: K7 takes no float64;
  the port's fp32 points, its ``.float()`` casts, widened to float64, as
  tests/_torch_ssm_noise.py widens them),
  fed the fp32 run's tokens, each fp32 logit set's distance from the
  float64 forward's, and the planted faults' readings in fp32;
- (b) the prefill hidden: fp32 flash and fp32 xla each against float64
  xla, and against each other;
- (c) the prefill hidden at the smaller cut: the card's fp32 and the CPU's
  fp32 each against the card's float64, and against each other;

and the bound each reading suggests: twice the larger fp32 distance from
float64, rounded up to one digit.  Without ``--card`` it runs the smoke
configs on the CPU at small sizes: a rehearsal of the code, not a reading.
"""
import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import chip_smoke as C  # noqa: E402  (sizes and seeds of phase 32)
from _torch_vlm_encdec_cases import (cross_attention_causal,  # noqa: E402
                                     decode_vs_forward, family_inputs, rel,
                                     sections_swapped, sinusoid_shifted)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model_zoo import build  # noqa: E402


def bound(*readings):
    """Twice the largest reading, rounded up to one significant digit."""
    x = 2 * max(readings)
    e = math.floor(math.log10(x))
    return float(f"{math.ceil(x / 10 ** e)}e{e}")


@contextlib.contextmanager
def widened():
    """Every ``Tensor.float()`` (the port's fp32 points: norms, softmax,
    the logits, the cross query) gives float64 inside the block."""
    orig = torch.Tensor.float
    torch.Tensor.float = lambda self: self.double()
    try:
        yield
    finally:
        torch.Tensor.float = orig


def twin(model, cfg, dtype, impl):
    out = type(model)(dataclasses.replace(cfg, attn_impl=impl),
                      device=model.device, dtype=dtype)
    out.load_state_dict(model.state_dict())
    return out


def probe(arch, dev, smoke):
    cfg = dataclasses.replace(get_config(arch, smoke=smoke),
                              attn_impl="flash")
    B, S, T = (2, 20, 3) if smoke else C.VE_FP32[arch]
    cut = dataclasses.replace(cfg, **({"n_layers": 2} if smoke
                                      else C.VE_FP32_CUT[arch]))
    model = build(cut, device=dev, dtype=torch.float32,
                  generator=torch.Generator(device=dev).manual_seed(0))
    prompts = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)), device=dev)
    extra = family_inputs(cut, B, S, 1, dev, torch.float32,
                          width=4 if smoke else C.VLM_GRID_W)
    pos = extra.pop("positions", None)
    out = {"arch": arch, "device": str(dev), "smoke": smoke}
    # (a)
    f32 = decode_vs_forward(model, prompts, T, extra, pos, keep=True)
    m64 = twin(model, cut, torch.float64, "xla")
    with widened():
        f64 = decode_vs_forward(m64, prompts, T,
                                {k: v.double() for k, v in extra.items()},
                                pos, tokens=f32["tokens"], keep=True)
    del m64
    dist = [max(rel(d, w64), rel(f, w64)) for d, f, w64 in
            zip(f32["decode"], f32["forward"], f64["forward"])]
    first = f32["tokens"][:, :1]
    faults = {}
    if cut.family == "vlm":
        bad = type(model)(dataclasses.replace(
            cut, m_rope_sections=sections_swapped(cut.m_rope_sections)),
            device=dev)
        bad.load_state_dict(model.state_dict())
        faults["sections_swapped"] = decode_vs_forward(
            model, prompts, 1, extra, pos, tokens=first,
            prefill_model=bad)["errs"][0]
        del bad
    else:
        faults["cross_attention_causal"] = decode_vs_forward(
            model, prompts, 1, extra, tokens=first,
            forward_fault=cross_attention_causal)["errs"][0]
        faults["sinusoid_shifted"] = decode_vs_forward(
            model, prompts, 1, extra, tokens=first,
            fault=sinusoid_shifted)["errs"][0]
    out["a"] = {"fp32_decode_vs_forward": f32["errs"],
                "float64_decode_vs_forward": f64["errs"],
                "fp32_from_float64_by_step": dist, "faults_fp32": faults,
                "bound": bound(*dist)}
    # (b)
    kw = dict(extra) if pos is None else {**extra, "positions": pos}
    hidden = {}
    for name, dtype, impl in (("flash", torch.float32, "flash"),
                              ("xla", torch.float32, "xla"),
                              ("xla64", torch.float64, "xla")):
        m = twin(model, cut, dtype, impl)
        wide = dtype == torch.float64
        with widened() if wide else contextlib.nullcontext():
            hidden[name], _ = m.prefill(prompts, S, **{
                k: v.to(dtype) if v.is_floating_point() else v
                for k, v in kw.items()})
        del m
    out["b"] = {"flash_vs_float64": rel(hidden["flash"], hidden["xla64"]),
                "xla_vs_float64": rel(hidden["xla"], hidden["xla64"]),
                "flash_vs_xla": rel(hidden["flash"], hidden["xla"])}
    out["b"]["bound"] = bound(out["b"]["flash_vs_float64"],
                              out["b"]["xla_vs_float64"])
    del model, hidden
    # (c)
    Bc, Sc, nvc, wc = (2, 20, 8, 4) if smoke else C.VE_CPU[arch]
    small = dataclasses.replace(cfg, **({"n_layers": 1} if smoke
                                        else C.VE_CPU_CUT[arch]))
    card = build(small, device=dev, dtype=torch.float32,
                 generator=torch.Generator(device=dev).manual_seed(2))
    cpu = type(card)(small, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (Bc, Sc)), device=dev)
    kw = family_inputs(small, Bc, Sc, 2, dev, torch.float32, n_vision=nvc,
                       width=wc)
    h_card, _ = card.prefill(tokens, Sc, **kw)
    h_cpu, _ = cpu.prefill(tokens.cpu(), Sc,
                           **{k: v.cpu() for k, v in kw.items()})
    with widened():
        h64, _ = twin(card, small, torch.float64, "xla").prefill(
            tokens, Sc, **{k: v.double() if v.is_floating_point() else v
                           for k, v in kw.items()})
    out["c"] = {"card_vs_float64": rel(h_card, h64),
                "cpu_vs_float64": rel(h_cpu, h64.cpu()),
                "card_vs_cpu": rel(h_card.cpu(), h_cpu)}
    out["c"]["bound"] = bound(out["c"]["card_vs_float64"],
                              out["c"]["cpu_vs_float64"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--card", action="store_true",
                    help="phase 32's sizes on the CUDA device")
    args = ap.parse_args(argv)
    if args.card and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda" if args.card else "cpu")
    for arch in (C.VLM_ARCH, C.ENCDEC_ARCH):
        with torch.no_grad():
            print(json.dumps(probe(arch, dev, smoke=not args.card)),
                  flush=True)
        if args.card:
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
