"""fp32 rounding of the moe family against float64, at ``chip_smoke.py``
phase 28's sizes: the readings phase 28's bounds come from.

    PYTHONPATH=src python tests/_torch_moe_noise.py --card   # on the H100
    PYTHONPATH=src python tests/_torch_moe_noise.py          # CPU rehearsal

For each moe arch (the same weights, seeds and inputs as phase 28), one JSON
line with:

- (a) decode against the train-mode forward (phase 28's no-drop config):
  the fp32 reading per step, the float64 one, and each fp32 run's distance
  from the float64 forward (decode and forward), and the two planted
  faults' readings in fp32;
- (b) the prefill hidden at the config's own groups: fp32 flash and fp32
  xla each against float64 xla (K7 takes no float64), and flash against
  xla in fp32;
- (c) the prefill hidden at the depth-2 cut: the card's fp32 and the CPU's
  fp32 each against the card's float64, and against each other;
- (d) one layer, einsum and scatter dispatch in fp32 each against einsum in
  float64, output and worst gradient, and against each other.

Routing runs in fp32 in every model (the router is fp32, ``models/moe.py``),
so the float64 runs route on fp32 logits of float64 inputs.  Without
``--card`` it runs the smoke configs on the CPU (depth 2 and 1, 2 x 64
tokens): a rehearsal of the code, not a reading.
"""
import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import chip_smoke as C  # noqa: E402  (sizes and seeds of phase 28)
from _torch_moe_cases import no_drop_config, slots_swapped  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.layers import flatten  # noqa: E402
from repro_torch.models.model_zoo import build  # noqa: E402
from repro_torch.models.moe import MoE, moe_table  # noqa: E402
from repro_torch.models.transformer import (Transformer,  # noqa: E402
                                            mask_pad_logits)


def rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def as_dtype(model, cfg, dtype, device):
    out = Transformer(cfg, device=device, dtype=dtype)
    out.load_state_dict(model.state_dict())
    return out


def decode_vs_forward(model, prompts, steps, faults=False):
    """Per-step logits of decode and of the forward, fed the decode's own
    greedy tokens; with ``faults`` also the first step's logits from a
    cache one place short and with the first token's slots swapped."""
    cfg = model.cfg
    S = prompts.shape[1]
    h, cache = model.prefill(prompts, S + steps + 1)
    prefilled = {k: v.clone() for k, v in cache.items()}
    with torch.no_grad():
        tok = torch.argmax(mask_pad_logits(model.logits(h), cfg), -1)
    first, seq, dec, fwd, toks = tok, prompts, [], [], []
    for i in range(steps):
        seq = torch.cat([seq, tok[:, None]], dim=1)
        toks.append(tok)
        logits, cache = model.decode_step(tok, cache, S + i)
        with torch.no_grad():
            hidden, _ = model(seq, remat=False)
            want = mask_pad_logits(model.logits(hidden[:, -1]), cfg)
        dec.append(logits[:, :cfg.vocab_size].cpu())
        fwd.append(want[:, :cfg.vocab_size].cpu())
        tok = torch.argmax(logits, -1)
    out = {"decode": dec, "forward": fwd, "tokens": toks}
    if faults:
        bad = {k: v.clone() for k, v in prefilled.items()}
        short, _ = model.decode_step(first, bad, S - 1)
        bad = {k: v.clone() for k, v in prefilled.items()}
        with slots_swapped():
            swapped, _ = model.decode_step(first, bad, S)
        out["faults"] = {
            "kv_len_short": rel(short[:, :cfg.vocab_size], fwd[0]),
            "slots_swapped": rel(swapped[:, :cfg.vocab_size], fwd[0])}
    return out


def forced_forward(model, prompts, tokens):
    """The forward's and decode's last logits fed the given ``tokens``."""
    cfg = model.cfg
    S = prompts.shape[1]
    _, cache = model.prefill(prompts, S + len(tokens) + 1)
    seq, dec, fwd = prompts, [], []
    for i, tok in enumerate(tokens):
        seq = torch.cat([seq, tok[:, None]], dim=1)
        logits, cache = model.decode_step(tok, cache, S + i)
        with torch.no_grad():
            hidden, _ = model(seq, remat=False)
        dec.append(logits[:, :cfg.vocab_size].cpu())
        fwd.append(mask_pad_logits(model.logits(hidden[:, -1]),
                                   cfg)[:, :cfg.vocab_size].cpu())
    return dec, fwd


def dispatch_case(cfg, dev, dtype, mode, tokens):
    """Phase 28 (d)'s layer in ``dtype``: (out, {name: grad})."""
    Bd, Sd = tokens
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(Bd, Sd, cfg.d_model, generator=gen, device=dev)
    r = torch.randn(Bd, Sd, cfg.d_model, generator=gen, device=dev)
    layer = MoE(cfg.d_model, cfg.n_experts, cfg.d_ff_expert,
                cfg.n_shared_experts, top_k=cfg.top_k,
                capacity_factor=cfg.capacity_factor,
                activation=cfg.activation, n_waves=cfg.moe_waves,
                dispatch_mode=mode, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    for path, pd in flatten(moe_table(cfg.d_model, cfg.n_experts,
                                      cfg.d_ff_expert,
                                      cfg.n_shared_experts)):
        pd.fill(layer.get_parameter(".".join(path)), g)
    layer.to(dtype)
    layer.router.data = layer.router.data.float()
    xx = x.to(dtype).requires_grad_()
    out, aux = layer(xx, cfg.moe_group_size)
    names, leaves = zip(*layer.named_parameters())
    grads = torch.autograd.grad((out * r.to(dtype)).sum() + aux,
                                [*leaves, xx])
    return out.detach().cpu(), {n: g.cpu() for n, g in
                                zip((*names, "x"), grads)}


def probe(arch, dev, card):
    cfg = dataclasses.replace(get_config(arch, smoke=not card),
                              attn_impl="flash")
    B, S, T = C.MOE_FP32 if card else (2, 64, 4)
    depth = C.MOE_FP32_DEPTH if card else 2
    V = cfg.vocab_size
    cut = dataclasses.replace(cfg, n_layers=depth)
    out = {"arch": arch, "device": str(dev), "n_layers": depth, "batch": B,
           "prompt_len": S, "tokens": T}
    # (a)
    cfg_a = no_drop_config(cut, B * (S + T))
    model = build(cfg_a, device=dev, dtype=torch.float32,
                  generator=torch.Generator(device=dev).manual_seed(0))
    prompts = torch.as_tensor(np.random.default_rng(1).integers(
        0, V, (B, S)), device=dev)
    r32 = decode_vs_forward(model, prompts, T, faults=True)
    m64 = as_dtype(model, dataclasses.replace(cfg_a, attn_impl="xla"),
                   torch.float64, dev)
    state = model.state_dict()
    del model
    d64, f64 = forced_forward(m64, prompts, r32["tokens"])
    del m64
    out["a"] = {
        "fp32_decode_vs_forward": [rel(a, b) for a, b in
                                   zip(r32["decode"], r32["forward"])],
        "f64_decode_vs_forward": [rel(a, b) for a, b in zip(d64, f64)],
        "fp32_decode_vs_f64_forward": [rel(a, b) for a, b in
                                       zip(r32["decode"], f64)],
        "fp32_forward_vs_f64_forward": [rel(a, b) for a, b in
                                        zip(r32["forward"], f64)],
        "faults_fp32": r32["faults"]}
    # (b)
    hidden = {}
    for impl, dtype in (("flash", torch.float32), ("xla", torch.float32),
                        ("xla", torch.float64)):
        m = Transformer(dataclasses.replace(cut, attn_impl=impl),
                        device=dev, dtype=dtype)
        m.load_state_dict(state)
        hidden[(impl, dtype)], _ = m.prefill(prompts, S)
        del m
    h64 = hidden[("xla", torch.float64)]
    out["b"] = {"flash_fp32_vs_f64": rel(hidden[("flash", torch.float32)],
                                         h64),
                "xla_fp32_vs_f64": rel(hidden[("xla", torch.float32)], h64),
                "flash_vs_xla_fp32": rel(hidden[("flash", torch.float32)],
                                         hidden[("xla", torch.float32)])}
    del state, hidden
    # (c)
    small = dataclasses.replace(cfg, n_layers=C.MOE_CPU_DEPTH if card else 1)
    Bc, Sc = C.MOE_CPU if card else (2, 32)
    card_m = build(small, device=dev, dtype=torch.float32,
                   generator=torch.Generator(device=dev).manual_seed(2))
    tokens = np.random.default_rng(2).integers(0, V, (Bc, Sc))
    h_card, _ = card_m.prefill(torch.as_tensor(tokens, device=dev), Sc)
    cpu = Transformer(small, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card_m.state_dict().items()})
    h_cpu, _ = cpu.prefill(torch.as_tensor(tokens), Sc)
    m64 = as_dtype(card_m, dataclasses.replace(small, attn_impl="xla"),
                   torch.float64, dev)
    h64, _ = m64.prefill(torch.as_tensor(tokens, device=dev), Sc)
    out["c"] = {"card_fp32_vs_f64": rel(h_card, h64),
                "cpu_fp32_vs_f64": rel(h_cpu, h64),
                "card_vs_cpu": rel(h_card, h_cpu)}
    del card_m, cpu, m64
    # (d)
    tok_d = C.MOE_DISPATCH if card else (2, 64)
    ref, gref = dispatch_case(cfg, dev, torch.float64, "einsum", tok_d)
    d = {}
    res = {mode: dispatch_case(cfg, dev, torch.float32, mode, tok_d)
           for mode in ("einsum", "scatter")}
    for mode, (o, g) in res.items():
        d[f"{mode}_fp32_vs_f64_out"] = rel(o, ref)
        d[f"{mode}_fp32_vs_f64_grad"] = max(rel(g[n], gref[n]) for n in g)
    d["scatter_vs_einsum_out"] = rel(res["scatter"][0], res["einsum"][0])
    d["scatter_vs_einsum_grad"] = max(
        rel(res["scatter"][1][n], res["einsum"][1][n])
        for n in res["einsum"][1])
    out["d"] = d
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--card", action="store_true",
                    help="phase 28's full sizes on the CUDA device")
    ap.add_argument("--arch", action="append", default=None)
    args = ap.parse_args(argv)
    if args.card and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda" if args.card else "cpu")
    for arch in args.arch or C.MOE_ARCHS:
        print(json.dumps(probe(arch, dev, args.card)), flush=True)
        if args.card:
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
