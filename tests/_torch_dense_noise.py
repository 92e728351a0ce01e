"""fp32 rounding at the dense archs' sizes (glm4-9b, phi3-medium-14b,
nemotron-4-15b) against float64: the readings ``chip_smoke.py`` phase 33's
bound and the fp32 K8/K9 bounds at their attention shapes come from.

    PYTHONPATH=src python tests/_torch_dense_noise.py --card   # on the H100
    PYTHONPATH=src python tests/_torch_dense_noise.py          # CPU rehearsal

One JSON line for each of:

- (a) K8/K9 in fp32 at each dense shape of ``tests/_torch_flash_cases.py``
  (the inputs of ``tests/test_torch_cuda.py``'s backward test): the kernels
  (dq, dk, dv), their plain versions, and a float64 evaluation of the
  backward from the same q, k, v and do (its own s, lse, p, o, delta and
  ds, nothing rounded); for each gradient the largest |x - y| / (2e-5 +
  1e-5 |y|) (the fp32 bound of phase 16 and the card test) of kernel
  against plain, kernel against float64 and plain against float64, and
  each one's largest |x - y| over the float64 result's max-abs;
- (b) phase 33's fp32 check (2 layers of the full-width config, 2 x 128
  tokens, weights from seed 2): the card's prefill hidden (flash), the
  CPU's (xla) and a float64 run on the card (xla, the port's ``.float()``
  casts widened to float64, as tests/_torch_vlm_encdec_noise.py widens
  them), each fp32 run's distance from float64 and from the other, and the
  bound the reading suggests: twice the larger fp32 distance from float64,
  rounded up to one digit.

Without ``--card`` it runs the smoke configs and small shapes on the CPU:
a rehearsal of the code, not a reading.
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

import chip_smoke as C  # noqa: E402
from _torch_flash_cases import DENSE_CASES, FLASH_CASES  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention_bwd import (  # noqa: E402
    flash_bwd, flash_bwd_plain, flash_fwd)
from repro_torch.models.model_zoo import build  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402

ATOL, RTOL = C.FLASH_BWD_TOL["float32"]


@contextlib.contextmanager
def widened():
    """Every ``Tensor.float()`` (the port's fp32 points: norms, softmax,
    rope, the LM head) as ``.double()``."""
    orig = torch.Tensor.float
    torch.Tensor.float = lambda self: self.double()
    try:
        yield
    finally:
        torch.Tensor.float = orig


def up1(x):
    """x rounded up to one significant digit."""
    if x <= 0:
        return 0.0
    e = math.floor(math.log10(x))
    return math.ceil(x / 10 ** e) * 10 ** e


def backward_f64(q, k, v, do, causal=True):
    """float64 dq, dk, dv of softmax attention, nothing rounded."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    mask = torch.ones(S, k.shape[1], dtype=torch.bool,
                      device=q.device).tril()
    dq = torch.zeros(B, S, H, hd, dtype=torch.float64, device=q.device)
    dk = torch.zeros(B, k.shape[1], KV, hd, dtype=torch.float64,
                     device=q.device)
    dv = torch.zeros_like(dk)
    for b in range(B):
        for hq in range(H):
            h = hq // G
            qq, kk, vv, dd = (t[b, :, i].double() for t, i in
                              ((q, hq), (k, h), (v, h), (do, hq)))
            s = qq @ kk.T * scale
            if causal:
                s = s.masked_fill(~mask, float("-inf"))
            p = torch.softmax(s, dim=-1)
            o = p @ vv
            dp = dd @ vv.T
            ds = p * (dp - (dd * o).sum(-1, keepdim=True)) * scale
            dq[b, :, hq] = ds @ kk
            dk[b, :, h] += ds.T @ qq
            dv[b, :, h] += p.T @ dd
    return dq, dk, dv


def ratio(x, y):
    return float(((x.double() - y.double()).abs()
                  / (ATOL + RTOL * y.double().abs())).max())


def rel(x, y):
    return float((x.double() - y.double()).abs().max()
                 / y.double().abs().max())


def flash_part(dev, card):
    for label in DENSE_CASES.values():
        (B, Sq, Skv, H, KV, hd), causal, _ = FLASH_CASES[label]
        if not card:
            B, Sq, Skv, H = 1, 96, 96, 2 * KV if KV <= 4 else KV
            hd = 16
        g = torch.Generator(device=dev).manual_seed(Sq + hd)
        q, k, v = (torch.randn(s, generator=g, device=dev)
                   for s in ((B, Sq, H, hd), (B, Skv, KV, hd),
                             (B, Skv, KV, hd)))
        g = torch.Generator(device=dev).manual_seed(Sq + 1)
        do = torch.randn(q.shape, generator=g, device=dev)
        o, lse = flash_fwd(q, k, v, causal=causal)
        got = flash_bwd(q, k, v, o, lse, do, causal=causal)
        plain = flash_bwd_plain(q, k, v, o, lse, do, causal=causal)
        ref = backward_f64(q, k, v, do, causal)
        out = {"case": label, "shape": [B, Sq, Skv, H, KV, hd],
               "dtype": "float32", "bound": [ATOL, RTOL]}
        for name, x, y, r in zip(("dq", "dk", "dv"), got, plain, ref):
            out[name] = {"kernel_vs_plain": ratio(x, y),
                         "kernel_vs_f64": ratio(x, r),
                         "plain_vs_f64": ratio(y, r),
                         "rel_kernel_vs_f64": rel(x, r),
                         "rel_plain_vs_f64": rel(y, r),
                         "max_abs": float(r.abs().max())}
        print(json.dumps(out), flush=True)
        del q, k, v, do, o, lse, got, plain, ref
        if card:
            torch.cuda.empty_cache()


def model_part(dev, card):
    Bc, Sc = C.DENSE_CPU if card else (2, 16)
    for arch in C.DENSE_ARCHS:
        cfg = dataclasses.replace(get_config(arch, smoke=not card),
                                  attn_impl="flash")
        small = dataclasses.replace(cfg, n_layers=C.DENSE_CPU_DEPTH)
        card_m = build(small, device=dev, dtype=torch.float32,
                       generator=torch.Generator(device=dev).manual_seed(2))
        tokens = torch.as_tensor(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (Bc, Sc)), device=dev)
        with torch.no_grad():
            h_card, _ = card_m.prefill(tokens, Sc)
        state = card_m.state_dict()
        xla = dataclasses.replace(small, attn_impl="xla")
        m64 = Transformer(xla, device=dev, dtype=torch.float64)
        m64.load_state_dict(state)
        with torch.no_grad(), widened():
            h64, _ = m64.prefill(tokens, Sc)
        del m64, card_m
        cpu = Transformer(xla, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in state.items()})
        with torch.no_grad():
            h_cpu, _ = cpu.prefill(tokens.cpu(), Sc)
        del cpu, state
        d_card, d_cpu = rel(h_card.cpu(), h64.cpu()), rel(h_cpu, h64.cpu())
        print(json.dumps({
            "arch": cfg.arch, "n_layers": small.n_layers, "batch": Bc,
            "prompt_len": Sc, "card_vs_f64": d_card, "cpu_vs_f64": d_cpu,
            "card_vs_cpu": rel(h_card.cpu(), h_cpu),
            "suggested_bound": up1(2 * max(d_card, d_cpu))}), flush=True)
        if card:
            torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--card", action="store_true")
    args = ap.parse_args()
    if args.card and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda" if args.card else "cpu")
    flash_part(dev, args.card)
    model_part(dev, args.card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
