"""K8/K9 (bf16) at the moe and dense archs' attention shapes against a
float64 evaluation of their formula, beside their fp32 plain versions:
where the bf16 rounding of ds (JAX's rule) makes the result jump.

    PYTHONPATH=src python tests/_torch_flash_bwd_noise.py   # on the H100

Inputs are ``chip_smoke.py`` phase 16's for these shapes (the same
generator, advanced through the same draws before them): the dense archs'
are cases of ``FLASH_CASES`` (glm4_shape, phi3_shape, nemotron_shape).  The reference
takes the kernels' own o, lse and delta, computes s, p, dp and ds in
float64, rounds ds to bf16 as the kernels and the plain versions do (K8 to
k's type, K9 to q's), and sums in float64: dq = round(ds) k, dk =
round(ds)^T q, dv = p^T do (p not rounded).  For each of dq, dk and dv, one
JSON line a shape: the largest |x - y| / (2e-3 + 1.6e-2 |y|) (the bf16
bound of phase 16) and the count past 1 for kernel against plain, kernel
against the reference and plain against the reference, and the worst
element of kernel against plain with its three values and the largest
|round(ds) * q| term of its sum (one flip of a bf16 rounding of ds moves
the sum by up to 2^-8 of that term, relative).
"""
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import chip_smoke as C  # noqa: E402
from _torch_flash_cases import DENSE_CASES, FLASH_CASES  # noqa: E402
from repro_torch.kernels.flash_attention_bwd import (  # noqa: E402
    flash_bwd, flash_bwd_dkv_plain, flash_bwd_dq_plain, flash_delta,
    flash_fwd)

ATOL, RTOL = C.FLASH_BWD_TOL["bfloat16"]


def ratio(x, y):
    r = (x.double() - y.double()).abs() / (ATOL + RTOL * y.double().abs())
    return r


def _ds(q, k, v, do, lse, delta, b, hq, h):
    """float64 p and bf16-rounded ds of one (batch, query head), causal."""
    S, hd = q.shape[1], q.shape[3]
    scale = hd ** -0.5
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = q[b, :, hq].double() @ k[b, :, h].double().T * scale
    p = torch.where(mask, torch.exp(s - lse[b, hq].double()[:, None]), 0.0)
    dp = do[b, :, hq].double() @ v[b, :, h].double().T
    ds = p * (dp - delta[b, hq].double()[:, None]) * scale
    return p, torch.where(mask, ds, 0.0).to(torch.bfloat16).double()


def reference(q, k, v, do, lse, delta):
    """float64 dq, dk, dv with ds rounded to bf16, causal."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    dq = torch.zeros(B, S, H, hd, dtype=torch.float64, device=q.device)
    dk = torch.zeros(B, S, KV, hd, dtype=torch.float64, device=q.device)
    dv = torch.zeros_like(dk)
    for b in range(B):
        for hq in range(H):
            h = hq // G
            p, ds = _ds(q, k, v, do, lse, delta, b, hq, h)
            dq[b, :, hq] = ds @ k[b, :, h].double()
            dk[b, :, h] += ds.T @ q[b, :, hq].double()
            dv[b, :, h] += p.T @ do[b, :, hq].double()
    return dq, dk, dv


def largest_term(q, k, v, do, lse, delta, index):
    """max over the group's heads and the queries of |round(ds) q| in the
    sum of dk at ``index`` (b, key, kv head, d)."""
    b, j, h, d = index
    G = q.shape[2] // k.shape[2]
    best = 0.0
    for hq in range(h * G, (h + 1) * G):
        _, ds = _ds(q, k, v, do, lse, delta, b, hq, h)
        best = max(best, float((ds[:, j].abs()
                                * q[b, :, hq, d].double().abs()).max()))
    return best


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gb = torch.Generator(device=dev).manual_seed(7)

    def draw(shape, dtype):
        B_, Sq_, Skv_, H_, KV_, hd_ = shape
        return [torch.randn(s_, generator=gb, device=dev).to(dtype)
                for s_ in ((B_, Sq_, H_, hd_), (B_, Skv_, KV_, hd_),
                           (B_, Skv_, KV_, hd_), (B_, Sq_, H_, hd_))]

    def analyse(name, shape, q, k, v, do):
        B, S, _, H, KV, hd = shape
        o, lse = flash_fwd(q, k, v, causal=True)
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, causal=True)
        delta = flash_delta(o, do)
        pdq = flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=True)
        pdk, pdv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=True)
        rdq, rdk, rdv = reference(q, k, v, do, lse, delta)
        for grad, x, y, r in (("dq", dq, pdq, rdq), ("dk", dk, pdk, rdk),
                              ("dv", dv, pdv, rdv)):
            kp, kr, pr = ratio(x, y), ratio(x, r), ratio(y, r)
            i = int(kp.argmax())
            idx = list(torch.unravel_index(torch.tensor(i), kp.shape))
            out = {"arch": name, "grad": grad, "shape": [B, S, H, KV, hd],
                   "kernel_vs_plain": [float(kp.max()), int((kp > 1).sum())],
                   "kernel_vs_f64": [float(kr.max()), int((kr > 1).sum())],
                   "plain_vs_f64": [float(pr.max()), int((pr > 1).sum())],
                   "max_abs": float(y.float().abs().max()),
                   "worst": {"index": [int(t) for t in idx],
                             "kernel": float(x.flatten()[i]),
                             "plain": float(y.flatten()[i]),
                             "f64": float(r.flatten()[i])}}
            if grad == "dk":
                out["worst"]["largest_term"] = largest_term(
                    q, k, v, do, lse, delta, [int(t) for t in idx])
            print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()

    # Phase 16's draws, the dense archs' bf16 cases among them, then the
    # moe shapes.
    for dtype in (torch.float32, torch.bfloat16):
        for label, (shape, _, _) in FLASH_CASES.items():
            drawn = draw(shape, dtype)
            if dtype == torch.bfloat16 and label in DENSE_CASES.values():
                analyse(label, shape, *drawn)
            del drawn
    Bh, Sh, Hh, KVh, hdh = C.HYBRID_SHAPE
    draw((Bh, Sh, Sh, Hh, KVh, hdh), torch.bfloat16)
    for arch, (B, S, H, KV, hd) in C.MOE_SHAPES.items():
        analyse(arch, (B, S, S, H, KV, hd),
                *draw((B, S, S, H, KV, hd), torch.bfloat16))
    return 0


if __name__ == "__main__":
    sys.exit(main())
