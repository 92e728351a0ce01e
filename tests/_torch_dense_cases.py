"""Designed inputs for K5's fp32 route (x @ W from three bf16 pieces of each
operand), its card shapes and its fp64 criterion, shared by the port's CPU
tests, its card tests and ``chip_smoke.py`` (no JAX here).

- ``perm_exact``: W a permutation matrix and x of full 24-bit mantissas
  over many binades.  x @ W is x with its columns permuted; each output is
  one product x0 + x1 + x2 of x's pieces, which a sum that adds x1 and x2
  before x0 keeps exact: error 0.0.
- ``w_pieces``: W a permutation times scalars of full 24-bit mantissas, x
  exact in bf16.  Each output is x * c for one pair; the six-product sum
  lands within 2 fp32 ulps of it, and a two-piece split of W (dropping
  c's last 8 bits) misses by about 128.
"""
import numpy as np
import torch

# |out - exact| in fp32 ulps of the exact value, at most, for w_pieces.
W_PIECES_ULPS = 2.0
# K5's card shapes (S, N), chip_smoke.py phase 2's: ragged against every
# tile, N % 8 != 0 too.
GEMM_SHAPES = ((1, 64), (8, 130), (300, 257), (1000, 4096), (4097, 1000))
# fp32 K5 against an fp64 product, with random W: max |y - y64| /
# (|x| . |W|) at most 2^-20.
K5_NORM_ERR = 2.0 ** -20


def full_mantissa(rng, shape, lo=-20, hi=20):
    """fp32 values with all 23 stored mantissa bits random, random signs and
    binades 2^lo .. 2^hi."""
    mant = rng.integers(0, 1 << 23, size=shape, dtype=np.uint32)
    exp = rng.integers(127 + lo, 127 + hi + 1, size=shape).astype(np.uint32)
    sign = rng.integers(0, 2, size=shape).astype(np.uint32)
    return ((sign << 31) | (exp << 23) | mant).view(np.float32)


def perm_exact_case(s, n, seed=0, device="cpu"):
    """x (s, n) fp32, w (n, n) a permutation, and the exact x @ w."""
    rng = np.random.default_rng(seed)
    x = full_mantissa(rng, (s, n))
    perm = rng.permutation(n)
    w = np.zeros((n, n), np.float32)
    w[perm, np.arange(n)] = 1.0          # out[:, j] = x[:, perm[j]]
    exact = x[:, perm]
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (x, w, exact))


def w_pieces_case(s, n, seed=0, device="cpu"):
    """x (s, n) fp32 values exact in bf16, w (n, n) a permutation times
    full-mantissa scalars, and the exact x @ w in fp64."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(full_mantissa(rng, (s, n), -8, 8)).bfloat16()
    x = x.float().numpy()
    perm = rng.permutation(n)
    c = full_mantissa(rng, (n,), -4, 4)
    w = np.zeros((n, n), np.float32)
    w[perm, np.arange(n)] = c            # out[:, j] = x[:, perm[j]] * c[j]
    exact = x[:, perm].astype(np.float64) * c.astype(np.float64)
    return (torch.from_numpy(x).to(device), torch.from_numpy(w).to(device),
            torch.from_numpy(exact).to(device))


def max_ulps(out, exact):
    """max |out - exact| over the fp32 ulp of exact, elementwise (exact in
    fp64, nonzero)."""
    ref = exact.float().abs()
    ulp = (torch.nextafter(ref, torch.full_like(ref, float("inf"))) - ref)
    return float(((out.double() - exact).abs() / ulp.double()).max())


def norm_err(y, x, w):
    """max |y - x @ w| / (|x| . |W|), the product and the denominator in
    fp64."""
    x64, w64 = x.double(), w.double()
    return float(((y.double() - x64 @ w64).abs()
                  / (x64.abs() @ w64.abs())).max())
