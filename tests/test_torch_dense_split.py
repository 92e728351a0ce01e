"""K5's fp32 route on the CPU: the split of fp32 values into three bf16
pieces and the six-product sum of csrc/dense_stencil_sm90.cu, repeated in
plain PyTorch (``split_bf16x3``, ``dense_stencil_split_plain``), against
the designed cases of tests/_torch_dense_cases.py and JAX's
``dense_stencil_matmul`` run interpreted on the CPU.

Tolerances: the pieces sum to the value bit for bit; ``perm_exact`` 0.0;
``w_pieces`` within 2 fp32 ulps of the exact product; JAX's kernel within
1e-4, test_torch_kernels.py's bound for K5 (its blocked sums run in another
order).  A two-piece split, planted in place of the three-piece one, must
fail both designed cases.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as JK
from repro_torch.kernels import dense_stencil as D
from repro_torch.kernels import (dense_stencil_plain,
                                 dense_stencil_split_plain, split_bf16x3)
from _torch_dense_cases import (W_PIECES_ULPS, full_mantissa, max_ulps,
                                perm_exact_case, w_pieces_case)

SHAPES = [(1, 64), (7, 130), (40, 257), (33, 96)]


@pytest.mark.parametrize("lo,hi", [(-20, 20), (-100, -60), (60, 100),
                                   (-110, 120)])
def test_pieces_sum_to_the_value_bit_for_bit(lo, hi):
    rng = np.random.default_rng(lo + 1000)
    v = torch.from_numpy(full_mantissa(rng, (64, 130), lo, hi))
    p = split_bf16x3(v).float()
    assert p.shape == (3, 64, 130)
    assert torch.equal((p[0] + p[1]) + p[2], v)
    # Each piece is at most half an ulp of the one before.
    assert bool((p[1].abs() <= p[0].abs() * 2.0 ** -8).all())
    assert bool((p[2].abs() <= p[1].abs() * 2.0 ** -8).all())


def test_split_pads_columns_with_zeros():
    v = torch.from_numpy(full_mantissa(np.random.default_rng(1), (5, 13)))
    p = split_bf16x3(v, 16)
    assert p.shape == (3, 5, 16) and p.dtype == torch.bfloat16
    assert torch.equal(p[..., :13], split_bf16x3(v))
    assert not bool(p[..., 13:].float().any())


@pytest.mark.parametrize("s,n", SHAPES)
def test_perm_exact_is_exact(s, n):
    x, w, exact = perm_exact_case(s, n, seed=s + n)
    assert float((dense_stencil_split_plain(x, w) - exact).abs().max()) == 0.0


@pytest.mark.parametrize("s,n", SHAPES)
def test_w_pieces_within_two_ulps(s, n):
    x, w, exact = w_pieces_case(s, n, seed=s + n)
    assert max_ulps(dense_stencil_split_plain(x, w), exact) <= W_PIECES_ULPS


@pytest.mark.parametrize("s,n", [(1, 64), (8, 130), (32, 96)])
def test_split_plain_matches_pallas(s, n):
    rng = np.random.default_rng(s * n)
    x = rng.standard_normal((s, n)).astype(np.float32)
    w = rng.standard_normal((n, n)).astype(np.float32)
    jout = JK.dense_stencil_matmul(jnp.asarray(x), jnp.asarray(w), bm=8,
                                   bk=128, bn=128)
    tout = dense_stencil_split_plain(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        tout.numpy(), dense_stencil_plain(torch.from_numpy(x),
                                          torch.from_numpy(w)).numpy(),
        rtol=1e-4, atol=1e-4)


def _two_pieces(v, cols=None):
    p = split_bf16x3(v, cols)
    p[2] = 0
    return p


@pytest.mark.parametrize("s,n", SHAPES[1:])
def test_a_two_piece_split_fails_the_designed_cases(monkeypatch, s, n):
    monkeypatch.setattr(D, "split_bf16x3", _two_pieces)
    x, w, exact = perm_exact_case(s, n, seed=s + n)
    assert float((dense_stencil_split_plain(x, w) - exact).abs().max()) > 0
    x, w, exact = w_pieces_case(s, n, seed=s + n)
    assert max_ulps(dense_stencil_split_plain(x, w), exact) > 32


def test_split_kernel_refuses_cpu_tensors():
    # On the CPU the wrapper runs the plain version; the split kernel's own
    # launcher takes CUDA tensors only and raises rather than fall back.
    with pytest.raises(ValueError, match="CUDA tensor"):
        D.launch_split(torch.zeros(2, 3), 8)
