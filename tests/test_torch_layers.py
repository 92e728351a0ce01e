"""The port's ``layer_norm`` and ``apply_mrope`` (``models/layers.py``)
against the JAX package's on the CPU, from the same numpy inputs.

``apply_mrope`` is held with three distinct position channels (temporal,
height and width ids that differ on every token), where each frequency
section reads its own channel: the JAX package's own tests use equal
channels, on which M-RoPE is plain RoPE and a section read from the wrong
channel would not show.  Tolerances: fp32 1e-6 absolute (the same fp32
arithmetic in another order; readings 2.4e-7 for M-RoPE, 4.8e-7 for the
layer norm), bf16 2e-2 absolute and relative (both round the fp32 result
once, so at most one bf16 ulp apart).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(rtol=0, atol=1e-6), "bf16": dict(rtol=2e-2, atol=2e-2)}
_rng = np.random.default_rng(31)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _distinct_positions(B, S):
    """(3, B, S) ids whose channels differ on every token: a time step, a
    row and a column of a patch grid 7 wide, offset per row of the batch."""
    i = np.arange(S)[None] + 5 * np.arange(B)[:, None]
    return np.stack([i // 49, (i // 7) % 7 + 11, i % 7 + 29]).astype(np.int32)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("hd,sections,theta", [
    (16, (2, 3, 3), 1e4),          # the smoke config's
    (128, (16, 24, 24), 1e6),      # qwen2-vl-2b's
])
def test_apply_mrope_matches_jax_with_distinct_channels(dt, hd, sections,
                                                        theta):
    jd, td = DT[dt]
    B, S, H = 2, 40, 3
    x = _rng.standard_normal((B, S, H, hd)).astype(np.float32)
    pos = _distinct_positions(B, S)
    assert all((pos[a] != pos[b]).all() for a, b in ((0, 1), (0, 2), (1, 2)))
    got = TL.apply_mrope(torch.from_numpy(x).to(td), torch.from_numpy(pos),
                         theta, sections)
    want = JL.apply_mrope(jnp.asarray(x, jd), jnp.asarray(pos), theta,
                          sections)
    assert got.dtype == td and got.shape == x.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dt])


def test_apply_mrope_sections_read_their_own_channel():
    """Each section of the hd/2 frequency slots equals plain RoPE at that
    section's channel, and a permutation of the sections (the fault a
    section bug makes) moves the output by far more than the bound."""
    hd, sections, theta = 16, (2, 3, 3), 1e4
    B, S = 2, 40
    x = torch.from_numpy(_rng.standard_normal((B, S, 2, hd))
                         .astype(np.float32))
    pos = torch.from_numpy(_distinct_positions(B, S))
    out = TL.apply_mrope(x, pos, theta, sections)
    start = 0
    for ch, n in enumerate(sections):
        rope = TL.apply_rope(x, pos[ch], theta)
        for half in (0, hd // 2):
            sl = slice(half + start, half + start + n)
            torch.testing.assert_close(out[..., sl], rope[..., sl],
                                       rtol=0, atol=1e-6)
        start += n
    swapped = TL.apply_mrope(x, pos, theta, (3, 2, 3))
    assert float((swapped - out).abs().max()) > 0.1


def test_apply_mrope_equals_rope_on_equal_channels():
    x = torch.from_numpy(_rng.standard_normal((2, 12, 2, 16))
                         .astype(np.float32))
    p = torch.arange(3, 15).expand(2, 12)
    torch.testing.assert_close(
        TL.apply_mrope(x, p.expand(3, 2, 12), 1e4, (2, 3, 3)),
        TL.apply_rope(x, p, 1e4), rtol=0, atol=1e-6)


def test_apply_mrope_raises_where_sections_do_not_sum_to_half_hd():
    x = torch.zeros(1, 4, 1, 16)
    pos = torch.zeros(3, 1, 4, dtype=torch.int64)
    with pytest.raises(ValueError, match="must sum to 8"):
        TL.apply_mrope(x, pos, 1e4, (2, 3, 2))
    with pytest.raises(ValueError):
        JL.apply_mrope(jnp.zeros((1, 4, 1, 16)), jnp.zeros((3, 1, 4)), 1e4,
                       (2, 3, 2))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_layer_norm_matches_jax(dt):
    """fp32 mean and population variance, the weight and bias in fp32, the
    cast back; on rows with an offset (mean 3) and a scale (std 2)."""
    jd, td = DT[dt]
    x = (3 + 2 * _rng.standard_normal((2, 7, 48))).astype(np.float32)
    w = (1 + 0.1 * _rng.standard_normal(48)).astype(np.float32)
    b = (0.1 * _rng.standard_normal(48)).astype(np.float32)
    got = TL.layer_norm(torch.from_numpy(x).to(td), torch.from_numpy(w),
                        torch.from_numpy(b), 1e-5)
    want = JL.layer_norm(jnp.asarray(x, jd), jnp.asarray(w), jnp.asarray(b),
                         1e-5)
    assert got.dtype == td
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dt])
    if dt == "f32":   # population variance: unit variance out, mean b
        y = (_f32(got) - b) / w
        np.testing.assert_allclose(y.var(-1), 1.0, rtol=1e-4)
        np.testing.assert_allclose(y.mean(-1), 0.0, atol=1e-5)
