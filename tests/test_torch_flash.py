"""The port's flash attention against the JAX package's Pallas kernels run
interpreted on the CPU, on the shapes of tests/test_flash_attention.py: the
forward, K6 (``flash_attention``) and K7 (``flash_fwd``, which also returns
the row logsumexp), and the backward, K8/K9 (``flash_bwd``) through
``flash_attention_trainable``'s autograd Function against JAX's
``custom_vjp``, with the designed cases on which each bf16 rounding (p
before p·v, ds before ds·k, none on p before pᵀ·do) shows.

On a CPU tensor each wrapper runs its plain PyTorch version (the TPU
kernels' arithmetic over their own blocks), so these hold the plain
versions against the TPU kernels; test_torch_cuda.py holds the CUDA kernels
against the plain versions on the card.

Tolerances: out 2e-5 absolute in fp32 (JAX's own bound,
tests/test_flash_attention.py:31) and, per element, 2e-3 + 1.6e-2 * |ref|
in bf16 (two bf16 ulps; JAX's own 3e-2 absolute is as large as the output
of a row that sees a thousand keys); lse 1e-5 relative.  Gradients: each of
dq, dk, dv within 1e-5 of its max-abs in fp32 (the same arithmetic in
another summation order reads under 1e-6), and per element within the bf16
bound above in bf16 (dq and dk read bit-equal, dv under 0.01 of the bound).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention_bwd import _fwd_rule
from repro.kernels.flash_attention_bwd import \
    flash_attention_trainable as jax_trainable
from repro.models.attention import attention as jax_attention
from repro_torch.kernels import (_build, flash_attention,
                                 flash_attention_trainable, flash_fwd)
from repro_torch.kernels.flash_attention_bwd import (flash_bwd,
                                                     flash_bwd_dq_plain,
                                                     flash_delta)
from repro_torch.models.attention import attention
from _torch_flash_cases import (BF16_ATOL, BF16_RTOL, CARD_ONLY,
                                FLASH_CASES, ds_rounding_case,
                                dv_p_rounding_case, p_rounding_case)

TOL = {"f32": (2e-5, 0.0), "bf16": (BF16_ATOL, BF16_RTOL)}  # (atol, rtol)
LSE_RTOL = 1e-5
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
_rng = np.random.default_rng(5)


def _mk(B, Sq, Skv, H, KV, hd):
    return [_rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd))]


def _both(arrays, dtype_name):
    jd, td = DT[dtype_name]
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# (B, Sq, Skv, H, KV, hd), causal, kv_offset, blocks (q, k), dtype
CASES = {
    "mha": ((1, 128, 128, 2, 2, 32), True, 0, (32, 128), "f32"),
    "gqa_ragged_96": ((2, 96, 96, 4, 2, 16), True, 0, (32, 128), "f32"),
    "mqa": ((1, 256, 256, 8, 1, 32), True, 0, (32, 128), "f32"),
    "non_causal": ((1, 64, 64, 2, 2, 16), False, 0, (32, 128), "f32"),
    "cross_lengths": ((1, 32, 160, 2, 2, 16), True, 128, (32, 128), "f32"),
    "bf16": ((1, 128, 128, 2, 2, 32), True, 0, (32, 128), "bf16"),
    "hd64_serve_blocks": ((1, 80, 80, 4, 2, 64), True, 0, (512, 512),
                          "f32"),
    "cross_ragged_non_causal": ((2, 40, 150, 6, 6, 64), False, 0, (32, 128),
                                "f32"),
    "non_causal_gqa6": ((1, 300, 300, 12, 2, 64), False, 0, (32, 128),
                        "f32"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_versions_match_the_tpu_kernels(case):
    shape, causal, kv_offset, (bq, bk), dt = CASES[case]
    (jq, jk, jv), (tq, tk, tv) = _both(_mk(*shape), dt)
    kw = dict(causal=causal, block_q=bq, block_k=bk, kv_offset=kv_offset)
    before = dict(_build.LAUNCHES)
    out6 = flash_attention(tq, tk, tv, **kw)
    out7, lse7 = flash_fwd(tq, tk, tv, **kw)
    assert dict(_build.LAUNCHES) == before   # the CPU runs no kernel
    ref6 = jax_flash(jq, jk, jv, **kw)
    ref7, (*_, ref_lse) = _fwd_rule(jq, jk, jv, causal, bq, bk, kv_offset)
    Sq = shape[1]
    assert out6.dtype == out7.dtype == DT[dt][1]
    assert lse7.dtype == torch.float32 and lse7.shape == (shape[0], shape[3],
                                                          Sq)
    atol, rtol = TOL[dt]
    np.testing.assert_allclose(_f32(out6), _f32(ref6), rtol=rtol, atol=atol)
    np.testing.assert_allclose(_f32(out7), _f32(ref7), rtol=rtol, atol=atol)
    np.testing.assert_allclose(_f32(lse7), _f32(ref_lse)[:, :, :Sq],
                               rtol=LSE_RTOL, atol=0)


@pytest.mark.parametrize("bq", [32, 64])
def test_block_size_invariance(bq):
    (jq, jk, jv), (tq, tk, tv) = _both(_mk(1, 128, 128, 2, 2, 16), "f32")
    a = flash_attention(tq, tk, tv, block_q=bq, block_k=128)
    b = flash_attention(tq, tk, tv, block_q=128, block_k=128)
    np.testing.assert_allclose(_f32(a), _f32(b), rtol=0, atol=TOL["f32"][0])
    np.testing.assert_allclose(
        _f32(a), _f32(jax_flash(jq, jk, jv, block_q=bq, block_k=128)),
        rtol=0, atol=TOL["f32"][0])


def test_causal_first_token_attends_self_only():
    q, k, v = (torch.from_numpy(a) for a in _mk(1, 64, 64, 1, 1, 16))
    out = flash_attention(q, k, v, causal=True, block_q=32, block_k=128)
    np.testing.assert_allclose(out[0, 0, 0].numpy(), v[0, 0, 0].numpy(),
                               atol=1e-5)


def test_kv_offset_is_subtracted_from_the_kv_index():
    """The TPU kernel's k_pos = index - kv_offset (flash_attention.py:47):
    kv_offset=128 is attention's kv_offset=-128, not +128."""
    q, k, v = (torch.from_numpy(a) for a in _mk(1, 32, 160, 2, 2, 16))
    out = flash_attention(q, k, v, causal=True, kv_offset=128, block_q=32,
                          block_k=128)
    same = attention(q, k, v, causal=True, q_chunk=32, kv_offset=-128)
    other = attention(q, k, v, causal=True, q_chunk=32, kv_offset=128)
    np.testing.assert_allclose(out.numpy(), same.numpy(), rtol=0,
                               atol=TOL["f32"][0])
    assert float((out - other).abs().max()) > 0.1


def test_mask_value_is_finite():
    """Rows with no valid key: -1e30, not -inf, so no NaN.  With
    kv_offset=-32 rows 0..31 see no key; their q block is skipped, so JAX
    and the plain version give 0 and lse -1e30 there, and the softmax on
    rows 32..63."""
    (jq, jk, jv), (tq, tk, tv) = _both(_mk(1, 64, 64, 2, 2, 16), "f32")
    out, lse = flash_fwd(tq, tk, tv, causal=True, kv_offset=-32,
                         block_q=32, block_k=128)
    ref, (*_, ref_lse) = _fwd_rule(jq, jk, jv, True, 32, 128, -32)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())
    assert float(out[:, :32].abs().max()) == 0.0
    assert bool((lse[:, :, :32] == -1e30).all())
    np.testing.assert_allclose(out.numpy(), _f32(ref), rtol=0,
                               atol=TOL["f32"][0])
    np.testing.assert_allclose(lse.numpy(), _f32(ref_lse)[:, :, :64],
                               rtol=LSE_RTOL, atol=0)
    np.testing.assert_allclose(
        out[:, 32:].numpy(),
        _f32(jax_attention(jq, jk, jv, causal=True, q_chunk=64,
                           kv_offset=32))[:, 32:],
        rtol=0, atol=TOL["f32"][0])


def test_bf16_rounds_p_to_v_type():
    """JAX rounds p to v's type before p . v (flash_attention.py:73); on
    ``p_rounding_case`` that moves the output by 0.026, thirteen times the
    bf16 bound, so an attention that skips the rounding fails there."""
    tq, tk, tv = p_rounding_case()
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (tq, tk, tv))
    ref = _f32(jax_flash(jq, jk, jv, causal=False))
    out = flash_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(_f32(out), ref, rtol=BF16_RTOL, atol=BF16_ATOL)
    np.testing.assert_allclose(ref, -0.0078, rtol=0, atol=1e-4)
    # The same inputs with p kept in fp32, as a kernel that skips the
    # rounding computes them.
    unrounded = flash_attention(tq.float(), tk.float(), tv.float(),
                                causal=False).to(torch.bfloat16)
    miss = np.abs(_f32(unrounded) - ref) / (BF16_ATOL + BF16_RTOL
                                             * np.abs(ref))
    assert miss.min() > 10


@pytest.mark.parametrize("case", [c for c in FLASH_CASES
                                  if c not in CARD_ONLY])
def test_bf16_tensor_core_tiling_stays_in_the_bound(case):
    """The bf16 kernel's schedule is the plain version at 128 x 128 tiles
    (one 128-row q tile a CTA, 128-key kv tiles, p rounded per tile): that
    schedule stays within the per-element bf16 bound of JAX's kernel at its
    own blocks, and its lse within 1e-5 relative."""
    shape, causal, kv_offset = FLASH_CASES[case]
    (jq, jk, jv), (tq, tk, tv) = _both(_mk(*shape), "bf16")
    out, lse = flash_fwd(tq, tk, tv, causal=causal, kv_offset=kv_offset,
                         block_q=128, block_k=128)
    ref, (*_, ref_lse) = _fwd_rule(jq, jk, jv, causal, 512, 512, kv_offset)
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=BF16_RTOL,
                               atol=BF16_ATOL)
    np.testing.assert_allclose(_f32(lse), _f32(ref_lse)[:, :, :shape[1]],
                               rtol=LSE_RTOL, atol=0)


class _StubKernel:
    """A ctypes function of a library that is not built: records its
    arguments and returns 0 (no CUDA error)."""

    def __init__(self, calls, symbol):
        self.argtypes = self.restype = None
        self.calls, self.symbol = calls, symbol

    def __call__(self, *args):
        self.calls.append((self.symbol, args))
        return 0


class _StubLibrary:
    def __init__(self, calls, *symbols):
        for name in symbols:
            setattr(self, name, _StubKernel(calls, name))


def test_wrapper_sends_bf16_to_the_tensor_cores_and_fp32_to_simt(
        monkeypatch):
    """``flash_attention.launch`` picks the kernel by dtype, with no
    fallback: bf16 calls flash_attention_sm90.cu's entry point, fp32
    flash_attention.cu's, each with its dtype code.  The card is stubbed:
    libraries that record their calls, and a stream lookup."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    calls = []
    monkeypatch.setitem(_build._libraries, "flash_attention_sm90",
                        _StubLibrary(calls, "flash_attention_sm90_launch"))
    monkeypatch.setitem(_build._libraries, "flash_attention",
                        _StubLibrary(calls, "flash_attention_launch"))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    q, k, v = (torch.from_numpy(a) for a in _mk(1, 16, 16, 4, 2, 32))
    n6, n7 = _build.LAUNCHES["flash_attention"], _build.LAUNCHES["flash_fwd"]
    monkeypatch.setitem(_build.LAUNCHES, "flash_attention", n6)  # restored
    monkeypatch.setitem(_build.LAUNCHES, "flash_fwd", n7)
    for dtype in (torch.bfloat16, torch.float32):
        out, lse = fa.launch(q.to(dtype), k.to(dtype), v.to(dtype),
                             causal=True, kv_offset=0, with_lse=True,
                             name="flash_fwd")
        assert out.dtype == dtype and lse.shape == (1, 4, 16)
        fa.launch(q.to(dtype), k.to(dtype), v.to(dtype), causal=False,
                  kv_offset=0, with_lse=False, name="flash_attention")
    assert [c[0] for c in calls] == ["flash_attention_sm90_launch"] * 2 + [
        "flash_attention_launch"] * 2
    # (B, Sq, Skv, H, KV, hd, dtype code, causal, ...) after the 5 pointers
    assert [c[1][5:13] for c in calls] == [
        (1, 16, 16, 4, 2, 32, 1, 1), (1, 16, 16, 4, 2, 32, 1, 0),
        (1, 16, 16, 4, 2, 32, 0, 1), (1, 16, 16, 4, 2, 32, 0, 0)]
    assert [c[1][4] is None for c in calls] == [False, True, False, True]
    assert (_build.LAUNCHES["flash_attention"], _build.LAUNCHES["flash_fwd"]
            ) == (n6 + 2, n7 + 2)


def test_trainable_raises_rather_than_return_a_wrong_gradient():
    """Under autograd the op returns attention's gradients (through the
    plain K8/K9 on the CPU) and refuses operands the kernels do not take,
    before computing anything."""
    q, k, v = (torch.from_numpy(a) for a in _mk(1, 16, 16, 2, 2, 16))
    with torch.no_grad():
        out = flash_attention_trainable(q.requires_grad_(), k, v, True, 512,
                                        512, 0)
    assert out.shape == q.shape
    k.requires_grad_()
    v.requires_grad_()
    grads = torch.autograd.grad(
        flash_attention_trainable(q, k, v, True, 512, 512, 0).sum(),
        (q, k, v))
    refs = torch.autograd.grad(
        attention(q, k, v, causal=True, q_chunk=16).sum(), (q, k, v))
    for g, r in zip(grads, refs):
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        flash_attention_trainable(q.half(), k.half(), v.half())


# -- the backward (K8/K9) ------------------------------------------------------

# (B, Sq, Skv, H, KV, hd), causal, kv_offset: TestFlashBackward's MHA, GQA
# and MQA, its non-causal case, a ragged Sq/Skv, cross lengths, and
# FLASH_CASES' ragged non-causal cross case and non-causal GQA-6 self case
# over three tiles.
BWD_CASES = {
    "mha": ((1, 128, 128, 2, 2, 32), True, 0),
    "gqa": ((2, 96, 96, 4, 2, 16), True, 0),
    "mqa": ((1, 64, 64, 4, 1, 16), True, 0),
    "non_causal": ((1, 64, 64, 2, 2, 16), False, 0),
    "ragged_100x70": ((1, 100, 70, 2, 1, 16), True, 0),
    "cross_kv_offset_128": ((1, 32, 160, 2, 2, 16), True, 128),
    **{c: FLASH_CASES[c] for c in ("cross_ragged_non_causal",
                                   "non_causal_gqa6")},
}


def _port_grads(arrays, do, dt, causal, bq, bk, kv_offset):
    """(dq, dk, dv) of sum(out * do) through the port's autograd Function."""
    qkv = [torch.from_numpy(a).to(DT[dt][1]).requires_grad_() for a in arrays]
    out = flash_attention_trainable(*qkv, causal, bq, bk, kv_offset)
    return torch.autograd.grad(out, qkv, torch.from_numpy(do).to(DT[dt][1]))


def _jax_grads(arrays, do, dt, causal, bq, bk, kv_offset):
    """The same through JAX's custom_vjp (Pallas interpreted)."""
    f = lambda q, k, v: jnp.sum(jax_trainable(
        q, k, v, causal, bq, bk, kv_offset).astype(jnp.float32) * do)
    return jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a, DT[dt][0])
                                            for a in arrays))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("blocks", [(32, 128), (512, 512)])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_backward_matches_the_tpu_kernels(case, blocks, dt):
    shape, causal, kv_offset = BWD_CASES[case]
    arrays = _mk(*shape)
    do = _rng.standard_normal(arrays[0].shape).astype(np.float32)
    kw = dict(causal=causal, bq=blocks[0], bk=blocks[1], kv_offset=kv_offset)
    before = dict(_build.LAUNCHES)
    ours = _port_grads(arrays, do, dt, **kw)
    assert dict(_build.LAUNCHES) == before   # the CPU runs no kernel
    ref = _jax_grads(arrays, do, dt, **kw)
    for name, a, b, want in zip("qkv", ours, ref, arrays):
        assert a.dtype == DT[dt][1] and a.shape == want.shape, name
        a, b = _f32(a), _f32(b)
        if dt == "f32":
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), name
        else:
            np.testing.assert_allclose(a, b, rtol=BF16_RTOL, atol=BF16_ATOL,
                                       err_msg=f"d{name}")


@pytest.mark.parametrize("case", ["mha", "gqa", "ragged_100x70"])
def test_backward_matches_attention_autograd(case):
    """The same gradients as autograd through the plain ``attention``."""
    shape, causal, _ = BWD_CASES[case]
    arrays = _mk(*shape)
    do = torch.from_numpy(
        _rng.standard_normal(arrays[0].shape).astype(np.float32))
    qkv = [torch.from_numpy(a).requires_grad_() for a in arrays]
    ours = torch.autograd.grad(flash_attention_trainable(*qkv, causal), qkv,
                               do)
    ref = torch.autograd.grad(attention(*qkv, causal=causal,
                                        q_chunk=shape[1]), qkv, do)
    for a, b in zip(ours, ref):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_bf16_rounds_ds_to_k_type():
    """JAX rounds ds to k's type before ds . k (flash_attention_bwd.py:150);
    on ``ds_rounding_case`` that moves dq[..., 1] from about -0.048 to
    -0.108, so a dq that skips the rounding fails the bf16 bound there."""
    q, k, v, do = ds_rounding_case()
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (q, k, v))
    jdq = jax.grad(lambda q: jnp.sum(jax_trainable(
        q, jk, jv, False, 512, 512, 0).astype(jnp.float32)
        * jnp.asarray(do.float().numpy())))(jq)
    out, lse = flash_fwd(q, k, v, causal=False)
    dq = flash_bwd(q, k, v, out, lse, do, causal=False)[0]
    np.testing.assert_allclose(_f32(dq), _f32(jdq), rtol=BF16_RTOL,
                               atol=BF16_ATOL)
    ref = _f32(jdq)
    np.testing.assert_allclose(ref[..., 1], -0.108, rtol=0, atol=2e-3)
    # The same numbers with ds kept in fp32, as a dq that skips the rounding
    # computes them.
    unrounded = flash_bwd_dq_plain(
        q.float(), k.float(), v.float(), do.float(), lse,
        flash_delta(out, do), causal=False).to(torch.bfloat16)
    miss = np.abs(_f32(unrounded) - ref) / (BF16_ATOL + BF16_RTOL
                                             * np.abs(ref))
    assert miss.max() > 10


def test_bf16_keeps_p_unrounded_in_dv(monkeypatch):
    """JAX does not round p before pᵀ·do (flash_attention_bwd.py:196: do is
    already fp32 there); on ``dv_p_rounding_case`` the plain K9 meets JAX's
    ``_flash_bwd`` (interpreted) within the bf16 bound, and the same plain
    version with p rounded to bf16 misses by more than ten times the
    bound."""
    q, k, v, do = dv_p_rounding_case()
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (q, k, v))
    jdv = jax.grad(lambda v: jnp.sum(jax_trainable(
        jq, jk, v, False, 512, 512, 0).astype(jnp.float32)
        * jnp.asarray(do.float().numpy())))(jv)
    out, lse = flash_fwd(q, k, v, causal=False)
    dq, dk, dv = flash_bwd(q, k, v, out, lse, do, causal=False)
    ref = _f32(jdv)
    np.testing.assert_allclose(_f32(dv), ref, rtol=BF16_RTOL, atol=BF16_ATOL)
    # About 5.45 before the cast to bf16 (whose ulp there is 1/32).
    np.testing.assert_allclose(ref[0, 0, 0, 0], 5.45, rtol=0, atol=1 / 32)
    assert float(dq.abs().max()) == float(dk.abs().max()) == 0.0
    # The plain version with p rounded to bf16 before pᵀ·do.
    fab = importlib.import_module("repro_torch.kernels.flash_attention_bwd")
    block_ds = fab._block_ds

    def p_rounded(*args, **kw):
        p, ds = block_ds(*args, **kw)
        return p.to(torch.bfloat16).float(), ds

    monkeypatch.setattr(fab, "_block_ds", p_rounded)
    rounded = fab.flash_bwd_dkv_plain(q, k, v, do, lse, flash_delta(out, do),
                                      causal=False)[1]
    miss = np.abs(_f32(rounded) - ref) / (BF16_ATOL + BF16_RTOL
                                           * np.abs(ref))
    assert miss.max() > 10


def test_backward_wrapper_sends_bf16_to_the_tensor_cores_and_fp32_to_simt(
        monkeypatch):
    """K8/K9's launchers pick the kernels by dtype (``KERNELS``), with no
    fallback: bf16 calls flash_attention_bwd_sm90.cu's two entry points,
    fp32 flash_attention_bwd.cu's, each counted once under
    ``flash_bwd_dq``/``flash_bwd_dkv``; a bf16 operand that TMA cannot read
    (not 16-byte aligned) raises before any launch.  The card is stubbed:
    libraries that record their calls, and a stream lookup."""
    fab = importlib.import_module("repro_torch.kernels.flash_attention_bwd")
    calls = []
    monkeypatch.setitem(_build._libraries, "flash_attention_bwd_sm90",
                        _StubLibrary(calls, "flash_bwd_dq_sm90_launch",
                                     "flash_bwd_dkv_sm90_launch"))
    monkeypatch.setitem(_build._libraries, "flash_attention_bwd",
                        _StubLibrary(calls, "flash_bwd_dq_launch",
                                     "flash_bwd_dkv_launch"))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    q, k, v = (torch.from_numpy(a) for a in _mk(1, 16, 16, 4, 2, 32))
    do = torch.from_numpy(_rng.standard_normal(q.shape).astype(np.float32))
    stats = dict(lse=torch.zeros(1, 4, 16), delta=torch.zeros(1, 4, 16))
    n8, n9 = _build.LAUNCHES["flash_bwd_dq"], _build.LAUNCHES["flash_bwd_dkv"]
    monkeypatch.setitem(_build.LAUNCHES, "flash_bwd_dq", n8)  # restored
    monkeypatch.setitem(_build.LAUNCHES, "flash_bwd_dkv", n9)
    kw = dict(causal=True, kv_offset=0)
    for dtype in (torch.bfloat16, torch.float32):
        ops = [t.to(dtype) for t in (q, k, v, do)]
        dq = fab.launch_bwd_dq(*ops, **stats, **kw)
        dk, dv = fab.launch_bwd_dkv(*ops, **stats, **kw)
        assert dq.dtype == dk.dtype == dv.dtype == dtype
        assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert [c[0] for c in calls] == [
        "flash_bwd_dq_sm90_launch", "flash_bwd_dkv_sm90_launch",
        "flash_bwd_dq_launch", "flash_bwd_dkv_launch"]
    # (B, Sq, Skv, H, KV, hd, dtype code, causal) after the 7 (K8) or 8
    # (K9) pointers
    assert [c[1][7 + ("dkv" in c[0]):][:8] for c in calls] == [
        (1, 16, 16, 4, 2, 32, 1, 1)] * 2 + [(1, 16, 16, 4, 2, 32, 0, 1)] * 2
    assert (_build.LAUNCHES["flash_bwd_dq"], _build.LAUNCHES["flash_bwd_dkv"]
            ) == (n8 + 2, n9 + 2)
    flat = torch.zeros(1 + q.numel(), dtype=torch.bfloat16)
    odd = flat[1:].view(q.shape)
    b16 = [t.to(torch.bfloat16) for t in (k, v, do)]
    for launch_bwd in (fab.launch_bwd_dq, fab.launch_bwd_dkv):
        with pytest.raises(ValueError, match="16-byte aligned"):
            launch_bwd(odd, *b16, **stats, **kw)
    assert len(calls) == 4
    assert (_build.LAUNCHES["flash_bwd_dq"], _build.LAUNCHES["flash_bwd_dkv"]
            ) == (n8 + 2, n9 + 2)


def test_wrappers_reject_what_the_kernel_cannot_run():
    q, k, v = (torch.from_numpy(a) for a in _mk(1, 16, 16, 4, 2, 16))
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="multiple of"):
        flash_fwd(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="must be"):
        flash_attention(q, k, v[:, :8])
