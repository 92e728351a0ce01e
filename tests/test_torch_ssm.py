"""The port's Mamba2 pieces against the JAX package on the CPU:
``core/conv1d.py`` (the stencil engine's causal 1D encoding), the chunked
SSD (``models/ssm.ssd_scan``), the Mamba2 block's full-sequence and decode
forms, the per-leaf dtype of ``ParamDef``, and the reference's fault at
``src/repro/models/ssm.py:57-60`` (NaN gradients at a 256-token chunk),
which the port does not copy.

Inputs are numpy from a seed, handed to both packages.  Tolerances:

- ``causal_conv1d`` and ``causal_conv1d_update``: bit-equal in fp32 and
  bf16 (the same fp32 sums in JAX's order, against JAX run op by op);
- ``ssd_scan``, ``mamba2_apply``, ``mamba2_decode`` in fp32: 1e-5 of the
  output's max-abs (the same arithmetic summed in another order; readings
  below 2e-6); in bf16: 2e-2 (the two frameworks round their bf16 matrix
  products at other places: about one bf16 ulp, 2**-8);
- the gradients of one smoke layer at ``ssm_chunk=256`` over 512 tokens
  against JAX's at chunk 8: 1e-4 of each leaf's max-abs (another chunking
  sums the same terms in another order: JAX's sit 4.7e-5 from a float64
  run of the port, the port's 3.0e-5, and the two read 1.7e-5 apart; with
  the reference's decays exp(cum_i - cum_j) the port's read 9.7e-5, on
  A_log).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.conv1d import causal_conv1d as jax_conv1d
from repro.core.conv1d import causal_conv1d_update as jax_conv1d_update
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.models.model_zoo import build as jax_build
from repro_torch.configs import get_config
from repro_torch.core.conv1d import causal_conv1d, causal_conv1d_update
from repro_torch.models import ssm as TS
from repro_torch.models.convert import from_jax_params, named_arrays
from repro_torch.models.layers import ParamDef, init_params, stack_tables

DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(a, b):
    a, b = _f32(a), _f32(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _pair(a, dt):
    """The same numbers in each framework's ``dt``."""
    jd, td = DT[dt]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


# -- the stencil engine's causal conv ------------------------------------------

@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_causal_conv1d_is_jax_bit_for_bit(dt, with_bias):
    rng = np.random.default_rng(30)
    x = rng.standard_normal((3, 41, 37)).astype(np.float32)
    w = rng.standard_normal((4, 37)).astype(np.float32)
    b = rng.standard_normal(37).astype(np.float32) if with_bias else None
    (jx, tx), (jw, tw) = _pair(x, dt), _pair(w, dt)
    jb, tb = _pair(b, dt) if with_bias else (None, None)
    out = causal_conv1d(tx, tw, tb)
    ref = jax_conv1d(jx, jw, jb)
    assert out.dtype == DT[dt][1] and out.shape == tuple(ref.shape)
    np.testing.assert_array_equal(_f32(out), _f32(ref))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_causal_conv1d_update_is_jax_bit_for_bit(dt):
    rng = np.random.default_rng(31)
    state = rng.standard_normal((3, 3, 300)).astype(np.float32)
    x_t = rng.standard_normal((3, 300)).astype(np.float32)
    w = rng.standard_normal((4, 300)).astype(np.float32)
    b = rng.standard_normal(300).astype(np.float32)
    args = [_pair(a, dt) for a in (state, x_t, w, b)]
    new, out = causal_conv1d_update(*(t for _, t in args))
    jnew, jout = jax_conv1d_update(*(j for j, _ in args))
    assert new.dtype == out.dtype == DT[dt][1]
    np.testing.assert_array_equal(_f32(new), _f32(jnew))
    np.testing.assert_array_equal(_f32(out), _f32(jout))


def test_conv_halo_carries_the_sequence_into_decode():
    """The full-sequence conv and the decode step agree where the halo is
    the last K-1 inputs (fp32; the step fuses its multiply-adds)."""
    rng = np.random.default_rng(32)
    x = torch.from_numpy(rng.standard_normal((2, 30, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    full = causal_conv1d(x, w, b)
    state = x[:, 20 - 3:20]
    for t in range(20, 30):
        state, out = causal_conv1d_update(state, x[:, t], w, b)
        torch.testing.assert_close(out, full[:, t], rtol=0, atol=1e-6)


# -- the per-leaf dtype -----------------------------------------------------------

def test_param_def_dtype_survives_stacking_and_init():
    table = stack_tables(stack_tables(TS.mamba2_table(16, 32, 2, 8, 4), 3),
                         2)
    assert table["A_log"] == ParamDef((2, 3, 2), (None, None, "ssm_heads"),
                                      "zero", torch.float32)
    params = init_params(table, torch.Generator().manual_seed(0),
                         torch.bfloat16, torch.device("cpu"))
    for name, t in params.items():
        pinned = name in ("A_log", "D", "dt_bias")
        assert t.dtype == (torch.float32 if pinned else torch.bfloat16), name
    mixer = TS.Mamba2Mixer(16, 32, 2, 16, 8, 4, 8, device="cpu",
                           dtype=torch.bfloat16)
    assert {n: p.dtype for n, p in mixer.named_parameters()} == {
        n: t.dtype for n, t in
        init_params(TS.mamba2_table(16, 32, 2, 8, 4),
                    torch.Generator(), torch.bfloat16,
                    torch.device("cpu")).items()}


# -- the chunked SSD -------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("L,chunk,with_state", [(32, 8, False), (37, 8, False),
                                                (37, 8, True), (5, 8, True),
                                                (40, 40, True)])
def test_ssd_scan_matches_jax(L, chunk, with_state, dt):
    """Whole chunks, a ragged tail (zero-padded), a sequence shorter than
    one chunk, and a carried state0."""
    rng = np.random.default_rng(33)
    B, H, P, N = 2, 3, 8, 5
    xdt = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dA = -np.abs(rng.standard_normal((B, L, H))).astype(np.float32)
    Bm = rng.standard_normal((B, L, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, N)).astype(np.float32)
    s0 = (rng.standard_normal((B, H, P, N)).astype(np.float32)
          if with_state else None)
    (jx, tx), (jb, tb), (jc, tc) = (_pair(a, dt) for a in (xdt, Bm, Cm))
    y, final = TS.ssd_scan(tx, torch.from_numpy(dA), tb, tc, chunk,
                           None if s0 is None else torch.from_numpy(s0))
    jy, jfinal = JS.ssd_scan(jx, jnp.asarray(dA), jb, jc, chunk,
                             None if s0 is None else jnp.asarray(s0))
    assert y.dtype == final.dtype == torch.float32
    assert y.shape == (B, L, H, P) and final.shape == (B, H, P, N)
    tol = 1e-5 if dt == "f32" else 2e-2
    assert _rel(y, jy) <= tol and _rel(final, jfinal) <= tol


def test_ssd_decays_keep_fp32_near_float64_over_a_256_token_chunk():
    """One 256-token chunk at the random init's dt scale (-dt*A about 0.8
    a token, so the chunk's cumsum reaches 187): the port's decays, each
    summed over its own segment, keep y and the final state within 1e-6 of
    a float64 recurrence (readings 1.3e-7 and 7.7e-8).  JAX's
    exp(cum_i - cum_j) subtracts two such sums near the diagonal and reads
    past 1e-6 (4.1e-6 and 6.3e-6): recorded."""
    rng = np.random.default_rng(37)
    B, L, H, P, N = 1, 256, 8, 16, 32
    xdt = rng.standard_normal((B, L, H, P))
    dA = -np.logaddexp(rng.standard_normal((B, L, H)), 0)
    Bm, Cm = (rng.standard_normal((B, L, N)) for _ in range(2))
    s0 = rng.standard_normal((B, H, P, N))
    state, ys = s0.copy(), []
    for t in range(L):         # the recurrence, float64
        state = (state * np.exp(dA[:, t])[:, :, None, None]
                 + xdt[:, t, :, :, None] * Bm[:, t, None, None, :])
        ys.append(np.einsum("bhpn,bn->bhp", state, Cm[:, t]))
    y64 = np.stack(ys, axis=1)
    f32 = [a.astype(np.float32) for a in (xdt, dA, Bm, Cm, s0)]
    y, final = TS.ssd_scan(*map(torch.from_numpy, f32[:4]), 256,
                           torch.from_numpy(f32[4]))
    rel = lambda a, b: float(np.abs(_f32(a) - b).max() / np.abs(b).max())
    assert rel(y, y64) <= 1e-6 and rel(final, state) <= 1e-6
    jy, jfinal = JS.ssd_scan(*map(jnp.asarray, f32[:4]), 256,
                             jnp.asarray(f32[4]))
    assert max(rel(jy, y64), rel(jfinal, state)) > 1e-6


def _mixer_params(cfg, dt, seed):
    """One layer's JAX-initialised mixer params, as (JAX's tree in ``dt``,
    the port's dict of tensors in their types)."""
    table = JS.mamba2_table(cfg.d_model, cfg.d_inner, cfg.n_ssm_heads,
                            cfg.ssm_state, cfg.d_conv)
    from repro.models.layers import init_params as jax_init
    jp = jax_init(table, jax.random.PRNGKey(seed), DT[dt][0])
    # Non-trivial A_log, dt_bias, D and conv bias (the init has 0 and 1).
    r = np.random.default_rng(seed)
    for name in ("A_log", "dt_bias", "D"):
        jp[name] = jnp.asarray(0.3 * r.standard_normal(jp[name].shape),
                               jnp.float32)
    jp["conv_b"] = jnp.asarray(0.1 * r.standard_normal(jp["conv_b"].shape),
                               DT[dt][0])
    tp = {n: torch.from_numpy(np.array(_f32(a))).to(
        torch.float32 if a.dtype == jnp.float32 else torch.bfloat16)
        for n, a in jp.items()}
    return jp, tp


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mamba2_apply_and_decode_match_jax(dt):
    rng = np.random.default_rng(34)
    cfg = jax_get_config("mamba2-370m", smoke=True)
    kw = dict(n_heads=cfg.n_ssm_heads, head_dim=cfg.ssm_head_dim,
              d_state=cfg.ssm_state)
    jp, tp = _mixer_params(cfg, dt, 4)
    x = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, dt)
    tol = 1e-5 if dt == "f32" else 2e-2
    out, final = TS.mamba2_apply(tp, tx, chunk=cfg.ssm_chunk,
                                 return_state=True, **kw)
    jout, jfinal = JS.mamba2_apply(jp, jx, chunk=cfg.ssm_chunk,
                                   return_state=True, **kw)
    assert out.dtype == DT[dt][1] and final.dtype == torch.float32
    assert _rel(out, jout) <= tol and _rel(final, jfinal) <= tol
    # Decode from a cache holding JAX's numbers, three steps.
    K = cfg.d_conv
    cache = {"conv_x": rng.standard_normal((2, K - 1, cfg.d_inner)),
             "conv_bc": rng.standard_normal((2, K - 1, 2 * cfg.ssm_state)),
             "state": _f32(jfinal)}
    jc = {n: jnp.asarray(a, jnp.float32 if n == "state" else DT[dt][0])
          for n, a in cache.items()}
    tc = {n: torch.from_numpy(np.array(a, np.float32)).to(
        torch.float32 if n == "state" else DT[dt][1]) for n, a in cache.items()}
    for step in range(3):
        x_t = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
        jx_t, tx_t = _pair(x_t, dt)
        y, tc = TS.mamba2_decode(tp, tx_t, tc, **kw)
        jy, jc = JS.mamba2_decode(jp, jx_t, jc, **kw)
        assert y.dtype == DT[dt][1] and tc["state"].dtype == torch.float32
        assert _rel(y, jy) <= tol, step
        for name in tc:
            assert _rel(tc[name], jc[name]) <= tol, (step, name)


def test_softplus_is_jax_logaddexp():
    """Within two fp32 ulps (XLA's exp and log1p are not libm's), and XLA
    flushes results below the smallest normal (1.2e-38) to 0."""
    rng = np.random.default_rng(35)
    x = np.concatenate([np.linspace(-90, 90, 2001),
                        rng.standard_normal(500) * 30]).astype(np.float32)
    np.testing.assert_allclose(
        TS.softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=2.4e-7,
        atol=1.2e-38)


# -- the reference's fault: the decay matrix's exponential -----------------------

def _layer_grads_jax(jcfg, params, tokens, r):
    def loss(p):
        hidden, _ = JT.forward(jcfg, p, tokens)
        return jnp.sum(hidden * r)
    return jax.jit(jax.value_and_grad(loss))(params)


def test_chunk_256_gradients_are_finite_and_equal_jax_at_chunk_8():
    """One smoke layer over 512 tokens, the loss <hidden, r> for a fixed
    random r.  JAX at chunk 256 exponentiates positive decay sums past
    fp32's range above the diagonal and gets non-finite gradients; the port
    at 256 masks first, and its gradients equal JAX's at chunk 8, where
    JAX's stay finite."""
    rng = np.random.default_rng(36)
    base = dataclasses.replace(jax_get_config("mamba2-370m", smoke=True),
                               n_layers=1)
    c256, c8 = (dataclasses.replace(base, ssm_chunk=c) for c in (256, 8))
    params = jax_build(c8).init(jax.random.PRNGKey(2), jnp.float32)
    tokens = rng.integers(0, base.vocab_size, (2, 512))
    r = rng.standard_normal((2, 512, base.d_model)).astype(np.float32)
    jl8, jg8 = _layer_grads_jax(c8, params, jnp.asarray(tokens), r)
    jl256, jg256 = _layer_grads_jax(c256, params, jnp.asarray(tokens), r)
    finite = lambda g: all(bool(jnp.isfinite(a).all())
                           for a in jax.tree.leaves(g))
    assert finite(jg8) and bool(jnp.isfinite(jl256))
    assert not finite(jg256)       # the reference's fault, recorded

    tcfg = dataclasses.replace(get_config("mamba2-370m", smoke=True),
                               n_layers=1, ssm_chunk=256)
    model = from_jax_params(tcfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    hidden, _ = model(torch.as_tensor(tokens))
    loss = torch.sum(hidden * torch.from_numpy(r))
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves,
                                                allow_unused=True,
                                                materialize_grads=True)))
    # The loss sums 65,536 terms of both signs: held against their sum of
    # magnitudes.
    scale = float(torch.sum(torch.abs(hidden * torch.from_numpy(r))))
    assert abs(float(loss) - float(jl8)) <= 1e-6 * scale
    want = named_arrays(tcfg, jax.tree.map(np.asarray, jg8))
    assert set(want) == set(grads)
    for name, g in grads.items():
        assert bool(torch.isfinite(g).all()), name
        if name == "lm_head":          # not in the loss
            assert float(g.abs().max()) == 0 == np.abs(want[name]).max()
            continue
        assert _rel(g, want[name]) <= 1e-4, name
