"""The port's LM serving slice (dense family, qwen3-0.6b's smoke config)
against the JAX package on the CPU: the layer functions, the initializer's
distributions, then prefill, the KV cache, decode logits and greedy tokens
with both ``attn_impl`` values, the weights carried across from JAX by
``models/convert.from_jax_params``.

The JAX flash path runs its Pallas kernel interpreted, as the JAX tests do;
the port's runs the kernel's plain version (a CPU tensor).  End-to-end
tolerances are relative to the tensor's max-abs (the random init lets the
residual stream grow layer by layer): fp32 hidden and logits 1e-4, caches
1e-5; bf16 hidden and decode logits 3e-2, and the bf16 LM head's fp32 logits
1e-5 (JAX keeps them fp32 too).  Layer functions: fp32 1e-6 absolute (the same
arithmetic), bf16 2e-2 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.models import layers as JL
from repro.models.attention import attention as jax_attention
from repro.models.attention import decode_attention as jax_decode_attention
from repro.models import transformer as JT
from repro.models.mlp import mlp_apply
from repro.models.model_zoo import build as jax_build
from repro.train.serve_step import greedy_generate as jax_greedy
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import _build
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import layers as TL
from repro_torch.models.attention import attention, decode_attention
from repro_torch.models.convert import from_jax_params
from repro_torch.models.mlp import MLP
from repro_torch.models.model_zoo import build
from repro_torch.models.transformer import model_table
from repro_torch.train.serve_step import greedy_generate

ARCH = "qwen3-0.6b"
B, S, STEPS = 2, 40, 8
MAX_LEN = S + STEPS + 1
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
_rng = np.random.default_rng(14)
TOKENS = _rng.integers(0, 512, (B, S))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(a, b):
    a, b = _f32(a), _f32(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _cfgs(impl):
    return (dataclasses.replace(jax_get_config(ARCH, smoke=True),
                                attn_impl=impl),
            dataclasses.replace(get_config(ARCH, smoke=True),
                                attn_impl=impl))


@pytest.fixture(scope="module", params=["f32", "bf16"])
def jax_params(request):
    jcfg, _ = _cfgs("xla")
    return request.param, jax_build(jcfg).init(jax.random.PRNGKey(0),
                                               DT[request.param][0])


# -- configs -----------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", jax_list_archs())
def test_config_is_a_copy_of_jax(arch, smoke):
    """Every arch of the JAX package's list, full and smoke: the port's
    config, padded vocab and parameter count are JAX's."""
    assert list_archs() == jax_list_archs()
    j, t = jax_get_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (j.padded_vocab, j.param_count()) == (t.padded_vocab,
                                                 t.param_count())


def test_unknown_arch_raises():
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("gpt-9")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(get_config(ARCH, smoke=True))


# -- layer functions -----------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rms_norm_rope_and_mlp_match_jax(dt):
    jd, td = DT[dt]
    x = _rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    w = (1 + 0.1 * _rng.standard_normal(16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 9), (2, 6))
    tx = torch.from_numpy(x).to(td)
    tol = dict(rtol=0, atol=1e-6) if dt == "f32" else dict(rtol=2e-2,
                                                          atol=2e-2)
    np.testing.assert_allclose(
        _f32(TL.rms_norm(tx, torch.from_numpy(w), 1e-5)),
        _f32(JL.rms_norm(jnp.asarray(x, jd), jnp.asarray(w), 1e-5)), **tol)
    np.testing.assert_array_equal(TL.rope_freqs(16, 1e6),
                                  JL.rope_freqs(16, 1e6))
    np.testing.assert_allclose(
        _f32(TL.apply_rope(tx, torch.from_numpy(pos.copy()), 1e6)),
        _f32(JL.apply_rope(jnp.asarray(x, jd), jnp.asarray(pos), 1e6)),
        **tol)
    h = _rng.standard_normal((2, 5, 32)).astype(np.float32)
    for activation, gated in (("silu", True), ("relu2", False),
                              ("gelu", False)):
        p = {"up": _rng.standard_normal((32, 48)).astype(np.float32) / 6,
             "down": _rng.standard_normal((48, 32)).astype(np.float32) / 7}
        if gated:
            p["gate"] = _rng.standard_normal((32, 48)).astype(np.float32) / 6
        mlp = MLP(32, 48, activation, gated, device="cpu", dtype=td)
        with torch.no_grad():
            for name, value in p.items():
                getattr(mlp, name).copy_(torch.from_numpy(value))
            out = mlp(torch.from_numpy(h).to(td))
        ref = mlp_apply({n: jnp.asarray(a, jd) for n, a in p.items()},
                        jnp.asarray(h, jd), activation)
        if dt == "f32":
            np.testing.assert_allclose(_f32(out), _f32(ref), rtol=0,
                                       atol=1e-5)
        else:
            assert _rel(out, ref) <= 2e-2, activation


@pytest.mark.parametrize("shard_heads", [False, True])
@pytest.mark.parametrize("causal,kv_offset,q_chunk", [
    (True, 0, 16), (True, 0, 48), (False, 0, 48), (True, -16, 24)])
def test_attention_matches_jax(shard_heads, causal, kv_offset, q_chunk):
    q = _rng.standard_normal((2, 48, 4, 16)).astype(np.float32)
    k = _rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    v = _rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, q_chunk=q_chunk, kv_offset=kv_offset,
              shard_heads=shard_heads)
    out = attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    ref = jax_attention(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=0, atol=1e-5)


def test_decode_attention_matches_jax():
    q = _rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    k = _rng.standard_normal((2, 30, 2, 16)).astype(np.float32)
    v = _rng.standard_normal((2, 30, 2, 16)).astype(np.float32)
    out = decode_attention(*(torch.from_numpy(a) for a in (q, k, v)), 17)
    ref = jax_decode_attention(*(jnp.asarray(a) for a in (q, k, v)), 17)
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=0, atol=1e-5)


def test_initializer_draws_jax_distributions():
    """Per-tensor std (mean for the "one" norms) equal to JAX's within
    sampling error, the stacked fan-in quirk included: every stacked layer
    weight has std 1/sqrt(n_layers), lm_head 1/sqrt(padded_vocab)."""
    jcfg, cfg = _cfgs("xla")
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0), jnp.float32)
    model = build(cfg, device="cpu", dtype=torch.float32,
                  generator=torch.Generator().manual_seed(3))
    tp = dict(model.named_parameters())
    for path, pd in TL.flatten(model_table(cfg)):
        ja = np.asarray(_get(jp, path))
        if path[0] == "layers":
            ta = np.stack([tp[f"layers.{i}." + ".".join(path[1:])]
                           .detach().numpy() for i in range(cfg.n_layers)])
        else:
            ta = tp[path[0]].detach().numpy()
        assert ta.shape == ja.shape, path
        if pd.scale == "one":
            assert (ta == 1).all() and (ja == 1).all(), path
            continue
        want = (1 / np.sqrt(pd.shape[0]) if pd.scale == "fan_in"
                else float(pd.scale))
        err = 6 * want / np.sqrt(2 * ta.size)   # 6 sigma of a sample std
        assert abs(ta.std() - want) <= err, (path, ta.std(), want)
        assert abs(ta.std() - ja.std()) <= 2 * err, (path, ta.std(),
                                                     ja.std())
    assert np.isclose(1 / np.sqrt(cfg.n_layers),
                      tp["layers.0.attn.wq"].detach().numpy().std(),
                      rtol=0.05)


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


# -- the slice end to end -----------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_prefill_and_cache_match_jax(jax_params, impl):
    dt, params = jax_params
    jcfg, cfg = _cfgs(impl)
    api = jax_build(jcfg)
    model = from_jax_params(cfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    assert model.dtype == DT[dt][1]
    jh, jc = api.prefill(params, {"tokens": jnp.asarray(TOKENS)}, MAX_LEN)
    before = dict(_build.LAUNCHES)
    th, tc = model.prefill(torch.as_tensor(TOKENS), MAX_LEN)
    assert dict(_build.LAUNCHES) == before
    assert th.shape == (B, cfg.d_model) and th.dtype == DT[dt][1]
    assert tc["k"].shape == tuple(jc["k"].shape) == (cfg.n_layers, B,
                                                     MAX_LEN, 2, 16)
    if dt == "f32":
        assert _rel(th, jh) <= 1e-4
        for name in ("k", "v"):
            assert _rel(tc[name], jc[name]) <= 1e-5, name
    else:
        assert _rel(th, jh) <= 3e-2


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_decode_and_greedy_tokens_match_jax(impl):
    jcfg, cfg = _cfgs(impl)
    api = jax_build(jcfg)
    params = api.init(jax.random.PRNGKey(0), jnp.float32)
    model = from_jax_params(cfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    batch = {"tokens": jnp.asarray(TOKENS)}
    jt = np.array(jax_greedy(api, params, batch, steps=STEPS,
                             max_len=MAX_LEN))
    tt = greedy_generate(model, {"tokens": torch.as_tensor(TOKENS)},
                         steps=STEPS, max_len=MAX_LEN)
    np.testing.assert_array_equal(tt.numpy(), jt)
    # Decode logits over STEPS steps, both fed JAX's greedy tokens.
    _, jc = api.prefill(params, batch, MAX_LEN)
    _, tc = model.prefill(torch.as_tensor(TOKENS), MAX_LEN)
    for i in range(STEPS):
        jl, jc = api.decode_step(params, jnp.asarray(jt[:, i]), jc, S + i)
        tl, tc = model.decode_step(torch.as_tensor(jt[:, i]), tc, S + i)
        assert tl.dtype == torch.float32
        assert _rel(tl, jl) <= 1e-4, i


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_bf16_decode_logits_and_greedy_tokens_match_jax(impl):
    jcfg, cfg = _cfgs(impl)
    api = jax_build(jcfg)
    params = api.init(jax.random.PRNGKey(0), jnp.bfloat16)
    model = from_jax_params(cfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    assert model.dtype == torch.bfloat16
    batch = {"tokens": jnp.asarray(TOKENS)}
    jt = np.array(jax_greedy(api, params, batch, steps=STEPS,
                             max_len=MAX_LEN))
    tt = greedy_generate(model, {"tokens": torch.as_tensor(TOKENS)},
                         steps=STEPS, max_len=MAX_LEN)
    np.testing.assert_array_equal(tt.numpy(), jt)
    # The LM head keeps fp32 logits from bf16 operands, as JAX's
    # preferred_element_type=float32: on the same hidden the two agree to
    # fp32 summation order, far inside one bf16 rounding (2**-9).
    hidden = _rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    hidden = torch.from_numpy(hidden).to(torch.bfloat16)
    jl = JT.logits_from_hidden(params, jnp.asarray(
        hidden.float().numpy(), jnp.bfloat16)[:, None])[:, 0]
    with torch.no_grad():
        tl = model.logits(hidden)
    assert tl.dtype == torch.float32 and _rel(tl, jl) <= 1e-5
    # Decode logits over STEPS steps, both fed JAX's greedy tokens.
    _, jc = api.prefill(params, batch, MAX_LEN)
    _, tc = model.prefill(torch.as_tensor(TOKENS), MAX_LEN)
    for i in range(STEPS):
        jl, jc = api.decode_step(params, jnp.asarray(jt[:, i]), jc, S + i)
        tl, tc = model.decode_step(torch.as_tensor(jt[:, i]), tc, S + i)
        assert tl.dtype == torch.float32
        assert _rel(tl, jl) <= 3e-2, i


def test_flash_and_xla_agree_in_the_port():
    _, cfg_x = _cfgs("xla")
    _, cfg_f = _cfgs("flash")
    gen = torch.Generator().manual_seed(0)
    mx = build(cfg_x, device="cpu", dtype=torch.float32, generator=gen)
    mf = build(cfg_f, device="cpu", dtype=torch.float32)
    mf.load_state_dict(mx.state_dict())
    tokens = torch.as_tensor(TOKENS)
    hx, cx = mx.prefill(tokens, MAX_LEN)
    hf, cf = mf.prefill(tokens, MAX_LEN)
    assert _rel(hf, hx) <= 1e-4 and _rel(cf["v"], cx["v"]) <= 1e-5
    assert float(cx["k"][:, :, S:].abs().max()) == 0.0  # padded to max_len
    # Train-mode forward: the last position is the prefill's hidden.
    with torch.no_grad():
        hidden, aux = mf(tokens)
    assert hidden.shape == (B, S, cfg_f.d_model) and float(aux) == 0.0
    assert _rel(hidden[:, -1], hf) <= 1e-5
    # With autograd on, the flash path's gradients (K8/K9's plain versions
    # here) are the plain attention's.
    used = lambda m: [p for n, p in m.named_parameters() if n != "lm_head"]
    r = torch.from_numpy(_rng.standard_normal(hidden.shape)
                         .astype(np.float32))
    gf = torch.autograd.grad((mf(tokens)[0] * r).sum(), used(mf))
    gx = torch.autograd.grad((mx(tokens)[0] * r).sum(), used(mx))
    for a, b in zip(gf, gx):
        assert _rel(a, b) <= 1e-4


def test_serve_cli_on_the_cpu(capsys):
    assert serve_main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--dtype", "float32", "--batch", "2",
                       "--prompt-len", "24", "--tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "prefill 2x24" in out and "ms/token" in out and "host" in out
