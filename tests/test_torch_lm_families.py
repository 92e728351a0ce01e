"""The port's ssm (mamba2-370m) and hybrid (zamba2-1.2b) LM families against
the JAX package on the CPU, on their smoke configs: the configs, the
initializer, prefill, the caches, decode logits and greedy tokens with both
``attn_impl`` values (the hybrid's shared attention; the ssm family has
none), the train-mode forward and its gradients, one train step from a JAX
train state, decode against forward inside the port, and both launchers.

Weights come from JAX's initializer through ``models/convert``; prompts and
batches are numpy from a seed.  The JAX flash path runs its Pallas kernel
interpreted, as the JAX tests do; the port's runs the kernel's plain version
(a CPU tensor), and no kernel launches.  Prompts of 21 tokens leave a
ragged tail against the smoke configs' 8-token SSD chunk.  Tolerances,
relative to the tensor's max-abs:

- fp32: prefill hidden, caches, decode logits and the forward 1e-4 (the
  same arithmetic summed in another order; readings below 1e-5); the
  gradients of the loss 3e-4 (both frameworks' fp32 gradients sit up to
  1.3e-4 from a float64 run of the port, the SSD's decay sums cancelling);
  the train step's loss 1e-5 relative and grad norm 5e-5, the update
  p_1 - p_0 1e-3 where JAX's gradient keeps clear of 0
  (``_clear_of_zero``: AdamW's first step is about lr * sign(g));
- bf16: prefill hidden and decode logits 3e-2 (the frameworks round their
  bf16 products at other places), greedy tokens equal; mamba2's train
  step: loss 1e-3 relative, grad norm 5e-3.  The hybrid's bf16 step: loss
  3e-3, and the grad norm not compared: at the smoke config's random init
  its bf16 runs scatter around the fp32 one in both frameworks (losses
  within 1.6e-3 of it; the shared attention's gradients 4-6 times their
  max-abs away, grad norms 8.13 in JAX and 6.45 in the port against fp32's
  4.07), so they say nothing of the port;
- decode against forward in the port, fp32: 1e-4 (the chunked SSD against
  its recurrence, the conv halo, the hybrid's attention caches); a wrong
  cache (the halo reversed, the attention cache one place short) moves
  the logits past it, and a test holds that.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.synthetic import DataConfig as JaxDataConfig
from repro.data.synthetic import token_batch as jax_token_batch
from repro.models import transformer as JT
from repro.models.layers import _flatten as jax_flatten
from repro.models.model_zoo import build as jax_build
from repro.optim import adamw as JA
from repro.train.train_step import loss_fn as jax_loss_fn
from repro_torch.configs import get_config, list_archs
from repro_torch.data.synthetic import DataConfig, token_batch
from repro_torch.kernels import _build
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.models.convert import (from_jax_params, from_jax_state,
                                        named_arrays, to_jax_tree)
from repro_torch.models.layers import flatten
from repro_torch.models.model_zoo import build
from repro_torch.models.transformer import model_table
from repro_torch.optim import adamw as TA
from repro_torch.train.serve_step import greedy_generate
from repro_torch.train.train_step import (compute_model, loss_fn,
                                          make_train_step, value_and_grad)

ARCHS = ("mamba2-370m", "zamba2-1.2b")
# (arch, attn_impl): the ssm family has no attention.
CASES = [("mamba2-370m", "xla"), ("zamba2-1.2b", "xla"),
         ("zamba2-1.2b", "flash")]
B, S, STEPS = 2, 21, 6
MAX_LEN = S + STEPS + 1
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
PINNED = ("A_log", "D", "dt_bias")
TOKENS = np.random.default_rng(23).integers(0, 512, (B, S))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(a, b):
    a, b = _f32(a), _f32(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _cfgs(arch, impl="xla"):
    return (dataclasses.replace(jax_get_config(arch, smoke=True),
                                attn_impl=impl),
            dataclasses.replace(get_config(arch, smoke=True),
                                attn_impl=impl))


def _models(arch, impl, dt, seed=0):
    """(JAX api, JAX params in ``dt``, the port's model from them)."""
    jcfg, cfg = _cfgs(arch, impl)
    api = jax_build(jcfg)
    params = api.init(jax.random.PRNGKey(seed), DT[dt][0])
    model = from_jax_params(cfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    return api, params, model


def _tree_by_path(tree):
    return {tuple(k.key for k in path): leaf for path, leaf
            in jax.tree_util.tree_leaves_with_path(tree)}


# -- configs and the initializer ---------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_a_copy_of_jax(arch):
    for smoke in (False, True):
        j, t = jax_get_config(arch, smoke=smoke), get_config(arch,
                                                             smoke=smoke)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (j.padded_vocab, j.param_count(), j.d_inner, j.n_ssm_heads) \
            == (t.padded_vocab, t.param_count(), t.d_inner, t.n_ssm_heads)
    assert arch in list_archs()
    full = get_config(arch)
    want = {"mamba2-370m": 419.7e6, "zamba2-1.2b": 1170.3e6}[arch]
    assert abs(full.param_count() - want) < 0.05e6
    assert full.ssm_chunk == 256


@pytest.mark.parametrize("arch", ARCHS)
def test_tables_and_initializer_follow_jax(arch):
    """The table's paths, shapes and pinned dtypes are JAX's; the stacked
    fan-in quirk holds (the hybrid's doubly stacked layers read the group
    count); a bf16 model keeps the pinned leaves fp32."""
    jcfg, cfg = _cfgs(arch)
    jt = dict(jax_flatten(JT.model_table(jcfg)))
    tt = dict(flatten(model_table(cfg)))
    assert list(jt) == list(tt)
    for path, pd in tt.items():
        assert pd.shape == jt[path].shape and pd.scale == jt[path].scale
        assert (pd.dtype == torch.float32) == (jt[path].dtype is not None)
        assert (path[-1] in PINNED) == (pd.dtype is not None), path
    model = build(cfg, device="cpu", dtype=torch.bfloat16,
                  generator=torch.Generator().manual_seed(1))
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    assert all((d == torch.float32) == (n.split(".")[-1] in PINNED)
               for n, d in dtypes.items())
    jp = _tree_by_path(jax_build(jcfg).init(jax.random.PRNGKey(0),
                                            jnp.float32))
    tp = _tree_by_path(to_jax_tree(cfg, dict(model.named_parameters())))
    for path, pd in tt.items():
        ja, ta = np.asarray(jp[path]), tp[path]
        assert ja.shape == ta.shape, path
        if pd.scale in ("one", "zero"):
            assert (ta == ja).all(), path
            continue
        want = (1 / np.sqrt(pd.shape[0]) if pd.scale == "fan_in"
                else float(pd.scale))
        err = 6 * want / np.sqrt(2 * ta.size)   # 6 sigma of a sample std
        assert abs(ta.std() - want) <= err + 0.01 * want, (path, ta.std())


@pytest.mark.parametrize("arch", (*ARCHS, "qwen3-0.6b"))
def test_cache_layout_is_jax(arch):
    """cache_shapes (shapes and dtypes) and cache_dims equal JAX's."""
    jcfg, cfg = _cfgs(arch)
    model = build(cfg, device="cpu", dtype=torch.bfloat16)
    want = _tree_by_path(JT.cache_shapes(jcfg, B, MAX_LEN, jnp.bfloat16))
    got = dict(flatten(model.cache_shapes(B, MAX_LEN)))
    assert set(got) == set(want)
    for path, (shape, dtype) in got.items():
        assert shape == tuple(want[path].shape), path
        assert (dtype == torch.float32) == (want[path].dtype == jnp.float32)
    is_dims = lambda x: isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)
    jdims = {tuple(k.key for k in p): d for p, d in
             jax.tree_util.tree_flatten_with_path(
                 JT.cache_dims(jcfg), is_leaf=is_dims)[0]}
    assert dict(flatten(model.cache_dims())) == jdims


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_default_to_the_card(arch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(get_config(arch, smoke=True))


# -- serving: prefill, caches, decode ------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch,impl", CASES)
def test_prefill_and_cache_match_jax(arch, impl, dt):
    api, params, model = _models(arch, impl, dt)
    assert model.dtype == DT[dt][1]
    jh, jc = api.prefill(params, {"tokens": jnp.asarray(TOKENS)}, MAX_LEN)
    before = dict(_build.LAUNCHES)
    th, tc = model.prefill(torch.as_tensor(TOKENS), MAX_LEN)
    assert dict(_build.LAUNCHES) == before
    assert th.shape == (B, model.cfg.d_model) and th.dtype == DT[dt][1]
    jleaves, tleaves = _tree_by_path(jc), dict(flatten(tc))
    assert set(jleaves) == set(tleaves)
    shapes = dict(flatten(model.cache_shapes(B, MAX_LEN)))
    for path, t in tleaves.items():
        j = jleaves[path]
        assert tuple(t.shape) == tuple(j.shape) == shapes[path][0], path
        assert t.dtype == shapes[path][1], path
        assert (t.dtype == torch.float32) == (j.dtype == jnp.float32), path
        if dt == "f32":
            assert _rel(t, j) <= 1e-4, path
    assert _rel(th, jh) <= (1e-4 if dt == "f32" else 3e-2)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch,impl", CASES)
def test_decode_and_greedy_tokens_match_jax(arch, impl, dt):
    """JAX's greedy loop (its prefill, then ``decode_step`` jitted with the
    cache fill traced: one compile for all steps), against the port's
    ``greedy_generate``; then the port's decode logits and caches, fed
    JAX's tokens, step by step."""
    api, params, model = _models(arch, impl, dt)
    jcfg = api.cfg
    jh, jc = jax.jit(api.prefill, static_argnums=2)(
        params, {"tokens": jnp.asarray(TOKENS)}, MAX_LEN)
    jdecode = jax.jit(api.decode_step)
    first = JT.mask_pad_logits(JT.logits_from_hidden(params, jh[:, None]),
                               jcfg)[:, 0]
    jt, jlogits = [np.asarray(jnp.argmax(first, -1))], []
    for i in range(STEPS - 1):
        jl, jc = jdecode(params, jnp.asarray(jt[-1]), jc, S + i)
        jlogits.append(jl)
        jt.append(np.asarray(jnp.argmax(jl, -1)))
    jt = np.stack(jt, axis=1)
    tt = greedy_generate(model, {"tokens": torch.as_tensor(TOKENS)},
                         steps=STEPS, max_len=MAX_LEN)
    np.testing.assert_array_equal(tt.numpy(), jt)
    _, tc = model.prefill(torch.as_tensor(TOKENS), MAX_LEN)
    for i, jl in enumerate(jlogits):
        tl, tc = model.decode_step(torch.as_tensor(jt[:, i]), tc, S + i)
        assert tl.dtype == torch.float32
        assert _rel(tl, jl) <= (1e-4 if dt == "f32" else 3e-2), i
    for path, t in flatten(tc):           # the caches after the steps
        if dt == "f32":
            assert _rel(t, _tree_by_path(jc)[path]) <= 1e-4, path


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_in_the_port(arch):
    """prefill(S) then decode steps = the train-mode forward over the
    tokens so far, at the last position (JAX's tests/test_models.py:62-63
    with the port alone)."""
    rng = np.random.default_rng(60)
    _, cfg = _cfgs(arch)
    model = build(cfg, device="cpu", dtype=torch.float32,
                  generator=torch.Generator().manual_seed(4))
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                           (B, S + STEPS)))
    _, cache = model.prefill(tokens[:, :S], MAX_LEN)
    for i in range(STEPS):
        logits, cache = model.decode_step(tokens[:, S + i], cache, S + i)
        with torch.no_grad():
            hidden, _ = model(tokens[:, :S + i + 1])
        want = model.logits(hidden[:, -1])
        assert _rel(logits[:, :cfg.vocab_size],
                    want[:, :cfg.vocab_size]) <= 1e-4, i


def _reverse_halo(cache):
    for sub in ([cache["groups"], cache["tail"]] if "groups" in cache
                else [cache]):
        for name in ("conv_x", "conv_bc"):
            sub[name].copy_(sub[name].flip(-2))


@pytest.mark.parametrize("arch,fault", [("mamba2-370m", "halo_reversed"),
                                        ("zamba2-1.2b", "halo_reversed"),
                                        ("zamba2-1.2b", "kv_len_short")])
def test_decode_against_forward_catches_a_wrong_cache(arch, fault):
    """The reach of the check above: one decode step from a prefill cache
    with its conv halos in reverse time order, or the hybrid's attention
    cache filled one place short (kv_len - 1), is past its 1e-4 (readings
    1.10 and 1.85 of max-abs for the halo, 8.2e-2 for the short cache)."""
    rng = np.random.default_rng(60)
    _, cfg = _cfgs(arch)
    model = build(cfg, device="cpu", dtype=torch.float32,
                  generator=torch.Generator().manual_seed(4))
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S + 1)))
    _, cache = model.prefill(tokens[:, :S], MAX_LEN)
    if fault == "halo_reversed":
        _reverse_halo(cache)
    kv_len = S - 1 if fault == "kv_len_short" else S
    logits, _ = model.decode_step(tokens[:, S], cache, kv_len)
    with torch.no_grad():
        hidden, _ = model(tokens)
    want = model.logits(hidden[:, -1])
    assert _rel(logits[:, :cfg.vocab_size],
                want[:, :cfg.vocab_size]) > 1e-4


# -- training ------------------------------------------------------------------

@pytest.mark.parametrize("arch,impl", CASES)
def test_forward_and_grads_match_jax(arch, impl):
    """The train-mode forward (remat on, the SSD chunks checkpointed) and
    the gradients of the LM loss, fp32, against jax.grad of JAX's."""
    api, params, model = _models(arch, impl, "f32")
    cfg = model.cfg
    batch_np = jax_token_batch(JaxDataConfig(cfg.vocab_size, S, B), 0)
    jhidden, _ = jax.jit(api.forward)(params, batch_np)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(api, p, batch_np, None, jnp.float32),
        has_aux=True))(params)
    batch = token_batch(DataConfig(cfg.vocab_size, S, B), 0, device="cpu")
    with torch.no_grad():
        hidden, aux = model(batch["tokens"])
    assert _rel(hidden, jhidden) <= 1e-4 and float(aux) == 0.0
    loss, _ = loss_fn(model, batch)
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) / float(jloss) - 1) <= 1e-5
    want = named_arrays(cfg, jax.tree.map(np.asarray, jg))
    for name, g in zip(names, grads):
        if np.abs(want[name]).max() == 0:
            assert float(g.abs().max()) == 0, name
        else:
            assert _rel(g, want[name]) <= 3e-4, name


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_equal_loss_and_grads(arch):
    """Layer groups and SSD chunks under checkpoint change nothing."""
    _, cfg = _cfgs(arch)
    cfg = dataclasses.replace(cfg, remat_group=3)   # divides ssm's 3 layers
    model = build(cfg, device="cpu", dtype=torch.float32)
    batch = token_batch(DataConfig(cfg.vocab_size, S, B), 0, device="cpu")
    out = []
    for remat in (True, False):
        loss, _ = loss_fn(model, batch, remat=remat)
        out.append((loss, torch.autograd.grad(loss, model.parameters())))
    assert float(out[0][0]) == float(out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def _clear_of_zero(g, ours):
    """Where AdamW's first update cannot flip sign: JAX's |g| above 1e-3 of
    the leaf's max-abs and above 4 times the leaf's largest |g_port -
    g_jax|, or g exactly 0 on both sides."""
    g = _f32(g)
    floor = max(1e-3 * np.abs(g).max(), 4 * np.abs(ours - g).max())
    return (np.abs(g) > floor) | ((g == 0) & (ours == 0))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch,impl", CASES)
def test_train_step_matches_jax(arch, impl, dt):
    """One train step of JAX's and the port's from the same JAX-initialised
    fp32 state (``from_jax_state``) and batch.  JAX's step is its
    ``make_train_step``'s two halves: ``jax.value_and_grad`` of its
    ``loss_fn``, then ``apply_update``, each jitted."""
    jd, td = DT[dt]
    jcfg, cfg = _cfgs(arch, impl)
    api = jax_build(jcfg)
    jstate = JA.init_state(api.init(jax.random.PRNGKey(0), jnp.float32))
    np_state = jax.tree.map(np.asarray, jstate)
    p0 = np_state["params"]
    model = from_jax_params(cfg, p0, device="cpu", dtype=torch.float32)
    tstate = from_jax_state(model, np_state)
    opt = dict(total_steps=10, warmup_steps=2)
    jb = jax_token_batch(JaxDataConfig(cfg.vocab_size, S, B), 0)
    tb = token_batch(DataConfig(cfg.vocab_size, S, B), 0, device="cpu")
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(api, p, jb, None, jd), has_aux=True))(
            jstate["params"])
    jstate, jm = jax.jit(JA.apply_update, static_argnums=2)(
        jstate, jg, JA.AdamWConfig(**opt))
    jm["loss"] = jloss
    _, _, tg = value_and_grad(compute_model(model, td), tstate["params"], tb)
    assert all(tg[n].dtype == (torch.float32 if n.split(".")[-1] in PINNED
                               else td) for n in tg)
    before = dict(_build.LAUNCHES)
    tstate, tm = make_train_step(model, TA.AdamWConfig(**opt), td)(tstate,
                                                                    tb)
    assert dict(_build.LAUNCHES) == before
    assert int(tstate["step"]) == 1 and float(tm["lr"]) == float(jm["lr"])
    tol = ({"loss": 1e-5, "grad_norm": 5e-5} if dt == "f32" else
           {"loss": 3e-3} if cfg.family == "hybrid" else
           {"loss": 1e-3, "grad_norm": 5e-3})
    for key, t in tol.items():
        assert abs(float(tm[key]) / float(jm[key]) - 1) <= t, key
    if dt == "bf16":
        return
    ours = to_jax_tree(cfg, tstate["params"])
    starts, ours_by, jgrads, grads = (_tree_by_path(t) for t in (
        p0, ours, jg, to_jax_tree(cfg, tg)))
    compared = 0
    for path, a in _tree_by_path(jstate["params"]).items():
        start, got_p = starts[path], ours_by[path]
        mask = _clear_of_zero(jgrads[path], grads[path])
        want, got = _f32(a) - start, got_p - start
        if mask.any():
            compared += int(mask.sum())
            err = np.abs(got - want)[mask].max() / np.abs(want).max()
            assert err <= 1e-3, (path, err)
    assert compared >= 0.1 * sum(np.size(p) for p in jax.tree.leaves(p0))
    np.testing.assert_array_equal(model.embed.detach().numpy(),
                                  named_arrays(cfg, ours)["embed"])


# -- the launchers -------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_the_cpu(arch, capsys):
    assert serve_main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--dtype", "float32", "--batch", "2",
                       "--prompt-len", "19", "--tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "prefill 2x19" in out and "ms/token" in out and "host" in out
    assert "kernel launches {}" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_on_the_cpu(arch, capsys, tmp_path):
    assert train_main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", "2", "--global-batch", "2",
                       "--seq-len", "16",
                       "--checkpoint-dir", str(tmp_path / "ckpt")]) == 0
    out = capsys.readouterr().out
    assert "step     2 loss=" in out and "tok/s" in out
    assert "timed by host" in out and "kernel launches {}" in out
