"""The port's vlm family (qwen2-vl-2b) against the JAX package on the CPU, on
its smoke config: the config, the initializer, the positions, prefill, the
caches, decode logits and greedy tokens with both ``attn_impl`` values, the
train-mode forward and its gradients, one train step from a JAX train
state, decode against forward inside the port, and both launchers.

Every call carries a vision prefix (``vision_embeds``: the first 8
positions, numpy normal draws) and Qwen2-VL's M-RoPE ids for it, a 4-wide
patch grid then text (``_torch_vlm_encdec_cases.grid_positions``): three
channels that differ on the vision tokens, so a section read from the wrong
channel shows.  Weights come from JAX's initializer through
``models/convert``; the JAX flash path runs its Pallas kernel interpreted,
the port's the kernel's plain version (a CPU tensor), and no kernel
launches.  Tolerances, relative to the tensor's max-abs:

- fp32: prefill hidden, caches, decode logits and the forward 1e-4
  (readings at most 5.3e-6); the gradients 3e-4 (readings up to 1.1e-4:
  the smoke config's high gain, below);
  the train step's loss 1e-5 relative and grad norm 5e-5, the update 1e-3
  where JAX's gradient keeps clear of 0 (``_clear_of_zero``);
- bf16: prefill hidden and decode logits 6e-2.  The smoke config has a
  high gain (the stacked fan-in rule gives every layer weight std
  1/sqrt(2), and scores reach about 30), so each framework's bf16 prefill
  lies 0.20 of max-abs from the fp32 one of the same weights; the two
  round their bf16 products at other places and part by up to 2.9e-2 with
  the vision prefix (1.3e-2 without), past the families' 3e-2 of
  tests/test_torch_lm_families.py.  Greedy tokens equal in each row up to
  the first step where JAX's top-2 logit margin is within the bound of
  its max-abs (one row's first margin is 1.5e-2: there either token is
  the same model's answer); the train step's loss 1e-3 relative (readings
  6e-5) and grad norm 2e-2 (both frameworks' bf16 norms, 3.09-3.17, lie
  27% above the fp32 one, 2.44, and 0.67% apart);
- decode against forward in the port, fp32: 1e-4, the forward carrying
  the prompt's grid ids and then kv_len on every channel for the decoded
  tokens (JAX's decode rule); readings 0.0 (the CPU's sums run in the
  same order both ways); the same step from a prefill with the M-RoPE
  sections swapped reads 0.10.
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
from repro_torch.launch.serve import stub_inputs
from repro_torch.launch.train import main as train_main
from repro_torch.models.convert import (from_jax_params, from_jax_state,
                                        named_arrays, to_jax_tree)
from repro_torch.models.layers import flatten
from repro_torch.models.model_zoo import build
from repro_torch.models.transformer import Transformer, model_table
from repro_torch.optim import adamw as TA
from repro_torch.train.serve_step import greedy_generate
from repro_torch.train.train_step import (compute_model, loss_fn,
                                          make_train_step, value_and_grad)
from _torch_vlm_encdec_cases import (decode_positions, decode_vs_forward,
                                     grid_positions, sections_swapped)
from test_torch_lm_families import _clear_of_zero, _f32, _rel, _tree_by_path

ARCH = "qwen2-vl-2b"
IMPLS = ("xla", "flash")
B, S, STEPS = 2, 21, 6
NV, GRID_W = 8, 4
MAX_LEN = S + STEPS + 1
RTOL = {"f32": 1e-4, "bf16": 6e-2}
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
_rng = np.random.default_rng(41)
TOKENS = _rng.integers(0, 512, (B, S))
VISION = _rng.standard_normal((B, NV, 64)).astype(np.float32)
POSITIONS = grid_positions(B, S, NV, GRID_W)


def _cfgs(impl="xla"):
    return (dataclasses.replace(jax_get_config(ARCH, smoke=True),
                                attn_impl=impl),
            dataclasses.replace(get_config(ARCH, smoke=True),
                                attn_impl=impl))


def _models(impl, dt, seed=0):
    """(JAX api, JAX params in ``dt``, the port's model from them)."""
    jcfg, cfg = _cfgs(impl)
    api = jax_build(jcfg)
    params = api.init(jax.random.PRNGKey(seed), DT[dt][0])
    model = from_jax_params(cfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    return api, params, model


def _jax_batch(dt, tokens=TOKENS, positions=POSITIONS, vision=VISION):
    return {"tokens": jnp.asarray(tokens), "positions": jnp.asarray(positions),
            "vision_embeds": jnp.asarray(vision, DT[dt][0])}


def _port_inputs(dt, positions=POSITIONS, vision=VISION):
    return {"positions": torch.as_tensor(positions),
            "vision_embeds": torch.as_tensor(vision).to(DT[dt][1])}


# -- configs, tables, positions ------------------------------------------------

def test_config_is_a_copy_of_jax():
    for smoke in (False, True):
        j, t = jax_get_config(ARCH, smoke=smoke), get_config(ARCH,
                                                             smoke=smoke)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (j.padded_vocab, j.param_count()) == (t.padded_vocab,
                                                     t.param_count())
    assert ARCH in list_archs()
    full = get_config(ARCH)
    assert abs(full.param_count() - 1777.03e6) < 0.05e6
    assert (full.family, full.m_rope_sections, full.n_vision_tokens) == (
        "vlm", (16, 24, 24), 1024)


def test_tables_and_initializer_follow_jax():
    """The table is the dense one (JAX's ``model_table`` for vlm): the
    same paths, shapes and rules; the initializer's std follows them."""
    jcfg, cfg = _cfgs()
    jt = dict(jax_flatten(JT.model_table(jcfg)))
    tt = dict(flatten(model_table(cfg)))
    assert list(jt) == list(tt)
    for path, pd in tt.items():
        assert pd.shape == jt[path].shape and pd.scale == jt[path].scale
    model = build(cfg, device="cpu", dtype=torch.float32,
                  generator=torch.Generator().manual_seed(1))
    tp = _tree_by_path(to_jax_tree(cfg, dict(model.named_parameters())))
    for path, pd in tt.items():
        ta = tp[path]
        if pd.scale in ("one", "zero"):
            assert (ta == (1.0 if pd.scale == "one" else 0.0)).all(), path
            continue
        want = (1 / np.sqrt(pd.shape[0]) if pd.scale == "fan_in"
                else float(pd.scale))
        err = 6 * want / np.sqrt(2 * ta.size)   # 6 sigma of a sample std
        assert abs(ta.std() - want) <= err + 0.01 * want, (path, ta.std())


def test_cache_layout_is_jax():
    jcfg, cfg = _cfgs()
    model = build(cfg, device="cpu", dtype=torch.bfloat16)
    want = _tree_by_path(JT.cache_shapes(jcfg, B, MAX_LEN, jnp.bfloat16))
    got = dict(flatten(model.cache_shapes(B, MAX_LEN)))
    assert set(got) == set(want)
    for path, (shape, dtype) in got.items():
        assert shape == tuple(want[path].shape) and dtype == torch.bfloat16
    assert model.cache_dims() == JT.cache_dims(jcfg)


def test_default_positions_are_jax():
    """(3, B, S) arange on every channel, as JAX's ``_default_positions``."""
    jcfg, cfg = _cfgs()
    model = Transformer(cfg, device="cpu")
    got = model._default_positions(torch.as_tensor(TOKENS))
    want = JT._default_positions(jcfg, jnp.asarray(TOKENS))
    assert got.shape == (3, B, S)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_grid_positions_follow_qwen2_vl():
    pos = grid_positions(1, 1030, 1024, 32)
    assert pos.shape == (3, 1, 1030)
    assert pos[:, 0, 33].tolist() == [0, 1, 1]       # vision token 33
    assert pos[:, 0, 1023].tolist() == [0, 31, 31]
    assert pos[:, 0, 1024].tolist() == [32, 32, 32]  # the first text token
    assert pos[:, 0, 1029].tolist() == [37, 37, 37]
    ext = decode_positions(pos, 2)
    assert ext[:, 0, 1030:].tolist() == [[1030, 1031]] * 3


def test_vision_embeds_take_the_first_positions():
    _, cfg = _cfgs()
    model = build(cfg, device="cpu", dtype=torch.float32)
    x = model._embed(torch.as_tensor(TOKENS), torch.as_tensor(VISION))
    np.testing.assert_array_equal(x[:, :NV].detach().numpy(), VISION)
    np.testing.assert_array_equal(x[:, NV:].detach().numpy(),
                                  model.embed[TOKENS[:, NV:]].detach().numpy())


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(get_config(ARCH, smoke=True))


# -- serving: prefill, caches, decode ------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_cache_match_jax(impl, dt):
    api, params, model = _models(impl, dt)
    jh, jc = api.prefill(params, _jax_batch(dt), MAX_LEN)
    before = dict(_build.LAUNCHES)
    th, tc = model.prefill(torch.as_tensor(TOKENS), MAX_LEN,
                           **_port_inputs(dt))
    assert dict(_build.LAUNCHES) == before
    assert th.shape == (B, model.cfg.d_model) and th.dtype == DT[dt][1]
    jleaves = _tree_by_path(jc)
    for path, t in flatten(tc):
        assert tuple(t.shape) == tuple(jleaves[path].shape), path
        if dt == "f32":
            assert _rel(t, jleaves[path]) <= 1e-4, path
    assert _rel(th, jh) <= RTOL[dt]


def _assert_greedy_equal(got, want, jax_logits, rtol):
    """(B, steps) tokens equal in each row up to its first step where JAX's
    top-2 logit margin is within ``rtol`` of its max-abs logit; at least
    one token compared."""
    compared = 0
    for b in range(got.shape[0]):
        for i, logits in enumerate(jax_logits):
            top = np.sort(_f32(logits[b]))[::-1]
            if top[0] - top[1] <= rtol * np.abs(top).max():
                break
            assert got[b, i] == want[b, i], (b, i)
            compared += 1
    assert compared > 0


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_decode_and_greedy_tokens_match_jax(impl, dt):
    """JAX's greedy loop (its prefill, then ``decode_step`` jitted with the
    cache fill traced) against the port's ``greedy_generate``; then the
    port's decode logits, fed JAX's tokens, step by step."""
    api, params, model = _models(impl, dt)
    jh, jc = jax.jit(api.prefill, static_argnums=2)(params, _jax_batch(dt),
                                                    MAX_LEN)
    jdecode = jax.jit(api.decode_step)
    first = JT.mask_pad_logits(JT.logits_from_hidden(params, jh[:, None]),
                               api.cfg)[:, 0]
    jt, jlogits = [np.asarray(jnp.argmax(first, -1))], [first]
    for i in range(STEPS - 1):
        jl, jc = jdecode(params, jnp.asarray(jt[-1]), jc, S + i)
        jlogits.append(jl)
        jt.append(np.asarray(jnp.argmax(jl, -1)))
    jt = np.stack(jt, axis=1)
    tt = greedy_generate(model, {"tokens": torch.as_tensor(TOKENS),
                                 **_port_inputs(dt)},
                         steps=STEPS, max_len=MAX_LEN)
    _assert_greedy_equal(tt.numpy(), jt, jlogits, RTOL[dt])
    _, tc = model.prefill(torch.as_tensor(TOKENS), MAX_LEN,
                          **_port_inputs(dt))
    for i, jl in enumerate(jlogits[1:]):
        tl, tc = model.decode_step(torch.as_tensor(jt[:, i]), tc, S + i)
        assert tl.dtype == torch.float32
        assert _rel(tl, jl) <= RTOL[dt], i


def _decode_vs_forward(model, tokens, prefill_model=None):
    """Per step: the decode logits' distance from the forward's over the
    tokens so far (grid ids, then kv_len on every channel), fed
    ``tokens[:, S:]``; the prefill on ``prefill_model`` where given (a
    planted fault)."""
    return decode_vs_forward(
        model, tokens[:, :S], tokens.shape[1] - S,
        {"vision_embeds": torch.as_tensor(VISION)},
        torch.as_tensor(POSITIONS), tokens=tokens[:, S:],
        prefill_model=prefill_model)["errs"]


def test_decode_matches_forward_in_the_port():
    _, cfg = _cfgs()
    model = build(cfg, device="cpu", dtype=torch.float32,
                  generator=torch.Generator().manual_seed(4))
    tokens = torch.as_tensor(np.random.default_rng(60).integers(
        0, cfg.vocab_size, (B, S + STEPS)))
    assert max(_decode_vs_forward(model, tokens)) <= 1e-4


def test_decode_against_forward_catches_swapped_sections():
    """The check's reach: a prefill whose M-RoPE sections are swapped
    (``sections_swapped``) keys the grid tokens' cache otherwise, and the
    first decode step's logits leave the forward's by more than 1e-4."""
    _, cfg = _cfgs()
    model = build(cfg, device="cpu", dtype=torch.float32,
                  generator=torch.Generator().manual_seed(4))
    bad = Transformer(dataclasses.replace(
        cfg, m_rope_sections=sections_swapped(cfg.m_rope_sections)),
        device="cpu")
    bad.load_state_dict(model.state_dict())
    tokens = torch.as_tensor(np.random.default_rng(60).integers(
        0, cfg.vocab_size, (B, S + 1)))
    assert _decode_vs_forward(model, tokens, prefill_model=bad)[0] > 1e-4


# -- training ------------------------------------------------------------------

def _train_batches(cfg, dt):
    """JAX's and the port's batch: token_batch's tokens and labels, the
    vision prefix and the grid ids."""
    jb = {**jax_token_batch(JaxDataConfig(cfg.vocab_size, S, B), 0),
          **{k: v for k, v in _jax_batch(dt).items() if k != "tokens"}}
    tb = {**token_batch(DataConfig(cfg.vocab_size, S, B), 0, device="cpu"),
          **_port_inputs(dt)}
    return jb, tb


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_and_grads_match_jax(impl):
    """The train-mode forward (remat on) and the gradients of the LM loss
    over every position, vision positions included, fp32, against jax.grad
    of JAX's ``loss_fn``."""
    api, params, model = _models(impl, "f32")
    cfg = model.cfg
    jb, tb = _train_batches(cfg, "f32")
    jhidden, _ = jax.jit(api.forward)(params, jb)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(api, p, jb, None, jnp.float32),
        has_aux=True))(params)
    with torch.no_grad():
        hidden, aux = model(tb["tokens"], tb["positions"],
                            vision_embeds=tb["vision_embeds"])
    assert _rel(hidden, jhidden) <= 1e-4 and float(aux) == 0.0
    loss, _ = loss_fn(model, tb)
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) / float(jloss) - 1) <= 1e-5
    want = named_arrays(cfg, jax.tree.map(np.asarray, jg))
    for name, g in zip(names, grads):
        assert _rel(g, want[name]) <= 3e-4, name


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_train_step_matches_jax(impl, dt):
    """One train step of JAX's (``jax.value_and_grad`` of its ``loss_fn``,
    then ``apply_update``, each jitted) and the port's from the same
    JAX-initialised fp32 state and batch."""
    jd, td = DT[dt]
    jcfg, cfg = _cfgs(impl)
    api = jax_build(jcfg)
    jstate = JA.init_state(api.init(jax.random.PRNGKey(0), jnp.float32))
    np_state = jax.tree.map(np.asarray, jstate)
    p0 = np_state["params"]
    model = from_jax_params(cfg, p0, device="cpu", dtype=torch.float32)
    tstate = from_jax_state(model, np_state)
    opt = dict(total_steps=10, warmup_steps=2)
    jb, tb = _train_batches(cfg, dt)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(api, p, jb, None, jd), has_aux=True))(
            jstate["params"])
    jstate, jm = jax.jit(JA.apply_update, static_argnums=2)(
        jstate, jg, JA.AdamWConfig(**opt))
    jm["loss"] = jloss
    _, _, tg = value_and_grad(compute_model(model, td), tstate["params"], tb)
    assert all(g.dtype == td for g in tg.values())
    before = dict(_build.LAUNCHES)
    tstate, tm = make_train_step(model, TA.AdamWConfig(**opt), td)(tstate,
                                                                    tb)
    assert dict(_build.LAUNCHES) == before
    assert int(tstate["step"]) == 1 and float(tm["lr"]) == float(jm["lr"])
    tol = ({"loss": 1e-5, "grad_norm": 5e-5} if dt == "f32" else
           {"loss": 1e-3, "grad_norm": 2e-2})
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


def test_zero_vision_stub_overflows_the_gradients_in_both_packages():
    """A fault of the reference, recorded (ROADMAP §3): JAX's launchers feed
    zero vision embeddings, so the vision rows of the residual stay exactly
    zero through every layer, and rms_norm's derivative at a zero row is
    rsqrt(eps) (316 at 1e-5).  Those rows' gradient grows by that gain at
    each norm, carries no parameter gradient while finite (their
    activations are zero), and overflows at depth: at 16 layers of the
    smoke config both packages' bf16 grad norms are NaN (at 12 they are
    3.09 and 3.23, finite), while the loss stays finite; vision embeddings
    drawn at the token embeddings' scale (std 1) keep them finite.  On the
    card qwen2-vl-2b's 28 layers overflow the same way (PERF.md §6, PR 25),
    so chip_smoke.py phase 30 trains on drawn embeddings."""
    jcfg, cfg = (dataclasses.replace(c, n_layers=16) for c in _cfgs())
    api = jax_build(jcfg)
    params = api.init(jax.random.PRNGKey(0), jnp.float32)
    model = from_jax_params(cfg, jax.tree.map(np.asarray, params),
                            device="cpu", dtype=torch.bfloat16)
    for vision, finite in ((np.zeros((B, NV, 64), np.float32), False),
                           (VISION, True)):
        jb = {**jax_token_batch(JaxDataConfig(cfg.vocab_size, S, B), 0),
              "vision_embeds": jnp.asarray(vision, jnp.bfloat16)}
        (jloss, _), jg = jax.jit(jax.value_and_grad(
            lambda p: jax_loss_fn(api, p, jb, None, jnp.bfloat16),
            has_aux=True))(params)
        jnorm = float(JA.global_norm(jg))
        tb = {**token_batch(DataConfig(cfg.vocab_size, S, B), 0,
                            device="cpu"),
              "vision_embeds": torch.as_tensor(vision).to(torch.bfloat16)}
        loss, _ = loss_fn(model, tb)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        norm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))
        assert np.isfinite(float(jloss)) and np.isfinite(float(
            loss.detach()))
        assert np.isfinite(jnorm) == np.isfinite(norm) == finite, (jnorm,
                                                                   norm)


# -- the launchers -------------------------------------------------------------

def test_stub_inputs_are_jax_launchers():
    """Zeros in the compute type, min(n_vision_tokens, S) rows (JAX's
    launch/serve.py:46-48 and launch/train.py:57-60)."""
    _, cfg = _cfgs()
    for seq, rows in ((32, NV), (5, 5)):
        got = stub_inputs(cfg, 3, seq, dtype=torch.bfloat16, device="cpu")
        assert list(got) == ["vision_embeds"]
        ve = got["vision_embeds"]
        assert ve.shape == (3, rows, cfg.d_model)
        assert ve.dtype == torch.bfloat16 and not ve.any()


def test_serve_cli_on_the_cpu(capsys):
    assert serve_main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--dtype", "float32", "--batch", "2",
                       "--prompt-len", "19", "--tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "prefill 2x19" in out and "ms/token" in out and "host" in out
    assert "kernel launches {}" in out


def test_train_cli_on_the_cpu(capsys, tmp_path):
    assert train_main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "2", "--global-batch", "2",
                       "--seq-len", "16",
                       "--checkpoint-dir", str(tmp_path / "ckpt")]) == 0
    out = capsys.readouterr().out
    assert "step     2 loss=" in out and "tok/s" in out
    assert "timed by host" in out and "kernel launches {}" in out
