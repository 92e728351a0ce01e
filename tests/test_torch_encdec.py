"""The port's encdec family (whisper-tiny, ``models/encdec.py``) against the
JAX package on the CPU, on its smoke config: the config, the table and
initializer, the cache layout, the sinusoid, ``encode``, ``decode_train``,
prefill and its caches, decode logits and greedy tokens with both
``attn_impl`` values (the encoder's self-attention and the decoder's
cross-attention non-causal, the cross one at Sq = the decoder's 21 tokens
and Skv = 24 frames), the train-mode forward and its gradients, one train
step from a JAX train state, decode against forward inside the port, and
both launchers.

Weights come from JAX's initializer through ``models/convert``; frames,
prompts and batches are numpy from a seed.  The JAX flash path runs its
Pallas kernel interpreted, the port's the kernel's plain version, and no
kernel launches.  Tolerances, relative to the tensor's max-abs:

- fp32: the encoder output, the decoder's hidden, caches, decode logits
  and the forward 5e-4.  The smoke model has a high gain (hidden values
  reach 270 after two layers): against a float64 run of the port on the
  same weights (xla), the fp32 forwards lie 7.3e-5 (port) and 7.8e-5
  (JAX) away, the decode logits 3.2e-5 and 2.2e-4; twice the larger,
  rounded up (readings up to 1.9e-4).  The gradients 2e-3 (JAX's
  fp32 gradients lie up to 8.0e-4 from float64's, the port's 3.9e-4); the
  train step's loss 1e-5 relative, grad norm 1e-3 (JAX's 3.7e-4 from
  float64's, the port's 1.0e-4), the update 2e-3 where JAX's gradient
  keeps clear of 0 (AdamW's eps of 1e-8 weighs against the clipped
  gradients there, so the update carries their fp32 noise; reading
  1.27e-3); greedy tokens equal;
- bf16: this model is chaotic in bf16.  Each framework's bf16 encoder
  lies 0.27 of max-abs from the fp32 run of the same (bf16) weights and
  inputs, and their bf16 gradients 0.4 to 6 times a leaf's max-abs from
  float64's (the grad norms 27.5 in JAX, 12.5 in the port, 22.08 in
  float64), while the two part by 4.3e-2 on the encoder (a one-ulp
  difference in the GELU, which the port rounds once and JAX op by op,
  amplified).  So bf16 outputs are held to the fp32 run: the port's no
  farther from it than 1.5 times JAX's, plus 1e-2; the train step's loss
  by the same rule against the fp32 loss, plus 1e-3 of it (bf16 losses
  6.2444-6.2535 against fp32's 6.2372), its grad norm not compared (as
  tests/test_torch_lm_families.py's hybrid);
- decode against forward in the port, fp32: 1e-4 (the two orders of the
  same fp32 sums; reading 4.0e-6); a prefill with cross-attention run
  causal, or with the encoder's sinusoid one position late, moves the
  first step's logits past it (readings 0.43 and 0.85).
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
from repro.models import encdec as JE
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
from repro_torch.models import encdec as TE
from repro_torch.models.convert import (from_jax_params, from_jax_state,
                                        named_arrays, to_jax_tree)
from repro_torch.models.layers import flatten
from repro_torch.models.model_zoo import build
from repro_torch.optim import adamw as TA
from repro_torch.train.serve_step import greedy_generate
from repro_torch.train.train_step import (compute_model, loss_fn,
                                          make_train_step, value_and_grad)
from _torch_vlm_encdec_cases import (cross_attention_causal,
                                     decode_vs_forward, sinusoid_shifted)
from test_torch_lm_families import _clear_of_zero, _f32, _rel, _tree_by_path
from test_torch_lm_vlm import _assert_greedy_equal

ARCH = "whisper-tiny"
IMPLS = ("xla", "flash")
B, S, STEPS = 2, 21, 6
MAX_LEN = S + STEPS + 1
RTOL = 5e-4        # fp32, of max-abs
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
_rng = np.random.default_rng(43)
TOKENS = _rng.integers(0, 512, (B, S))
FRAMES = _rng.standard_normal((B, 24, 64)).astype(np.float32)


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


def _jax_frames(dt):
    return jnp.asarray(FRAMES, DT[dt][0])


def _frames(dt):
    return torch.as_tensor(FRAMES).to(DT[dt][1])


def _fp32_twin(model):
    """The port's fp32 model holding ``model``'s (bf16) weights."""
    twin = TE.EncDec(model.cfg, device="cpu", dtype=torch.float32)
    twin.load_state_dict(model.state_dict())
    return twin


def _held(dt, port, jax_out, ref):
    """fp32: the port within RTOL of JAX.  bf16: the port no farther from
    the fp32 run ``ref`` than 1.5 times JAX's bf16 output is, plus 1e-2."""
    if dt == "f32":
        assert _rel(port, jax_out) <= RTOL
        return
    mine, theirs = _rel(port, ref), _rel(jax_out, ref)
    assert mine <= 1.5 * theirs + 1e-2, (mine, theirs)


# -- configs, tables, the sinusoid --------------------------------------------

def test_config_is_a_copy_of_jax():
    for smoke in (False, True):
        j, t = jax_get_config(ARCH, smoke=smoke), get_config(ARCH,
                                                             smoke=smoke)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (j.padded_vocab, j.param_count()) == (t.padded_vocab,
                                                     t.param_count())
    assert ARCH in list_archs()
    full = get_config(ARCH)
    assert (full.family, full.n_enc_layers, full.n_layers, full.enc_len) == (
        "encdec", 4, 4, 1500)
    n = sum(np.prod(pd.shape) for _, pd in flatten(TE.encdec_table(full)))
    assert n == 69_026_304    # dec_pos and the padded vocab in


def test_tables_and_initializer_follow_jax():
    """The table's paths, shapes and rules are JAX's ``encdec_table``; the
    stacked fan-in quirk reads the layer counts; the initializer's std
    follows the rules."""
    jcfg, cfg = _cfgs()
    jt = dict(jax_flatten(JE.encdec_table(jcfg)))
    tt = dict(flatten(TE.encdec_table(cfg)))
    assert list(jt) == list(tt)
    for path, pd in tt.items():
        assert pd.shape == jt[path].shape and pd.scale == jt[path].scale
    model = build(cfg, device="cpu", dtype=torch.float32,
                  generator=torch.Generator().manual_seed(1))
    assert isinstance(model, TE.EncDec)
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
    want = _tree_by_path(JE.encdec_cache_shapes(jcfg, B, MAX_LEN,
                                                jnp.bfloat16))
    got = dict(flatten(model.cache_shapes(B, MAX_LEN)))
    assert set(got) == set(want)
    for path, (shape, dtype) in got.items():
        assert shape == tuple(want[path].shape) and dtype == torch.bfloat16
    is_dims = lambda x: isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)
    jdims = {tuple(k.key for k in p): d for p, d in
             jax.tree_util.tree_flatten_with_path(
                 JE.encdec_cache_dims(), is_leaf=is_dims)[0]}
    assert dict(flatten(model.cache_dims())) == jdims


@pytest.mark.parametrize("length,d", [(24, 64), (1500, 384), (7, 2)])
def test_sinusoid_is_jax(length, d):
    """JAX's table, bit for bit, its max(1, d//2 - 1) divisor included."""
    np.testing.assert_array_equal(TE._sinusoid(length, d),
                                  JE._sinusoid(length, d))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(get_config(ARCH, smoke=True))


def test_transformer_refuses_the_family():
    from repro_torch.models.transformer import Transformer
    with pytest.raises(NotImplementedError, match="encdec"):
        Transformer(get_config(ARCH, smoke=True), device="cpu")


# -- encode, decode_train, prefill, decode ---------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_encode_and_decode_train_match_jax(impl, dt):
    api, params, model = _models(impl, dt)
    jcfg = api.cfg
    twin = _fp32_twin(model)
    jenc = JE.encode(jcfg, params, _jax_frames(dt))
    with torch.no_grad():
        enc = model.encode(_frames(dt))
        ref = twin.encode(_frames(dt).float())
    assert enc.dtype == DT[dt][1] and enc.shape == (B, 24, 64)
    _held(dt, enc, jenc, ref)
    # The decoder on JAX's own encoder output, so it is held alone.
    jh = JE.decode_train(jcfg, params, jnp.asarray(TOKENS), jenc)
    jenc_t = torch.from_numpy(np.array(_f32(jenc)))
    with torch.no_grad():
        th = model.decode_train(torch.as_tensor(TOKENS),
                                jenc_t.to(DT[dt][1]))
        ref = twin.decode_train(torch.as_tensor(TOKENS), jenc_t)
    _held(dt, th, jh, ref)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_cache_match_jax(impl, dt):
    api, params, model = _models(impl, dt)
    jh, jc = api.prefill(params, {"tokens": jnp.asarray(TOKENS),
                                  "enc_frames": _jax_frames(dt)}, MAX_LEN)
    before = dict(_build.LAUNCHES)
    th, tc = model.prefill(torch.as_tensor(TOKENS), MAX_LEN, _frames(dt))
    assert dict(_build.LAUNCHES) == before
    assert th.shape == (B, 64) and th.dtype == DT[dt][1]
    jleaves = _tree_by_path(jc)
    assert set(jleaves) == {p for p, _ in flatten(tc)}
    for path, t in flatten(tc):
        assert tuple(t.shape) == tuple(jleaves[path].shape), path
        if dt == "f32":
            assert _rel(t, jleaves[path]) <= RTOL, path
    ref, _ = _fp32_twin(model).prefill(torch.as_tensor(TOKENS), MAX_LEN,
                                       _frames(dt).float())
    _held(dt, th, jh, ref)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_decode_and_greedy_tokens_match_jax(impl, dt):
    """JAX's greedy loop (its prefill, then ``decode_step`` jitted with the
    cache fill traced) against the port's ``greedy_generate`` (fp32);
    then the port's decode logits and caches, fed JAX's tokens, step by
    step."""
    api, params, model = _models(impl, dt)
    batch = {"tokens": jnp.asarray(TOKENS), "enc_frames": _jax_frames(dt)}
    jh, jc = jax.jit(api.prefill, static_argnums=2)(params, batch, MAX_LEN)
    jdecode = jax.jit(api.decode_step)
    first = JT.mask_pad_logits(JT.logits_from_hidden(params, jh[:, None]),
                               api.cfg)[:, 0]
    jt, jlogits = [np.asarray(jnp.argmax(first, -1))], [first]
    for i in range(STEPS - 1):
        jl, jc = jdecode(params, jnp.asarray(jt[-1]), jc, S + i)
        jlogits.append(jl)
        jt.append(np.asarray(jnp.argmax(jl, -1)))
    jt = np.stack(jt, axis=1)
    if dt == "f32":
        tt = greedy_generate(model, {"tokens": torch.as_tensor(TOKENS),
                                     "enc_frames": _frames(dt)},
                             steps=STEPS, max_len=MAX_LEN)
        _assert_greedy_equal(tt.numpy(), jt, jlogits, RTOL)
    twin = _fp32_twin(model)
    _, tc = model.prefill(torch.as_tensor(TOKENS), MAX_LEN, _frames(dt))
    _, rc = twin.prefill(torch.as_tensor(TOKENS), MAX_LEN,
                         _frames(dt).float())
    for i, jl in enumerate(jlogits[1:]):
        tok = torch.as_tensor(jt[:, i])
        tl, tc = model.decode_step(tok, tc, S + i)
        rl, rc = twin.decode_step(tok, rc, S + i)
        assert tl.dtype == torch.float32
        V = model.cfg.vocab_size
        _held(dt, tl[:, :V], jl[:, :V], rl[:, :V])
    if dt == "f32":   # the caches after the steps
        for path, t in flatten(tc):
            assert _rel(t, _tree_by_path(jc)[path]) <= RTOL, path


def _decode_vs_forward(model, tokens, frames, fault=None):
    """Per step: the decode logits' distance from the forward's over the
    tokens so far, fed ``tokens[:, S:]``; the prefill under ``fault`` (a
    context manager) where given."""
    return decode_vs_forward(model, tokens[:, :S], tokens.shape[1] - S,
                             {"enc_frames": frames}, tokens=tokens[:, S:],
                             fault=fault)["errs"]


def _own_model():
    _, cfg = _cfgs()
    model = build(cfg, device="cpu", dtype=torch.float32,
                  generator=torch.Generator().manual_seed(4))
    rng = np.random.default_rng(60)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (B, S + STEPS)))
    frames = torch.as_tensor(rng.standard_normal((B, 24, 64))
                             .astype(np.float32))
    return model, tokens, frames


def test_decode_matches_forward_in_the_port():
    """prefill(S) then decode steps = the train-mode forward over the
    tokens so far, at the last position (JAX's test_decode_matches_forward
    with the port alone)."""
    model, tokens, frames = _own_model()
    assert max(_decode_vs_forward(model, tokens, frames)) <= 1e-4


@pytest.mark.parametrize("fault", [cross_attention_causal, sinusoid_shifted])
def test_decode_against_forward_catches_a_wrong_encoder_path(fault):
    """The check's reach: the first decode step from a prefill whose
    cross-attention ran causal (the decoder's token j sees frames 0..j),
    or whose encoder read the sinusoid one position late, is past 1e-4."""
    model, tokens, frames = _own_model()
    assert _decode_vs_forward(model, tokens[:, :S + 1], frames,
                              fault)[0] > 1e-4


# -- training ------------------------------------------------------------------

def _train_batches(cfg, dt):
    jb = {**jax_token_batch(JaxDataConfig(cfg.vocab_size, S, B), 0),
          "enc_frames": _jax_frames(dt)}
    tb = {**token_batch(DataConfig(cfg.vocab_size, S, B), 0, device="cpu"),
          "enc_frames": _frames(dt)}
    return jb, tb


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_and_grads_match_jax(impl):
    """The train-mode forward (every layer under checkpoint) and the
    gradients of the LM loss, fp32, against jax.grad of JAX's."""
    api, params, model = _models(impl, "f32")
    cfg = model.cfg
    jb, tb = _train_batches(cfg, "f32")
    jhidden, _ = jax.jit(api.forward)(params, jb)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(api, p, jb, None, jnp.float32),
        has_aux=True))(params)
    with torch.no_grad():
        hidden, aux = model(tb["tokens"], tb["enc_frames"])
    assert _rel(hidden, jhidden) <= RTOL and float(aux) == 0.0
    loss, _ = loss_fn(model, tb)
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) / float(jloss) - 1) <= 1e-5
    want = named_arrays(cfg, jax.tree.map(np.asarray, jg))
    for name, g in zip(names, grads):
        if np.abs(want[name]).max() == 0:
            assert float(g.abs().max()) == 0, name
        else:
            assert _rel(g, want[name]) <= 2e-3, name


def test_remat_gives_equal_loss_and_grads():
    """Layers under checkpoint change nothing."""
    _, cfg = _cfgs()
    model = build(cfg, device="cpu", dtype=torch.float32)
    _, tb = _train_batches(cfg, "f32")
    out = []
    for remat in (True, False):
        loss, _ = loss_fn(model, tb, remat=remat)
        out.append((loss, torch.autograd.grad(loss, model.parameters())))
    assert float(out[0][0].detach()) == float(out[1][0].detach())
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


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
    if dt == "bf16":
        with torch.no_grad():
            ref = float(loss_fn(model, _train_batches(cfg, "f32")[1])[0])
        mine, theirs = (abs(float(m["loss"]) - ref) for m in (tm, jm))
        assert mine <= 1.5 * theirs + 1e-3 * ref, (mine, theirs)
        return
    for key, t in {"loss": 1e-5, "grad_norm": 1e-3}.items():
        assert abs(float(tm[key]) / float(jm[key]) - 1) <= t, key
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
            assert err <= 2e-3, (path, err)
    assert compared >= 0.1 * sum(np.size(p) for p in jax.tree.leaves(p0))


# -- the launchers -------------------------------------------------------------

def test_stub_inputs_are_jax_launchers():
    """Zeros in the compute type, (B, enc_len, D) (JAX's launch/serve.py:43-45
    and launch/train.py:53-56)."""
    _, cfg = _cfgs()
    got = stub_inputs(cfg, 3, 16, dtype=torch.bfloat16, device="cpu")
    assert list(got) == ["enc_frames"]
    f = got["enc_frames"]
    assert f.shape == (3, 24, 64) and f.dtype == torch.bfloat16
    assert not f.any()


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
