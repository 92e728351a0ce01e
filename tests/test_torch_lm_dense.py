"""The dense family's last three archs (nemotron-4-15b: squared ReLU, an
ungated MLP, GQA 2:1 in its smoke config; glm4-9b: SwiGLU, GQA 2:1;
phi3-medium-14b: SwiGLU, 5 heads on 5, the ``sp`` profile carried as data)
against the JAX package on the CPU, on their smoke configs: the configs and
tables, prefill and its cache, decode logits and greedy tokens in fp32 and
bf16 with both ``attn_impl`` values, one fp32 train step from a JAX train
state, and both launchers.

Weights come from JAX's initializer through ``models/convert``; prompts and
batches are numpy from a seed.  The JAX flash path runs its Pallas kernel
interpreted, as the JAX tests do; the port's runs the kernels' plain
versions (CPU tensors), and no kernel launches.  Tolerances, relative to
the tensor's max-abs, are test_torch_lm.py's and
test_torch_lm_families.py's for the dense family:

- fp32: prefill hidden, caches and decode logits 1e-4 (the same arithmetic
  summed in another order); the train step's loss and nll 1e-5 relative,
  its grad norm 5e-5 and every gradient leaf 3e-4, the bounds of
  test_torch_lm_families.py: against a float64 run of the port (its fp32
  LM head aside) JAX's fp32 gradient leaves read up to 1.6e-4 and the
  port's 1.9e-4 (phi3's attn_norm, a sum over every position), their grad
  norms 7.8e-5 and 9.8e-5, and the two packages 1.2e-4 and 2.4e-5 apart;
  the update p_1 - p_0 1e-3 where JAX's gradient keeps clear of 0
  (``_clear_of_zero``: AdamW's first step is about lr * sign(g));
- bf16: prefill hidden and decode logits 3e-2 (the frameworks round their
  bf16 products at other places), or 3 times JAX's own bf16 rounding
  where that is larger: JAX's bf16 run against its fp32 run of the same
  (bf16) weights.  phi3-medium-14b's flash route reads 8.7e-2 at the
  last prompt position of one row, where JAX's bf16 run lies 3.4e-2 from
  its fp32 run (its other positions within 4.6e-2; its attention is
  JAX's bit for bit on the same operands, so it is the rounding of the
  other products, amplified at random init);
- greedy tokens equal in each row up to its first step where JAX's top-2
  logit margin lies within the prefill hidden's bound of their max-abs
  (test_torch_lm_vlm.py's rule: glm4-9b's bf16 smoke model meets such a
  near-tie at its second token, phi3's flash route at its first).
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
from repro_torch.models.transformer import model_table
from repro_torch.optim import adamw as TA
from repro_torch.train.serve_step import greedy_generate
from repro_torch.train.train_step import make_train_step, value_and_grad
from test_torch_lm_families import (DT, _cfgs, _clear_of_zero, _f32, _rel,
                                    _tree_by_path)
from test_torch_lm_vlm import _assert_greedy_equal

ARCHS = ("nemotron-4-15b", "glm4-9b", "phi3-medium-14b")
CASES = [(a, i) for a in ARCHS for i in ("xla", "flash")]
B, S, STEPS = 2, 21, 5
MAX_LEN = S + STEPS + 1
TOKENS = np.random.default_rng(26).integers(0, 512, (B, S))
# Parameters of the full configs (untied embed and head; ModelConfig's
# param_count, JAX's numbers), and their attention groups.
FULL = {"nemotron-4-15b": (15_628_376_064, 48, 8, "relu2", False, "tp"),
        "glm4-9b": (9_399_767_040, 32, 2, "silu", True, "tp"),
        "phi3-medium-14b": (14_659_507_200, 40, 10, "silu", True, "sp")}


def _models(arch, impl, dt, seed=0):
    """(JAX api, JAX params in ``dt``, the port's model from them)."""
    from repro.models.model_zoo import build as jax_build
    jcfg, cfg = _cfgs(arch, impl)
    api = jax_build(jcfg)
    params = api.init(jax.random.PRNGKey(seed), DT[dt][0])
    model = from_jax_params(cfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    return api, params, model


# -- configs and tables --------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_are_jax_and_their_sizes(arch):
    assert arch in list_archs()
    for smoke in (False, True):
        j, t = jax_get_config(arch, smoke=smoke), get_config(arch,
                                                             smoke=smoke)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert t.family == "dense"
    full = get_config(arch)
    n, heads, kv, act, gated, profile = FULL[arch]
    assert full.param_count() == n
    assert (full.n_heads, full.n_kv_heads, full.head_dim) == (heads, kv, 128)
    assert (full.activation, full.gated_mlp, full.sharding_profile) == (
        act, gated, profile)


@pytest.mark.parametrize("arch", ARCHS)
def test_tables_follow_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jt = dict(jax_flatten(JT.model_table(jcfg)))
    tt = dict(flatten(model_table(cfg)))
    assert list(jt) == list(tt)
    for path, pd in tt.items():
        assert pd.shape == jt[path].shape and pd.scale == jt[path].scale
    # nemotron's MLP is ungated: no gate leaf.
    assert (("layers", "mlp", "gate") in tt) == cfg.gated_mlp


# -- serving -------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch,impl", CASES)
def test_prefill_decode_and_greedy_tokens_match_jax(arch, impl, dt):
    """Prefill and its cache, JAX's greedy loop (its decode jitted) against
    the port's ``greedy_generate``, then the port's decode logits fed JAX's
    tokens step by step."""
    api, params, model = _models(arch, impl, dt)
    prefill = jax.jit(api.prefill, static_argnums=2)
    jh, jc = prefill(params, {"tokens": jnp.asarray(TOKENS)}, MAX_LEN)
    if dt == "f32":
        def tol(got, want, f32):
            return 1e-4
    else:
        # JAX's fp32 run of the same bf16 weights: its bf16 rounding noise.
        params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        jh32, jc32 = prefill(params32, {"tokens": jnp.asarray(TOKENS)},
                             MAX_LEN)

        def tol(got, want, f32):
            return max(3e-2, 3 * _rel(want, f32))
    before = dict(_build.LAUNCHES)
    th, tc = model.prefill(torch.as_tensor(TOKENS), MAX_LEN)
    assert th.shape == (B, model.cfg.d_model) and th.dtype == DT[dt][1]
    hidden_tol = tol(th, jh, None if dt == "f32" else jh32)
    assert _rel(th, jh) <= hidden_tol
    for path, t in flatten(tc):
        j = _tree_by_path(jc)[path]
        assert tuple(t.shape) == tuple(j.shape), path
        if dt == "f32":
            assert _rel(t, j) <= 1e-4, path
    jdecode = jax.jit(api.decode_step)
    first = JT.mask_pad_logits(JT.logits_from_hidden(params, jh[:, None]),
                               api.cfg)[:, 0]
    jt, jlogits = [np.asarray(jnp.argmax(first, -1))], [first]
    for i in range(STEPS - 1):
        jl, jc = jdecode(params, jnp.asarray(jt[-1]), jc, S + i)
        jlogits.append(jl)
        jt.append(np.asarray(jnp.argmax(jl, -1)))
    jt = np.stack(jt, axis=1)
    tt = greedy_generate(model, {"tokens": torch.as_tensor(TOKENS)},
                         steps=STEPS, max_len=MAX_LEN)
    _assert_greedy_equal(tt.numpy(), jt, jlogits, hidden_tol)
    for i, jl in enumerate(jlogits[1:]):
        tl, tc = model.decode_step(torch.as_tensor(jt[:, i]), tc, S + i)
        assert tl.dtype == torch.float32
        jl32 = None
        if dt == "bf16":
            jl32, jc32 = jdecode(params32, jnp.asarray(jt[:, i]), jc32,
                                 S + i)
        assert _rel(tl, jl) <= tol(tl, jl, jl32), i
    assert dict(_build.LAUNCHES) == before   # the CPU runs no kernel


# -- training ------------------------------------------------------------------

@pytest.mark.parametrize("arch,impl", CASES)
def test_fp32_train_step_matches_jax(arch, impl):
    """One fp32 train step of JAX's (``jax.value_and_grad`` of its
    ``loss_fn``, then ``apply_update``, each jitted) and the port's from the
    same JAX-initialised state (``from_jax_state``) and batch."""
    from repro.models.model_zoo import build as jax_build
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
    (jloss, jparts), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(api, p, jb, None, jnp.float32),
        has_aux=True))(jstate["params"])
    jstate, jm = jax.jit(JA.apply_update, static_argnums=2)(
        jstate, jg, JA.AdamWConfig(**opt))
    jm = {**jm, "loss": jloss, "nll": jparts["nll"]}
    _, _, tg = value_and_grad(model, tstate["params"], tb)
    grads = to_jax_tree(cfg, tg)
    for path, a in _tree_by_path(jg).items():
        assert _rel(_tree_by_path(grads)[path], a) <= 3e-4, path
    before = dict(_build.LAUNCHES)
    tstate, tm = make_train_step(model, TA.AdamWConfig(**opt),
                                 torch.float32)(tstate, tb)
    assert dict(_build.LAUNCHES) == before
    assert int(tstate["step"]) == 1 and float(tm["lr"]) == float(jm["lr"])
    for key, t in (("loss", 1e-5), ("nll", 1e-5), ("grad_norm", 5e-5)):
        assert abs(float(tm[key]) / float(jm[key]) - 1) <= t, key
    ours = to_jax_tree(cfg, tstate["params"])
    starts, ours_by, jgrads, tgrads = (_tree_by_path(t) for t in (
        p0, ours, jg, grads))
    compared = 0
    for path, a in _tree_by_path(jstate["params"]).items():
        mask = _clear_of_zero(jgrads[path], tgrads[path])
        want, got = _f32(a) - starts[path], ours_by[path] - starts[path]
        if mask.any():
            compared += int(mask.sum())
            err = np.abs(got - want)[mask].max() / np.abs(want).max()
            assert err <= 1e-3, (path, err)
    assert compared >= 0.1 * sum(np.size(p) for p in jax.tree.leaves(p0))
    np.testing.assert_array_equal(model.embed.detach().numpy(),
                                  named_arrays(cfg, ours)["embed"])


# -- the launchers -------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_and_train_clis_on_the_cpu(arch, capsys, tmp_path):
    assert serve_main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--dtype", "float32", "--batch", "2",
                       "--prompt-len", "19", "--tokens", "4"]) == 0
    assert train_main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", "2", "--global-batch", "2",
                       "--seq-len", "16",
                       "--checkpoint-dir", str(tmp_path / "ckpt")]) == 0
    out = capsys.readouterr().out
    assert "prefill 2x19" in out and "ms/token" in out
    assert "step     2 loss=" in out and "kernel launches {}" in out
    assert "checkpoint save step 2" in out
