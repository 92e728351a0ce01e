"""The port's training slice (qwen3-0.6b's smoke config) against the JAX
package on the CPU: the synthetic batches, the chunked cross-entropy, AdamW
and its schedule, the remat groups, and three train steps from one
JAX-initialised fp32 state with both ``attn_impl`` values, in fp32 and bf16
compute.

The JAX flash path runs its Pallas kernels interpreted, as the JAX tests do;
the port's runs the kernels' plain versions (CPU tensors).  Tolerances,
each relative to the tensor's max-abs unless said otherwise:

- token batches: bit-equal;
- chunked_xent: value 1e-6 relative; grads 1e-5 in fp32, 2e-2 in bf16 (JAX
  rounds the bf16 head's and hidden's grads where they form, the port once
  after the fp32 sum over chunks);
- AdamW over 5 steps: params, m, v and lr within 1e-6 relative;
- the train step in fp32 compute: loss, nll and grad norm per step within
  1e-5 relative, every grad leaf within 1e-4 (readings: 1e-7, 3e-7, 2.3e-6);
- in bf16 compute (the two frameworks round bf16 at other places): loss
  within 1e-3 relative, grad norm 2e-3, grad leaves 6e-2 (readings: 1.8e-4,
  3.6e-4, 3.1e-2);
- params after the 3 steps: the update p_3 - p_0 within 1e-3 of its
  max-abs in fp32 and 1e-1 in bf16, compared only where, at every step,
  JAX's |g| stayed above 1e-3 of its leaf's max-abs and above 4 times the
  leaf's largest |g_port - g_jax| (the bf16 grads differ by up to 3% of
  max-abs), or g was exactly 0 on both sides (embedding rows of tokens not
  in the batch); in bf16 that leaves no element of lm_head, whose large
  grads move with the labels.  AdamW's first step is lr * g / (|g| + eps), about +-lr
  whatever |g| is, so a grad within rounding of 0 can flip an element's
  update by 2 lr.
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
from repro.models.model_zoo import build as jax_build
from repro.optim import adamw as JA
from repro.train.loss import chunked_xent as jax_chunked_xent
from repro.train.train_step import loss_fn as jax_loss_fn
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.data.synthetic import DataConfig, batches, token_batch
from repro_torch.kernels import _build
from repro_torch.launch.train import main as train_main
from repro_torch.models.convert import (from_jax_params, from_jax_state,
                                        named_arrays, to_jax_tree)
from repro_torch.models.model_zoo import build
from repro_torch.optim import adamw as TA
from repro_torch.train.loss import chunk_count, chunked_xent
from repro_torch.train.train_step import (compute_model, loss_fn,
                                          make_train_step, value_and_grad)

ARCH = "qwen3-0.6b"
B, S = 2, 24
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
_rng = np.random.default_rng(15)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(a, b):
    a, b = _f32(a), _f32(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _cfgs(impl):
    return (dataclasses.replace(jax_get_config(ARCH, smoke=True),
                                attn_impl=impl),
            dataclasses.replace(get_config(ARCH, smoke=True),
                                attn_impl=impl))


# -- data ----------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,n_hosts,host_id",
                         [(1234, 0, 1, 0), (1234, 7, 1, 0), (5, 3, 2, 1),
                          (0, 1000, 4, 2)])
def test_token_batch_is_jax_bit_for_bit(seed, step, n_hosts, host_id):
    j = jax_token_batch(JaxDataConfig(512, 33, 8, seed), step, n_hosts,
                        host_id)
    t = token_batch(DataConfig(512, 33, 8, seed), step, n_hosts, host_id,
                    device="cpu")
    for name in ("tokens", "labels"):
        assert t[name].dtype == torch.int32
        np.testing.assert_array_equal(t[name].numpy(), np.asarray(j[name]))
    got = list(batches(DataConfig(512, 33, 8, seed), 2, n_hosts, host_id,
                       device="cpu"))
    np.testing.assert_array_equal(got[1]["tokens"].numpy(), np.asarray(
        jax_token_batch(JaxDataConfig(512, 33, 8, seed), 1, n_hosts,
                        host_id)["tokens"]))


# -- the loss --------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n_chunks,valid_vocab", [(1, None), (3, None),
                                                  (8, None), (8, 500)])
def test_chunked_xent_matches_jax(n_chunks, valid_vocab, dt):
    jd, td = DT[dt]
    V, D, Bx, Sx = 512, 32, 2, 15        # 30 tokens: 8 chunks -> 6
    head = (_rng.standard_normal((V, D)) / np.sqrt(D)).astype(np.float32)
    hidden = _rng.standard_normal((Bx, Sx, D)).astype(np.float32)
    labels = _rng.integers(0, valid_vocab or V, (Bx, Sx))
    jf = lambda w, h: jax_chunked_xent(w, h, jnp.asarray(labels),
                                       n_chunks=n_chunks,
                                       valid_vocab=valid_vocab)
    jv, jg = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(head, jd), jnp.asarray(hidden, jd))
    w = torch.from_numpy(head).to(td).requires_grad_()
    h = torch.from_numpy(hidden).to(td).requires_grad_()
    tv = chunked_xent(w, h, torch.from_numpy(labels), n_chunks=n_chunks,
                      valid_vocab=valid_vocab)
    tg = torch.autograd.grad(tv, (w, h))
    assert tv.dtype == torch.float32 and tv.shape == ()
    assert abs(float(tv) / float(jv) - 1) <= 1e-6
    for a, b in zip(tg, jg):
        assert a.dtype == td
        assert _rel(a, b) <= (1e-5 if dt == "f32" else 2e-2)


def test_chunk_rule_and_padded_vocab_mask():
    assert [chunk_count(t, 8) for t in (64, 30, 7, 1)] == [8, 6, 7, 1]
    # A padded row with the largest logit must not move the loss.
    w = torch.zeros(8, 4)
    w[7] = 100.0
    h = torch.ones(1, 3, 4)
    y = torch.zeros(1, 3, dtype=torch.long)
    masked = chunked_xent(w, h, y, n_chunks=3, valid_vocab=7)
    assert abs(float(masked) - np.log(7)) <= 1e-6


# -- AdamW -----------------------------------------------------------------------

def test_schedule_matches_jax():
    for cfg in (TA.AdamWConfig(warmup_steps=3, total_steps=10),
                TA.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=5,
                               min_lr_ratio=0.0)):
        jcfg = JA.AdamWConfig(**dataclasses.asdict(cfg))
        for step in range(13):
            t = TA.schedule(cfg, step)
            j = JA.schedule(jcfg, jnp.asarray(step, jnp.int32))
            assert t.dtype == torch.float32
            assert abs(float(t) - float(j)) <= 1e-6 * cfg.lr, step


def test_adamw_matches_jax_over_five_steps():
    """Through warmup and decay, with the clip active on step 3."""
    shapes = {"a": (6, 5), "b": (7,), "c": (3, 4, 2)}
    params = {n: _rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    cfg = TA.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    jstate = JA.init_state({n: jnp.asarray(p) for n, p in params.items()})
    tstate = TA.init_state({n: torch.from_numpy(p.copy())
                            for n, p in params.items()})
    clipped = 0
    for step in range(5):
        scale = 30.0 if step == 2 else 0.05
        grads = {n: (scale * _rng.standard_normal(s)).astype(np.float32)
                 for n, s in shapes.items()}
        jstate, jm = JA.apply_update(
            jstate, {n: jnp.asarray(g) for n, g in grads.items()},
            JA.AdamWConfig(**dataclasses.asdict(cfg)))
        tstate, tm = TA.apply_update(
            tstate, {n: torch.from_numpy(g) for n, g in grads.items()}, cfg)
        clipped += float(tm["grad_norm"]) > cfg.grad_clip
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        for key in ("grad_norm", "lr"):
            assert abs(float(tm[key]) / float(jm[key]) - 1) <= 1e-6, key
        for key in ("params", "m", "v"):
            for n in shapes:
                a, b = _f32(tstate[key][n]), _f32(jstate[key][n])
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=0,
                                           err_msg=f"{key}/{n} step {step}")
    assert clipped == 1


# -- the model forward under remat -----------------------------------------------

@pytest.mark.parametrize("remat_group", [2, 3])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_remat_gives_equal_loss_and_grads(impl, remat_group):
    """remat_group 2 divides the smoke config's 2 layers; 3 does not, and
    falls back to one layer a group, as JAX's _run_layers does."""
    _, cfg = _cfgs(impl)
    cfg = dataclasses.replace(cfg, remat_group=remat_group)
    model = build(cfg, device="cpu", dtype=torch.float32)
    batch = token_batch(DataConfig(cfg.vocab_size, S, B), 0, device="cpu")
    out = []
    for remat in (True, False):
        loss, parts = loss_fn(model, batch, remat=remat)
        out.append((loss, torch.autograd.grad(loss, model.parameters())))
    assert float(out[0][0]) == float(out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# -- the slice end to end ----------------------------------------------------------

def _clear_of_zero(g, ours):
    """Where an update cannot flip sign: JAX's |g| above 1e-3 of the leaf's
    max-abs and above 4 times the leaf's largest |g_port - g_jax|, or g
    exactly 0 on both sides."""
    g = _f32(g)
    floor = max(1e-3 * np.abs(g).max(), 4 * np.abs(ours - g).max())
    return (np.abs(g) > floor) | ((g == 0) & (ours == 0))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_train_step_matches_jax(impl, dt):
    """Three steps of JAX's make_train_step(api, None, ...) and the port's,
    from the same JAX-initialised fp32 state and the same batches."""
    jd, td = DT[dt]
    jcfg, cfg = _cfgs(impl)
    api = jax_build(jcfg)
    jstate = JA.init_state(api.init(jax.random.PRNGKey(0), jnp.float32))
    np_state = jax.tree.map(np.asarray, jstate)
    p0 = np_state["params"]
    model = from_jax_params(cfg, p0, device="cpu", dtype=torch.float32)
    tstate = from_jax_state(model, np_state)
    opt = dict(total_steps=10, warmup_steps=2)
    jstep = jax.jit(jax_make_train_step(api, None, JA.AdamWConfig(**opt),
                                        compute_dtype=jd))
    jgrad = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(api, p, b, None, jd), has_aux=True))
    tstep = make_train_step(model, TA.AdamWConfig(**opt), td)
    compute = compute_model(model, td)
    tol = ({"loss": 1e-5, "grad_norm": 1e-5, "grad": 1e-4, "update": 1e-3}
           if dt == "f32" else
           {"loss": 1e-3, "grad_norm": 2e-3, "grad": 6e-2, "update": 1e-1})
    data = (cfg.vocab_size, S, B)
    keep = None
    before = dict(_build.LAUNCHES)
    for i in range(3):
        jb = jax_token_batch(JaxDataConfig(*data), i)
        tb = token_batch(DataConfig(*data), i, device="cpu")
        (_, _), jg = jgrad(jstate["params"], jb)
        _, _, tg = value_and_grad(compute, tstate["params"], tb)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jg),
                                jax.tree.leaves(to_jax_tree(cfg, tg))):
            assert _rel(b, a) <= tol["grad"], (i, path)
        big = jax.tree.map(_clear_of_zero, jg, to_jax_tree(cfg, tg))
        keep = big if keep is None else jax.tree.map(np.logical_and, keep,
                                                     big)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        assert int(tstate["step"]) == i + 1
        assert float(tm["lr"]) == float(jm["lr"])
        keys = ("loss", "nll", "grad_norm") if dt == "f32" else (
            "loss", "grad_norm")
        for key in keys:
            err = abs(float(tm[key]) / float(jm[key]) - 1)
            assert err <= tol.get(key, tol["loss"]), (i, key, err)
    assert dict(_build.LAUNCHES) == before   # the CPU runs no kernel
    # The update of every parameter where JAX's grad kept clear of 0.
    ours = to_jax_tree(cfg, tstate["params"])
    compared = 0
    for (path, a), b, start, mask in zip(
            jax.tree_util.tree_leaves_with_path(jstate["params"]),
            jax.tree.leaves(ours), jax.tree.leaves(p0),
            jax.tree.leaves(keep)):
        want, got = _f32(a) - start, b - start
        compared += int(mask.sum())
        if not mask.any():
            # bf16: lm_head's big grads move with the labels, and no element
            # stays clear of the bf16 noise for three steps.
            assert dt == "bf16" and path[0].key == "lm_head", path
            continue
        err = np.abs(got - want)[mask].max() / np.abs(want).max()
        assert err <= tol["update"], (path, err)
    assert compared >= 0.1 * sum(p.size for p in jax.tree.leaves(p0))
    # The model holds the updated masters (the state shares its tensors).
    np.testing.assert_array_equal(model.embed.detach().numpy(),
                                  named_arrays(cfg, ours)["embed"])


def test_train_cli_on_the_cpu(capsys, tmp_path):
    assert train_main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "2", "--global-batch", "2",
                       "--seq-len", "16",
                       "--checkpoint-dir", str(tmp_path / "ckpt")]) == 0
    out = capsys.readouterr().out
    assert "step     2 loss=" in out and "tok/s" in out
    assert "timed by host" in out and "kernel launches {}" in out
