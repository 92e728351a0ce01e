"""The port's learned-stencil solver family against the JAX package's, on the
CPU: the config, the layer, the weights bridge and the train step
(models/solver_layer.py, configs/learned_stencil.py, model_zoo.build's and
make_train_step's solver routes), plus the two small copies that came with
them (configs/jacobi.py, data/synthetic.py::stencil_tiles).

Both packages start from the same numbers: JAX's parameters go into the
port through ``convert.from_jax_solver_params``, and the batch (a hidden
kappa field's steady states, solved by JAX) is numpy from a seed.  The
forward is held to 1e-6 and the loss and gradients of a train step to 1e-4
of the largest entry.  Every solve runs on a CPU default plan cache, set per
test and restored.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.configs import JACOBI_CONFIGS as J_JACOBI
from repro.configs import get_config as jax_get_config
from repro.data.synthetic import stencil_tiles as jax_stencil_tiles
from repro.models.model_zoo import build as jax_build
from repro.models.solver_layer import solver_loss_fn as jax_solver_loss_fn
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train.train_step import init_train_state as jax_init_state
from repro.train.train_step import make_train_step as jax_make_train_step

import repro_torch.core as T
from repro_torch.configs import JACOBI_CONFIGS, get_config, list_archs
from repro_torch.data.synthetic import stencil_tiles
from repro_torch.models.convert import (from_jax_solver_params,
                                        to_jax_solver_params)
from repro_torch.models.model_zoo import build
from repro_torch.models.solver_layer import (SolverLayer, SolverLayerConfig,
                                             solver_loss_fn)
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step

ARCH = "learned-stencil"
OPT = dict(lr=1e-2, warmup_steps=5, total_steps=25, weight_decay=0.0,
           grad_clip=1.0)


@pytest.fixture(autouse=True)
def cpu_cache():
    old = T.set_default_plan_cache(T.PlanCache(device="cpu", probe=False))
    yield
    T.set_default_plan_cache(old)


def _batch(cfg, n=4, seed=0):
    """JAX's test batch (tests/test_solver_layer.py), as numpy."""
    rng = np.random.default_rng(seed)
    true_spec = J.heterogeneous_jacobi(1.0 + 9.0 * rng.random(cfg.grid))
    src = jnp.asarray(rng.standard_normal((n, *cfg.grid)), jnp.float32)
    tgt = J.implicit_solve(true_spec, jnp.zeros_like(src),
                           fields=jnp.asarray(true_spec.field_stack()),
                           source=src, backend=cfg.backend, rtol=1e-6,
                           max_iters=2 * cfg.max_iters)
    return {"source": np.asarray(src), "target": np.asarray(tgt)}


def _random_params(cfg, seed=1):
    """JAX-layout params off the uniform start (so every tap matters)."""
    rng = np.random.default_rng(seed)
    v = len(cfg.grid) * 2
    return {"taps": (0.25 + 0.02 * rng.standard_normal((v, *cfg.grid)))
            .astype(np.float32), "bc": np.float32(0.3)}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# -- config --------------------------------------------------------------------

def test_config_is_registered_equal_to_jax_and_not_an_arch():
    for smoke in (False, True):
        j, t = jax_get_config(ARCH, smoke=smoke), get_config(ARCH,
                                                             smoke=smoke)
        assert isinstance(t, SolverLayerConfig) and t.family == "solver"
        # Every field is JAX's; the provenance note drops its tracker tag.
        jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
        assert jd.pop("source").endswith(": " + td.pop("source"))
        assert jd == td
    full = get_config(ARCH)
    assert (full.grid, full.backend, full.rtol, full.max_iters) == (
        (32, 32), "conv", 1e-5, 500)
    assert ARCH not in list_archs()
    with pytest.raises(ValueError, match="differentiable"):
        SolverLayerConfig(backend="cuda_fused")


def test_jacobi_configs_and_stencil_tiles_equal_jax():
    assert list(JACOBI_CONFIGS) == list(J_JACOBI)
    for name, cfg in JACOBI_CONFIGS.items():
        j = J_JACOBI[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(j)
        assert (cfg.n_per_step, cfg.steps) == (j.n_per_step, j.steps)
    for grid, batch in (((64, 64), 2), ((10, 64, 64), 1)):
        got = list(stencil_tiles(grid, 3, seed=5, batch=batch,
                                 device="cpu"))
        want = list(jax_stencil_tiles(grid, 3, seed=5, batch=batch))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the layer -----------------------------------------------------------------

def test_build_gives_the_layer_at_jax_init():
    cfg = get_config(ARCH, smoke=True)
    model = build(cfg, device="cpu", dtype=torch.bfloat16)
    assert isinstance(model, SolverLayer) and model.cfg is cfg
    jparams = jax_build(jax_get_config(ARCH, smoke=True)).init(
        jax.random.PRNGKey(0))
    names = [n for n, _ in model.named_parameters()]
    assert names == ["taps", "bc"] == list(jparams)
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.requires_grad
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(jparams[name]))
    assert float(model.bc.detach()) == 0.0
    assert float(model.taps.detach().min()) == 0.25


def test_weights_round_trip_through_convert():
    cfg = get_config(ARCH, smoke=True)
    for params in (_random_params(cfg),
                   jax.tree.map(np.asarray, jax_build(
                       jax_get_config(ARCH, smoke=True)).init(
                           jax.random.PRNGKey(0)))):
        model = from_jax_solver_params(cfg, params, device="cpu")
        back = to_jax_solver_params(model)
        assert list(back) == ["taps", "bc"]
        for k in params:
            assert back[k].dtype == np.float32
            np.testing.assert_array_equal(back[k], params[k])
    with pytest.raises(ValueError, match="shape"):
        from_jax_solver_params(cfg, {"taps": np.zeros((4, 3, 3)),
                                     "bc": np.float32(0)}, device="cpu")


def test_forward_equals_jax_solver_forward():
    cfg = get_config(ARCH, smoke=True)
    batch = _batch(cfg, n=2)
    params = _random_params(cfg)
    model = from_jax_solver_params(cfg, params, device="cpu")
    got, aux = model(_torch_batch(batch))
    api = jax_build(jax_get_config(ARCH, smoke=True))
    want, jaux = api.forward(jax.tree.map(jnp.asarray, params),
                             jax.tree.map(jnp.asarray, batch))
    assert got.shape == batch["source"].shape and float(aux) == 0.0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)


def test_token_entry_points_raise():
    model = build(get_config(ARCH, smoke=True), device="cpu")
    for call in (lambda: model.prefill(None, 0),
                 lambda: model.decode_step(None, None, 0),
                 lambda: model.cache_shapes(1, 0)):
        with pytest.raises(NotImplementedError, match="steady states"):
            call()


# -- training --------------------------------------------------------------------

def test_train_step_loss_and_grads_equal_jax():
    cfg = get_config(ARCH, smoke=True)
    batch = _batch(cfg)
    params = _random_params(cfg)
    api = jax_build(jax_get_config(ARCH, smoke=True))
    jp = jax.tree.map(jnp.asarray, params)
    jb = jax.tree.map(jnp.asarray, batch)
    (jloss, jparts), jgrads = jax.value_and_grad(
        lambda p: jax_solver_loss_fn(api, p, jb), has_aux=True)(jp)

    model = from_jax_solver_params(cfg, params, device="cpu")
    loss, parts = solver_loss_fn(model, _torch_batch(batch))
    grads = dict(zip(("taps", "bc"), torch.autograd.grad(
        loss, [model.taps, model.bc])))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    assert float(parts["mse"].detach()) == float(loss.detach())
    for name, g in grads.items():
        want = np.asarray(jgrads[name])
        assert g.shape == want.shape
        scale = float(np.abs(want).max())
        assert float(np.abs(g.numpy() - want).max()) <= 1e-4 * scale, name

    # One step of each package's make_train_step from the same state.
    jstate = jax_init_state(api, jax.random.PRNGKey(0))
    jstate["params"] = jp
    jstate, jm = jax_make_train_step(api, None, JAdamWConfig(**OPT))(
        jstate, jb)
    state = init_train_state(model)
    step = make_train_step(model, AdamWConfig(**OPT),
                           compute_dtype=torch.bfloat16)
    state, m = step(state, _torch_batch(batch))
    assert set(m) >= {"loss", "mse", "aux", "grad_norm", "lr"}
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    # The masters are the layer's own fp32 parameters: no compute copy.
    assert state["params"]["taps"].data_ptr() == model.taps.data_ptr()
    assert model.taps.dtype == torch.float32
    for name in ("taps", "bc"):
        np.testing.assert_allclose(
            state["params"][name].numpy(), np.asarray(jstate["params"][name]),
            rtol=0, atol=1e-6)


def test_loss_falls_over_ten_adamw_steps():
    cfg = get_config(ARCH, smoke=True)
    batch = _torch_batch(_batch(cfg))
    model = build(cfg, device="cpu")
    state = init_train_state(model)
    step = make_train_step(model, AdamWConfig(**OPT))
    with torch.no_grad():
        first = float(solver_loss_fn(model, batch)[0])
    losses = []
    for _ in range(10):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    with torch.no_grad():
        last = float(solver_loss_fn(model, batch)[0])
    assert int(state["step"]) == 10
    assert losses[0] == pytest.approx(first, rel=1e-6)
    assert last < first / 2, (first, losses, last)
