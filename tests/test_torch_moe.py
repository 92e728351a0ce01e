"""The port's ``models/moe.py`` against the JAX package's on the CPU, fp32,
on inputs from a numpy seed: the routing (each slot's expert, its position
within the expert, kept or dropped) exactly, ties included; the output, the
aux loss and their gradients in both dispatch modes, at capacity factors
8.0 (nothing dropped), 1.25 (the configs') and 0.5, in 1 and 4 waves, with
and without shared experts.

JAX's ``_group_moe`` returns no routing, so ``_jax_route`` repeats its
routing lines (``src/repro/models/moe.py:51-64``) with JAX's own ops.
Tolerances, relative to the tensor's max-abs: outputs 1e-5 and gradients
1e-4 (the same sums in another order: readings below 1e-6), the aux loss
1e-6 relative; bf16 outputs 2e-2 (the frameworks round their bf16 products
at other places) with the routing still equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import _flatten as jax_flatten
from repro.models.moe import moe_apply as jax_moe_apply
from repro.models.moe import moe_table as jax_moe_table
from repro_torch.models.layers import flatten
from repro_torch.models.moe import (MoE, expert_capacity, moe_apply,
                                    moe_table, route, wave_layout)

D, E, FF, K = 32, 8, 48, 2
B, S = 2, 64
GROUP = 16
MODES = ("einsum", "scatter")
FACTORS = (8.0, 1.25, 0.5)


def _params(seed=0, shared=0, router_scale=0.5):
    """fp32 numpy leaves of ``moe_table(D, E, FF, shared)``."""
    rng = np.random.default_rng(seed)

    def normal(*shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    p = {"router": normal(D, E, std=router_scale),
         "up": normal(E, D, FF, std=D ** -0.5),
         "gate": normal(E, D, FF, std=D ** -0.5),
         "down": normal(E, FF, D, std=FF ** -0.5)}
    if shared:
        p["shared"] = {"up": normal(D, shared * FF, std=D ** -0.5),
                       "gate": normal(D, shared * FF, std=D ** -0.5),
                       "down": normal(shared * FF, D, std=FF ** -0.5)}
    return p


def _x(seed=1, shape=(B, S, D)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _torch(tree, grad=False):
    return jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)).requires_grad_(grad), tree)


def _rel(a, b):
    a, b = (np.asarray(t.detach() if isinstance(t, torch.Tensor) else t,
                       np.float32) for t in (a, b))
    return float(np.abs(a - b).max() / np.abs(b).max())


def _jax_route(params, xg, top_k, capacity):
    """JAX's routing, ``src/repro/models/moe.py:51-64`` as they stand."""
    G, S_, _ = xg.shape
    E_ = params["router"].shape[1]
    logits = jnp.einsum("gsd,de->gse", xg.astype(jnp.float32),
                        params["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_idx = jax.lax.top_k(probs, top_k)
    gate_vals = gate_vals / jnp.sum(gate_vals, axis=-1, keepdims=True)
    onehot = jax.nn.one_hot(expert_idx, E_, dtype=jnp.float32)
    flat = onehot.transpose(0, 2, 1, 3).reshape(G, top_k * S_, E_)
    pos_in_expert = (jnp.cumsum(flat, axis=1) - flat).reshape(
        G, top_k, S_, E_).transpose(0, 2, 1, 3)
    pos = jnp.sum(pos_in_expert * onehot, axis=-1)
    keep = pos < capacity
    return (np.asarray(gate_vals * keep), np.asarray(expert_idx),
            np.asarray(pos).astype(np.int64), np.asarray(keep))


def _routes_equal(params, x, top_k, cf):
    """Route one wave of groups both ways and require the same expert,
    position and keep for every slot; returns the port's routing."""
    xg = x.reshape(-1, GROUP, D)
    cap = expert_capacity(GROUP, top_k, cf, E)
    jg, ji, jp, jk = _jax_route(jax.tree.map(jnp.asarray, params),
                                jnp.asarray(xg), top_k, cap)
    _, tg, ti, tp, tk = route(torch.from_numpy(xg),
                              torch.from_numpy(params["router"]), top_k, cap)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tk.numpy(), jk)
    assert _rel(tg, jg) <= 1e-6
    return ti.numpy(), tp.numpy(), tk.numpy()


# -- the table and the module ---------------------------------------------------

@pytest.mark.parametrize("shared", [0, 2])
def test_table_is_jax(shared):
    jt = dict(jax_flatten(jax_moe_table(D, E, FF, shared)))
    tt = dict(flatten(moe_table(D, E, FF, shared)))
    assert list(jt) == list(tt)
    for path, pd in tt.items():
        assert pd.shape == jt[path].shape and pd.scale == jt[path].scale
        assert (pd.dtype == torch.float32) == (jt[path].dtype is not None)
    assert tt[("router",)].dtype == torch.float32


@pytest.mark.parametrize("shared", [0, 2])
def test_module_is_moe_apply_on_its_parameters(shared):
    """``MoE`` in bf16 keeps the router fp32 and computes ``moe_apply`` of
    its own parameters."""
    mod = MoE(D, E, FF, shared, top_k=K, device="cpu", dtype=torch.bfloat16)
    with torch.no_grad():
        for name, value in flatten(_torch(_params(3, shared))):
            mod.get_parameter(".".join(name)).copy_(value)
    assert mod.router.dtype == torch.float32
    assert all(p.dtype == torch.bfloat16 for n, p in mod.named_parameters()
               if n != "router")
    x = torch.from_numpy(_x()).to(torch.bfloat16)
    with torch.no_grad():
        out, aux = mod(x, GROUP)
        want, want_aux = moe_apply(mod.params(), x, top_k=K,
                                   group_size=GROUP)
    assert out.dtype == torch.bfloat16 and torch.equal(out, want)
    assert aux.dtype == torch.float32 and torch.equal(aux, want_aux)


# -- routing -------------------------------------------------------------------

@pytest.mark.parametrize("cf", FACTORS)
def test_routing_equals_jax(cf):
    """Expert, position and keep of every (token, slot), exactly; at 1.25
    and 0.5 some slots are dropped, at 8.0 none."""
    _, _, keep = _routes_equal(_params(), _x(), K, cf)
    assert keep.all() == (cf == 8.0)


@pytest.mark.parametrize("top_k", [1, 2])
def test_routing_ties_go_to_the_lower_expert(top_k):
    """Two equal router columns (experts 2 and 5, three times the others'
    size) give equal probabilities on every token: ``jax.lax.top_k`` puts
    expert 2 first.  With top-1 the tie picks the expert; with top-2 it
    orders the slots, which sets the priority of the positions and the
    top-1 fraction of the aux loss."""
    p = _params(4)
    p["router"][:, 2] *= 3
    p["router"][:, 5] = p["router"][:, 2]
    x = _x(5)
    idx, _, _ = _routes_equal(p, x, top_k, 1.25)
    # The case really ties: expert 5 is never first, and never picked
    # without expert 2 before it.
    if top_k == 1:
        assert (idx != 5).all() and (idx == 2).sum() >= 10
    else:
        both = (idx == 2).any(-1) & (idx == 5).any(-1)
        assert both.sum() >= 10 and (idx[both][:, 0] == 2).all()
        assert ((idx == 5).any(-1) == both).all()
    out, aux = moe_apply(_torch(p), torch.from_numpy(x), top_k=top_k,
                         capacity_factor=1.25, group_size=GROUP)
    jout, jaux = jax_moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                               top_k=top_k, capacity_factor=1.25,
                               group_size=GROUP)
    assert _rel(out, jout) <= 1e-5
    assert abs(float(aux) / float(jaux) - 1) <= 1e-6


def test_a_kept_slot_with_zero_gate_is_not_dispatched():
    """``dispatch`` is ``combine > 0`` (JAX's rule), not ``keep``: a
    router one expert of which outscores the rest by far more than fp32's
    exp range gives the second slot a gate weight of exactly 0 (and every
    other expert a probability of 0, a tie that ``top_k`` breaks to expert
    1); the slot keeps its place in its expert, and adds nothing, in both
    modes as in JAX."""
    p = _params(6)
    x = np.abs(_x(7))
    p["router"][:, 0] = 40.0         # logit 0 beats the rest by about 1000
    idx, _, keep = _routes_equal(p, x, K, 8.0)
    xg = torch.from_numpy(x.reshape(-1, GROUP, D))
    _, gates, _, _, _ = route(xg, torch.from_numpy(p["router"]), K,
                              expert_capacity(GROUP, K, 8.0, E))
    assert (idx[..., 0] == 0).all() and (idx[..., 1] == 1).all()
    assert keep.all()
    assert (gates[..., 1] == 0).all() and (gates[..., 0] == 1).all()
    for mode in MODES:
        out, _ = moe_apply(_torch(p), torch.from_numpy(x), top_k=K,
                           capacity_factor=8.0, group_size=GROUP,
                           dispatch_mode=mode)
        jout, _ = jax_moe_apply(jax.tree.map(jnp.asarray, p),
                                jnp.asarray(x), top_k=K, capacity_factor=8.0,
                                group_size=GROUP, dispatch_mode=mode)
        assert _rel(out, jout) <= 1e-5, mode


def test_group_size_must_divide_the_tokens():
    with pytest.raises(ValueError, match="not divisible by group_size=16"):
        moe_apply(_torch(_params()), torch.zeros(1, 40, D), top_k=K,
                  group_size=GROUP)
    # A group never exceeds the tokens; the waves divide the groups.
    assert wave_layout(40, 1024, 16) == (40, 1, 1)
    assert wave_layout(8192, 1024, 16) == (1024, 8, 1)
    assert wave_layout(12 * 16, 16, 8) == (16, 6, 2)
    assert expert_capacity(1024, 8, 1.25, 128) == 80
    assert expert_capacity(1024, 6, 1.25, 64) == 120
    assert expert_capacity(4, 8, 1.25, 128) == 4


# -- outputs and gradients -----------------------------------------------------

@pytest.mark.parametrize("shared", [0, 2])
@pytest.mark.parametrize("waves", [1, 4])
@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("mode", MODES)
def test_moe_apply_matches_jax(mode, cf, waves, shared):
    p, x = _params(0, shared), _x()
    kw = dict(top_k=K, capacity_factor=cf, group_size=GROUP, n_waves=waves,
              dispatch_mode=mode)
    jout, jaux = jax_moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                               **kw)
    with torch.no_grad():
        out, aux = moe_apply(_torch(p), torch.from_numpy(x), **kw)
    assert out.dtype == torch.float32 and aux.shape == ()
    assert _rel(out, jout) <= 1e-5
    assert abs(float(aux) / float(jaux) - 1) <= 1e-6


@pytest.mark.parametrize("shared", [0, 2])
@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("mode", MODES)
def test_moe_gradients_match_jax(mode, cf, shared):
    """Gradients of <out, r> + aux with respect to x and every leaf, the
    waves checkpointed (4 waves)."""
    p, x = _params(0, shared), _x()
    r = _x(9)
    kw = dict(top_k=K, capacity_factor=cf, group_size=GROUP, n_waves=4,
              dispatch_mode=mode)

    def jloss(pp, xx):
        out, aux = jax_moe_apply(pp, xx, **kw)
        return jnp.sum(out * r) + aux

    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp, tx = _torch(p, grad=True), torch.from_numpy(x).requires_grad_()
    out, aux = moe_apply(tp, tx, **kw)
    leaves = [t for _, t in flatten(tp)]
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum() + aux,
                                [*leaves, tx])
    want = [np.asarray(g) for _, g in flatten(jg_p)] + [jg_x]
    for (path, _), g, w in zip([*flatten(tp), (("x",), None)], grads, want):
        assert _rel(g, w) <= 1e-4, path


@pytest.mark.parametrize("cf", FACTORS)
def test_scatter_equals_einsum(cf):
    """The two dispatch modes, outputs and gradients, in the port alone
    (JAX's tests/test_moe_and_padding.py:20-37)."""
    p, x = _params(0, 2), _x()
    res = []
    for mode in MODES:
        tp, tx = _torch(p, grad=True), torch.from_numpy(x).requires_grad_()
        out, aux = moe_apply(tp, tx, top_k=K, capacity_factor=cf,
                             group_size=GROUP, dispatch_mode=mode)
        grads = torch.autograd.grad((out ** 2).sum() + aux,
                                    [t for _, t in flatten(tp)] + [tx])
        res.append((out, aux, grads))
    (a, aa, ga), (b, ab, gb) = res
    assert _rel(a, b) <= 1e-6 and float(aa) == float(ab)
    for u, v in zip(ga, gb):
        assert _rel(u, v) <= 1e-5


def test_bf16_matches_jax_with_equal_routing():
    """bf16 activations and experts, the router fp32 (as in a bf16 model):
    the same routing as JAX's, the output within bf16's rounding."""
    p, x = _params(0, 2), _x()
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    jp["router"] = jnp.asarray(p["router"])
    tp = jax.tree.map(lambda a: torch.from_numpy(a).to(torch.bfloat16), p)
    tp["router"] = torch.from_numpy(p["router"])
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    cap = expert_capacity(GROUP, K, 1.25, E)
    _, jidx, jpos, jkeep = _jax_route(jp, xb.reshape(-1, GROUP, D), K, cap)
    _, _, tidx, tpos, tkeep = route(xt.reshape(-1, GROUP, D), tp["router"],
                                    K, cap)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    np.testing.assert_array_equal(tpos.numpy(), jpos)
    np.testing.assert_array_equal(tkeep.numpy(), jkeep)
    for mode in MODES:
        jout, _ = jax_moe_apply(jp, xb, top_k=K, group_size=GROUP,
                                dispatch_mode=mode)
        with torch.no_grad():
            out, _ = moe_apply(tp, xt, top_k=K, group_size=GROUP,
                               dispatch_mode=mode)
        assert out.dtype == torch.bfloat16
        assert _rel(out.float(), np.asarray(jout, np.float32)) <= 2e-2, mode
