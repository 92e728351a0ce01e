"""The port's sharded dense family (``models/transformer.ShardedDense``,
``train/loss.sharded_xent``, the sharded train and serve steps, ZeRO-1
AdamW) against the JAX package's sharded steps and against the port's own
unsharded runs, on the CPU.

The JAX side needs a multi-device mesh, so it runs once in a subprocess
under ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` on a (2, 4)
("data", "model") mesh built with ``AxisType.Auto`` axes (jax 0.9's
default Explicit axes make its ``with_sharding_constraint`` raise), on the
smoke configs in fp32, from ``PRNGKey(0)`` weights and numpy-seeded
batches, and writes every output to one ``.npz``.  The port side loads
JAX's initial weights (``models/convert``) and runs on a CPU ``TileMesh``
of the same shape, in-process.

Tolerances, all fp32: the loss and the grad norm within 1e-5 relative
and the updated params within 1e-4 absolute, against JAX's sharded step
and the port's unsharded one; each gradient leaf (the first AdamW step
moves a param by about lr = 3e-6 whatever its gradient, so the grads
carry the comparison) within ``GRAD_BOUND`` of its max-abs; decode
logits within 1e-5 absolute.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.models.convert import from_jax_params, to_jax_tree
from repro_torch.models.layers import flatten, set_path
from repro_torch.models.model_zoo import build
from repro_torch.models.transformer import kv_heads_for
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.halo import make_mesh
from repro_torch.parallel.sharding import Sharded, Sharder
from repro_torch.train.serve_step import greedy_generate, make_prefill_step
from repro_torch.train.train_step import (init_train_state, loss_fn,
                                          make_train_step, value_and_grad)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = (2, 4)
TRAIN = (("qwen3-0.6b", "tp"), ("phi3-medium-14b", "sp"))
DECODE = (("glm4-9b", "tp"), ("phi3-medium-14b", "sp"))
B, S, MAX_LEN = 4, 12, 16          # decode: model 4 divides 16
TRAIN_B, TRAIN_S = 4, 16


def _inputs():
    rng = np.random.default_rng(28)
    d = {}
    for arch, _ in TRAIN:
        d[f"{arch}/tokens"] = rng.integers(0, 512, (TRAIN_B, TRAIN_S))
        d[f"{arch}/labels"] = rng.integers(0, 512, (TRAIN_B, TRAIN_S))
    for arch, _ in DECODE:
        d[f"{arch}/prompt"] = rng.integers(0, 512, (B, S))
        d[f"{arch}/next"] = rng.integers(0, 512, (B,))
    return d


JAX_SIDE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models.model_zoo import build
from repro.optim.adamw import AdamWConfig
from repro.parallel.sharding import Sharder
from repro.train.train_step import init_train_state, loss_fn, make_train_step

cfg = json.loads(sys.argv[1])
inp = dict(np.load(cfg["inputs"]))
mesh = jax.make_mesh(tuple(cfg["mesh"]), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
out = {}


def flat(prefix, tree):
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/" + "/".join(k.key for k in path)] = np.asarray(v)


for arch, profile in cfg["train"]:
    api = build(get_config(arch, smoke=True))
    batch = {k: jnp.asarray(inp[f"{arch}/{k}"]) for k in ("tokens", "labels")}
    state0 = init_train_state(api, jax.random.PRNGKey(0))
    flat(f"{arch}/params0", state0["params"])
    sh = Sharder(mesh=mesh, profile=profile)
    step = make_train_step(api, sh, AdamWConfig(), jnp.float32)

    def step_and_grads(state, batch):
        (_, _), grads = jax.value_and_grad(
            lambda p: loss_fn(api, p, batch, sh, jnp.float32),
            has_aux=True)(state["params"])
        return (*step(state, batch), grads)

    with mesh:
        st, m, grads = jax.jit(step_and_grads)(state0, batch)
    out[f"{arch}/loss"] = np.asarray(m["loss"])
    out[f"{arch}/grad_norm"] = np.asarray(m["grad_norm"])
    flat(f"{arch}/grads", grads)
    flat(f"{arch}/params", st["params"])

for arch, profile in cfg["decode"]:
    api = build(get_config(arch, smoke=True))
    params = api.init(jax.random.PRNGKey(0), jnp.float32)
    flat(f"{arch}/dparams", params)
    batch = {"tokens": jnp.asarray(inp[f"{arch}/prompt"])}
    tok = jnp.asarray(inp[f"{arch}/next"])
    S, L = batch["tokens"].shape[1], cfg["max_len"]
    sh = Sharder(mesh=mesh, profile=profile)
    with mesh:
        _, cache = jax.jit(lambda p, b: api.prefill(p, b, L, sharder=sh))(
            params, batch)
        for i in range(2):
            logits, cache = jax.jit(lambda p, t, c, i=i: api.decode_step(
                p, t, c, S + i, sharder=sh))(params, tok, cache)
            out[f"{arch}/logits{i}"] = np.asarray(logits)
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
np.savez(cfg["out"], **out)
print("jax side ok")
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke models' ops are tiny: one intra-op thread runs them
    several times faster than a pool (restored after the module)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory, inputs):
    """Every JAX output, from one subprocess with 8 forced host devices."""
    d = tmp_path_factory.mktemp("jax_tp")
    np.savez(d / "inputs.npz", **inputs)
    cfg = {"inputs": str(d / "inputs.npz"), "out": str(d / "out.npz"),
           "mesh": MESH, "train": TRAIN, "decode": DECODE,
           "max_len": MAX_LEN}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, json.dumps(cfg)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0 and "jax side ok" in r.stdout, r.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


def cpu_mesh(shape=MESH, names=("data", "model")):
    return make_mesh(shape, names, devices="cpu")


def _tree(out, prefix):
    tree = {}
    for key, v in out.items():
        if key.startswith(prefix + "/"):
            set_path(tree, tuple(key[len(prefix) + 1:].split("/")), v)
    return tree


def _model(arch, params, impl="xla", **changes):
    cfg = dataclasses.replace(get_config(arch, smoke=True), attn_impl=impl,
                              **changes)
    return from_jax_params(cfg, params, device="cpu", dtype=torch.float32)


def _batch(inputs, arch):
    return {k: torch.as_tensor(inputs[f"{arch}/{k}"])
            for k in ("tokens", "labels")}


@functools.lru_cache(maxsize=None)
def _port_step(arch, profile, impl, sharded):
    """The port's (metrics, updated params, grads), JAX-layout numpy."""
    inputs, out = _CACHE["inputs"], _CACHE["jax"]
    model = _model(arch, _tree(out, f"{arch}/params0"), impl)
    sh = Sharder(cpu_mesh(), profile) if sharded else None
    batch = _batch(inputs, arch)
    state = init_train_state(model)
    _, _, grads = value_and_grad(model, state["params"], batch,
                                 functools.partial(loss_fn, sharder=sh))
    grads = to_jax_tree(model.cfg, grads)
    state, m = make_train_step(model, AdamWConfig(), torch.float32,
                               sharder=sh)(state, batch)
    return ({k: float(v) for k, v in m.items()},
            to_jax_tree(model.cfg, state["params"]), grads)


_CACHE: dict = {}


@pytest.fixture(scope="module")
def port(inputs, jax_out):
    _CACHE.update(inputs=inputs, jax=jax_out)
    yield _port_step
    _port_step.cache_clear()
    _CACHE.clear()


def _reference(out, arch, ref, port_fn, profile, impl):
    """(loss, grad norm, params tree, grads tree) of a reference run."""
    if ref == "port-unsharded":
        m, params, grads = port_fn(arch, profile, impl, False)
        return m["loss"], m["grad_norm"], params, grads
    return (float(out[f"{arch}/loss"]), float(out[f"{arch}/grad_norm"]),
            _tree(out, f"{arch}/params"), _tree(out, f"{arch}/grads"))


# The grads' bound, relative to each leaf's max-abs: the port's two runs
# differ only in summation order (1.1e-6 measured); the port's unsharded
# run lies up to 6.0e-5 from JAX's on phi3's smoke config, as JAX's own
# sharded and single-device runs part by 3.8e-5, so against JAX the bound
# is tests/test_torch_lm_dense.py's 3e-4.
GRAD_BOUND = {"jax-sharded": 3e-4, "port-unsharded": 1e-5}
STEP_CASES = [(a, p, i, r) for a, p in TRAIN for i in ("xla", "flash")
              for r in GRAD_BOUND]


@pytest.mark.parametrize("arch,profile,impl,ref", STEP_CASES,
                         ids=[f"{a}-{i}-vs-{r}" for a, _, i, r in STEP_CASES])
def test_sharded_train_step_matches(arch, profile, impl, ref, port,
                                    jax_out):
    m, params, grads = port(arch, profile, impl, True)
    loss, gnorm, want_params, want_grads = _reference(
        jax_out, arch, ref, port, profile, impl)
    assert abs(m["loss"] / loss - 1) <= 1e-5, (m["loss"], loss)
    assert abs(m["grad_norm"] / gnorm - 1) <= 1e-5, (m["grad_norm"], gnorm)
    for path, want in flatten(want_params):
        got = dict(flatten(params))[path]
        assert np.abs(got - want).max() <= 1e-4, path
    mine = dict(flatten(grads))
    for path, want in flatten(want_grads):
        err = np.abs(mine[path] - want).max()
        assert err <= GRAD_BOUND[ref] * max(np.abs(want).max(), 1e-3), (
            path, err)


DECODE_CASES = [(a, p, i) for a, p in DECODE for i in ("xla", "flash")]
# glm4-9b within 1e-5 absolute of JAX's sharded decode; phi3-medium-14b's
# smoke config within the fp32 decode bound of tests/test_torch_lm_dense.py
# (1e-4 of the max-abs): the port's unsharded decode already lies 5.1e-5
# from JAX's there at the second step.  Both within 1e-5 of the port's
# unsharded decode.
JAX_DECODE_BOUND = {"glm4-9b": 1e-5, "phi3-medium-14b": 1e-4 * 1.5}


@pytest.mark.parametrize("arch,profile,impl", DECODE_CASES,
                         ids=[f"{a}-{i}" for a, _, i in DECODE_CASES])
def test_decode_on_a_kv_seq_sharded_cache_matches_jax(arch, profile, impl,
                                                       inputs, jax_out):
    model = _model(arch, _tree(jax_out, f"{arch}/dparams"), impl)
    sh = Sharder(cpu_mesh(), profile)
    prompt = torch.as_tensor(inputs[f"{arch}/prompt"])
    _, cache = model.prefill(prompt, MAX_LEN, sharder=sh)
    _, whole = model.prefill(prompt, MAX_LEN)
    assert isinstance(cache["k"], Sharded)
    assert tuple(cache["k"].spec) == (None, "data", "model", None, None)
    assert cache["k"].pieces[0].shape[2] == MAX_LEN // MESH[1]
    tok = torch.as_tensor(inputs[f"{arch}/next"])
    for i in range(2):
        logits, cache = model.decode_step(tok, cache, S + i, sharder=sh)
        mine, whole = model.decode_step(tok, whole, S + i)
        got = logits.gather()
        want = jax_out[f"{arch}/logits{i}"]
        assert np.abs(got.numpy() - want).max() <= JAX_DECODE_BOUND[arch], i
        assert (got - mine).abs().max() <= 1e-5, i
        tok = torch.as_tensor(want.argmax(-1))


@pytest.mark.parametrize("arch,profile", DECODE)
def test_replicated_cache_decode_equals_unsharded(arch, profile):
    # model 4 does not divide max_len 17: the cache stays whole on every
    # shard (JAX's divisibility rule) and decode attends per head shard
    cfg = get_config(arch, smoke=True)
    model = build(cfg, device="cpu", dtype=torch.float32)
    sh = Sharder(cpu_mesh(), profile)
    prompt = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S)))
    t1, c1 = make_prefill_step(model, MAX_LEN + 1)({"tokens": prompt})
    t2, c2 = make_prefill_step(model, MAX_LEN + 1, sharder=sh)(
        {"tokens": prompt})
    assert tuple(c2["k"].spec)[2] is None
    assert c2["k"].pieces[0].shape[2] == MAX_LEN + 1
    assert torch.equal(t1, t2)
    for i in range(3):
        l1, c1 = model.decode_step(t1, c1, S + i)
        l2, c2 = model.decode_step(t1, c2, S + i, sharder=sh)
        assert (l1 - l2.gather()).abs().max() <= 1e-5, i
        t1 = l1.argmax(-1)
    k1, k2 = c1["k"].numpy(), c2["k"].gather().numpy()
    assert np.abs(k2 - k1).max() <= 1e-5 * np.abs(k1).max()


@pytest.mark.parametrize("arch,profile", DECODE + TRAIN[:1])
def test_sharded_greedy_tokens_equal_unsharded(arch, profile):
    cfg = get_config(arch, smoke=True)
    model = build(cfg, device="cpu", dtype=torch.float32)
    prompt = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S)))
    want = greedy_generate(model, {"tokens": prompt}, steps=4,
                           max_len=MAX_LEN)
    got = greedy_generate(model, {"tokens": prompt}, steps=4,
                          max_len=MAX_LEN, sharder=Sharder(cpu_mesh(),
                                                           profile))
    assert torch.equal(got, want)


def _port_pair(cfg, batch, sharder, mesh_devs=None):
    """(unsharded, sharded) (loss, grads by name) of one model."""
    model = build(cfg, device="cpu", dtype=torch.float32)
    state = init_train_state(model)
    out = []
    for sh in (None, sharder):
        loss, _, grads = value_and_grad(model, state["params"], batch,
                                        functools.partial(loss_fn,
                                                          sharder=sh))
        out.append((float(loss), grads))
    return out


EDGE_CASES = {
    # 12 q heads over model 4: 3 a shard and G = 4, so a group straddles
    # two shards and each shard reads one kv head a q head
    "straddling-heads": (dict(n_heads=12, n_kv_heads=3,
                              sharding_profile="tp"), (2, 4),
                         ("data", "model"), 4),
    # batch 3 does not split over data 2: it replicates, counted once
    "replicated-batch": ({}, (2, 4), ("data", "model"), 3),
    # a pod axis: batch over ("pod", "data")
    "pod-data-model": ({}, (2, 2, 2), ("pod", "data", "model"), 4),
    # sp on a pod mesh: weights gathered over data, tokens over all three
    "sp-pod": (dict(sharding_profile="sp"), (2, 2, 2),
               ("pod", "data", "model"), 4),
}


@pytest.mark.parametrize("impl", ("xla", "flash"))
@pytest.mark.parametrize("case", EDGE_CASES)
def test_sharded_loss_and_grads_equal_unsharded(case, impl):
    changes, shape, names, batch_rows = EDGE_CASES[case]
    cfg = dataclasses.replace(get_config("qwen3-0.6b", smoke=True),
                              attn_impl=impl, **changes)
    rng = np.random.default_rng(7)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                             (batch_rows, 8)))
             for k in ("tokens", "labels")}
    sh = Sharder(cpu_mesh(shape, names), cfg.sharding_profile)
    (l1, g1), (l2, g2) = _port_pair(cfg, batch, sh)
    assert abs(l2 / l1 - 1) <= 1e-5
    for name, g in g1.items():
        err = (g2[name] - g).abs().max()
        assert err <= 1e-5 * max(float(g.abs().max()), 1e-3), name


def test_kv_heads_a_shard_reads():
    assert kv_heads_for(4, 4, 2) == slice(2, 4)        # qwen3-0.6b at 4
    assert kv_heads_for(8, 8, 16) == slice(0, 1)       # glm4-9b, shard 1
    assert kv_heads_for(24, 8, 16) == slice(1, 2)      # glm4-9b, shard 3
    assert kv_heads_for(10, 10, 4).tolist() == [2, 2, 3, 3, 3, 3, 4, 4, 4, 4]


@pytest.mark.parametrize("arch", list_archs())
def test_state_over_data_runs_and_matches_on_a_larger_mesh(arch):
    # state_over_data now has its execution: every entry point runs under
    # it on a larger mesh and gives the unsharded results (batch 4 takes
    # the data axis first, so here the flag moves no cache: the batch-1
    # layouts are tests/test_torch_state_over_data.py's)
    cfg = get_config(arch, smoke=True)
    model = build(cfg, device="cpu", dtype=torch.float32)
    sh = Sharder(cpu_mesh(), cfg.sharding_profile, state_over_data=True)
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 8)))
    extra = {}
    if cfg.family == "encdec":
        extra = {"enc_frames": torch.zeros(4, cfg.enc_len, cfg.d_model)}
    with torch.no_grad():
        got, _ = model(tokens, sharder=sh, **extra)
        want, _ = model(tokens, **extra)
    assert float((got.gather() - want).abs().max()) <= 1e-5 * max(
        float(want.abs().max()), 1e-3)
    t1, c1 = make_prefill_step(model, 12, sharder=sh)(
        {"tokens": tokens, **extra})
    t0, c0 = make_prefill_step(model, 12)({"tokens": tokens, **extra})
    assert torch.equal(t1, t0)
    l1, _ = model.decode_step(t1, c1, 8, sharder=sh)
    l0, _ = model.decode_step(t0, c0, 8)
    assert float((l1.gather() - l0).abs().max()) <= 1e-5 * float(
        l0.abs().max())
    batch = {"tokens": tokens, "labels": tokens.roll(1, 1), **extra}
    losses = []
    for s in (sh, None):
        master = build(cfg, device="cpu", dtype=torch.float32)
        _, m = make_train_step(master, AdamWConfig(), torch.float32,
                               sharder=s)(init_train_state(master), batch)
        losses.append(float(m["loss"]))
    assert abs(losses[0] / losses[1] - 1) <= 1e-5


ALL = ("qwen3-0.6b", "glm4-9b", "phi3-medium-14b", "nemotron-4-15b",
       "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "mamba2-370m",
       "zamba2-1.2b", "qwen2-vl-2b", "whisper-tiny")


@pytest.mark.parametrize("arch", ALL)
def test_one_by_one_mesh_is_the_unsharded_path_bit_for_bit(arch):
    from repro_torch.launch.serve import stub_inputs
    cfg = get_config(arch, smoke=True)
    one = Sharder(cpu_mesh((1, 1)), cfg.sharding_profile)
    assert one.trivial
    rng = np.random.default_rng(11)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 8)))
    extra = stub_inputs(cfg, 2, 8, dtype=torch.float32, device="cpu")
    batch = {"tokens": tokens, "labels": tokens, **extra}
    runs = []
    for sh in (None, one):
        model = build(cfg, device="cpu", dtype=torch.float32)
        gen = greedy_generate(model, {"tokens": tokens, **extra}, steps=2,
                              max_len=12, sharder=sh)
        state, m = make_train_step(model, AdamWConfig(), sharder=sh)(
            init_train_state(model), batch)
        runs.append((gen, float(m["loss"]), state["params"]))
    (g1, l1, p1), (g2, l2, p2) = runs
    assert torch.equal(g1, g2) and l1 == l2
    assert all(torch.equal(p1[n], p2[n]) for n in p1)
