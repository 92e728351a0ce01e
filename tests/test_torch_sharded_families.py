"""The port's shard programs of every family but the dense one
(``models/transformer.ShardedMoE``, ``ShardedSSM``, ``ShardedHybrid``,
``ShardedDense`` with the vlm's inputs, ``models/encdec.ShardedEncDec``)
against the JAX package's sharded steps and against the port's own
unsharded runs, on the CPU.

The JAX side needs a multi-device mesh, so it runs in subprocesses under
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` on a (2, 4)
("data", "model") mesh built with ``AxisType.Auto`` axes (jax 0.9's default
Explicit axes make its ``with_sharding_constraint`` raise), on the smoke
configs in fp32, from ``PRNGKey(0)`` weights and numpy-seeded batches; the
cases are cut into groups that run at once, each writing one ``.npz``.  The
port side loads JAX's initial weights (``models/convert``) and runs on a
CPU ``TileMesh`` of the same shape, in-process.

Tolerances, all fp32: the loss within 1e-5 relative and the updated
params within 1e-4 absolute; the grad norm and each gradient leaf
(relative to its max-abs) within ``JAX_BOUND`` of JAX's sharded step
(``tests/test_torch_tp.py``'s 5e-5 and 3e-4 where it names none) and
within 5e-5 and ``UNSHARDED_GRAD`` of the port's unsharded step; prefill
hidden and decode logits within ``SERVE_BOUND`` of their max-abs against
JAX (1e-4 where it names none) and 1e-5 against the port's unsharded run.
The MoE layer's routing (expert ids and keep mask, every shard's groups)
equals JAX's exactly and its aux loss lies within 1e-6 relative of JAX's
sharded ``moe_apply``.
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

from repro_torch.configs import get_config
from repro_torch.launch.serve import stub_inputs
from repro_torch.models.convert import from_jax_params, to_jax_tree
from repro_torch.models.layers import flatten, set_path
from repro_torch.models.model_zoo import build
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.halo import make_mesh
from repro_torch.parallel.sharding import (PartitionSpec, Sharded, Sharder,
                                           shard)
from repro_torch.train.serve_step import greedy_generate, make_prefill_step
from repro_torch.train.train_step import (init_train_state, loss_fn,
                                          make_train_step, value_and_grad)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = (2, 4)
TRAIN_B, TRAIN_S = 4, 16
B, S, MAX_LEN = 4, 12, 16          # decode: model 4 divides 16
# name -> (arch, config changes, train seq, decode (prompt, max_len));
# every case on its arch's own profile (tp: moe, ssm, hybrid; sp: vlm,
# encdec).
CASES = {
    # groups of 8 in 4 waves: 64 tokens make 8 groups, G = 2 a wave, so
    # the groups split over data; capacity 4 drops tokens
    "qwen3-moe-split": ("qwen3-moe-30b-a3b",
                        dict(moe_group_size=8, moe_waves=4,
                             capacity_factor=1.0), TRAIN_S, (S, MAX_LEN)),
    # one group of 64: it replicates over data; the scatter dispatch and
    # two shared experts, dff-parallel
    "moonshot-scatter": ("moonshot-v1-16b-a3b", dict(moe_dispatch="scatter"),
                         TRAIN_S, (S, MAX_LEN)),
    # d_inner 128 over model 4: one head of 32 channels a shard, the gated
    # norm's sum of squares added over model
    "mamba2": ("mamba2-370m", {}, TRAIN_S, (S, MAX_LEN)),
    "zamba2": ("zamba2-1.2b", {}, TRAIN_S, (S, MAX_LEN)),
    # 8 vision positions on sequence shards of 4: shards 0 and 1 hold them
    "qwen2-vl": ("qwen2-vl-2b", {}, TRAIN_S, (S, MAX_LEN)),
    "whisper": ("whisper-tiny", {}, TRAIN_S, (S, MAX_LEN)),
    # a decoder length model 4 does not divide: the sequence and the cache
    # replicate over model
    "whisper-ragged": ("whisper-tiny", {}, 6, (6, MAX_LEN + 1)),
}
# The JAX subprocesses, run at once (about 25 s each; the MoE layer alone
# runs with the first group).
GROUPS = (("qwen3-moe-split",), ("zamba2",), ("moonshot-scatter", "mamba2"),
          ("qwen2-vl", "whisper", "whisper-ragged"))
# The MoE layer alone: (B, S) of its input, groups of 8 in 4 waves (G = 4
# a wave, 2 a data row), capacity factor 1 (capacity 4: tokens drop).
MOE_LAYER = dict(shape=(4, 32), group_size=8, waves=4, capacity_factor=1.0)
# The port's sharded step against its unsharded one, the grads relative
# to each leaf's max-abs: the two sum in other orders (the head and expert
# partial sums, the gated norm's sum of squares); measured worst 2.7e-5
# (moonshot's expert gates), 5.3e-5 (mamba2's conv taps), 1.9e-5
# (zamba2), under 3e-6 elsewhere.
UNSHARDED_GRAD = {"moe": 1e-4, "ssm": 1e-4, "hybrid": 1e-4}
# Against JAX's sharded step, (grad norm relative, grads relative to each
# leaf's max-abs): tests/test_torch_tp.py's, the ssm family's grads at
# tests/test_torch_ssm.py's 1e-4; whisper's smoke model, chaotic past one
# layer, puts the port's unsharded step 3.4e-4 (grad norm) and 1.0e-3
# (the encoder's wq) from JAX's sharded one, and the sharded step no
# farther, so encdec is held at 5e-4 and 1.5e-3 (tests/test_torch_encdec.py
# holds fp32 at 5e-4 of max-abs).
JAX_BOUND = {"ssm": (5e-5, 1e-4), "encdec": (5e-4, 1.5e-3)}
# Prefill hidden and decode logits against JAX, relative to max-abs: the
# family tests' fp32 bounds (tests/test_torch_encdec.py's 5e-4 for
# whisper: its ragged case's second decode step lies 1.4e-4 from JAX's).
SERVE_BOUND = {"encdec": 5e-4}


def _family(case):
    return get_config(CASES[case][0], smoke=True).family


def _inputs():
    rng = np.random.default_rng(29)
    d = {}
    for case, (arch, changes, train_s, (ps, _)) in CASES.items():
        cfg = dataclasses.replace(get_config(arch, smoke=True), **changes)
        d[f"{case}/tokens"] = rng.integers(0, cfg.vocab_size,
                                           (TRAIN_B, train_s))
        d[f"{case}/labels"] = rng.integers(0, cfg.vocab_size,
                                           (TRAIN_B, train_s))
        d[f"{case}/prompt"] = rng.integers(0, cfg.vocab_size, (B, ps))
        d[f"{case}/next"] = rng.integers(0, cfg.vocab_size, (B,))
        if cfg.family == "vlm":
            for tag, rows in (("train", TRAIN_B), ("serve", B)):
                d[f"{case}/{tag}/vision_embeds"] = rng.standard_normal(
                    (rows, cfg.n_vision_tokens, cfg.d_model)).astype(
                        np.float32)
        if cfg.family == "encdec":
            for tag, rows in (("train", TRAIN_B), ("serve", B)):
                d[f"{case}/{tag}/enc_frames"] = rng.standard_normal(
                    (rows, cfg.enc_len, cfg.d_model)).astype(np.float32)
    Bm, Sm = MOE_LAYER["shape"]
    d["moe_layer/h"] = rng.standard_normal((Bm, Sm, 64)).astype(np.float32)
    return d


JAX_SIDE = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models.model_zoo import build
from repro.models.moe import moe_apply
from repro.optim.adamw import AdamWConfig, apply_update
from repro.parallel.sharding import Sharder
from repro.train.train_step import init_train_state, loss_fn

cfg = json.loads(sys.argv[1])
inp = dict(np.load(cfg["inputs"]))
mesh = jax.make_mesh(tuple(cfg["mesh"]), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
out = {}


def flat(prefix, tree):
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/" + "/".join(k.key for k in path)] = np.asarray(v)


def extra(case, tag):
    return {k: jnp.asarray(inp[f"{case}/{tag}/{k}"])
            for k in ("vision_embeds", "enc_frames")
            if f"{case}/{tag}/{k}" in inp}


for case in cfg["cases"]:
    arch, changes, _, (ps, max_len) = cfg["all"][case]
    mcfg = dataclasses.replace(get_config(arch, smoke=True), **changes)
    api = build(mcfg)
    sh = Sharder(mesh=mesh, profile=mcfg.sharding_profile)
    batch = {k: jnp.asarray(inp[f"{case}/{k}"]) for k in ("tokens", "labels")}
    batch.update(extra(case, "train"))
    state0 = init_train_state(api, jax.random.PRNGKey(0))
    flat(f"{case}/params0", state0["params"])

    def step_and_grads(state, batch):
        # make_train_step's body, its grads kept
        (loss, parts), grads = jax.value_and_grad(
            lambda p: loss_fn(api, p, batch, sh, jnp.float32),
            has_aux=True)(state["params"])
        st, m = apply_update(state, grads, AdamWConfig())
        return st, {"loss": loss, **parts, **m}, grads

    with mesh:
        st, m, grads = jax.jit(step_and_grads)(state0, batch)
    for k in ("loss", "grad_norm", "aux"):
        out[f"{case}/{k}"] = np.asarray(m[k])
    flat(f"{case}/grads", grads)
    flat(f"{case}/params", st["params"])

    params = state0["params"]
    sbatch = {"tokens": jnp.asarray(inp[f"{case}/prompt"]),
              **extra(case, "serve")}
    tok = jnp.asarray(inp[f"{case}/next"])
    with mesh:
        hidden, cache = jax.jit(lambda p, b: api.prefill(
            p, b, max_len, sharder=sh))(params, sbatch)
        out[f"{case}/hidden"] = np.asarray(hidden)
        # kv_len traced: one compile for both steps
        decode = jax.jit(lambda p, t, c, n: api.decode_step(
            p, t, c, n, sharder=sh))
        for i in range(2):
            logits, cache = decode(params, tok, cache, jnp.int32(ps + i))
            out[f"{case}/logits{i}"] = np.asarray(logits)
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)

if cfg["moe_layer"]:
    # One MoE layer (the first of qwen3-moe's smoke model, PRNGKey(0)) on a
    # tp mesh, each dispatch mode, and its routing by JAX's own ops over
    # the global wave layout (``moe.py:141-151`` and ``_group_moe``).
    ml = cfg["moe_layer"]
    mcfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    params = build(mcfg).init(jax.random.PRNGKey(0), jnp.float32)
    p = jax.tree.map(lambda t: t[0], params["layers"]["moe"])
    h = jnp.asarray(inp["moe_layer/h"])
    sh = Sharder(mesh=mesh, profile="tp")
    for mode in ("einsum", "scatter"):
        with mesh:
            o, a = jax.jit(lambda p, h, mode=mode: moe_apply(
                p, h, top_k=mcfg.top_k,
                capacity_factor=ml["capacity_factor"],
                group_size=ml["group_size"], activation=mcfg.activation,
                sharder=sh, n_waves=ml["waves"], dispatch_mode=mode))(p, h)
        out[f"moe_layer/{mode}/out"] = np.asarray(o)
        out[f"moe_layer/{mode}/aux"] = np.asarray(a)
    Bm, Sm, D = h.shape
    gs, E, k = ml["group_size"], mcfg.n_experts, mcfg.top_k
    waves = ml["waves"]
    G = Bm * Sm // gs // waves
    C = max(4, int(gs * k * ml["capacity_factor"] / E))
    xf = h.reshape(waves, G, gs, D)
    probs = jax.nn.softmax(jnp.einsum("wgsd,de->wgse", xf, p["router"]), -1)
    _, idx = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(idx, E, dtype=jnp.float32)
    fl = onehot.transpose(0, 1, 3, 2, 4).reshape(waves, G, k * gs, E)
    pos = (jnp.cumsum(fl, axis=2) - fl).reshape(
        waves, G, k, gs, E).transpose(0, 1, 3, 2, 4)
    pos = jnp.sum(pos * onehot, axis=-1)
    out["moe_layer/expert_idx"] = np.asarray(idx)
    out["moe_layer/keep"] = np.asarray(pos < C)
    flat("moe_layer/params0", params)
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
    """Every JAX output: one subprocess a group of ``GROUPS``, all at
    once, each with 8 forced host devices."""
    d = tmp_path_factory.mktemp("jax_families")
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    procs = []
    for i, group in enumerate(GROUPS):
        cfg = {"inputs": str(d / "inputs.npz"), "out": str(d / f"{i}.npz"),
               "mesh": MESH, "cases": group, "all": CASES,
               "moe_layer": MOE_LAYER if i == 0 else None}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", JAX_SIDE, json.dumps(cfg)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
    out = {}
    for i, p in enumerate(procs):
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0 and "jax side ok" in stdout, stderr[-4000:]
        out.update(np.load(d / f"{i}.npz"))
    return out


def cpu_mesh(shape=MESH, names=("data", "model")):
    return make_mesh(shape, names, devices="cpu")


def _tree(out, prefix):
    tree = {}
    for key, v in out.items():
        if key.startswith(prefix + "/"):
            set_path(tree, tuple(key[len(prefix) + 1:].split("/")), v)
    return tree


def _cfg(case, impl="xla"):
    arch, changes, _, _ = CASES[case]
    return dataclasses.replace(get_config(arch, smoke=True), attn_impl=impl,
                               **changes)


def _model(case, out, impl="xla"):
    return from_jax_params(_cfg(case, impl), _tree(out, f"{case}/params0"),
                           device="cpu", dtype=torch.float32)


def _extra(inputs, case, tag):
    return {k: torch.as_tensor(inputs[f"{case}/{tag}/{k}"])
            for k in ("vision_embeds", "enc_frames")
            if f"{case}/{tag}/{k}" in inputs}


def _batch(inputs, case):
    return {**{k: torch.as_tensor(inputs[f"{case}/{k}"])
               for k in ("tokens", "labels")},
            **_extra(inputs, case, "train")}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


_CACHE: dict = {}


@functools.lru_cache(maxsize=None)
def _port_step(case, impl, sharded):
    """The port's (metrics, updated params, grads), JAX-layout numpy."""
    inputs, out = _CACHE["inputs"], _CACHE["jax"]
    model = _model(case, out, impl)
    sh = Sharder(cpu_mesh(), model.cfg.sharding_profile) if sharded else None
    batch = _batch(inputs, case)
    state = init_train_state(model)
    _, parts, grads = value_and_grad(model, state["params"], batch,
                                     functools.partial(loss_fn, sharder=sh))
    grads = to_jax_tree(model.cfg, grads)
    state, m = make_train_step(model, AdamWConfig(), torch.float32,
                               sharder=sh)(state, batch)
    m = {k: float(v) for k, v in m.items()}
    return m, to_jax_tree(model.cfg, state["params"]), grads


@pytest.fixture(scope="module")
def port(inputs, jax_out):
    _CACHE.update(inputs=inputs, jax=jax_out)
    yield _port_step
    _port_step.cache_clear()
    _CACHE.clear()


STEP_CASES = [(c, i, r) for c in CASES for i in ("xla", "flash")
              for r in ("jax-sharded", "port-unsharded")]


@pytest.mark.parametrize("case,impl,ref", STEP_CASES,
                         ids=[f"{c}-{i}-vs-{r}" for c, i, r in STEP_CASES])
def test_sharded_train_step_matches(case, impl, ref, port, jax_out):
    m, params, grads = port(case, impl, True)
    family = _family(case)
    if ref == "port-unsharded":
        want_m, want_params, want_grads = port(case, impl, False)
        gnorm, bound = 5e-5, UNSHARDED_GRAD.get(family, 1e-5)
    else:
        want_m = {k: float(jax_out[f"{case}/{k}"])
                  for k in ("loss", "grad_norm", "aux")}
        want_params = _tree(jax_out, f"{case}/params")
        want_grads = _tree(jax_out, f"{case}/grads")
        gnorm, bound = JAX_BOUND.get(family, (5e-5, 3e-4))
    assert abs(m["loss"] / want_m["loss"] - 1) <= 1e-5, (m, want_m)
    assert abs(m["grad_norm"] / want_m["grad_norm"] - 1) <= gnorm
    if family == "moe":
        assert abs(m["aux"] / want_m["aux"] - 1) <= 1e-6, (m, want_m)
    mine_p = dict(flatten(params))
    for path, want in flatten(want_params):
        assert np.abs(mine_p[path] - want).max() <= 1e-4, path
    mine = dict(flatten(grads))
    for path, want in flatten(want_grads):
        err = np.abs(mine[path] - want).max()
        assert err <= bound * max(np.abs(want).max(), 1e-3), (path, err)


SERVE_CASES = [(c, i) for c in CASES for i in ("xla", "flash")]


@pytest.mark.parametrize("case,impl", SERVE_CASES,
                         ids=[f"{c}-{i}" for c, i in SERVE_CASES])
def test_sharded_prefill_and_decode_match(case, impl, inputs, jax_out):
    model = _model(case, jax_out, impl)
    sh = Sharder(cpu_mesh(), model.cfg.sharding_profile)
    _, _, (ps, max_len) = CASES[case][1:]
    prompt = torch.as_tensor(inputs[f"{case}/prompt"])
    extra = _extra(inputs, case, "serve")
    hidden, cache = model.prefill(prompt, max_len, sharder=sh, **extra)
    whole_h, whole = model.prefill(prompt, max_len, **extra)
    assert isinstance(hidden, Sharded)
    bound = SERVE_BOUND.get(model.cfg.family, 1e-4)
    assert _rel(hidden.gather(), jax_out[f"{case}/hidden"]) <= bound
    assert _rel(hidden.gather(), whole_h) <= 1e-5
    tok = torch.as_tensor(inputs[f"{case}/next"])
    for i in range(2):
        logits, cache = model.decode_step(tok, cache, ps + i, sharder=sh)
        mine, whole = model.decode_step(tok, whole, ps + i)
        got, want = logits.gather(), jax_out[f"{case}/logits{i}"]
        assert _rel(got, want) <= bound, i
        assert _rel(got, mine) <= 1e-5, i
        tok = torch.as_tensor(want.argmax(-1))


def test_the_caches_are_laid_by_their_dims(inputs, jax_out):
    """Each family's sharded cache follows ``cache_dims``: the kv caches on
    kv_seq over model where model divides max_len, the Mamba conv state on
    its channels and the SSD state on its heads over model, whisper's
    cross cache whole on every model shard."""
    want = {
        "mamba2": {"conv_x": (None, "data", None, "model"),
                   "conv_bc": (None, "data", None, None),
                   "state": (None, "data", "model", None, None)},
        "zamba2": {"groups/state": (None, None, "data", "model", None, None),
                   "attn/k": (None, "data", "model", None, None),
                   "tail/conv_x": (None, "data", None, "model")},
        "qwen2-vl": {"k": (None, "data", "model", None, None)},
        "whisper": {"self/k": (None, "data", "model", None, None),
                    "cross_k": (None, "data", None, None, None)},
        "whisper-ragged": {"self/k": (None, "data", None, None, None)},
    }
    for case, leaves in want.items():
        model = _model(case, jax_out)
        sh = Sharder(cpu_mesh(), model.cfg.sharding_profile)
        prompt = torch.as_tensor(inputs[f"{case}/prompt"])
        _, cache = model.prefill(prompt, CASES[case][3][1], sharder=sh,
                                 **_extra(inputs, case, "serve"))
        for path, spec in leaves.items():
            leaf = cache
            for p in path.split("/"):
                leaf = leaf[p]
            assert tuple(leaf.spec) == spec, (case, path, leaf.spec)


def _moe_layer(jax_out, mode):
    cfg = dataclasses.replace(
        get_config("qwen3-moe-30b-a3b", smoke=True), moe_dispatch=mode,
        moe_group_size=MOE_LAYER["group_size"], moe_waves=MOE_LAYER["waves"],
        capacity_factor=MOE_LAYER["capacity_factor"])
    return from_jax_params(cfg, _tree(jax_out, "moe_layer/params0"),
                           device="cpu", dtype=torch.float32)


@pytest.mark.parametrize("mode", ("einsum", "scatter"))
def test_moe_layer_routing_and_aux_equal_jax(mode, inputs, jax_out):
    """The expert-parallel layer: every shard's routing of its groups (the
    groups split over data, 2 a wave a data row) equals JAX's expert ids
    and keep mask exactly, so the shards of a data row agree with each
    other; the output and the aux loss match JAX's sharded ``moe_apply``
    and the port's unsharded layer."""
    model = _moe_layer(jax_out, mode)
    sh = Sharder(cpu_mesh(), "tp")
    prog = model.sharded(sh)
    h = torch.as_tensor(inputs["moe_layer/h"])
    spec = prog.layout(*h.shape[:2])
    prog.routes, model.layers[0].moe.routes = {}, []
    with torch.no_grad():
        outs, aux = prog._ffn("layers.0.", shard(h, PartitionSpec(
            *spec, None), sh.mesh), spec, MOE_LAYER["group_size"])
        whole, whole_aux = model.layers[0].moe(h, MOE_LAYER["group_size"])
    idx, keep = jax_out["moe_layer/expert_idx"], jax_out["moe_layer/keep"]
    waves, G = idx.shape[:2]
    n = sh.mesh.size
    log = prog.routes["layers.0."]
    assert len(log) == waves * n
    for w, (e, kp, _) in enumerate(model.layers[0].moe.routes):
        np.testing.assert_array_equal(e.numpy(), idx[w])
        np.testing.assert_array_equal(kp.numpy(), keep[w])
    Gl = G // MESH[0]
    for w in range(waves):
        for k, coord in enumerate(sh.mesh.coords()):
            e, kp, _ = log[w * n + k]
            g0 = coord[0] * Gl
            assert e.shape[0] == Gl
            np.testing.assert_array_equal(e.numpy(), idx[w, g0:g0 + Gl])
            np.testing.assert_array_equal(kp.numpy(), keep[w, g0:g0 + Gl])
    assert not keep.all() and keep.any()      # some tokens dropped
    got = Sharded(outs, PartitionSpec(*spec, None), tuple(h.shape),
                  sh.mesh).gather()
    assert _rel(got, jax_out[f"moe_layer/{mode}/out"]) <= 1e-5
    assert _rel(got, whole) <= 1e-5
    want = float(jax_out[f"moe_layer/{mode}/aux"])
    assert abs(float(aux) / want - 1) <= 1e-6
    assert abs(float(whole_aux) / want - 1) <= 1e-6


PORT_ONLY = {
    # the ssm and moe families on the sp profile: a Mamba block gathers
    # the sequence and scans it whole; the experts gather it with the
    # batch before the global wave layout
    "mamba2-sp": ("mamba2-370m", dict(sharding_profile="sp")),
    "qwen3-moe-sp": ("qwen3-moe-30b-a3b", dict(sharding_profile="sp")),
    # the vlm and encdec families on tp: heads over model
    "qwen2-vl-tp": ("qwen2-vl-2b", dict(sharding_profile="tp")),
    # (at 1 + 1 layers: whisper's smoke model is chaotic past one, its
    # tp hidden 1.7e-5 from unsharded at 2 + 2 where sp's is bit-equal)
    "whisper-tp": ("whisper-tiny", dict(sharding_profile="tp", n_layers=1,
                                        n_enc_layers=1)),
    # 2 ssm heads do not divide model 4, 128 channels do: each shard
    # gathers z and the conv's output and scans both heads
    "mamba2-fallback": ("mamba2-370m", dict(ssm_head_dim=64)),
    # a pod axis: batch over ("pod", "data")
    "zamba2-pod": ("zamba2-1.2b", {}),
}


@pytest.mark.parametrize("case", PORT_ONLY)
def test_other_layouts_equal_unsharded(case):
    arch, changes = PORT_ONLY[case]
    cfg = dataclasses.replace(get_config(arch, smoke=True), **changes)
    shape, names = (((2, 2, 2), ("pod", "data", "model"))
                    if case.endswith("pod") else (MESH, ("data", "model")))
    sh = Sharder(cpu_mesh(shape, names), cfg.sharding_profile)
    model = build(cfg, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(13)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 16)))
    extra = stub_inputs(cfg, 4, 16, dtype=torch.float32, device="cpu")
    extra = {k: torch.as_tensor(rng.standard_normal(v.shape),
                                dtype=v.dtype) if v.is_floating_point()
             else v for k, v in extra.items()}
    batch = {"tokens": tokens, "labels": tokens.roll(1, 1), **extra}
    params = init_train_state(model)["params"]
    l1, _, g1 = value_and_grad(model, params, batch)
    l2, _, g2 = value_and_grad(model, params, batch,
                               functools.partial(loss_fn, sharder=sh))
    assert abs(float(l2) / float(l1) - 1) <= 1e-5
    for name, g in g1.items():
        err = float((g2[name] - g).abs().max())
        assert err <= 1e-4 * max(float(g.abs().max()), 1e-3), name
    serve = {"tokens": tokens[:, :12],
             **{k: v for k, v in extra.items() if k != "positions"}}
    want = greedy_generate(model, serve, steps=3, max_len=16)
    got = greedy_generate(model, serve, steps=3, max_len=16, sharder=sh)
    assert torch.equal(got, want)


def test_prefill_step_on_every_family_gives_a_sharded_cache(inputs,
                                                            jax_out):
    for case in ("qwen3-moe-split", "zamba2", "whisper"):
        model = _model(case, jax_out)
        sh = Sharder(cpu_mesh(), model.cfg.sharding_profile)
        batch = {"tokens": torch.as_tensor(inputs[f"{case}/prompt"]),
                 **_extra(inputs, case, "serve")}
        t1, _ = make_prefill_step(model, MAX_LEN)(batch)
        t2, cache = make_prefill_step(model, MAX_LEN, sharder=sh)(batch)
        assert torch.equal(t1, t2)
        assert all(isinstance(leaf, Sharded)
                   for _, leaf in flatten(cache))


BF16_ARCHS = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "mamba2-370m",
              "zamba2-1.2b", "qwen2-vl-2b", "whisper-tiny")


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_sharded_step_and_serve(arch):
    """bf16 compute on every family's shard program: the step's loss
    within 1e-3 relative of the unsharded step's (bf16 resolves 3.9e-3;
    measured at most 1.5e-4), the served logits finite (bf16 routing and
    roundings part the two runs' logits by up to a quarter of their
    max-abs on these smoke models, so they are not held to each other)."""
    cfg = get_config(arch, smoke=True)
    sh = Sharder(cpu_mesh(), cfg.sharding_profile)
    rng = np.random.default_rng(17)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 16)))
    extra = {k: torch.as_tensor(rng.standard_normal(v.shape)).to(v.dtype)
             for k, v in stub_inputs(cfg, 4, 16, dtype=torch.bfloat16,
                                     device="cpu").items()}
    batch = {"tokens": tokens, "labels": tokens.roll(1, 1), **extra}
    losses = []
    for s in (None, sh):
        master = build(cfg, device="cpu", dtype=torch.float32)
        _, m = make_train_step(master, AdamWConfig(), sharder=s)(
            init_train_state(master), batch)
        losses.append(float(m["loss"]))
    assert abs(losses[1] / losses[0] - 1) <= 1e-3, losses
    model = build(cfg, device="cpu", dtype=torch.bfloat16)
    hidden, cache = model.prefill(tokens, 20, sharder=sh, **extra)
    assert hidden.pieces[0].dtype == torch.bfloat16
    tok = tokens[:, 0]
    for i in range(2):
        logits, cache = model.decode_step(tok, cache, 16 + i, sharder=sh)
        got = logits.gather()
        assert got.shape == (4, cfg.padded_vocab)
        assert bool(torch.isfinite(got[:, :cfg.vocab_size]).all())
        tok = got.argmax(-1)
