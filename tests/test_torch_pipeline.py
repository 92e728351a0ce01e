"""The port's GPipe pipeline (``parallel/pipeline.py``) and the pipelined
loss (``train.train_step.pipelined_loss_fn``) against the JAX package's
``gpipe``, on the CPU.

The JAX side runs once in a subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` on a 4-stage
("stage",) mesh with an ``AxisType.Auto`` axis: ``tests/test_distributed.py``'s
tanh stack (forward and the gradient of the summed squares) at 1, 2 and 4
microbatches, and a qwen3-0.6b smoke model cut to 4 layers whose dense
blocks run one a stage, with the model's chunked cross-entropy on top
(the JAX pipeline dry-run's step, ``launch/dryrun_pp.py``, with the
model's own loss), in fp32 from ``PRNGKey(0)`` weights and numpy-seeded
batches.  The port side runs in-process on a CPU ``TileMesh``.

Tolerances: the tanh stack's outputs and grads within 1e-5 absolute of
JAX's (JAX's own test holds its pipeline to its sequential run so); the
model's loss within 1e-5 relative and each gradient leaf within 3e-4 of
its max-abs of JAX's (``tests/test_torch_lm_dense.py``'s fp32 bound), and
within 1e-5 relative and 1e-5 of the max-abs of the port's unpipelined
run.
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
from repro_torch.models.convert import from_jax_params, to_jax_tree
from repro_torch.models.layers import flatten, set_path
from repro_torch.models.model_zoo import build
from repro_torch.parallel.halo import make_mesh
from repro_torch.parallel.pipeline import gpipe, split_stages
from repro_torch.train.train_step import loss_fn, pipelined_loss_fn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = 4
TANH_MBS = (1, 2, 4)
LM_MBS = (2, 4)
LM_LAYERS, LM_B, LM_S = 4, 4, 16


def _inputs():
    rng = np.random.default_rng(28)
    return {"W": (rng.standard_normal((8, 16, 16)) * 0.2).astype(np.float32),
            "x": rng.standard_normal((8, 5, 16)).astype(np.float32),
            "tokens": rng.integers(0, 512, (LM_B, LM_S)),
            "labels": rng.integers(0, 512, (LM_B, LM_S))}


JAX_SIDE = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models.layers import rms_norm
from repro.models.model_zoo import build
from repro.models.transformer import dense_block
from repro.parallel.pipeline import gpipe, split_stages
from repro.train.loss import chunked_xent

cfg = json.loads(sys.argv[1])
inp = dict(np.load(cfg["inputs"]))
S = cfg["stages"]
mesh = jax.make_mesh((S,), ("stage",), axis_types=(AxisType.Auto,))
out = {}


def flat(prefix, tree):
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/" + "/".join(k.key for k in path)] = np.asarray(v)


def tanh_stage(ws, x):
    def body(x, w):
        return jnp.tanh(x @ w), None
    x, _ = jax.lax.scan(body, x, ws)
    return x


W, x = jnp.asarray(inp["W"]), jnp.asarray(inp["x"])
for M in cfg["tanh_mbs"]:
    pipe = gpipe(tanh_stage, mesh, "stage", n_microbatches=M)
    with mesh:
        out[f"tanh/M{M}/out"] = np.asarray(jax.jit(
            lambda W: pipe(split_stages(W, S), x))(W))
        out[f"tanh/M{M}/grad"] = np.asarray(jax.jit(jax.grad(
            lambda W: jnp.sum(pipe(split_stages(W, S), x) ** 2)))(W))

mcfg = dataclasses.replace(get_config("qwen3-0.6b", smoke=True),
                           n_layers=cfg["layers"])
api = build(mcfg)
params = api.init(jax.random.PRNGKey(0), jnp.float32)
flat("lm/params0", params)
tokens, labels = jnp.asarray(inp["tokens"]), jnp.asarray(inp["labels"])
L = tokens.shape[1]


def lm_stage(stage_params, x):
    pos = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32), x.shape[:2])

    def body(x, lp):
        y, _, _ = dense_block(mcfg, lp, x, positions=pos, sharder=None,
                              mode="train")
        return y, None
    x, _ = jax.lax.scan(body, x, stage_params)
    return x


for M in cfg["lm_mbs"]:
    pipe = gpipe(lm_stage, mesh, "stage", n_microbatches=M)

    def loss(p):
        h = pipe(split_stages(p["layers"], S), jnp.take(p["embed"], tokens,
                                                        axis=0))
        h = rms_norm(h, p["final_norm"], mcfg.norm_eps)
        return chunked_xent(p["lm_head"], h, labels,
                            valid_vocab=mcfg.vocab_size)
    with mesh:
        val, grads = jax.jit(jax.value_and_grad(loss))(params)
    out[f"lm/M{M}/loss"] = np.asarray(val)
    flat(f"lm/M{M}/grads", grads)
np.savez(cfg["out"], **out)
print("jax side ok")
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny ops: one intra-op thread (restored after the module)."""
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
    d = tmp_path_factory.mktemp("jax_pipe")
    np.savez(d / "inputs.npz", **inputs)
    cfg = {"inputs": str(d / "inputs.npz"), "out": str(d / "out.npz"),
           "stages": STAGES, "tanh_mbs": TANH_MBS, "lm_mbs": LM_MBS,
           "layers": LM_LAYERS}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, json.dumps(cfg)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0 and "jax side ok" in r.stdout, r.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


def stage_mesh(n=STAGES):
    return make_mesh((n,), ("stage",), devices="cpu")


def tanh_stage(ws, x):
    for w in ws:
        x = torch.tanh(x @ w)
    return x


# --- gpipe against JAX's --------------------------------------------------------

@pytest.mark.parametrize("M", TANH_MBS)
def test_gpipe_forward_matches_jax(M, inputs, jax_out):
    W, x = torch.tensor(inputs["W"]), torch.tensor(inputs["x"])
    pipe = gpipe(tanh_stage, stage_mesh(), "stage", n_microbatches=M)
    out = pipe(split_stages(W, STAGES), x)
    assert out.shape == x.shape
    assert np.abs(out.numpy() - jax_out[f"tanh/M{M}/out"]).max() <= 1e-5
    ref = x
    for w in W:
        ref = torch.tanh(ref @ w)
    assert (out - ref).abs().max() <= 1e-5


@pytest.mark.parametrize("M", TANH_MBS)
def test_gpipe_grads_match_jax(M, inputs, jax_out):
    W = torch.tensor(inputs["W"], requires_grad=True)
    x = torch.tensor(inputs["x"])
    pipe = gpipe(tanh_stage, stage_mesh(), "stage", n_microbatches=M)
    (g,) = torch.autograd.grad((pipe(split_stages(W, STAGES), x) ** 2).sum(),
                               W)
    assert np.abs(g.numpy() - jax_out[f"tanh/M{M}/grad"]).max() <= 1e-5


def test_gpipe_runs_the_schedule_and_no_bubble():
    # T = M + S - 1 ticks; stage s takes microbatch t - s at tick t, and a
    # bubble runs nothing (JAX runs it on zeros and discards it)
    S, M = 3, 4
    calls = []

    def stage(p, x):
        calls.append((int(p), int(x[0, 0])))
        return x + 100 * (int(p) + 1)

    x = torch.arange(M * 2, dtype=torch.float32).reshape(M * 2, 1)
    out = gpipe(stage, stage_mesh(S), "stage", M)(torch.arange(S), x)
    assert torch.equal(out, x + 600)
    assert len(calls) == S * M
    assert calls[:4] == [(0, 0), (0, 2), (1, 100), (0, 4)]
    ticks = [s + mb for s in range(S) for mb in range(M)]
    assert max(ticks) + 1 == M + S - 1


def test_gpipe_and_split_stages_validate():
    with pytest.raises(ValueError, match="not divisible by microbatches"):
        gpipe(tanh_stage, stage_mesh(), "stage", 3)(
            torch.zeros(4, 1, 2, 2), torch.zeros(8, 2))
    with pytest.raises(ValueError, match="7 layers not divisible"):
        split_stages({"w": torch.zeros(7, 2)}, 4)
    tree = split_stages({"a": torch.zeros(8, 3), "b": [torch.zeros(8)]}, 4)
    assert tree["a"].shape == (4, 2, 3) and tree["b"][0].shape == (4, 2)


def test_gpipe_stages_ride_one_axis_of_a_larger_mesh():
    # stages on "stage" of a (stage, data) mesh: stage s sits at (s, 0)
    mesh = make_mesh((2, 2), ("stage", "data"), devices="cpu")
    W, x = torch.randn(4, 6, 6) * 0.3, torch.randn(4, 6)
    out = gpipe(tanh_stage, mesh, "stage", 2)(split_stages(W, 2), x)
    ref = x
    for w in W:
        ref = torch.tanh(ref @ w)
    assert (out - ref).abs().max() <= 1e-6


# --- the pipelined loss -----------------------------------------------------------

def _tree(out, prefix):
    tree = {}
    for key, v in out.items():
        if key.startswith(prefix + "/"):
            set_path(tree, tuple(key[len(prefix) + 1:].split("/")), v)
    return tree


def _lm(jax_out, impl="xla"):
    cfg = dataclasses.replace(get_config("qwen3-0.6b", smoke=True),
                              n_layers=LM_LAYERS, attn_impl=impl)
    return from_jax_params(cfg, _tree(jax_out, "lm/params0"), device="cpu",
                           dtype=torch.float32)


def _grads(model, loss):
    names, leaves = zip(*model.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, leaves)))


@functools.lru_cache(maxsize=None)
def _unpipelined(impl):
    model = _lm(_CACHE["jax"], impl)
    loss, _ = loss_fn(model, _CACHE["batch"], remat=False)
    return float(loss), to_jax_tree(model.cfg, _grads(model, loss))


_CACHE: dict = {}


@pytest.fixture(scope="module")
def lm_batch(inputs, jax_out):
    batch = {k: torch.as_tensor(inputs[k]) for k in ("tokens", "labels")}
    _CACHE.update(jax=jax_out, batch=batch)
    yield batch
    _unpipelined.cache_clear()
    _CACHE.clear()


LM_CASES = [(M, impl) for M in LM_MBS for impl in ("xla", "flash")]


@pytest.mark.parametrize("M,impl", LM_CASES)
def test_pipelined_loss_and_grads_match_jax_and_unpipelined(M, impl,
                                                             lm_batch,
                                                             jax_out):
    model = _lm(jax_out, impl)
    loss, parts = pipelined_loss_fn(model, lm_batch, stage_mesh(),
                                    n_microbatches=M)
    assert parts["nll"] is loss
    grads = dict(flatten(to_jax_tree(model.cfg, _grads(model, loss))))
    want = float(jax_out[f"lm/M{M}/loss"])
    assert abs(float(loss) / want - 1) <= 1e-5
    for path, g in flatten(_tree(jax_out, f"lm/M{M}/grads")):
        err = np.abs(grads[path] - g).max()
        assert err <= 3e-4 * max(np.abs(g).max(), 1e-3), (path, err)
    base_loss, base_grads = _unpipelined(impl)
    assert abs(float(loss) / base_loss - 1) <= 1e-5
    for path, g in flatten(base_grads):
        err = np.abs(grads[path] - g).max()
        assert err <= 1e-5 * max(np.abs(g).max(), 1e-3), (path, err)


@pytest.mark.parametrize("stages,M", [(1, 1), (2, 1), (2, 4), (4, 1)])
def test_pipelined_loss_equals_unpipelined_at_other_schedules(stages, M):
    cfg = dataclasses.replace(get_config("qwen3-0.6b", smoke=True),
                              n_layers=LM_LAYERS)
    model = build(cfg, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(stages * 10 + M)
    batch = {k: torch.as_tensor(rng.integers(0, 512, (4, 8)))
             for k in ("tokens", "labels")}
    base, _ = loss_fn(model, batch, remat=False)
    g0 = _grads(model, base)
    loss, _ = pipelined_loss_fn(model, batch, stage_mesh(stages),
                                n_microbatches=M)
    g1 = _grads(model, loss)
    assert abs(float(loss) / float(base) - 1) <= 1e-5
    for name, g in g0.items():
        assert (g1[name] - g).abs().max() <= 1e-5 * max(
            float(g.abs().max()), 1e-3), name


def test_pipelined_loss_takes_the_dense_family_only():
    model = build(get_config("mamba2-370m", smoke=True), device="cpu",
                  dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="ssm"):
        pipelined_loss_fn(model, {"tokens": torch.zeros(2, 4).long(),
                                  "labels": torch.zeros(2, 4).long()},
                          stage_mesh(2), n_microbatches=1)
