"""``state_over_data`` execution (batch-1 decode, the cache state spread
over the data axis) in every family's shard program, on the CPU.

Each family's smoke model decodes at batch 1 on a 2 x 4 ("data", "model")
CPU mesh with ``Sharder(..., state_over_data=True)``: the kv caches on
kv_seq over ("model", "data"), the SSD state's head dim over data.  Held
against the port's unsharded decode from the same weights and prompt
(fp32; logits within 1e-5 of their max-abs, as
``tests/test_torch_sharded_families.py`` holds the sharded programs, and
every cache leaf gathered within 1e-5 of the unsharded cache's max-abs),
and, for the families whose JAX step runs there (ssm, hybrid, dense, moe,
vlm, encdec), against JAX's ``make_decode_step`` under the same
``Sharder`` on 8 forced host devices with ``AxisType.Auto`` axes, run in
subprocesses as ``tests/test_torch_halo.py`` does (prefill hidden and
decode logits within 1e-4 of their max-abs, whisper's 5e-4: the family
tests' fp32 bounds).

The prompt is 12 tokens in a cache of 16: kv_seq splits 8 ways, 2
positions a shard, block b = 2·model + data (the model axis major).  The
three decode steps write kv_len 12, 13 (block 6: model 3, data 0) and 14
(block 7: model 3, data 1, a data-major block).

bf16: mamba2-370m at full width and 4 of its 48 layers decodes 8 tokens at
batch 1 from a seeded random SSD and conv state, sharded under the flag,
unsharded and in fp32, in JAX (one of the subprocesses) and in the port
from JAX's weights.  JAX's sharded bf16 decode equals its unsharded one
bit for bit (its all-reduces add the f32 dot outputs); the port's adds its
row-parallel partial products in fp32 too (``sharding.psum_rounded``), so
each token lies no farther from fp32 sharded than unsharded, within
``chip_smoke.py``'s ``DIST_BF16_RATIO`` (1.5), and parts from its own
unsharded decode by less than the two frameworks' unsharded decodes part.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.models.convert import from_jax_params
from repro_torch.models.layers import flatten, set_path
from repro_torch.models.model_zoo import build
from repro_torch.parallel.halo import make_mesh
from repro_torch.parallel.sharding import Sharded, Sharder
from repro_torch.train.serve_step import make_prefill_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = (2, 4)
PROMPT, MAX_LEN, STEPS = 12, 16, 3
JAX_ARCHS = ("mamba2-370m", "zamba2-1.2b", "qwen3-0.6b",
             "qwen3-moe-30b-a3b", "qwen2-vl-2b", "whisper-tiny")
# The JAX subprocesses, run at once.
GROUPS = (("mamba2-370m", "qwen3-0.6b"), ("zamba2-1.2b",),
          ("qwen3-moe-30b-a3b",), ("qwen2-vl-2b", "whisper-tiny"))
JAX_BOUND = {"encdec": 5e-4}
# The bf16 decode: its layers, tokens, the subprocess that runs it, and the
# hold of chip_smoke.py's phase 39 (c).
BF16_LAYERS, BF16_TOKENS, BF16_GROUP, DIST_BF16_RATIO = 4, 8, 2, 1.5


def _inputs():
    rng = np.random.default_rng(30)
    d = {}
    for arch in list_archs():
        cfg = get_config(arch, smoke=True)
        d[f"{arch}/prompt"] = rng.integers(0, cfg.vocab_size, (1, PROMPT))
        d[f"{arch}/next"] = rng.integers(0, cfg.vocab_size, (STEPS, 1))
        if cfg.family == "vlm":
            d[f"{arch}/vision_embeds"] = rng.standard_normal(
                (1, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec":
            d[f"{arch}/enc_frames"] = rng.standard_normal(
                (1, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return d


JAX_SIDE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models.model_zoo import build
from repro.parallel.sharding import Sharder
from repro.train.serve_step import make_decode_step

cfg = json.loads(sys.argv[1])
inp = dict(np.load(cfg["inputs"]))
mesh = jax.make_mesh(tuple(cfg["mesh"]), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
out = {}
for arch in cfg["archs"]:
    mcfg = get_config(arch, smoke=True)
    api = build(mcfg)
    sh = Sharder(mesh=mesh, profile=mcfg.sharding_profile,
                 state_over_data=True)
    params = api.init(jax.random.PRNGKey(0), jnp.float32)
    for path, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        out[arch + "/params/" + "/".join(k.key for k in path)] = \
            np.asarray(v)
    batch = {"tokens": jnp.asarray(inp[arch + "/prompt"])}
    for k in ("vision_embeds", "enc_frames"):
        if arch + "/" + k in inp:
            batch[k] = jnp.asarray(inp[arch + "/" + k])
    with mesh:
        hidden, cache = jax.jit(lambda p, b: api.prefill(
            p, b, cfg["max_len"], sharder=sh))(params, batch)
        out[arch + "/hidden"] = np.asarray(hidden)
        decode = jax.jit(lambda p, t, c, n: api.decode_step(
            p, t, c, n, sharder=sh))
        for i in range(cfg["steps"]):
            tok = jnp.asarray(inp[arch + "/next"][i])
            logits, cache = decode(params, tok, cache,
                                   jnp.int32(cfg["prompt"] + i))
            out[arch + "/logits%d" % i] = np.asarray(logits)

if cfg["bf16_layers"]:
    # mamba2-370m in bf16 at full width: sharded, unsharded and fp32 from
    # one seeded random cache.
    import dataclasses
    mcfg = dataclasses.replace(get_config("mamba2-370m"),
                               n_layers=cfg["bf16_layers"])
    api = build(mcfg)
    params = api.init(jax.random.PRNGKey(0), jnp.bfloat16)
    for path, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["bf16/params/" + "/".join(k.key for k in path)] = \
            np.asarray(v.astype(jnp.float32))
    rng = np.random.default_rng(31)
    cache = {}
    shapes = api.cache_shapes(1, 16)
    for path, st in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        name = "/".join(k.key for k in path)
        cache[name] = (rng.standard_normal(st.shape).astype(np.float32),
                       st.dtype)
        out["bf16/cache/" + name] = cache[name][0]
    toks = rng.integers(0, mcfg.vocab_size, (cfg["bf16_tokens"], 1))
    out["bf16/tokens"] = toks
    sh = Sharder(mesh=mesh, profile=mcfg.sharding_profile,
                 state_over_data=True)
    p32 = jax.tree.map(lambda t: t.astype(jnp.float32), params)
    runs = (("sharded", params, None, sh), ("unsharded", params, None, None),
            ("fp32", p32, jnp.float32, None))
    for name, p, dt, s in runs:
        c = {k: jnp.asarray(a, dt or d) for k, (a, d) in cache.items()}
        with mesh:
            dec = jax.jit(lambda p, t, c, n, s=s: api.decode_step(
                p, t, c, n, sharder=s))
            for i in range(cfg["bf16_tokens"]):
                lg, c = dec(p, jnp.asarray(toks[i], jnp.int32), c,
                            jnp.int32(8 + i))
                out[f"bf16/{name}/{i}"] = np.asarray(
                    lg[:, :mcfg.vocab_size].astype(jnp.float32))
np.savez(cfg["out"], **out)
print("jax side ok")
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory, inputs):
    d = tmp_path_factory.mktemp("jax_sod")
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    procs = []
    for i, group in enumerate(GROUPS):
        cfg = {"inputs": str(d / "inputs.npz"), "out": str(d / f"{i}.npz"),
               "mesh": MESH, "archs": group, "max_len": MAX_LEN,
               "prompt": PROMPT, "steps": STEPS,
               "bf16_layers": BF16_LAYERS if i == BF16_GROUP else 0,
               "bf16_tokens": BF16_TOKENS}
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


def _sharder(cfg, flag=True):
    return Sharder(make_mesh(MESH, ("data", "model"), devices="cpu"),
                   cfg.sharding_profile, state_over_data=flag)


def _extra(inputs, arch):
    out = {}
    for k in ("vision_embeds", "enc_frames"):
        if f"{arch}/{k}" in inputs:
            out[k] = torch.as_tensor(inputs[f"{arch}/{k}"])
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _leaves(cache):
    return [(path, leaf) for path, leaf in flatten(cache)]


def _decode_both(model, inputs, arch):
    """(sharded run, unsharded run): each the prefill hidden, the logits
    of every step and the final cache (the sharded one gathered)."""
    cfg = model.cfg
    sh = _sharder(cfg)
    prompt = torch.as_tensor(inputs[f"{arch}/prompt"])
    extra = _extra(inputs, arch)
    runs = []
    for s in (sh, None):
        kw = {} if s is None else {"sharder": s}
        hidden, cache = model.prefill(prompt, MAX_LEN, **extra, **kw)
        logits = []
        for i in range(STEPS):
            tok = torch.as_tensor(inputs[f"{arch}/next"][i])
            lg, cache = model.decode_step(tok, cache, PROMPT + i, **kw)
            logits.append(lg.gather() if s is not None else lg)
        if s is not None:
            hidden = hidden.gather()
        cache = {".".join(p): leaf for p, leaf in _leaves(cache)}
        runs.append((hidden, logits, cache))
    return runs


@pytest.mark.parametrize("arch", list_archs())
def test_every_family_decodes_under_the_flag(arch, inputs):
    cfg = get_config(arch, smoke=True)
    model = build(cfg, device="cpu", dtype=torch.float32)
    (h, logits, cache), (h0, logits0, cache0) = _decode_both(model, inputs,
                                                            arch)
    assert _rel(h, h0) <= 1e-5
    for got, want in zip(logits, logits0):
        assert _rel(got, want) <= 1e-5
    assert set(cache) == set(cache0)
    for name, leaf in cache.items():
        assert isinstance(leaf, Sharded), name
        assert _rel(leaf.gather(), cache0[name]) <= 1e-5, name


def test_prefill_lays_its_cache_by_the_flag(inputs):
    """The specs a decode takes: kv_seq over ("model", "data"), the SSD
    state's head dim over data, the conv state on its channels; the cross
    cache (enc_seq, no rule) whole."""
    want = {
        "mamba2-370m": {"state": (None, None, "model", "data", None),
                        "conv_x": (None, None, None, "model")},
        "zamba2-1.2b": {"groups.state": (None, None, None, "model", "data",
                                         None),
                        "attn.k": (None, None, ("model", "data"), None,
                                   None)},
        "qwen3-0.6b": {"k": (None, None, ("model", "data"), None, None)},
        "whisper-tiny": {"self.k": (None, None, ("model", "data"), None,
                                    None),
                         "cross_k": (None, None, None, None, None)},
    }
    for arch, leaves in want.items():
        cfg = get_config(arch, smoke=True)
        model = build(cfg, device="cpu", dtype=torch.float32)
        _, cache = make_prefill_step(model, MAX_LEN, sharder=_sharder(cfg))(
            {"tokens": torch.as_tensor(inputs[f"{arch}/prompt"]),
             **_extra(inputs, arch)})
        flat = {".".join(p): leaf for p, leaf in _leaves(cache)}
        for name, spec in leaves.items():
            assert tuple(flat[name].spec) == spec, (arch, name)


def test_the_new_token_lands_in_its_data_major_block(inputs):
    """kv_len 14 lies in block 7 of 8 (2 positions each): model 3, data 1.
    Only that shard's piece changes, at its local position 0, and its
    value is the unsharded decode's k at position 14 (within 1e-5 of its
    max-abs: the residual streams differ by the sharded sums' order)."""
    arch = "qwen3-0.6b"
    cfg = get_config(arch, smoke=True)
    model = build(cfg, device="cpu", dtype=torch.float32)
    sh = _sharder(cfg)
    prompt = torch.as_tensor(inputs[f"{arch}/prompt"])
    _, cache = model.prefill(prompt, MAX_LEN, sharder=sh)
    _, whole = model.prefill(prompt, MAX_LEN)
    for i in range(2):
        tok = torch.as_tensor(inputs[f"{arch}/next"][i])
        _, cache = model.decode_step(tok, cache, PROMPT + i, sharder=sh)
        _, whole = model.decode_step(tok, whole, PROMPT + i)
    before = [p.clone() for p in cache["k"].pieces]
    tok = torch.as_tensor(inputs[f"{arch}/next"][2])
    model.decode_step(tok, cache, 14, sharder=sh)
    model.decode_step(tok, whole, 14)
    coords = sh.mesh.coords()
    for k, (c, p, b) in enumerate(zip(coords, cache["k"].pieces, before)):
        changed = not torch.equal(p, b)
        assert changed == (c == (1, 3)), c
        if c == (1, 3):
            assert _rel(p[:, :, 0], whole["k"][:, :, 14]) <= 1e-5


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_decode_matches_jax_under_the_flag(arch, inputs, jax_out):
    cfg = get_config(arch, smoke=True)
    tree = {}
    for key, v in jax_out.items():
        if key.startswith(arch + "/params/"):
            set_path(tree, tuple(key.split("/")[2:]), v)
    model = from_jax_params(cfg, tree, device="cpu", dtype=torch.float32)
    (h, logits, _), (h0, logits0, _) = _decode_both(model, inputs, arch)
    bound = JAX_BOUND.get(cfg.family, 1e-4)
    assert _rel(h, jax_out[f"{arch}/hidden"]) <= bound
    assert _rel(h, h0) <= 1e-5
    for i, (got, whole) in enumerate(zip(logits, logits0)):
        assert _rel(got, jax_out[f"{arch}/logits{i}"]) <= bound, i
        assert _rel(got, whole) <= 1e-5, i


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
@pytest.mark.parametrize("arch", ("mamba2-370m", "zamba2-1.2b",
                                  "qwen3-0.6b"))
def test_the_flag_moves_the_state_and_changes_no_number(arch, dtype,
                                                         inputs):
    """The decode under state_over_data equals the same shard program
    without it (the cache on model alone): bit for bit in bf16, where the
    SSD state's head-dim slices, the y gather over data and the
    flash-decoding combine over 8 blocks instead of 4 all round to the
    same values, so a bf16 run's distance from unsharded is the tp
    program's own (its partial products rounded to bf16 before they are
    added); in fp32 within the file's 1e-5 of the logits' max-abs (the
    products over a P slice and the combine over 8 blocks sum in other
    orders: zamba2's smoke decode lies 1.7e-6 off)."""
    cfg = get_config(arch, smoke=True)
    model = build(cfg, device="cpu", dtype=dtype)
    prompt = torch.as_tensor(inputs[f"{arch}/prompt"])
    runs = []
    for flag in (True, False):
        sh = _sharder(cfg, flag)
        _, cache = model.prefill(prompt, MAX_LEN, sharder=sh)
        logits = []
        for i in range(STEPS):
            tok = torch.as_tensor(inputs[f"{arch}/next"][i])
            lg, cache = model.decode_step(tok, cache, PROMPT + i, sharder=sh)
            logits.append(lg.gather())
        runs.append(logits)
    for got, want in zip(*runs):
        if dtype == torch.bfloat16:
            assert torch.equal(got, want)
        else:
            assert _rel(got, want) <= 1e-5


def test_bf16_sharded_decode_against_jax_per_token(jax_out):
    """mamba2-370m's bf16 decode (module docstring), token by token: JAX's
    sharded decode equals its unsharded one; the port's lies within
    DIST_BF16_RATIO of its unsharded distance from fp32 at every token,
    and its sharded-vs-unsharded distance is below the two frameworks'
    unsharded distance."""
    import dataclasses
    cfg = dataclasses.replace(get_config("mamba2-370m"),
                              n_layers=BF16_LAYERS)
    tree = {}
    for key, v in jax_out.items():
        if key.startswith("bf16/params/"):
            set_path(tree, tuple(key.split("/")[2:]), v)
    sh = _sharder(cfg)
    toks = jax_out["bf16/tokens"]
    port = {}
    for name, dtype, s in (("sharded", torch.bfloat16, sh),
                           ("unsharded", torch.bfloat16, None),
                           ("fp32", torch.float32, None)):
        model = from_jax_params(cfg, tree, device="cpu", dtype=dtype)
        cache = model.init_cache(1, 16)
        for path, leaf in flatten(cache):
            leaf.copy_(torch.from_numpy(
                jax_out["bf16/cache/" + "/".join(path)]))
        if s is not None:
            cache = _sharded_cache(model, s, cache)
        kw = {} if s is None else {"sharder": s}
        logits = []
        for i in range(BF16_TOKENS):
            lg, cache = model.decode_step(torch.as_tensor(toks[i]), cache,
                                          8 + i, **kw)
            lg = lg.gather() if s is not None else lg
            logits.append(lg[:, :cfg.vocab_size].float().numpy())
        port[name] = logits
    for i in range(BF16_TOKENS):
        js, ju, jf = (jax_out[f"bf16/{n}/{i}"]
                      for n in ("sharded", "unsharded", "fp32"))
        ps, pu, pf = (port[n][i] for n in ("sharded", "unsharded", "fp32"))
        assert np.array_equal(js, ju), i            # JAX's own ratio: 1
        assert _rel(pf, jf) <= 1e-5, i              # the fp32 runs agree
        assert _rel(ps, pf) <= DIST_BF16_RATIO * _rel(pu, pf), i
        assert _rel(ps, pu) < _rel(pu, ju), i


def _sharded_cache(model, sharder, cache):
    """``cache`` (the model's tree) as ``Sharded`` leaves laid by the
    sharder's specs of its ``cache_dims``."""
    from repro_torch.parallel.sharding import shard
    dims = dict(flatten(model.cache_dims()))
    out = {}
    for path, leaf in flatten(cache):
        spec = sharder.spec(dims[path], tuple(leaf.shape))
        set_path(out, path, Sharded(shard(leaf, spec, sharder.mesh), spec,
                                    tuple(leaf.shape), sharder.mesh))
    return out
