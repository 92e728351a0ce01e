"""The port's op-level cost counter (``launch/hlo_cost.py``) against the
JAX package's HLO analyser, on the CPU.

JAX's two ``TestHLOCostAnalyzer`` functions (``tests/test_loss_and_
sharding.py``) are written in PyTorch and counted by both packages: the
scanned loop of 64 x 64 products exactly, the nested remat loop with its
gradient within JAX's own 5% of 4x the forward (and of each other).  The
flash kernels are charged their analytic work on ``cpu`` and ``meta``
alike; the collectives once a group member, the same on both; and a smoke
train step on a 2 x 4 mesh counts the same on both, every key exactly.
The stencil kernels K1-K5 are charged once a call the bytes of their
operands and result (K5 also its 2·S·N² flops) on both devices, and a
short ``Solver`` run on ``meta`` through ``auto`` counts what the same
plan counts on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.launch.hlo_cost import analyze as jax_analyze
from repro_torch.configs import get_config
from repro_torch.core.stencil import heterogeneous_jacobi, laplace_jacobi
from repro_torch.core.solver import Solver
from repro_torch.kernels.dense_stencil import dense_stencil_matmul
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention_bwd import flash_bwd, flash_fwd
from repro_torch.kernels.jacobi_fused import jacobi2d_fused_step
from repro_torch.kernels.stencil2d import stencil2d
from repro_torch.kernels.stencil3d import stencil3d
from repro_torch.launch.dryrun import native_meta_kernels
from repro_torch.launch.hlo_cost import (CostCounter, analyze,
                                         visible_pairs)
from repro_torch.models.model_zoo import build
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.halo import make_mesh
from repro_torch.parallel.sharding import all_gather, psum
from repro_torch.train.train_step import init_train_state, make_train_step


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jax_flops(fn, *shapes):
    hlo = jax.jit(fn).lower(*(jax.ShapeDtypeStruct(s, jnp.float32)
                              for s in shapes)).compile().as_text()
    return jax_analyze(hlo)["flops"]


def test_scan_trip_count():
    def jf(x, w):
        def body(x, wi):
            return x @ wi, None
        x, _ = jax.lax.scan(body, x, w)
        return x

    def tf(x, w):
        for wi in w:
            x = x @ wi
        return x

    want = 2 * 64 ** 3 * 12
    got = analyze(tf, torch.zeros(64, 64), torch.zeros(12, 64, 64))
    assert got["flops"] == want
    assert _jax_flops(jf, (64, 64), (12, 64, 64)) == pytest.approx(
        want, rel=0.01)


def test_nested_scan_with_remat():
    def jg(x, w):
        w2 = w.reshape(4, 2, 32, 32)

        def outer(x, gw):
            def inner(x, wi):
                return x @ wi, None
            x, _ = jax.lax.scan(inner, x, gw)
            return x, None
        x, _ = jax.lax.scan(jax.checkpoint(outer), x, w2)
        return jnp.sum(x)

    def group(x, gw):
        for wi in gw:
            x = x @ wi
        return x

    def tg(x, w):
        for gw in w.reshape(4, 2, 32, 32):
            x = checkpoint(group, x, gw, use_reentrant=False)
        return x.sum()

    def grad_w(x, w):
        w = w.requires_grad_()
        torch.autograd.grad(tg(x, w), [w])

    fwd = 2 * 16 * 32 * 32 * 8
    one = fwd // 8
    x, w = torch.zeros(16, 32), torch.zeros(8, 32, 32)
    # PyTorch's checkpoint stops its recompute once the saved tensors the
    # backward needs are back: a group's second product is not rerun (its
    # output is saved by nothing), so 8 + 4 + 8 (dw) + 7 (dx; x takes no
    # gradient) products.  The counter sees exactly that.
    assert analyze(grad_w, x, w)["flops"] == 27 * one
    # jax.checkpoint reruns the whole body: so does PyTorch's without the
    # early stop, 8 + 8 + 8 + 7 products, within JAX's 5% of 4x.
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        got = analyze(grad_w, x, w)
    assert got["flops"] == 31 * one
    want = _jax_flops(jax.grad(jg, argnums=1), (16, 32), (8, 32, 32))
    assert got["flops"] == pytest.approx(4 * fwd, rel=0.05)
    assert want == pytest.approx(4 * fwd, rel=0.05)
    assert got["flops"] == pytest.approx(want, rel=0.05)


def test_visible_pairs_match_the_mask():
    for Sq, Skv in ((5, 7), (8, 8), (13, 4)):
        for causal in (True, False):
            for off in (-9, -3, 0, 2, 6, 20):
                i = np.arange(Sq)[:, None]
                j = np.arange(Skv)[None, :] - off
                seen = np.broadcast_to(j < Skv, (Sq, Skv))
                if causal:
                    seen = seen & (j <= i)
                assert visible_pairs(Sq, Skv, causal, off) == seen.sum()


FLASH = [((2, 40, 4, 16), (2, 40, 2, 16), True, 0),
         ((1, 24, 4, 32), (1, 56, 4, 32), False, 0),
         ((2, 16, 6, 16), (2, 48, 2, 16), True, 32)]


@pytest.mark.parametrize("qs,ks,causal,off", FLASH)
def test_flash_kernels_cost_the_same_on_cpu_and_meta(qs, ks, causal, off):
    B, Sq, H, hd = qs
    pairs = visible_pairs(Sq, ks[1], causal, off) * B * H
    esz = 4
    qb, kb = np.prod(qs) * esz, np.prod(ks) * esz
    lse = B * H * Sq * 4
    runs = []
    for dev in ("cpu", "meta"):
        g = torch.Generator().manual_seed(0)
        q, k, v, do = (torch.randn(s, generator=g).to(dev)
                       for s in (qs, ks, ks, qs))
        kw = dict(causal=causal, kv_offset=off)
        with CostCounter() as c6:
            out6 = flash_attention(q, k, v, **kw)
        with CostCounter() as c7:
            out, lse_t = flash_fwd(q, k, v, **kw)
        with CostCounter() as c89:
            dq, dk, dv = flash_bwd(q, k, v, out, lse_t, do, **kw)
        assert out6.shape == out.shape == dq.shape == q.shape
        assert dk.shape == dv.shape == k.shape
        assert lse_t.shape == (B, H, Sq) and lse_t.dtype == torch.float32
        assert c6.flops == c7.flops == 4 * hd * pairs
        assert c6.hbm_bytes == 2 * qb + 2 * kb
        assert c7.hbm_bytes == 2 * qb + 2 * kb + lse
        # K8 6·hd and K9 8·hd; delta = sum(do·o) over hd, a counted
        # PyTorch einsum (a batched product of 2·hd a row and head)
        assert c89.flops == 14 * hd * pairs + 2 * B * Sq * H * hd
        reads = 2 * qb + 2 * kb + 2 * lse
        delta_op = 2 * qb + lse           # do·o then its sum
        assert c89.hbm_bytes >= reads + qb + reads + 2 * kb + delta_op
        runs.append((c6.result(), c7.result(), c89.result()))
    assert runs[0] == runs[1]


def test_collectives_count_once_a_member_on_cpu_and_meta():
    runs = []
    for dev in ("cpu", "meta"):
        mesh = make_mesh((2, 4), ("data", "model"), devices=dev)
        xs = [torch.ones(3, 5, device=dev, requires_grad=True)
              for _ in range(8)]
        with CostCounter() as c:
            s = psum(xs, mesh, "model")
            g = all_gather(xs, mesh, "data", 0)
            loss = sum(t.sum() for t in s) + sum(t.sum() for t in g)
            torch.autograd.grad(loss, xs)
        r = c.result()["collectives"]
        piece = 3 * 5 * 4
        assert r["all-reduce"] == {"count": 16.0,          # 8 + backward 8
                                   "operand_bytes": 16.0 * piece,
                                   "result_bytes": 16.0 * piece}
        assert r["all-gather"] == {"count": 8.0, "operand_bytes": 8.0 * piece,
                                   "result_bytes": 8.0 * 2 * piece}
        assert r["reduce-scatter"] == {"count": 8.0,
                                       "operand_bytes": 8.0 * 2 * piece,
                                       "result_bytes": 8.0 * piece}
        runs.append(c.result())
    assert runs[0] == runs[1]


STEP_ARCHS = ("qwen3-0.6b", "mamba2-370m", "qwen2-vl-2b", "whisper-tiny")


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_smoke_train_step_counts_the_same_on_cpu_and_meta(arch):
    """The step the dry run counts, on a 2 x 4 mesh of each device type
    (the meta run under ``native_meta_kernels``, as the dry run's)."""
    results = []
    for dev in ("cpu", "meta"):
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  attn_impl="flash")
        model = build(cfg, device=dev, dtype=torch.float32)
        mesh = make_mesh((2, 4), ("data", "model"), devices=dev)
        from repro_torch.parallel.sharding import Sharder
        step = make_train_step(model, AdamWConfig(),
                               sharder=Sharder(mesh, cfg.sharding_profile))
        tok = torch.zeros(4, 32, dtype=torch.long, device=dev)
        batch = {"tokens": tok, "labels": tok}
        if cfg.family == "encdec":
            batch["enc_frames"] = torch.zeros(4, cfg.enc_len, cfg.d_model,
                                              device=dev)
        state = init_train_state(model)
        if dev == "meta":
            with native_meta_kernels():
                r = analyze(step, state, batch)
        else:
            r = analyze(step, state, batch)
        results.append(r)
    cpu, meta = results
    assert cpu["flops"] > 0 and cpu["hbm_bytes"] > 0
    assert {k: cpu[k] for k in ("flops", "hbm_bytes", "collectives")} == \
        {k: meta[k] for k in ("flops", "hbm_bytes", "collectives")}
    assert sum(c["count"] for c in cpu["collectives"].values()) > 0


def _variable_spec(shape):
    """Four per-cell field taps (V = 4) on a grid of ``shape``."""
    rng = np.random.default_rng(7)
    return heterogeneous_jacobi(rng.uniform(0.5, 1.5, shape))


# (name, call on a device -> (fn, args, kwargs), reckoned bytes, flops)
STENCILS = [
    ("K1 scalar taps", lambda d: (stencil2d, (torch.zeros(3, 20, 24, device=d),
                                              laplace_jacobi(2)),
                                  {"bc_value": 1.0}), 2 * 3 * 20 * 24 * 4, 0),
    ("K1 field taps", lambda d: (stencil2d, (torch.zeros(3, 20, 24, device=d),
                                             _variable_spec((20, 24))), {}),
     2 * 3 * 20 * 24 * 4 + 4 * 20 * 24 * 4, 0),
    ("K2 trapezoid passes", lambda d: (
        jacobi2d_fused_step, (torch.zeros(2, 40, 40, device=d),
                              laplace_jacobi(2)),
        {"fuse": 40, "bc_value": 0.5}), 2 * 2 * 40 * 40 * 4, 0),
    ("K3 resident", lambda d: (
        jacobi2d_fused_step, (torch.zeros(2, 16, 16, device=d),
                              laplace_jacobi(2)),
        {"fuse": 8, "bc_value": 1.0, "rim": "resident"}),
     2 * 2 * 16 * 16 * 4, 0),
    ("K4", lambda d: (stencil3d, (torch.zeros(2, 6, 8, 12, device=d),
                                  laplace_jacobi(3)), {"bc_value": 1.0}),
     2 * 2 * 6 * 8 * 12 * 4, 0),
    ("K5 fp32", lambda d: (dense_stencil_matmul,
                           (torch.zeros(5, 48, device=d),
                            torch.zeros(48, 48, device=d)), {}),
     (2 * 5 * 48 + 48 * 48) * 4, 2 * 5 * 48 * 48),
    ("K5 bf16", lambda d: (dense_stencil_matmul,
                           (torch.zeros(5, 48, device=d, dtype=torch.bfloat16),
                            torch.zeros(48, 48, device=d,
                                        dtype=torch.bfloat16)), {}),
     (2 * 5 * 48 + 48 * 48) * 2, 2 * 5 * 48 * 48),
]


@pytest.mark.parametrize("name,call,hbm,flops", STENCILS,
                         ids=[c[0] for c in STENCILS])
def test_stencil_kernels_charge_their_operands_on_cpu_and_meta(name, call,
                                                               hbm, flops):
    got = {}
    for dev in ("cpu", "meta"):
        fn, args, kw = call(dev)
        with CostCounter() as c:
            out = fn(*args, **kw)
        assert out.shape == args[0].shape and out.device.type == dev
        got[dev] = c.result()
    assert got["cpu"] == got["meta"]
    assert got["cpu"]["hbm_bytes"] == hbm
    assert got["cpu"]["flops"] == flops


@pytest.mark.parametrize("spec,grid,batch,backend", [
    (laplace_jacobi(2), (16, 16), 3, "auto"),
    (_variable_spec((12, 20)), (12, 20), 2, "auto"),
    (_variable_spec((12, 20)), (12, 20), 2, "cuda"),
    (laplace_jacobi(3), (6, 8, 8), 2, "auto"),
], ids=["laplace", "variable", "variable-K1", "3d"])
def test_a_solve_counts_the_same_on_cpu_and_meta(spec, grid, batch,
                                                 backend):
    """``auto`` on ``meta`` prices as the card and picks a kernel backend;
    the same plan on the CPU (its kernels' plain versions, a solve that
    does not converge in the 64 iterations) counts the same, every key,
    the kernels charged once a call.  ``cuda`` at fuse 1 takes K1 one
    step a call, after the shell is set."""
    kw = dict(bc=1.0, rtol=1e-9, max_iters=64, check_every=16)
    fuse = 1 if backend == "cuda" else None
    meta = Solver(spec, grid, backend=backend, fuse=fuse, device="meta",
                  **kw)
    assert meta.backend in ("cuda", "cuda_fused")
    cpu = Solver(spec, grid, backend=meta.backend, fuse=meta.fuse,
                 device="cpu", **kw)
    assert (cpu.fuse, cpu.plan.rim) == (meta.fuse, meta.plan.rim)
    counts = [analyze(s.run, torch.zeros(batch, *grid, device=d))
              for s, d in ((cpu, "cpu"), (meta, "meta"))]
    assert counts[0] == counts[1]
    # every chunk's kernel calls charged their operands at the least
    calls = 64 // meta.fuse
    cells = int(np.prod(grid))
    assert counts[0]["hbm_bytes"] >= calls * 2 * batch * 4 * cells
