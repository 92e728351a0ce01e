"""The port's serving engine against the JAX package's, on the CPU: the
cases of tests/serve/test_engine.py, each request also run through the
JAX package's engine on the same inputs.

A request served by the port's engine must equal the same request solved
alone through the port's cache, bit for bit (coalescing is an execution
detail), and take the iterations the JAX package's engine takes, with the
field within 1e-6 absolute of it (its compiled reference rounds the same
sums in another order).  All engine interaction goes through
``asyncio.run``.
"""
import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.serve as JS
import repro_torch.core as T
from repro_torch.serve import EngineStats, RejectedError, ServingEngine

GRID = (12, 12)
BC = 0.5
KW = dict(bc=BC, rtol=1e-4, check_every=10, max_iters=2000)
JAX_TOL = 1e-6


def _x0(seed=0, grid=GRID, bc=BC):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(grid).astype(np.float32)
    shell = np.ones(grid, np.float32)
    shell[tuple(slice(1, -1) for _ in grid)] = 0.0
    return x * (1.0 - shell) + bc * shell


def _cache():
    return T.PlanCache(probe=False, device="cpu")


def _serve(pkg, submits, **engine_kw):
    """Run ``submits`` (a list of (args, kwargs)) concurrently through a
    fresh engine of ``pkg`` ("jax" or "torch"); returns (engine, results,
    cache)."""
    if pkg == "jax":
        cache, spec = J.PlanCache(probe=False), J.laplace_jacobi(2)
        Engine, conv = JS.ServingEngine, jnp.asarray
    else:
        cache, spec = _cache(), T.laplace_jacobi(2)
        Engine, conv = ServingEngine, (lambda a: a)

    async def main():
        eng = Engine(cache, **engine_kw)
        async with eng:
            results = await asyncio.gather(
                *(eng.submit(spec, conv(x0), **kw) for x0, kw in submits))
        return eng, results

    eng, results = asyncio.run(main())
    return eng, results, cache


def _equal_to_jax(submits, got, **engine_kw):
    _, want, _ = _serve("jax", submits, **engine_kw)
    for g, w in zip(got, want):
        assert g.iterations == w.iterations and g.converged == w.converged
        np.testing.assert_allclose(np.asarray(g.x), np.asarray(w.x), rtol=0,
                                   atol=JAX_TOL)


def test_round_trip_matches_direct_solve():
    submits = [(_x0(), KW)]
    eng, (res,), cache = _serve("torch", submits, max_wait=0.0)
    want = cache.solve(T.laplace_jacobi(2), _x0(), **KW)
    assert res.converged and tuple(res.x.shape) == GRID
    assert torch.equal(res.x, want.x)
    assert res.iterations == want.iterations
    _equal_to_jax(submits, [res], max_wait=0.0)


def test_coalescing_is_exact_and_batches_once():
    submits = [(_x0(seed=s), KW) for s in range(5)]
    eng, results, cache = _serve("torch", submits, max_batch=8, max_wait=0.1)
    assert eng.stats.batches == 1 and eng.stats.coalesced == 5
    assert eng.stats.mean_batch == 5.0
    for (x0, _), res in zip(submits, results):
        want = cache.solve(T.laplace_jacobi(2), x0, **KW)
        assert torch.equal(res.x, want.x)
        assert res.iterations == want.iterations
        assert res.converged == want.converged
        assert (res.residual_history.shape[0]
                >= want.residual_history.shape[0])
    assert len({r.iterations for r in results}) > 1
    _equal_to_jax(submits, results, max_batch=8, max_wait=0.1)


def test_per_request_sources_coalesce():
    rng = np.random.default_rng(9)
    srcs = [None, (rng.standard_normal(GRID) * 1e-2).astype(np.float32)]
    submits = [(_x0(seed=i), dict(KW, source=s)) for i, s in enumerate(srcs)]
    eng, results, cache = _serve("torch", submits, max_batch=4, max_wait=0.1)
    assert eng.stats.batches == 1
    for (x0, kw), res in zip(submits, results):
        want = cache.solve(T.laplace_jacobi(2), x0, **kw)
        assert torch.equal(res.x, want.x)
    _equal_to_jax(submits, results, max_batch=4, max_wait=0.1)


def test_mixed_shapes_share_one_bucket_entry():
    # 12x12, 10x14 and 16x16 fall in the (16, 16) bucket: three groups,
    # one cache entry, each result equal to its request solved alone.
    submits = [(_x0(seed=1), KW), (_x0(seed=2, grid=(10, 14)), KW),
               (_x0(seed=3, grid=(16, 16)), KW), (_x0(seed=4), KW)]
    eng, results, cache = _serve("torch", submits, max_batch=8, max_wait=0.1)
    assert eng.stats.batches == 3 and eng.stats.coalesced == 2
    assert len(cache) == 1 and cache.stats.misses == 1
    for (x0, _), res in zip(submits, results):
        want = T.solve(T.laplace_jacobi(2), x0, backend=res.backend,
                       device="cpu", **KW)
        assert torch.equal(res.x, want.x)
        assert res.iterations == want.iterations
    _equal_to_jax(submits, results, max_batch=8, max_wait=0.1)


def test_incompatible_requests_split_groups():
    submits = [(_x0(0), KW), (_x0(1), dict(KW, rtol=1e-5))]
    eng, results, _ = _serve("torch", submits, max_batch=8, max_wait=0.1)
    assert all(r.converged for r in results)
    assert eng.stats.batches == 2 and eng.stats.completed == 2
    _equal_to_jax(submits, results, max_batch=8, max_wait=0.1)


def test_kernel_backend_requests_are_exact_entries():
    kw = dict(KW, backend="cuda_fused")
    submits = [(_x0(seed=s), kw) for s in range(3)]
    eng, results, cache = _serve("torch", submits, max_batch=4, max_wait=0.1)
    assert eng.stats.batches == 1 and cache.keys()[0][0] == "exact"
    for (x0, _), res in zip(submits, results):
        want = T.solve(T.laplace_jacobi(2), x0, device="cpu", **kw)
        assert res.backend == "cuda_fused"
        assert torch.equal(res.x, want.x)
        assert res.iterations == want.iterations


def test_backpressure_rejects_with_reason():
    cache = _cache()

    async def main():
        async with ServingEngine(cache, max_queue=1, max_wait=0.0) as eng:
            eng.pause()
            first = asyncio.ensure_future(
                eng.submit(T.laplace_jacobi(2), _x0(0), **KW))
            await asyncio.sleep(0.05)   # first is admitted and held
            with pytest.raises(RejectedError) as exc:
                await eng.submit(T.laplace_jacobi(2), _x0(1), **KW)
            eng.resume()
            res = await first
            return eng, res, exc.value

    eng, res, err = asyncio.run(main())
    assert res.converged
    assert "queue full" in err.reason and "max_queue=1" in err.reason
    assert eng.stats.rejected == 1 and eng.stats.accepted == 1


def test_pause_holds_and_resume_releases():
    cache = _cache()

    async def main():
        async with ServingEngine(cache, max_batch=8, max_wait=0.0) as eng:
            eng.pause()
            futs = [asyncio.ensure_future(
                eng.submit(T.laplace_jacobi(2), _x0(s), **KW))
                for s in range(3)]
            await asyncio.sleep(0.05)
            held = [f.done() for f in futs]
            eng.resume()
            return held, await asyncio.gather(*futs), eng

    held, results, eng = asyncio.run(main())
    assert held == [False] * 3
    assert all(r.converged for r in results) and eng.stats.completed == 3


def test_submit_after_stop_rejects():
    async def main():
        eng = ServingEngine(_cache())
        await eng.start()
        await eng.stop()
        with pytest.raises(RejectedError):
            await eng.submit(T.laplace_jacobi(2), _x0(), **KW)

    asyncio.run(main())


def test_multigrid_routes_through_cache():
    x0 = _x0(seed=3, grid=(17, 17))
    kw = dict(method="multigrid", bc=BC, rtol=1e-4)
    cache = _cache()

    async def main(eng, spec, conv):
        async with eng:
            # sequential: the second dispatch must hit the cached hierarchy
            r1 = await eng.submit(spec, conv(x0), **kw)
            r2 = await eng.submit(spec, conv(x0 + 0.1), **kw)
        return r1, r2

    r1, r2 = asyncio.run(main(ServingEngine(cache, max_wait=0.0),
                              T.laplace_jacobi(2), lambda a: a))
    assert r1.converged and r2.converged
    assert isinstance(r1, T.MGResult)
    assert any(k[0] == "multigrid" for k in cache.keys())
    assert cache.stats.hits == 1 and cache.stats.misses == 1
    j1, j2 = asyncio.run(main(
        JS.ServingEngine(J.PlanCache(probe=False), max_wait=0.0),
        J.laplace_jacobi(2), jnp.asarray))
    for t, j in ((r1, j1), (r2, j2)):
        assert t.cycles == j.cycles
        np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=0,
                                   atol=1e-5)


def test_input_validation():
    async def main():
        async with ServingEngine(_cache()) as eng:
            with pytest.raises(ValueError, match="bare"):
                await eng.submit(T.laplace_jacobi(2),
                                 np.zeros((2, *GRID), np.float32), **KW)
            with pytest.raises(ValueError, match="method"):
                await eng.submit(T.laplace_jacobi(2), _x0(), method="sor",
                                 **KW)
            with pytest.raises(ValueError, match="scalar"):
                await eng.submit(T.laplace_jacobi(2), _x0(),
                                 bc=np.zeros(GRID))  # type: ignore[arg-type]
            with pytest.raises(ValueError, match="unknown arguments"):
                await eng.submit(T.laplace_jacobi(2), _x0(), smoother="rb",
                                 **KW)

    asyncio.run(main())


def test_stats_as_dict_and_constructor_validation():
    d = EngineStats(accepted=3, completed=2, batches=1).as_dict()
    assert d == JS.EngineStats(accepted=3, completed=2, batches=1).as_dict()
    assert d["accepted"] == 3 and d["mean_batch"] == 2.0
    with pytest.raises(ValueError):
        ServingEngine(_cache(), max_batch=0)
    with pytest.raises(ValueError):
        ServingEngine(_cache(), max_queue=0)


# -- tensor requests (the engine once took numpy only) -----------------------

def _tensor_case():
    """A bf16 16x16 field from a seed, and the same values as fp32 numpy."""
    x = np.random.default_rng(7).standard_normal((16, 16)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    return xb, xb.float().numpy()


@pytest.mark.parametrize("backend", ["auto", "conv"])
def test_bf16_tensor_request_serves_as_its_fp32_values(backend):
    xb, x32 = _tensor_case()
    kw = dict(bc=1.0, rtol=1e-3, backend=backend)
    src = torch.full((16, 16), 1e-3, dtype=torch.bfloat16)
    submits = [(xb, dict(kw, source=src)), (x32, dict(kw, source=None)),
               (x32, dict(kw, source=src.float().numpy()))]

    async def main():
        async with ServingEngine(_cache(), max_wait=0.05) as eng:
            return await asyncio.gather(*(eng.submit(T.laplace_jacobi(2),
                                                     x0, **k)
                                          for x0, k in submits))

    got_b, got_none, got_32 = asyncio.run(main())
    assert got_b.converged and got_b.x.dtype == torch.float32
    assert got_b.iterations == got_32.iterations
    assert torch.equal(got_b.x, got_32.x)
    # Without the source the field differs, and the group still coalesced.
    assert not torch.equal(got_none.x, got_32.x)
    # JAX's engine takes the bf16 jax.Array; where the bucket runs the
    # same backend, the counts agree.
    async def jax_main():
        async with JS.ServingEngine(J.PlanCache(probe=False)) as eng:
            return await eng.submit(J.laplace_jacobi(2),
                                    jnp.asarray(x32, jnp.bfloat16),
                                    source=jnp.asarray(src.float().numpy(),
                                                       jnp.bfloat16), **kw)

    want = asyncio.run(jax_main())
    if want.backend == got_b.backend:
        assert got_b.iterations == want.iterations
        np.testing.assert_allclose(got_b.x.numpy(), np.asarray(want.x),
                                   rtol=0, atol=JAX_TOL)


def test_tensor_requests_of_any_dtype_coalesce_with_numpy():
    # A float64 tensor, a non-contiguous view, and the fp32 numpy of the
    # same values share one group and one batched solve (the solve's
    # dtype is the request's dtype= argument).
    x = _x0()
    x64 = torch.from_numpy(np.ascontiguousarray(x.T)).double().T
    assert not x64.is_contiguous()
    submits = [(x64, KW), (x, KW)]

    async def main():
        async with ServingEngine(_cache(), max_wait=0.05) as eng:
            return eng, await asyncio.gather(*(eng.submit(
                T.laplace_jacobi(2), x0, **k) for x0, k in submits))

    eng, (a, b) = asyncio.run(main())
    assert eng.stats.coalesced == 2 and eng.stats.batches == 1
    assert a.iterations == b.iterations and torch.equal(a.x, b.x)
