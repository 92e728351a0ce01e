"""The port's plan cache against its own exact solves and the JAX
package's cache, on the CPU.

A bucketed solve embeds the request in its power-of-two bucket; on the
same backend it must reproduce the exact-shape solve: iterations,
convergence, residual history, and a bit-equal field (scalar and per-cell
taps alike here: the port's reference sums a lifted tap as it sums a scalar
one).  Against the JAX package's cache, the same requests take equal
iterations and fields within 1e-6 absolute (its compiled reference rounds
the same sums in another order).  Keying, LRU order, rebuilds, the probe
and the build latch follow tests/serve/test_plan_cache.py.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch.core.boundary import BoundaryMode
from repro_torch.core.plan_cache import PlanCache

GRID = (12, 12)
KW = dict(bc=0.5, rtol=1e-4, atol=0.0, check_every=10, max_iters=2000)
JAX_TOL = 1e-6


def _x0(grid, batch=None, seed=0, bc=0.5):
    """Random interior, shell at the Dirichlet value."""
    rng = np.random.default_rng(seed)
    shape = grid if batch is None else (batch, *grid)
    x = rng.standard_normal(shape).astype(np.float32)
    shell = np.ones(grid, np.float32)
    shell[tuple(slice(1, -1) for _ in grid)] = 0.0
    return x * (1.0 - shell) + bc * shell


def _cache(**kw):
    kw.setdefault("probe", False)
    return PlanCache(device="cpu", **kw)


def _star_r2(pkg):
    return pkg.star(2, [0.15, 0.05], center=0.2)


class TestKeying:
    def test_same_bucket_hits(self):
        cache = _cache()
        s1 = cache.solver(T.laplace_jacobi(2), (12, 12), **KW)
        s2 = cache.solver(T.laplace_jacobi(2), (14, 10), **KW)
        assert s1.padded and s2.padded
        assert s1.bucket == s2.bucket == (16, 16)
        assert len(cache) == 1
        assert cache.stats.misses == 1 and cache.stats.hits == 1

    def test_different_bucket_misses(self):
        cache = _cache()
        cache.solver(T.laplace_jacobi(2), (12, 12), **KW)
        s = cache.solver(T.laplace_jacobi(2), (20, 20), **KW)
        assert s.bucket == (32, 32)
        assert len(cache) == 2 and cache.stats.misses == 2

    def test_scalar_weight_family_and_dirichlet_share_an_entry(self):
        cache = _cache()
        cache.solver(T.laplace_jacobi(2), GRID, **KW)
        other = T.StencilSpec(
            taps={off: 0.2 for off, _ in T.laplace_jacobi(2).taps},
            name="fat_laplace")
        assert cache.solver(other, GRID, **KW).padded
        cache.solver(T.laplace_jacobi(2), GRID, **dict(KW, bc=-3.0))
        assert len(cache) == 1 and cache.stats.hits == 2

    def test_convergence_cfg_separates_entries(self):
        cache = _cache()
        cache.solver(T.laplace_jacobi(2), GRID, **KW)
        cache.solver(T.laplace_jacobi(2), GRID, **dict(KW, rtol=1e-6))
        assert len(cache) == 2 and cache.stats.misses == 2

    @pytest.mark.parametrize("kw", [
        dict(KW, bc=None),
        dict(KW, backend="dense", mode=BoundaryMode.MATRIX),
        dict(KW, bc=T.DirichletBC(np.full(GRID, 0.5, np.float32))),
        dict(KW, backend="cuda"),
        dict(KW, backend="cuda_fused"),
    ], ids=["bc-none", "dense-matrix", "array-bc", "cuda", "cuda_fused"])
    def test_non_bucketable_degrades_to_exact(self, kw):
        cache = _cache()
        s = cache.solver(T.laplace_jacobi(2), GRID, **kw)
        assert not s.padded and s.bucket is None
        cache.solver(T.laplace_jacobi(2), GRID, **kw)
        assert cache.stats.hits == 1 and len(cache) == 1
        if kw.get("backend", "").startswith("cuda"):
            assert s.backend == kw["backend"]
            r = s.solve(_x0(GRID))
            want = T.solve(T.laplace_jacobi(2), _x0(GRID), device="cpu",
                           **kw)
            assert r.iterations == want.iterations
            assert torch.equal(r.x, want.x)

    def test_oversized_pad_ratio_degrades_to_exact(self):
        cache = _cache(max_pad_ratio=1.1)
        s = cache.solver(T.laplace_jacobi(2), (17, 17), **KW)
        assert not s.padded
        cache.solver(T.laplace_jacobi(2), (17, 17), **KW)
        assert cache.stats.hits == 1


def _compare(spec, x0, **kw):
    """Bucketed solve against the exact solve on the same backend."""
    cache = _cache()
    cached = cache.solver(spec, x0.shape[-spec.ndim:], **kw)
    assert cached.padded, "the test must exercise the embedding"
    got = cached.solve(x0)
    want = T.solve(spec, x0, backend=cached.backend, device="cpu", **kw)
    assert torch.equal(got.x, want.x)
    np.testing.assert_array_equal(got.iterations, want.iterations)
    np.testing.assert_array_equal(got.converged, want.converged)
    np.testing.assert_array_equal(got.residual_history,
                                  want.residual_history)
    return got


class TestExactness:
    @pytest.mark.parametrize("radius", [1, 2])
    @pytest.mark.parametrize("grid", [(12, 12), (9, 14), (16, 16)], ids=str)
    def test_bare_grid(self, radius, grid):
        spec = T.laplace_jacobi(2) if radius == 1 else _star_r2(T)
        got = _compare(spec, _x0(grid), **KW)
        assert got.converged and tuple(got.x.shape) == grid

    def test_batched_per_instance_iterations(self):
        x0 = np.stack([_x0(GRID, seed=s) for s in range(3)])
        x0[0] = 0.5  # already at the fixed point -> converges immediately
        got = _compare(T.laplace_jacobi(2), x0, **KW)
        assert got.iterations[0] < got.iterations[1]

    def test_variable_coefficients(self):
        kappa = (1.0 + np.random.default_rng(3).random(GRID)
                 ).astype(np.float32)
        assert _compare(T.heterogeneous_jacobi(kappa), _x0(GRID, seed=1),
                        **KW).converged

    def test_run_returns_the_solve_s_tensors(self):
        cache = _cache()
        cached = cache.solver(T.laplace_jacobi(2), GRID, **KW)
        x, iters, conv, res = cached.run(_x0(GRID))
        want = cached.solve(_x0(GRID))
        assert torch.equal(x, want.x) and int(iters) == want.iterations
        assert bool(conv) and float(res) == want.residual
        xb, ib, _, _ = cached.run(_x0(GRID, batch=2))
        assert tuple(xb.shape) == (2, *GRID) and tuple(ib.shape) == (2,)

    def test_source_term(self):
        spec = T.laplace_jacobi(2)
        src = (np.random.default_rng(5).standard_normal(GRID) * 1e-2
               ).astype(np.float32)
        cache = _cache()
        cached = cache.solver(spec, GRID, **KW)
        got = cached.solve(_x0(GRID), source=src)
        want = T.solve(spec, _x0(GRID), backend=cached.backend, source=src,
                       device="cpu", **KW)
        assert torch.equal(got.x, want.x)
        assert got.iterations == want.iterations

    def test_one_shot_solve_entry_point(self):
        cache = _cache()
        assert cache.solve(T.laplace_jacobi(2), _x0(GRID), **KW).converged
        cache.solve(T.laplace_jacobi(2), _x0((14, 10), seed=2), **KW)
        assert cache.stats.hits == 1


REQUESTS = [
    ("laplace", (12, 12), None), ("laplace", (14, 10), 3),
    ("laplace", (20, 20), None), ("star_r2", (12, 12), None),
    ("hetero", (12, 12), None), ("laplace", (16, 16), 2),
]


@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_same_requests_through_jax_s_cache(i):
    name, grid, batch = REQUESTS[i]
    kappa = (1.0 + np.random.default_rng(8).random(grid)).astype(np.float32)
    specs = {"laplace": lambda P: P.laplace_jacobi(2), "star_r2": _star_r2,
             "hetero": lambda P: P.heterogeneous_jacobi(kappa)}
    x0 = _x0(grid, batch=batch, seed=i)
    jc = J.PlanCache(probe=False)
    want = jc.solver(specs[name](J), grid, **KW).solve(jnp.asarray(x0))
    cache = _cache()
    got = cache.solver(specs[name](T), grid, **KW).solve(x0)
    assert got.backend == want.backend == "reference"
    np.testing.assert_array_equal(got.iterations, want.iterations)
    np.testing.assert_array_equal(got.converged, want.converged)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=JAX_TOL)


class TestLifecycle:
    def test_lru_eviction_order(self):
        cache = _cache(capacity=2)
        cache.solver(T.laplace_jacobi(2), (8, 8), **KW)      # bucket (8, 8)
        cache.solver(T.laplace_jacobi(2), (12, 12), **KW)    # (16, 16)
        cache.solver(T.laplace_jacobi(2), (8, 8), **KW)      # touch (8, 8)
        cache.solver(T.laplace_jacobi(2), (20, 20), **KW)    # evicts 16
        assert len(cache) == 2 and cache.stats.evictions == 1
        buckets = [k[2] for k in cache.keys()]
        assert buckets == [(8, 8), (32, 32)]
        misses = cache.stats.misses
        cache.solver(T.laplace_jacobi(2), (12, 12), **KW)
        assert cache.stats.misses == misses + 1
        assert [k[2] for k in cache.keys()] == [(32, 32), (16, 16)]

    def test_corrupt_entry_rebuilds_once(self):
        cache = _cache()
        cached = cache.solver(T.laplace_jacobi(2), GRID, **KW)
        cache._entries[cached._entry.key].obj = None  # sabotage
        assert cached.solve(_x0(GRID)).converged
        assert cache.stats.rebuilds == 1
        assert cached.solve(_x0(GRID, seed=2)).converged
        assert cache.stats.rebuilds == 1

    def test_stats_shape_and_clear(self):
        cache = _cache()
        cache.solver(T.laplace_jacobi(2), GRID, **KW)
        cache.solver(T.laplace_jacobi(2), GRID, **KW)
        d = cache.stats.as_dict()
        assert d["hits"] == 1 and d["misses"] == 1 and d["hit_rate"] == 0.5
        assert d["compile_seconds"] > 0.0 and d["probe_dropped"] == 0
        cache.clear()
        assert len(cache) == 0

    def test_multigrid_entries_cache(self):
        # bc 0.5: a fixed point away from zero, where the criterion's two
        # norms do not both shrink into rounding noise.
        cache = _cache()
        mg1 = cache.multigrid(T.laplace_jacobi(2), (17, 17), bc=0.5,
                              rtol=1e-4)
        mg2 = cache.multigrid(T.laplace_jacobi(2), (17, 17), bc=0.5,
                              rtol=1e-4)
        assert mg1 is mg2 and cache.stats.hits == 1
        assert mg1.device.type == "cpu"
        assert any(k[0] == "multigrid" for k in cache.keys())
        res = mg1.solve(_x0((17, 17)))
        want = J.PlanCache(probe=False).multigrid(
            J.laplace_jacobi(2), (17, 17), bc=0.5, rtol=1e-4).solve(
            jnp.asarray(_x0((17, 17))))
        assert res.converged and res.cycles == want.cycles
        np.testing.assert_allclose(res.x.numpy(), np.asarray(want.x),
                                   rtol=0, atol=1e-5)

    def test_default_cache_swap(self):
        mine = _cache()
        old = T.set_default_plan_cache(mine)
        try:
            assert T.default_plan_cache() is mine
        finally:
            T.set_default_plan_cache(old)

    def test_default_cache_is_on_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device exists: the default device is usable")
        old = T.set_default_plan_cache(None)
        try:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                T.default_plan_cache()
        finally:
            T.set_default_plan_cache(old)

    def test_probe_picks_a_capable_backend(self):
        cache = PlanCache(probe=True, probe_iters=2, device="cpu")
        s = cache.solver(T.laplace_jacobi(2), (8, 8), **KW)
        assert s.backend in ("reference", "conv")
        assert cache.stats.probe_seconds > 0.0
        assert cache.stats.probe_dropped == 0
        assert s.solve(_x0((8, 8))).converged

    def test_probe_counts_a_failing_candidate(self, monkeypatch):
        import repro_torch.core.plan as plan_mod
        real = plan_mod.make_plan

        def failing(spec, grid, *, backend, **kw):
            if backend == "conv":
                raise RuntimeError("planted failure")
            return real(spec, grid, backend=backend, **kw)

        monkeypatch.setattr(plan_mod, "make_plan", failing)
        cache = PlanCache(probe=True, probe_iters=2, device="cpu")
        s = cache.solver(T.laplace_jacobi(2), (8, 8), **KW)
        assert s.backend == "reference" and cache.stats.probe_dropped == 1


def test_racing_threads_build_once(monkeypatch):
    cache = _cache()
    solvers, errors, builds = [], [], []
    orig = PlanCache._build_bucket

    def counting(self, *a, **kw):
        builds.append(threading.get_ident())
        return orig(self, *a, **kw)

    monkeypatch.setattr(PlanCache, "_build_bucket", counting)

    def work(seed):
        try:
            s = cache.solver(T.laplace_jacobi(2), GRID, **KW)
            solvers.append(s.solve(_x0(GRID, seed=seed)))
        except Exception as e:  # pragma: no cover - diagnostic
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert len(solvers) == 6 and all(r.converged for r in solvers)
    assert len(cache) == 1 and len(builds) == 1
