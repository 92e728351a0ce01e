"""The port's solver against the JAX package's on the paper's Table-1 solve,
its Fig-6 3D solve and heterogeneous grids, plus its batching and
fixed-iteration modes.

Table 1 (5-point Laplace Jacobi, 64x64, bc=1, rtol=1e-6, check_every=20)
converges in 7960 iterations in the JAX package.  The port sums the taps in
the same order with the same roundings, so on the CPU it must take exactly
as many and the field must match to 1e-6.  The residual history matches to
5e-6 relative: the trajectories are bit-equal, but JAX's fp32 reduction of
the 4096 squares inside its while_loop is off a float64 sum by up to 3.4e-6
relative on this solve, where the port's is off by 1.2e-7.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T

TABLE1 = dict(bc=1.0, rtol=1e-6, check_every=20, max_iters=20_000)
FIG6 = dict(rtol=1e-6, check_every=20, max_iters=10_000)
FIG6_GRID = (10, 64, 64)
FIG6_RESIDUAL = 1.4074293721932918e-04
PORT_TO_JAX = {"cuda": "pallas", "conv": "conv",
               "conv3d_native": "conv3d_native", "reference": "reference"}


@pytest.fixture(scope="module")
def jax_table1():
    return J.solve(J.laplace_jacobi(2), jnp.zeros((64, 64), jnp.float32),
                   backend="reference", tuned=None, **TABLE1)


@pytest.mark.parametrize("backend", ["cuda", "cuda_fused", "conv",
                                     "reference"])
def test_table1_converges_in_7960_iterations_like_jax(backend, jax_table1):
    assert jax_table1.iterations == 7960
    r = T.solve(T.laplace_jacobi(2), np.zeros((64, 64), np.float32),
                backend=backend, device="cpu", **TABLE1)
    assert r.backend == backend and r.converged
    assert r.iterations == 7960
    np.testing.assert_allclose(r.x.numpy(), np.asarray(jax_table1.x),
                               rtol=0, atol=1e-6)
    assert r.residual_history.shape == jax_table1.residual_history.shape
    np.testing.assert_allclose(r.residual_history,
                               jax_table1.residual_history, rtol=5e-6)
    assert r.residual == pytest.approx(jax_table1.residual, rel=5e-6)


def test_batched_solve_equals_instance_by_instance():
    rng = np.random.default_rng(5)
    x0 = rng.random((3, 16, 16)).astype(np.float32)
    x0[1] *= 0.1
    solver = T.Solver(T.laplace_jacobi(2), (16, 16), backend="cuda",
                      bc=1.0, rtol=1e-4, check_every=8, max_iters=4000,
                      device="cpu")
    batched = solver.solve(x0)
    assert len(set(batched.iterations.tolist())) > 1  # they freeze apart
    for i in range(3):
        alone = solver.solve(x0[i])
        assert alone.iterations == batched.iterations[i]
        assert alone.converged == batched.converged[i]
        torch.testing.assert_close(alone.x, batched.x[i], rtol=0, atol=0)
        hist = batched.residual_history[:, i]
        n = len(alone.residual_history)
        np.testing.assert_array_equal(hist[:n], alone.residual_history)
        assert np.isnan(hist[n:]).all()  # frozen rows record NaN


def test_fixed_iteration_mode():
    spec = T.star(2, [0.15, 0.05], center=0.2)
    x0 = np.random.default_rng(6).standard_normal((2, 20, 24))
    r = T.solve(spec, x0.astype(np.float32), backend="cuda_fused", bc=0.5,
                rtol=None, atol=None, max_iters=12, fuse=4, device="cpu")
    assert r.check_every == 12 and r.fuse == 4
    assert (r.iterations == 12).all() and not r.converged.any()
    assert np.isnan(r.residual).all() and r.residual_history.shape == (0, 2)
    ref = T.jacobi_reference(torch.tensor(x0, dtype=torch.float32), spec,
                             T.DirichletBC(0.5), 12)
    torch.testing.assert_close(r.x, ref, rtol=0, atol=1e-6)
    jres = J.solve(J.star(2, [0.15, 0.05], center=0.2),
                   jnp.asarray(x0, jnp.float32), backend="pallas_fused",
                   bc=0.5, rtol=None, atol=None, max_iters=12, fuse=4,
                   tuned=None)
    np.testing.assert_allclose(r.x.numpy(), np.asarray(jres.x), atol=1e-6)


def test_heterogeneous_solve_through_k1_matches_pallas():
    kappa = 1.0 + 9.0 * np.random.default_rng(0).random((33, 57))
    kw = dict(bc=1.0, rtol=None, atol=None, max_iters=50, fuse=1)
    jres = J.Solver(J.heterogeneous_jacobi(kappa), (33, 57),
                    backend="pallas", tuned=None, **kw).solve(
        jnp.zeros((33, 57), jnp.float32))
    solver = T.Solver(T.heterogeneous_jacobi(kappa), (33, 57),
                      backend="cuda", device="cpu", **kw)
    assert solver.plan.operands == frozenset({"fields"})
    r = solver.solve(np.zeros((33, 57), np.float32))
    np.testing.assert_allclose(r.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=1e-6)


def test_solver_validates_like_jax():
    lap = T.laplace_jacobi(2)
    with pytest.raises(ValueError, match="norm"):
        T.Solver(lap, (8, 8), norm="l1", device="cpu")
    with pytest.raises(ValueError, match="unsatisfiable"):
        T.Solver(lap, (8, 8), rtol=0.0, atol=0.0, device="cpu")
    with pytest.raises(ValueError, match="solver built for grid"):
        T.Solver(lap, (8, 8), backend="conv", bc=1.0,
                 device="cpu").solve(np.zeros((9, 9), np.float32))
    s = T.Solver(lap, (8, 8), bc=1.0, max_iters=10, check_every=4,
                 norm="linf", device="cpu")
    assert (s.backend, s.plan.source, s.check_every, s.n_chunks) == \
        ("conv", "roofline", 4, 2)
    r = s.solve(np.zeros((8, 8), np.float32))
    assert r.iterations <= 8 and len(r.residual_history) <= 2


@functools.lru_cache(maxsize=None)
def _jax_fig6(backend, bc):
    return J.solve(J.laplace_jacobi(3), jnp.zeros(FIG6_GRID, jnp.float32),
                   backend=backend, bc=bc, tuned=None, **FIG6)


@pytest.mark.parametrize("backend", ["cuda", "conv", "conv3d_native",
                                     "reference"])
def test_fig6_converges_in_620_iterations_like_jax(backend):
    jres = _jax_fig6(PORT_TO_JAX[backend], 1.0)
    assert jres.iterations == 620
    r = T.solve(T.laplace_jacobi(3), np.zeros(FIG6_GRID, np.float32),
                backend=backend, bc=1.0, device="cpu", **FIG6)
    assert r.backend == backend and r.converged
    assert r.iterations == 620
    if backend == "cuda":
        np.testing.assert_array_equal(r.x.numpy(), np.asarray(jres.x))
        assert r.residual == float(jres.residual) == FIG6_RESIDUAL
    else:
        np.testing.assert_allclose(r.x.numpy(), np.asarray(jres.x), rtol=0,
                                   atol=5e-6)


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_heat3d_hot_walls_converge_in_620_iterations(backend):
    # examples/heat3d.py's problem: the Fig-6 grid with bc=100.
    r = T.solve(T.laplace_jacobi(3), np.zeros(FIG6_GRID, np.float32),
                backend=backend, bc=100.0, device="cpu", **FIG6)
    assert r.converged and r.iterations == 620
    jres = _jax_fig6(PORT_TO_JAX[backend], 100.0)
    assert jres.iterations == 620
    np.testing.assert_allclose(r.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=5e-4)  # 5e-6 relative to the bc


@pytest.mark.parametrize("backend", ["cuda", "conv3d_native", "reference"])
def test_heterogeneous_3d_solve_takes_640_iterations(backend):
    kappa = 1.0 + 9.0 * np.random.default_rng(0).random(FIG6_GRID)
    r = T.solve(T.heterogeneous_jacobi(kappa),
                np.zeros(FIG6_GRID, np.float32), backend=backend, bc=1.0,
                device="cpu", **FIG6)
    assert r.converged and r.iterations == 640


def test_fixed_iteration_3d_reference_equals_jax_oracle():
    x0 = np.random.default_rng(8).standard_normal(FIG6_GRID).astype(
        np.float32)
    want = J.jacobi_reference(jnp.asarray(x0), J.laplace_jacobi(3),
                              J.DirichletBC(1.0), 50)
    r = T.solve(T.laplace_jacobi(3), x0, backend="reference", bc=1.0,
                rtol=None, atol=None, max_iters=50, device="cpu")
    np.testing.assert_array_equal(r.x.numpy(), np.asarray(want))
    got = T.jacobi_reference(torch.from_numpy(x0), T.laplace_jacobi(3),
                             T.DirichletBC(1.0), 50)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batched_3d_solve_equals_instance_by_instance():
    rng = np.random.default_rng(9)
    x0 = rng.random((3, 6, 10, 12)).astype(np.float32)
    x0[1] *= 0.1
    solver = T.Solver(T.laplace_jacobi(3), (6, 10, 12), backend="cuda",
                      bc=1.0, rtol=1e-4, check_every=4, max_iters=2000,
                      device="cpu")
    batched = solver.solve(x0)
    assert len(set(batched.iterations.tolist())) > 1
    for i in range(3):
        alone = solver.solve(x0[i])
        assert alone.iterations == batched.iterations[i]
        torch.testing.assert_close(alone.x, batched.x[i], rtol=0, atol=0)
