"""The port's multigrid V-cycle against the JAX package's, on the CPU.

The hierarchy is the same construction (transfer specs, coarse shapes,
coarsened specs, work accounting), so those are compared exactly.  The
cycles run through each package's dispatcher on the same seeded inputs:
the cycle counts must be equal and the fields within 1e-5 absolute (the
two packages' compiled and eager reference paths round the same sums in
different orders; in 3D the JAX package's compiled reference drifts 1.7e-6
from its op-by-op oracle).  The residual histories are held to 1e-3
relative or, absolute, sqrt(cells) fp32 ulps of 1 (the fields are O(1):
the L2 norm of one ulp of rounding noise a cell).  One red-black sweep is
held to 1e-6.

The counts the JAX package's own records hold: 13 cycles on Table 1 (64x64,
bc 1) and 5 on the heterogeneous 65x65 at rtol 1e-5, the tolerance
``BENCH_stencil.json``'s multigrid rows were run at (its residuals are the
13th and 5th entries of these histories); at rtol 1e-6, 18 and 6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core.multigrid import _parity_mask as j_parity
from repro_torch.core.multigrid import _parity_mask as t_parity

FIELD_TOL = 1e-5
SWEEP_TOL = 1e-6


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_transfer_specs_are_tap_equal(ndim):
    for tf, jf in ((T.restriction_spec, J.restriction_spec),
                   (T.prolongation_spec, J.prolongation_spec)):
        t, j = tf(ndim), jf(ndim)
        assert t.taps == tuple((o, float(w)) for o, w in j.taps)
        assert t.name == j.name
    # Prolongation is 2^ndim times restriction, tap by tap.
    for (o1, r), (o2, p) in zip(T.restriction_spec(ndim).taps,
                                T.prolongation_spec(ndim).taps):
        assert o1 == o2 and p == r * 2 ** ndim


@pytest.mark.parametrize("shape", [(64, 64), (65, 65), (17, 17, 17),
                                   (10, 64, 64), (4097, 4097), (6, 7)],
                         ids=str)
def test_coarse_shapes_and_parity_masks(shape):
    assert T.coarse_shape(shape) == J.coarse_shape(shape)
    np.testing.assert_array_equal(t_parity(shape[:2]), j_parity(shape[:2]))


def test_coarsen_spec_injects_fields_like_jax():
    kappa = 1.0 + 9.0 * np.random.default_rng(0).random((9, 9)) \
        .astype(np.float32)
    t, j = T.heterogeneous_jacobi(kappa), J.heterogeneous_jacobi(kappa)
    for _ in range(2):
        t, j = T.coarsen_spec(t), J.coarsen_spec(j)
        assert t.weights_shape == j.weights_shape
        np.testing.assert_array_equal(t.field_stack(), j.field_stack())
    assert T.coarsen_spec(T.laplace_jacobi(2)) == T.laplace_jacobi(2)


@pytest.mark.parametrize("with_source", [False, True])
def test_red_black_step_agrees_with_jax(with_source):
    n, bc = 17, 1.5
    rng = np.random.default_rng(11)
    u = rng.standard_normal((n, n)).astype(np.float32)
    g = rng.standard_normal((n, n)).astype(np.float32)
    jp = J.make_plan(J.laplace_jacobi(2), (n, n), backend="reference",
                     bc=bc, iters=1, tuned=None)
    tp = T.make_plan(T.laplace_jacobi(2), (n, n), backend="reference",
                     bc=bc, iters=1, device="cpu")
    kw_j = kw_t = {}
    if with_source:
        kw_j = dict(g=jnp.asarray(g), mask=J.DirichletBC(0.0)
                    .interior_mask((n, n)))
        kw_t = dict(g=torch.from_numpy(g), mask=T.DirichletBC(0.0)
                    .interior_mask((n, n)))
    want = J.red_black_step(J.DirichletBC(bc).set_boundary(jnp.asarray(u)),
                            jp, **kw_j)
    got = T.red_black_step(T.DirichletBC(bc).set_boundary(
        torch.from_numpy(u), 2), tp, **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=SWEEP_TOL)
    # The sweep is two masked half-sweeps of the plan.
    red = torch.from_numpy(t_parity((n, n)))
    u0 = T.DirichletBC(bc).set_boundary(torch.from_numpy(u), 2)
    half = (lambda v: tp(v) + kw_t["mask"] * kw_t["g"]) if with_source \
        else tp
    manual = torch.where(red, half(u0), u0)
    manual = torch.where(red, manual, half(manual))
    torch.testing.assert_close(got, manual, rtol=0, atol=0)


def _kappa(n, seed=0):
    # benchmarks/multigrid_bench.py's heterogeneous problem
    rng = np.random.default_rng(seed)
    return 1.0 + 9.0 * rng.random((n, n)).astype(np.float32)


CASES = {
    # name: (spec builder, grid, x0 seed or None for zeros, bc, solve kwargs,
    #        cycles expected (None: only equality with JAX))
    "table1_rtol1e-5": (lambda P: P.laplace_jacobi(2), (64, 64), None, 1.0,
                        dict(rtol=1e-5), 13),
    "table1_rtol1e-6": (lambda P: P.laplace_jacobi(2), (64, 64), None, 1.0,
                        dict(rtol=1e-6), 18),
    "hetero65_rtol1e-5": (lambda P: P.heterogeneous_jacobi(_kappa(65)),
                          (65, 65), None, 1.0, dict(rtol=1e-5), 5),
    "hetero65_rtol1e-6": (lambda P: P.heterogeneous_jacobi(_kappa(65)),
                          (65, 65), None, 1.0, dict(rtol=1e-6), 6),
    "odd65_random": (lambda P: P.laplace_jacobi(2), (65, 65), 3, 1.5,
                     dict(rtol=1e-5), None),
    "jacobi_smoother": (lambda P: P.laplace_jacobi(2), (33, 33), 4, 1.0,
                        dict(rtol=1e-5, smoother="jacobi"), None),
    "linf_norm": (lambda P: P.laplace_jacobi(2), (33, 33), 5, 1.0,
                  dict(rtol=1e-5, norm="linf"), None),
    "laplace3d_17": (lambda P: P.laplace_jacobi(3), (17, 17, 17), 6, 0.5,
                     dict(rtol=1e-5), None),
    "fixed_cycles": (lambda P: P.laplace_jacobi(2), (33, 33), None, 1.0,
                     dict(rtol=None, atol=None, max_cycles=3), 3),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_multigrid_cycles_equal_jax(name):
    build, grid, seed, bc, kw, cycles = CASES[name]
    x0 = np.zeros(grid, np.float32) if seed is None else \
        np.random.default_rng(seed).standard_normal(grid).astype(np.float32)
    j = J.multigrid_solve(build(J), jnp.asarray(x0), bc=bc, **kw)
    t = T.multigrid_solve(build(T), x0, bc=bc, device="cpu", **kw)
    assert t.cycles == j.cycles
    if cycles is not None:
        assert t.cycles == cycles
    assert t.converged == j.converged == ("max_cycles" not in kw)
    assert t.level_shapes == j.level_shapes
    assert t.work_per_cycle == j.work_per_cycle
    assert t.work_units == pytest.approx(t.cycles * t.work_per_cycle)
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=0,
                               atol=FIELD_TOL)
    np.testing.assert_allclose(
        t.residual_history, j.residual_history, rtol=1e-3,
        atol=np.sqrt(np.prod(grid)) * np.finfo(np.float32).eps)
    assert t.residual_history.dtype == np.float32


def test_table1_hierarchy_and_work():
    mg = T.Multigrid(T.laplace_jacobi(2), (64, 64), bc=1.0, rtol=1e-6,
                     device="cpu")
    assert mg.level_shapes == ((64, 64), (32, 32), (16, 16), (8, 8))
    assert mg.work_per_cycle == 17.4375
    mg = T.Multigrid(T.laplace_jacobi(2), (4097, 4097), device="cpu")
    assert len(mg.level_shapes) == 11 and mg.level_shapes[-1] == (5, 5)


@pytest.mark.parametrize("backend,transfer", [("cuda", "reference"),
                                              ("cuda", "cuda"),
                                              ("reference", "cuda")])
@pytest.mark.parametrize("ndim", [2, 3])
def test_kernel_backends_take_the_reference_cycles(backend, transfer, ndim):
    # On the CPU the kernel backends run their plain versions, which sum
    # the taps as the reference does.
    grid = (33, 33) if ndim == 2 else (9, 17, 17)
    x0 = np.random.default_rng(7).standard_normal(grid).astype(np.float32)
    kw = dict(bc=1.0, rtol=1e-5, device="cpu")
    ref = T.multigrid_solve(T.laplace_jacobi(ndim), x0, backend="reference",
                            **kw)
    got = T.multigrid_solve(T.laplace_jacobi(ndim), x0, backend=backend,
                            transfer_backend=transfer, **kw)
    assert got.backend == backend and got.cycles == ref.cycles
    np.testing.assert_allclose(got.x.numpy(), ref.x.numpy(), rtol=0,
                               atol=SWEEP_TOL)


def test_matches_the_plain_solver():
    spec = T.laplace_jacobi(2)
    x0 = np.zeros((33, 33), np.float32)
    jac = T.solve(spec, x0, bc=1.5, rtol=1e-6, max_iters=50_000,
                  device="cpu")
    mg = T.multigrid_solve(spec, x0, bc=1.5, rtol=1e-6, device="cpu")
    assert jac.converged and mg.converged
    rel = float(torch.linalg.norm(mg.x - jac.x) / torch.linalg.norm(jac.x))
    assert rel < 1e-3, rel


@pytest.mark.parametrize("kwargs,grid,match", [
    (dict(smoother="sor"), (33, 33), "smoother"),
    (dict(norm="l1"), (33, 33), "norm"),
    ({}, (4, 4), "min_size"),
    (dict(nu_pre=0, nu_post=0), (33, 33), "smoothing sweep"),
    (dict(rtol=0.0, atol=0.0), (33, 33), "unsatisfiable"),
])
def test_constructor_errors_match_jax(kwargs, grid, match):
    with pytest.raises(ValueError, match=match) as jerr:
        J.Multigrid(J.laplace_jacobi(2), grid, **kwargs)
    with pytest.raises(ValueError, match=match) as terr:
        T.Multigrid(T.laplace_jacobi(2), grid, device="cpu", **kwargs)
    assert str(terr.value) == str(jerr.value)


def test_batched_input_and_rank_rejected():
    mg = T.Multigrid(T.laplace_jacobi(2), (33, 33), device="cpu")
    with pytest.raises(ValueError, match="batched"):
        mg.solve(np.zeros((2, 33, 33), np.float32))
    with pytest.raises(ValueError, match="bare grid"):
        T.multigrid_solve(T.laplace_jacobi(2), np.zeros((2, 33, 33)),
                          device="cpu")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.Multigrid(T.laplace_jacobi(2), (33, 33))
