"""The port's dispatcher against the JAX package's: the same support matrix
and reasons under the backend-name map, the same roofline picks on the CPU
profile, and a cross-package conformance walk in which every live 2D and 3D
port cell equals the JAX ``reference`` cell.

Tolerances are test_matrix.py's: fp32 2e-5, bf16 6e-2 absolute.
"""
import functools
import importlib.util
import itertools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.solver as JS
import repro_torch.core as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX backend -> port backend.
NAME_MAP = {"reference": "reference", "dense": "dense", "conv": "conv",
            "pallas": "cuda", "pallas_fused": "cuda_fused",
            "conv3d_native": "conv3d_native", "halo": "halo"}
PORT_TO_JAX = {v: k for k, v in NAME_MAP.items()}


def _load_matrix():
    path = os.path.join(REPO, "tests", "conformance", "test_matrix.py")
    spec = importlib.util.spec_from_file_location("_jax_conformance_matrix",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_M = _load_matrix()
SPECS, GRIDS, MODES, BC_VALUE, ITERS = (_M.SPECS, _M.GRIDS, _M.MODES,
                                        _M.BC_VALUE, _M.ITERS)
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 6e-2)}
FAMILIES_2D = [f for f, s in SPECS.items() if s.ndim == 2]
FAMILIES_3D = [f for f, s in SPECS.items() if s.ndim == 3]


def to_torch_spec(jspec):
    return T.spec_from_taps(
        [(o, w.array if isinstance(w, J.WeightField) else w)
         for o, w in jspec.taps], name=jspec.name)


TSPECS = {f: to_torch_spec(s) for f, s in SPECS.items()}


def _mapped_reason(reason: str) -> str:
    """A JAX reason string as the port words it: the kernels and the
    backend are CUDA where JAX says Pallas."""
    reason = reason.replace(repr(J.BACKENDS), repr(T.BACKENDS))
    return re.sub(r"\bpallas\b", "cuda", reason.replace("Pallas", "CUDA"))


def _assert_same_verdict(family, jax_backend, mode, bc, mesh=None):
    grid = GRIDS[SPECS[family].ndim]
    js = J.backend_support(jax_backend, SPECS[family], grid_shape=grid,
                           mode=mode, bc=bc, mesh=mesh)
    ts = T.backend_support(NAME_MAP[jax_backend], TSPECS[family],
                           grid_shape=grid, mode=T.BoundaryMode(mode.value),
                           bc=bc, mesh=mesh)
    # Every JAX backend is ported: no reason may say otherwise.
    assert "not yet ported" not in ts.reason, (family, jax_backend, mode)
    if ts.ok:
        assert js.ok, (family, jax_backend, mode, js.reason)
    else:
        assert not js.ok, (family, jax_backend, mode, ts.reason)
        assert ts.reason == _mapped_reason(js.reason)
    return ts


# The tilings halo is asked about: one tile (no mesh), a 2x4 tuple mesh
# (the conformance grid 12x17 does not tile over it: JAX's refusal) and a
# 2x1 mesh it tiles over.
MESHES = (None, (2, 4), (2, 1))


def test_backend_support_reasons_equal_jax():
    live = 0
    for family, jb, mode, bc in itertools.product(
            SPECS, J.BACKENDS, MODES, (BC_VALUE, None)):
        live += _assert_same_verdict(family, jb, mode, bc).ok
    assert live > 50
    for family, mode, bc, mesh in itertools.product(
            SPECS, MODES, (BC_VALUE, None), MESHES):
        _assert_same_verdict(family, "halo", mode, bc, mesh)
    for nd in (1, 2):
        ts = T.backend_support("tensorflow", TSPECS[f"laplace/{nd}d"])
        js = J.backend_support("tensorflow", SPECS[f"laplace/{nd}d"])
        assert ts.reason == _mapped_reason(js.reason)
    # Every 2D and 3D cell JAX runs, the port runs too — halo included, on
    # one tile and on the meshes above.
    halo_live = 0
    for family, jb, mode, bc, mesh in itertools.product(
            FAMILIES_2D + FAMILIES_3D, J.BACKENDS, MODES, (BC_VALUE, None),
            MESHES):
        grid = GRIDS[SPECS[family].ndim]
        if J.backend_support(jb, SPECS[family], grid_shape=grid, mode=mode,
                             bc=bc, mesh=mesh):
            assert T.backend_support(NAME_MAP[jb], TSPECS[family],
                                     grid_shape=grid,
                                     mode=T.BoundaryMode(mode.value),
                                     bc=bc, mesh=mesh), (family, jb, mode,
                                                         bc, mesh)
            halo_live += jb == "halo"
    assert halo_live > 0


@pytest.mark.parametrize("iters", [1, 20, 100])
def test_choose_backend_on_cpu_profile_makes_jax_picks(iters):
    for family, mode in itertools.product(SPECS, MODES):
        jspec = SPECS[family]
        grid = GRIDS[jspec.ndim]
        jb, jcosts = J.choose_backend(jspec, grid, mode=mode, bc=BC_VALUE,
                                      iters=iters, device_kind="cpu",
                                      tuned=None)
        tb, tcosts = T.choose_backend(TSPECS[family], grid,
                                      mode=T.BoundaryMode(mode.value),
                                      bc=BC_VALUE, iters=iters,
                                      device_kind="cpu")
        assert tb == NAME_MAP[jb], (family, mode)
        assert {NAME_MAP[k]: v for k, v in jcosts.items()} == \
            pytest.approx(tcosts, rel=1e-12)
        # With a mesh, halo joins the table (2D, and where the grid tiles).
        jb, jcosts = J.choose_backend(jspec, grid, mode=mode, bc=BC_VALUE,
                                      iters=iters, device_kind="cpu",
                                      mesh=(2, 1), tuned=None)
        tb, tcosts = T.choose_backend(TSPECS[family], grid,
                                      mode=T.BoundaryMode(mode.value),
                                      bc=BC_VALUE, iters=iters,
                                      device_kind="cpu", mesh=(2, 1))
        assert tb == NAME_MAP[jb], (family, mode, "mesh")
        assert {NAME_MAP[k]: v for k, v in jcosts.items()} == \
            pytest.approx(tcosts, rel=1e-12)
    # Table 1 over 2x2 and 8192x8192 over 2x4: the JAX picks and costs.
    lap = TSPECS["laplace/2d"]
    for grid, mesh in (((64, 64), (2, 2)), ((8192, 8192), (2, 4))):
        jb, jcosts = J.choose_backend(SPECS["laplace/2d"], grid, bc=1.0,
                                      iters=iters, device_kind="cpu",
                                      mesh=mesh, tuned=None)
        tb, tcosts = T.choose_backend(lap, grid, bc=1.0, iters=iters,
                                      device_kind="cpu", mesh=mesh)
        assert "halo" in tcosts and tb == NAME_MAP[jb], (grid, mesh)
        assert {NAME_MAP[k]: v for k, v in jcosts.items()} == \
            pytest.approx(tcosts, rel=1e-12)
    # Table 1: conv on the CPU (as JAX), the fused kernel on the card.
    lap = TSPECS["laplace/2d"]
    assert T.choose_backend(lap, (64, 64), bc=1.0, iters=20,
                            device_kind="cpu")[0] == "conv"
    assert T.choose_backend(lap, (64, 64), bc=1.0, iters=20,
                            device_kind="cuda")[0] == "cuda_fused"
    # Fig 6: the JAX pick on the CPU; on the card K4 and native Conv3D are
    # both bytes-bound with the same bytes, a tie that goes to the kernel.
    lap3 = TSPECS["laplace/3d"]
    assert T.choose_backend(lap3, (10, 64, 64), bc=1.0, iters=20,
                            device_kind="cpu")[0] == NAME_MAP[
        J.choose_backend(SPECS["laplace/3d"], (10, 64, 64), bc=1.0,
                         iters=20, device_kind="cpu", tuned=None)[0]]
    pick, costs = T.choose_backend(lap3, (10, 64, 64), bc=1.0, iters=20,
                                   device_kind="cuda")
    assert costs["cuda"] == costs["conv3d_native"] < costs["conv"]
    assert pick == "cuda"


def test_select_fuse_on_cpu_profile_makes_jax_picks():
    grids = [(12, 17), (64, 64), (1024, 1024), (8192, 8192)]
    for family, jb, grid, ce in itertools.product(
            FAMILIES_2D, ("pallas", "pallas_fused", "conv", "reference"),
            grids, (7, 16, 20, 24)):
        want = JS.select_fuse(jb, SPECS[family], grid, ce, device_kind="cpu",
                              tuned=None)
        got = T.select_fuse(NAME_MAP[jb], TSPECS[family], grid, ce, "cpu")
        assert got == want, (family, jb, grid, ce)


@functools.lru_cache(maxsize=None)
def _jax_reference_cell(family, dtype_name):
    jd = DTYPES[dtype_name][0]
    grid = GRIDS[SPECS[family].ndim]
    x = np.random.default_rng(7).standard_normal((2, *grid))
    out = J.stencil_apply(SPECS[family], jnp.asarray(x, jd),
                          backend="reference", bc=BC_VALUE, iters=ITERS,
                          tuned=None)
    return x, np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.value)
@pytest.mark.parametrize("backend", T.BACKENDS)
@pytest.mark.parametrize("family", FAMILIES_2D + FAMILIES_3D)
def test_conformance_cell_equals_jax_reference(family, backend, mode,
                                               dtype_name):
    ts = _assert_same_verdict(family, PORT_TO_JAX[backend], mode, BC_VALUE)
    if not ts:
        pytest.skip(f"{backend}/{family}/{mode.value}: {ts.reason}")
    _, td, atol = DTYPES[dtype_name]
    x, ref = _jax_reference_cell(family, dtype_name)
    out = T.stencil_apply(TSPECS[family], torch.tensor(x).to(td),
                          backend=backend, bc=BC_VALUE,
                          mode=T.BoundaryMode(mode.value),
                          iters=ITERS, device="cpu")
    assert out.dtype == td
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=atol,
                               err_msg=f"{backend} diverges from the JAX "
                                       f"reference on {family} {mode.value}")


@pytest.mark.parametrize("backend", ["reference", "conv", "dense"])
def test_source_and_bc_value_operands_match_jax(backend):
    mode = J.BoundaryMode.MATRIX if backend == "dense" else J.BoundaryMode.MASK
    tmode = T.BoundaryMode(mode.value)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 12, 17)).astype(np.float32)
    src = 0.1 * rng.standard_normal((12, 17)).astype(np.float32)
    jplan = J.make_plan(J.laplace_jacobi(2), (12, 17), backend=backend,
                        bc=1.0, mode=mode, iters=5, tuned=None)
    tplan = T.make_plan(T.laplace_jacobi(2), (12, 17), backend=backend,
                        bc=1.0, mode=tmode, iters=5, device="cpu")
    jout = jplan(jnp.asarray(x), source=jnp.asarray(src), bc_value=2.5)
    tout = tplan(torch.tensor(x), source=torch.tensor(src), bc_value=2.5)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-5)


@pytest.mark.parametrize("backend", [b for b in T.BACKENDS
                                     if b != "conv3d_native"])
def test_fields_operand_matches_jax(backend):
    jspec = SPECS["varcoef/2d"]
    mode = J.BoundaryMode.MATRIX if backend == "dense" else J.BoundaryMode.MASK
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 12, 17)).astype(np.float32)
    f = (0.2 + 0.05 * rng.random((4, 12, 17))).astype(np.float32)
    jb = PORT_TO_JAX[backend]
    jplan = J.make_plan(jspec, (12, 17), backend=jb, bc=1.0, mode=mode,
                        iters=4, fuse=2 if jb == "pallas_fused" else None,
                        tuned=None)
    tplan = T.make_plan(TSPECS["varcoef/2d"], (12, 17), backend=backend,
                        bc=1.0, mode=T.BoundaryMode(mode.value), iters=4,
                        fuse=2 if backend == "cuda_fused" else None,
                        device="cpu")
    if backend == "halo":
        # halo takes no runtime operands, in either package.
        with pytest.raises(ValueError) as jerr:
            jplan(jnp.asarray(x), fields=jnp.asarray(f))
        with pytest.raises(ValueError) as terr:
            tplan(torch.tensor(x), fields=torch.tensor(f))
        assert str(terr.value) == str(jerr.value)
        return
    jout = jplan(jnp.asarray(x), fields=jnp.asarray(f))
    tout = tplan(torch.tensor(x), fields=torch.tensor(f))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-5)


def test_raw_kernel_plans_match_jax():
    # bc=None: the raw zero-pad operator, scalar (K2) and variable (K1).
    x = np.random.default_rng(13).standard_normal((1, 12, 17))
    for family, backend, fuse in (("laplace/2d", "cuda_fused", 2),
                                  ("laplace/2d", "cuda", 1),
                                  ("varcoef/2d", "cuda", 1)):
        jout = J.stencil_apply(SPECS[family], jnp.asarray(x, jnp.float32),
                               backend=PORT_TO_JAX[backend], bc=None,
                               iters=4, fuse=fuse, tuned=None)
        tout = T.stencil_apply(TSPECS[family], torch.tensor(x).float(),
                               backend=backend, bc=None, iters=4, fuse=fuse,
                               device="cpu")
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   atol=1e-6)


def test_resident_plan_past_one_cta_runs_as_jax():
    # A 256x256 grid is past one CTA's shared memory and inside JAX's 8 MiB:
    # a plan with rim="resident" builds and runs, and equals JAX's
    # pallas_fused plan with the same schedule.
    x = np.random.default_rng(256).standard_normal((256, 256))
    jplan = J.make_plan(J.laplace_jacobi(2), (256, 256),
                        backend="pallas_fused", bc=BC_VALUE, iters=16,
                        rim="resident", tuned=None)
    plan = T.make_plan(T.laplace_jacobi(2), (256, 256), backend="cuda_fused",
                       bc=BC_VALUE, iters=16, rim="resident", device="cpu")
    assert (plan.fuse, plan.rim) == (jplan.fuse, "resident") == (16,
                                                                 "resident")
    jout = jplan(jnp.asarray(x, jnp.float32))
    tout = plan(torch.tensor(x).float())
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-6)


def test_plan_contract():
    lap = T.laplace_jacobi(2)
    x = torch.zeros(12, 17)
    plan = T.make_plan(lap, (12, 17), backend="cuda_fused", bc=1.0, iters=8,
                       device="cpu")
    assert (plan.fuse, plan.rim, plan.source) == (8, "trapezoid", "explicit")
    assert plan(x).shape == x.shape  # a bare grid round-trips
    res = T.make_plan(lap, (12, 17), backend="cuda_fused", bc=1.0, iters=40,
                      rim="resident", device="cpu")
    assert (res.fuse, res.rim) == (40, "resident")
    auto = T.make_plan(lap, (12, 17), bc=1.0, iters=8, device="cpu")
    assert (auto.backend, auto.source) == ("conv", "roofline")
    assert T.make_plan(lap, (12, 17), backend="conv", bc=1.0, iters=8,
                       fuse=4, device="cpu").fuse == 1
    with pytest.raises(ValueError, match="not divisible"):
        T.make_plan(lap, (12, 17), backend="cuda", bc=1.0, iters=10, fuse=4,
                    device="cpu")
    with pytest.raises(ValueError, match="rim strategy"):
        T.make_plan(lap, (12, 17), backend="cuda", bc=1.0, iters=4,
                    rim="diamond", device="cpu")
    with pytest.raises(ValueError, match="takes no runtime fields"):
        plan(x, fields=torch.zeros(0, 12, 17))
    with pytest.raises(ValueError, match="plan built for grid"):
        plan(torch.zeros(1, 8, 8))
    with pytest.raises(ValueError, match="unsupported here"):
        T.make_plan(lap, (12, 17), backend="dense", bc=1.0, device="cpu")
    with pytest.raises(ValueError, match="incompatible"):
        T.stencil_apply(T.laplace_jacobi(3), torch.zeros(4, 4), device="cpu")


@pytest.mark.parametrize("bc", [BC_VALUE, None])
@pytest.mark.parametrize("family", FAMILIES_3D)
def test_3d_kernel_plans_carry_the_spec_across(family, bc):
    # K4's plan, raw and with a bc, on every 3D family (varcoef/3d's fields
    # come across through to_torch_spec), against JAX's pallas plan.
    grid = GRIDS[3]
    x = np.random.default_rng(15).standard_normal((2, *grid))
    jout = J.stencil_apply(SPECS[family], jnp.asarray(x, jnp.float32),
                           backend="pallas", bc=bc, iters=3, tuned=None)
    plan = T.make_plan(TSPECS[family], grid, backend="cuda", bc=bc, iters=3,
                       fuse=4 if bc is None else None, device="cpu")
    assert (plan.fuse, plan.rim, plan.operands) == (1, None, frozenset())
    tout = plan(torch.tensor(x).float())
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("backend", ["conv", "conv3d_native", "reference"])
def test_3d_source_and_bc_value_operands_match_jax(backend):
    rng = np.random.default_rng(16)
    x = rng.standard_normal((2, *GRIDS[3])).astype(np.float32)
    src = 0.1 * rng.standard_normal(GRIDS[3]).astype(np.float32)
    jplan = J.make_plan(J.laplace_jacobi(3), GRIDS[3], backend=backend,
                        bc=1.0, iters=5, tuned=None)
    tplan = T.make_plan(T.laplace_jacobi(3), GRIDS[3], backend=backend,
                        bc=1.0, iters=5, device="cpu")
    assert tplan.operands == frozenset({"source", "bc_value"})
    jout = jplan(jnp.asarray(x), source=jnp.asarray(src), bc_value=2.5)
    tout = tplan(torch.tensor(x), source=torch.tensor(src), bc_value=2.5)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-5)


def test_3d_fields_operand_matches_jax():
    jspec = SPECS["varcoef/3d"]
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2, *GRIDS[3])).astype(np.float32)
    f = (0.1 + 0.05 * rng.random((6, *GRIDS[3]))).astype(np.float32)
    jplan = J.make_plan(jspec, GRIDS[3], backend="conv3d_native", bc=1.0,
                        iters=4, tuned=None)
    tplan = T.make_plan(TSPECS["varcoef/3d"], GRIDS[3],
                        backend="conv3d_native", bc=1.0, iters=4,
                        device="cpu")
    jout = jplan(jnp.asarray(x), fields=jnp.asarray(f))
    tout = tplan(torch.tensor(x), fields=torch.tensor(f))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-5)


# --- stencils past the kernels' former limits ---------------------------------
# The CUDA kernels once refused more than 25 taps (2D) or 125 (3D) and a
# trapezoid past one CTA's shared memory; JAX's pallas/pallas_fused run
# them.  fp32 within 1e-6 (same arithmetic, same tap order), bf16 within
# 2e-2 (one bf16 ulp at these magnitudes), as test_torch_kernels.py.
LIMIT_TOL = {"f32": 1e-6, "bf16": 2e-2}


def _radius3_box(ndim):
    n = 7 ** ndim
    return J.StencilSpec({o: 1.0 / n for o in itertools.product(
        range(-3, 4), repeat=ndim)}, name=f"box{ndim}d_r3")


@pytest.mark.parametrize("backend,grid,fuse", [
    ("cuda", (64, 64), 1), ("cuda_fused", (64, 64), 2),
    ("cuda", (10, 64, 64), 1)])
def test_radius3_boxes_run_as_jax(backend, grid, fuse):
    jspec = _radius3_box(len(grid))
    assert len(jspec.taps) == 7 ** len(grid)   # 49 and 343 taps
    x = np.random.default_rng(18).standard_normal((1, *grid))
    jout = J.stencil_apply(jspec, jnp.asarray(x, jnp.float32),
                           backend=PORT_TO_JAX[backend], bc=BC_VALUE,
                           iters=2, fuse=fuse, tuned=None)
    tout = T.stencil_apply(to_torch_spec(jspec), torch.tensor(x).float(),
                           backend=backend, bc=BC_VALUE, iters=2, fuse=fuse,
                           device="cpu")
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=LIMIT_TOL["f32"])


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("radius", [1, 2])
def test_fuse_64_runs_as_jax(radius, dtype_name):
    # The 5-point Laplace Jacobi, and the radius-2 averaging star of the
    # kernel tests (weights summing to 1).  The fourth-order Laplace Jacobi
    # star (16/60, -1/60) is no test of this: its weights' absolute sum is
    # 68/60, so 64 steps grow the grid to ~100, where JAX's own pallas and
    # reference backends already differ by 1.5e-5.
    jspec = (J.laplace_jacobi(2) if radius == 1
             else J.star(2, [0.15, 0.05], center=0.2))
    jd, td, _ = DTYPES[dtype_name]
    x = np.random.default_rng(19).standard_normal((1, 24, 24))
    jout = J.stencil_apply(jspec, jnp.asarray(x, jd), backend="pallas_fused",
                           bc=BC_VALUE, iters=64, fuse=64, tuned=None)
    plan = T.make_plan(to_torch_spec(jspec), (24, 24), backend="cuda_fused",
                       bc=BC_VALUE, iters=64, fuse=64, dtype=td,
                       device="cpu")
    assert (plan.fuse, plan.rim) == (64, "trapezoid")
    tout = plan(torch.tensor(x).to(td))
    assert tout.dtype == td
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)), rtol=0,
                               atol=LIMIT_TOL[dtype_name])
