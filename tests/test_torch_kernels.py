"""The port's kernels K1 (``stencil2d``) and K2/K3 (``jacobi2d_fused_step``,
trapezoid and resident) against the JAX package's Pallas kernels, run
interpreted on the CPU as the JAX tests run them.

On a CPU tensor each wrapper runs its plain PyTorch version, so these hold
the plain versions against the TPU kernels.  test_torch_cuda.py holds the
CUDA kernels against the plain versions on the card.

Tolerances: fp32 1e-6 absolute (same arithmetic, same tap order — the
results are expected bit-equal); bf16 2e-2 absolute (one bf16 ulp at the
magnitudes of these inputs, for a rounding that lands differently).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.kernels as JK
import repro_torch.core as T
from repro_torch.kernels import (_build, jacobi2d, jacobi2d_fused_step,
                                 stencil2d)

SHAPE = (2, 33, 57)
TOL = {"f32": 1e-6, "bf16": 2e-2}
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                     torch.bfloat16)}
_rng = np.random.default_rng(20261016)
KAPPA = 1.0 + 9.0 * _rng.random(SHAPE[1:])
X = _rng.standard_normal(SHAPE).astype(np.float32)
OVERRIDE = (0.2 + 0.1 * _rng.random((4, *SHAPE[1:]))).astype(np.float32)

# name -> (JAX spec, bc_value)
CASES = {
    "laplace_bc": (J.laplace_jacobi(2), 1.5),
    "laplace_raw": (J.laplace_jacobi(2), None),
    "fields_bc": (J.heterogeneous_jacobi(KAPPA), 1.5),
    "fields_raw": (J.variable_coefficient(
        J.laplace_jacobi(2), {(0, 1): 0.1 + 0.2 * _rng.random(SHAPE[1:])}),
        None),
    "radius2_bc": (J.star(2, [0.15, 0.05], center=0.2), 1.5),
    "box_raw": (J.box(2), None),
}


def to_torch_spec(jspec):
    return T.spec_from_taps(
        [(o, w.array if isinstance(w, J.WeightField) else w)
         for o, w in jspec.taps], name=jspec.name)


def _inputs(dtype_name):
    jd, td = DT[dtype_name]
    return jnp.asarray(X, jd), torch.from_numpy(X).to(td)


def _close(jout, tout, dtype_name):
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               rtol=0, atol=TOL[dtype_name])


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_stencil2d_matches_pallas(case, dtype_name):
    jspec, bc = CASES[case]
    jx, tx = _inputs(dtype_name)
    jout = JK.stencil2d(jx, jspec, bc_value=bc)
    tout = stencil2d(tx, to_torch_spec(jspec), bc_value=bc)
    assert tout.dtype == tx.dtype and tout.shape == tx.shape
    _close(jout, tout, dtype_name)


def test_plain_stencil2d_fields_override_matches_pallas():
    jspec, bc = CASES["fields_bc"]
    jx, tx = _inputs("f32")
    jout = JK.stencil2d(jx, jspec, bc_value=bc, fields=jnp.asarray(OVERRIDE))
    tout = stencil2d(tx, to_torch_spec(jspec), bc_value=bc,
                     fields=torch.from_numpy(OVERRIDE))
    _close(jout, tout, "f32")


TRAPEZOID = ([(c, f, "f32") for c in CASES for f in (4,)]
             + [(c, f, "f32") for c in ("laplace_bc", "fields_bc")
                for f in (1, 2, 8)]
             + [("laplace_bc", 4, "bf16"), ("fields_bc", 2, "bf16")])
RESIDENT = ([(c, f, "f32") for c in ("laplace_bc", "fields_bc")
             for f in (2, 8, 32)]
            + [(c, 8, "f32") for c in ("laplace_raw", "radius2_bc",
                                       "box_raw")]
            + [("laplace_bc", 8, "bf16")])


@pytest.mark.parametrize("rim,case,fuse,dtype_name",
                         [("trapezoid", *c) for c in TRAPEZOID]
                         + [("resident", *c) for c in RESIDENT])
def test_plain_fused_step_matches_pallas(rim, case, fuse, dtype_name):
    jspec, bc = CASES[case]
    jx, tx = _inputs(dtype_name)
    jout = JK.jacobi2d_fused_step(jx, jspec, fuse=fuse, bc_value=bc, rim=rim)
    tout = jacobi2d_fused_step(tx, to_torch_spec(jspec), fuse=fuse,
                               bc_value=bc, rim=rim)
    assert tout.dtype == tx.dtype
    _close(jout, tout, dtype_name)


@pytest.mark.parametrize("case,fuse", [("laplace_bc", 4), ("fields_bc", 1),
                                       ("fields_bc", 2)])
def test_jacobi2d_loop_matches_pallas(case, fuse):
    # ops.jacobi2d: shell seeding, then fuse-step passes (K1 for a
    # variable spec at fuse=1, K2 otherwise).
    jspec, bc = CASES[case]
    jx, tx = _inputs("f32")
    jout = JK.jacobi2d(jx, jspec, bc_value=bc, iterations=8, fuse=fuse)
    tout = jacobi2d(tx, to_torch_spec(jspec), bc_value=bc, iterations=8,
                    fuse=fuse)
    _close(jout, tout, "f32")


def test_fused_step_is_repeated_direct_steps():
    # The fused pass keeps fp32 across its steps and rounds once; in fp32
    # that is exactly T direct steps from a grid whose shell is set.
    tspec = to_torch_spec(CASES["fields_bc"][0])
    x = T.DirichletBC(1.5).set_boundary(torch.from_numpy(X), 2)
    y = x
    for _ in range(6):
        y = stencil2d(y, tspec, bc_value=1.5)
    torch.testing.assert_close(
        jacobi2d_fused_step(x, tspec, fuse=6, bc_value=1.5), y,
        rtol=0, atol=0)


def test_naive_oracles_match_jax():
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref
    for case in ("laplace_raw", "radius2_bc", "fields_bc"):
        jspec, _ = CASES[case]
        jx, tx = _inputs("f32")
        np.testing.assert_allclose(
            tref.stencil2d_ref(tx, to_torch_spec(jspec)).numpy(),
            np.asarray(jref.stencil2d_ref(jx, jspec)), rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            tref.jacobi2d_ref(tx, to_torch_spec(jspec), 1.5, 3).numpy(),
            np.asarray(jref.jacobi2d_ref(jx, jspec, 1.5, 3)), rtol=0,
            atol=1e-6)


def test_wrappers_reject_what_the_kernels_cannot_run():
    x = torch.from_numpy(X)
    lap = T.laplace_jacobi(2)
    with pytest.raises(ValueError, match="not divisible"):
        jacobi2d(x, lap, bc_value=1.0, iterations=10, fuse=4)
    with pytest.raises(ValueError, match="resident"):
        jacobi2d_fused_step(torch.zeros(1, 200, 200), lap, fuse=2,
                            rim="resident")
    with pytest.raises(ValueError, match="shared memory"):
        jacobi2d_fused_step(x, lap, fuse=60)
    wide = T.StencilSpec({(i, j): 0.01 for i in range(-2, 3)
                          for j in range(-3, 3)})
    with pytest.raises(ValueError, match="at most 25"):
        stencil2d(x, wide)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        stencil2d(x.double(), lap)
    with pytest.raises(ValueError, match="fields must be shaped"):
        stencil2d(x, to_torch_spec(CASES["fields_bc"][0]),
                  fields=torch.zeros(4, 3, 3))
    box5 = T.StencilSpec({(i, j): 0.04 for i in range(-2, 3)
                          for j in range(-2, 3)})
    assert stencil2d(x, box5).shape == x.shape  # 25 taps fit


def test_plain_path_launches_no_kernel():
    before = dict(_build.LAUNCHES)
    x = torch.from_numpy(X)
    stencil2d(x, T.laplace_jacobi(2), bc_value=1.0)
    jacobi2d_fused_step(x, T.laplace_jacobi(2), fuse=2, bc_value=1.0)
    assert dict(_build.LAUNCHES) == before
