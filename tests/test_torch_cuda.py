"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one; on a machine with
an H100 run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only the port is installed.
Tolerances: fp32 1e-6 absolute — the kernels round each product and each
sum as the plain versions do (no FMA contraction), in the same tap order,
so fp32 results are expected bit-equal; bf16 2e-2 absolute (one bf16 ulp
at these magnitudes).  K5 (a GEMM) sums in another order than the library
product its plain version calls: 1e-4 relative and absolute in fp32, and
3e-2 relative plus 3e-1 absolute in bf16, the JAX package's tolerances.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.kernels import (_build, dense_jacobi_kernel,
                                 dense_stencil_matmul, dense_stencil_plain,
                                 jacobi2d, jacobi2d_fused_plain,
                                 jacobi2d_fused_step, stencil2d,
                                 stencil2d_plain, stencil3d, stencil3d_plain)

pytestmark = pytest.mark.cuda

SMALL = (3, 33, 57)
TOL = {torch.float32: 1e-6, torch.bfloat16: 2e-2}
_rng = np.random.default_rng(20261016)


def _field(shape):
    return 0.1 + 0.2 * _rng.random(shape)


def _specs(grid):
    """name -> (spec on this grid, bc_value)."""
    return {
        "laplace_bc": (T.laplace_jacobi(2), 1.5),
        "laplace_raw": (T.laplace_jacobi(2), None),
        "fields_bc": (T.heterogeneous_jacobi(1.0 + 9.0 * _rng.random(grid)),
                      1.5),
        "fields_raw": (T.variable_coefficient(T.laplace_jacobi(2),
                                              {(0, 1): _field(grid)}), None),
        "radius2_bc": (T.star(2, [0.15, 0.05], center=0.2), 1.5),
        "box_raw": (T.box(2), None),
    }


CASES = list(_specs((2, 2)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(cuda, case, shape, dtype):
    spec, bc = _specs(shape[1:])[case]
    x = torch.from_numpy(
        np.random.default_rng(1).standard_normal(shape).astype(np.float32))
    return spec, bc, x.to(cuda, dtype)


@pytest.mark.parametrize("shape", [SMALL, (2, 1024, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_stencil2d_matches_plain(cuda, case, dtype, shape):
    spec, bc, x = _inputs(cuda, case, shape, dtype)
    n = _build.LAUNCHES["stencil2d"]
    out = stencil2d(x, spec, bc_value=bc)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["stencil2d"] == n + 1
    ref = stencil2d_plain(x, spec, bc_value=bc)
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=TOL[dtype])


@pytest.mark.parametrize("rim,fuse,shape",
                         [("trapezoid", f, SMALL) for f in (1, 2, 4, 8, 16)]
                         + [("trapezoid", 16, (2, 300, 260))]
                         + [("resident", f, (2, 64, 64)) for f in (1, 8, 64)]
                         + [("resident", 512, (1, 160, 160))])
@pytest.mark.parametrize("case", ["laplace_bc", "fields_bc", "radius2_bc",
                                  "box_raw"])
def test_fused_step_matches_plain(cuda, case, rim, fuse, shape):
    spec, bc, x = _inputs(cuda, case, shape, torch.float32)
    key = f"jacobi2d_{rim}"
    n = _build.LAUNCHES[key]
    out = jacobi2d_fused_step(x, spec, fuse=fuse, bc_value=bc, rim=rim)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == n + 1
    ref = jacobi2d_fused_plain(x, spec, fuse=fuse, bc_value=bc)
    torch.testing.assert_close(out, ref, rtol=0, atol=TOL[torch.float32])


def test_fused_step_bf16_rounds_once_per_pass(cuda):
    spec, bc, x = _inputs(cuda, "laplace_bc", SMALL, torch.bfloat16)
    out = jacobi2d_fused_step(x, spec, fuse=8, bc_value=bc)
    ref = jacobi2d_fused_plain(x, spec, fuse=8, bc_value=bc)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=TOL[torch.bfloat16])


def test_table1_on_the_card_takes_the_cpu_iteration_count(cuda):
    for backend in ("cuda_fused", "cuda"):
        r = T.solve(T.laplace_jacobi(2), torch.zeros(64, 64), backend=backend,
                    bc=1.0, rtol=1e-6, check_every=20, max_iters=20_000)
        assert r.converged and r.x.device.type == "cuda"
        assert abs(r.iterations - 7960) <= 20, (backend, r.iterations)


def test_wrappers_raise_rather_than_fall_back(cuda):
    x = torch.zeros(2, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        stencil2d(x.transpose(1, 2), T.laplace_jacobi(2))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        jacobi2d_fused_step(x.half(), T.laplace_jacobi(2), fuse=2)


def _specs3(grid):
    """name -> (3D spec on this grid, bc_value)."""
    return {
        "laplace_bc": (T.laplace_jacobi(3), 1.5),
        "laplace_raw": (T.laplace_jacobi(3), None),
        "fields_bc": (T.heterogeneous_jacobi(1.0 + 9.0 * _rng.random(grid)),
                      1.5),
        "radius2_bc": (T.star(3, [0.15, 0.05], center=0.2), 1.5),
        "box_raw": (T.box(3), None),
    }


@pytest.mark.parametrize("shape", [(2, 6, 10, 12), (1, 10, 33, 57),
                                   (3, 10, 64, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(_specs3((2, 2, 2))))
def test_stencil3d_matches_plain(cuda, case, dtype, shape):
    spec, bc = _specs3(shape[1:])[case]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(shape)
                         .astype(np.float32)).to(cuda, dtype)
    n = _build.LAUNCHES["stencil3d"]
    out = stencil3d(x, spec, bc_value=bc)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["stencil3d"] == n + 1
    ref = stencil3d_plain(x, spec, bc_value=bc)
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=TOL[dtype])


@pytest.mark.parametrize("s,n", [(1, 64), (8, 130), (300, 257),
                                 (129, 1024)])
def test_dense_stencil_matches_plain(cuda, s, n):
    rng = np.random.default_rng(s + n)
    x = torch.from_numpy(rng.standard_normal((s, n)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
    x, w = x.to(cuda), w.to(cuda)
    k = _build.LAUNCHES["dense_stencil_matmul"]
    out = dense_stencil_matmul(x, w)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["dense_stencil_matmul"] == k + 1
    torch.testing.assert_close(out, dense_stencil_plain(x, w), rtol=1e-4,
                               atol=1e-4)


def test_dense_stencil_bf16_accumulates_fp32(cuda):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((8, 256)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((256, 256)).astype(np.float32))
    x, w = x.to(cuda, torch.bfloat16), w.to(cuda, torch.bfloat16)
    out = dense_stencil_matmul(x, w)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), dense_stencil_plain(x, w).float(),
                               rtol=3e-2, atol=3e-1)


def test_dense_jacobi_kernel_equals_the_stencil_kernels(cuda):
    lap = T.laplace_jacobi(2)
    m = torch.as_tensor(T.build_dense_matrix((20, 24), lap), device=cuda)
    x0 = torch.from_numpy(np.random.default_rng(4).random((5, 20, 24))
                          .astype(np.float32)).to(cuda)
    x0 = T.DirichletBC(1.0).set_boundary(x0, 2)
    out = dense_jacobi_kernel(x0, m, iterations=7)
    ref = jacobi2d(x0, lap, bc_value=1.0, iterations=7)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


def test_fig6_on_the_card_takes_the_cpu_iteration_count(cuda):
    for backend in ("auto", "cuda", "reference", "conv", "conv3d_native"):
        r = T.solve(T.laplace_jacobi(3), torch.zeros(10, 64, 64),
                    backend=backend, bc=1.0, rtol=1e-6, check_every=20,
                    max_iters=10_000)
        assert r.converged and r.x.device.type == "cuda"
        if backend == "auto":
            # The default entry point runs K4 on the card.
            assert r.backend == "cuda"
        if backend in ("auto", "cuda", "reference"):
            # Bit-equal to the CPU: the same count and residual.
            assert r.iterations == 620, backend
            assert r.residual == 1.4074293721932918e-04, backend
        else:
            assert abs(r.iterations - 620) <= 20, (backend, r.iterations)


def test_3d_and_dense_wrappers_raise_rather_than_fall_back(cuda):
    x = torch.zeros(2, 4, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        stencil3d(x.transpose(2, 3), T.laplace_jacobi(3))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        stencil3d(x.half(), T.laplace_jacobi(3))
    with pytest.raises(ValueError, match="contiguous"):
        dense_stencil_matmul(x[0, 0], x[0, 0].t())
