"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one; on a machine with
an H100 run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only the port is installed.
Tolerances: fp32 1e-6 absolute — the kernels round each product and each
sum as the plain versions do (no FMA contraction), in the same tap order,
so fp32 results are expected bit-equal; bf16 2e-2 absolute (one bf16 ulp
at these magnitudes).
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.kernels import (_build, jacobi2d_fused_plain,
                                 jacobi2d_fused_step, stencil2d,
                                 stencil2d_plain)

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
