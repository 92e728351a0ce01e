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
K6/K7 (flash attention) sum in another order than their plain versions:
out 2e-5 absolute in fp32 (JAX's own bound) and, per element, 2e-3 + 1.6e-2
* |plain| in bf16 (two bf16 ulps; the bf16 kernel's 128-key tiles round p
against other running maxima than the plain version's blocks), lse 1e-5 of
its max-abs.  Four faults planted in the bf16 (tensor-core) kernel's
source, each built on its own, must fail that bf16 bound.  K8/K9 (the flash
backward) are held per element to 2e-5 + 1e-5 * |plain| in fp32 and to the
same bf16 bound as K6/K7, and four faults planted in their bf16
(tensor-core) source must fail it too.
"""
import contextlib
import ctypes
import dataclasses
import itertools
import shutil
import subprocess

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.configs import get_config
from repro_torch.launch.serve import serve
from repro_torch.models.model_zoo import build
from repro_torch.models.transformer import Transformer
from repro_torch.kernels import (_build, dense_jacobi_kernel,
                                 dense_stencil_matmul, dense_stencil_plain,
                                 flash_attention, flash_fwd, flash_fwd_plain,
                                 jacobi2d, jacobi2d_fused_plain,
                                 jacobi2d_fused_step, stencil2d,
                                 stencil2d_plain, stencil3d, stencil3d_plain)
from repro_torch.kernels.flash_attention_bwd import (flash_bwd,
                                                     flash_bwd_plain,
                                                     flash_delta)
from repro_torch.data.synthetic import DataConfig, token_batch
from repro_torch.train.train_step import init_train_state, value_and_grad
from repro_torch.kernels.dense_stencil import (dense_stencil_split_plain,
                                               launch_split, padded_cols,
                                               split_bf16x3)
from repro_torch.kernels.jacobi_fused import (COUNTERS, KERNELS as K23,
                                              kernel_for, trapezoid_passes)
from repro_torch.kernels.stencil3d import KERNELS
from _torch_dense_cases import (GEMM_SHAPES, K5_NORM_ERR, W_PIECES_ULPS,
                                full_mantissa, max_ulps, norm_err,
                                perm_exact_case, w_pieces_case)
from _torch_flash_cases import (BF16_ATOL, BF16_RTOL, FLASH_CASES,
                                FLIP_CASES, ds_flip_atol, ds_rounding_case,
                                dv_p_rounding_case, p_rounding_case)
from _torch_vlm_encdec_cases import family_inputs

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
    # The launch count is the kernel's the shape sends the request to: a
    # trapezoid on a one-CTA grid with a small batch runs the resident
    # register kernel (kernel_for).
    spec, bc, x = _inputs(cuda, case, shape, torch.float32)
    key = _counter(rim, spec, fuse, shape)
    n = _build.LAUNCHES[key]
    out = jacobi2d_fused_step(x, spec, fuse=fuse, bc_value=bc, rim=rim)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == n + 1
    ref = jacobi2d_fused_plain(x, spec, fuse=fuse, bc_value=bc)
    torch.testing.assert_close(out, ref, rtol=0, atol=TOL[torch.float32])


def _counter(rim, spec, fuse, shape):
    """The LAUNCHES key of the kernel a request takes by shape."""
    return COUNTERS[kernel_for(rim, spec, fuse, *shape)]


def test_fused_step_bf16_rounds_once_per_pass(cuda):
    spec, bc, x = _inputs(cuda, "laplace_bc", SMALL, torch.bfloat16)
    out = jacobi2d_fused_step(x, spec, fuse=8, bc_value=bc)
    ref = jacobi2d_fused_plain(x, spec, fuse=8, bc_value=bc)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=TOL[torch.bfloat16])


def _radius3_box(ndim):
    n = 7 ** ndim
    return T.StencilSpec({o: 1.0 / n for o in itertools.product(
        range(-3, 4), repeat=ndim)})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["stencil2d", "trapezoid", "stencil3d"])
def test_tables_past_the_parameter_taps_equal_the_plain_versions(
        cuda, kernel, dtype):
    """49 taps (the 2D radius-3 box) through K1 and K2, 343 (the 3D one)
    through K4: the table comes as a device array, bit-equal in fp32."""
    rng = np.random.default_rng(49)
    if kernel == "stencil3d":
        spec, shape = _radius3_box(3), (2, 10, 64, 64)
    else:
        spec, shape = _radius3_box(2), (2, 64, 64)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        cuda, dtype)
    if kernel == "stencil2d":
        key, out = "stencil2d", lambda: stencil2d(x, spec, bc_value=1.5)
        ref = stencil2d_plain(x, spec, bc_value=1.5)
    elif kernel == "stencil3d":
        key, out = "stencil3d", lambda: stencil3d(x, spec, bc_value=1.5)
        ref = stencil3d_plain(x, spec, bc_value=1.5)
    else:
        key = _counter("trapezoid", spec, 4, shape)
        out = lambda: jacobi2d_fused_step(x, spec, fuse=4, bc_value=1.5)
        ref = jacobi2d_fused_plain(x, spec, fuse=4, bc_value=1.5)
    n = _build.LAUNCHES[key]
    got = out()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == n + 1
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=0 if dtype == torch.float32
                               else TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius,passes", [(1, 2), (2, 3)])
def test_fuse_64_runs_in_passes_that_keep_fp32(cuda, radius, passes, dtype):
    """A trapezoid past one CTA's shared memory runs in passes (32 + 32 at
    radius 1; 22 + 21 + 21 at radius 2) that hand each other fp32: the
    plain version, which keeps fp32 across all 64 steps and rounds once, is
    met to 0.0 in fp32 and within the bf16 bound."""
    spec = (T.laplace_jacobi(2) if radius == 1
            else T.star(2, [0.15, 0.05], center=0.2))
    x = torch.from_numpy(np.random.default_rng(64).standard_normal(
        (2, 300, 260)).astype(np.float32)).to(cuda, dtype)
    key = _counter("trapezoid", spec, 64, x.shape)
    n = _build.LAUNCHES[key]
    out = jacobi2d_fused_step(x, spec, fuse=64, bc_value=1.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == n + passes
    ref = jacobi2d_fused_plain(x, spec, fuse=64, bc_value=1.5)
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=0 if dtype == torch.float32
                               else TOL[dtype])


# The stream kernel (K2), asked for by name and by shape: ragged shapes (W
# not a multiple of the strip, H not of the chunk), batches of 1 and 3, fuse
# 1-16 and the deepest fuse of one pass +- 1 (37 at radius 1, 22 at radius
# 2, 16 at radius 3: one pass and two), radius 1, 2 and 3 (the 49-tap box),
# fields.  fp32 0.0 from the plain version, bf16 within TOL.
STREAM_SHAPES = [(1, 300, 517), (3, 129, 260)]
STREAM_FUSES = {"laplace_bc": (1, 2, 4, 8, 16, 36, 37, 38),
                "fields_bc": (1, 2, 8), "fields_raw": (4,),
                "radius2_bc": (1, 8, 21, 22, 23), "box_r3": (1, 4, 15, 16, 17)}


def _stream_spec(case, grid):
    if case == "box_r3":
        return _radius3_box(2), 1.5
    return _specs(grid)[case]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", STREAM_SHAPES)
@pytest.mark.parametrize("case,fuse", [(c, f) for c, fs in
                                       STREAM_FUSES.items() for f in fs])
def test_stream_trapezoid_matches_plain(cuda, case, fuse, shape, dtype):
    # By shape these small grids may take the tile kernel: the count is the
    # kernel's that ran.
    spec, bc = _stream_spec(case, shape[1:])
    x = torch.from_numpy(np.random.default_rng(fuse).standard_normal(
        shape).astype(np.float32)).to(cuda, dtype)
    ref = jacobi2d_fused_plain(x, spec, fuse=fuse, bc_value=bc)
    for name in ("stream", None):
        kernel = name or kernel_for("trapezoid", spec, fuse, *shape)
        passes = len(trapezoid_passes(fuse, spec.radius, kernel))
        n = _build.LAUNCHES[COUNTERS[kernel]]
        out = jacobi2d_fused_step(x, spec, fuse=fuse, bc_value=bc,
                                  kernel=name)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[COUNTERS[kernel]] == n + passes
        assert out.dtype == dtype
        e = float((out.float() - ref.float()).abs().max())
        assert e == 0.0 if dtype == torch.float32 else e <= TOL[dtype], e


# The register kernel (K3) at 33x57, 64x64 and its largest patches
# (128x128, 256x64 and 16x1024: 512 threads of 16x2 cells), for the 5-point
# star with and without fields and the 3x3 box; the cta kernel on the
# largest one-CTA grids (168x168 at radius 1, 160x160 at radius 2) and a
# radius-2 64x64 grid; each by name and by shape (rim="resident").  The
# grid-wide kernel at 169x169, 512x512 and 1024x2048 (JAX's 8 MiB limit),
# past one CTA.  fp32 0.0, bf16 within TOL.
RESIDENT_CASES = (
    [("resident_regs", g, c, f)
     for g in ((33, 57), (64, 64), (128, 128), (256, 64), (16, 1024))
     for c in ("laplace_bc", "fields_bc", "fields_raw", "box_raw")
     for f in (1, 8, 517)]
    + [("resident_cta", (168, 168), c, f)
       for c in ("laplace_bc", "fields_bc", "box_raw") for f in (1, 8, 517)]
    + [("resident_cta", g, "radius2_bc", f) for g in ((160, 160), (64, 64))
       for f in (1, 8, 517)]
    + [("resident_grid", g, c, f) for g in ((169, 169), (512, 512))
       for c in ("laplace_bc", "fields_bc", "radius2_bc", "box_raw")
       for f in (1, 8, 512)]
    + [("resident_grid", (1024, 2048), "laplace_bc", f) for f in (1, 8, 512)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel,grid,case,fuse", RESIDENT_CASES)
def test_resident_kernels_match_plain(cuda, kernel, grid, case, fuse, dtype):
    spec, bc = _specs(grid)[case]
    B = 1 if grid[0] * grid[1] > 2 ** 18 else 2
    x = torch.from_numpy(np.random.default_rng(fuse).standard_normal(
        (B, *grid)).astype(np.float32)).to(cuda, dtype)
    ref = jacobi2d_fused_plain(x, spec, fuse=fuse, bc_value=bc)
    for name in (kernel, None):
        n = _build.LAUNCHES[COUNTERS[kernel]]
        out = jacobi2d_fused_step(x, spec, fuse=fuse, bc_value=bc,
                                  rim="resident", kernel=name)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[COUNTERS[kernel]] == n + 1
        e = float((out.float() - ref.float()).abs().max())
        assert e == 0.0 if dtype == torch.float32 else e <= TOL[dtype], e


@pytest.mark.parametrize("kernel", ["tile", "resident_smem"])
@pytest.mark.parametrize("case", ["laplace_bc", "fields_bc", "radius2_bc",
                                  "box_raw"])
def test_earlier_kernels_by_name_match_plain(cuda, kernel, case):
    # The kernels before the stream and register ones, kept by name.
    shape = (3, 33, 57) if kernel == "resident_smem" else (2, 300, 260)
    spec, bc, x = _inputs(cuda, case, shape, torch.float32)
    n = _build.LAUNCHES[COUNTERS[kernel]]
    out = jacobi2d_fused_step(x, spec, fuse=16, bc_value=bc, kernel=kernel)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[COUNTERS[kernel]] == n + 1
    ref = jacobi2d_fused_plain(x, spec, fuse=16, bc_value=bc)
    assert float((out - ref).abs().max()) == 0.0


@pytest.mark.parametrize("kernel", ["stream_r0", "stream_u1"])
@pytest.mark.parametrize("case,fuse", [("laplace_bc", 1), ("laplace_bc", 4),
                                       ("laplace_bc", 16), ("box_raw", 8),
                                       ("radius2_bc", 8)])
def test_stream_variants_by_name_match_plain(cuda, kernel, case, fuse):
    # The stream kernel with the radius a runtime value, and with one level
    # at a time: by name only, counted as the stream kernel.
    spec, bc, x = _inputs(cuda, case, (2, 300, 260), torch.float32)
    n = _build.LAUNCHES["jacobi2d_trapezoid"]
    out = jacobi2d_fused_step(x, spec, fuse=fuse, bc_value=bc, kernel=kernel)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["jacobi2d_trapezoid"] == n + 1
    ref = jacobi2d_fused_plain(x, spec, fuse=fuse, bc_value=bc)
    assert float((out - ref).abs().max()) == 0.0


def test_trapezoid_on_a_small_grid_runs_resident(cuda):
    # Table 1's launch (one 64x64 grid, fuse 4) takes the register kernel,
    # a batch of them too; a grid past one CTA takes the stream kernel: the
    # same bits.
    spec, bc = T.laplace_jacobi(2), 1.0
    x = torch.rand(1024, 64, 64, device=cuda)
    for batch, key in ((1, "jacobi2d_resident"), (1024, "jacobi2d_resident")):
        n = dict(_build.LAUNCHES)
        out = jacobi2d_fused_step(x[:batch], spec, fuse=4, bc_value=bc)
        torch.cuda.synchronize()
        grew = {k: v - n.get(k, 0) for k, v in _build.LAUNCHES.items()
                if v != n.get(k, 0)}
        assert grew == {key: 1}, grew
        ref = jacobi2d_fused_plain(x[:batch], spec, fuse=4, bc_value=bc)
        assert float((out - ref).abs().max()) == 0.0
    x = torch.rand(1, 300, 260, device=cuda)
    n = _build.LAUNCHES["jacobi2d_trapezoid"]
    out = jacobi2d_fused_step(x, spec, fuse=4, bc_value=bc)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["jacobi2d_trapezoid"] == n + 1
    ref = jacobi2d_fused_plain(x, spec, fuse=4, bc_value=bc)
    assert float((out - ref).abs().max()) == 0.0


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


# The Z-streaming kernel takes the unrolled tap counts up to radius 2 on
# grids whose Y is a multiple of 4: fp32 0.0 from the plain version, bf16
# within TOL.  name -> (shape, spec factory, bc).
STREAM_CASES = {
    "paper_slice": ((512, 10, 64, 64), lambda g: T.laplace_jacobi(3), 1.0),
    "deep_grid": ((1, 256, 512, 512), lambda g: T.laplace_jacobi(3), 1.0),
    "raw": ((3, 10, 64, 64), lambda g: T.laplace_jacobi(3), None),
    "hetero_bc": ((2, 10, 64, 64), lambda g: T.heterogeneous_jacobi(
        1.0 + 9.0 * _rng.random(g)), 1.0),
    "hetero_raw": ((2, 12, 40, 68), lambda g: T.heterogeneous_jacobi(
        1.0 + 9.0 * _rng.random(g)), None),
    "star_r2_13": ((2, 17, 33, 36), lambda g: T.star(3, [0.15, 0.05],
                                                      center=0.2), 1.5),
    "star_r2_13_raw": ((1, 9, 70, 132), lambda g: T.star(3, [0.15, 0.05],
                                                           center=0.2), None),
    "box_27": ((2, 11, 20, 72), lambda g: T.box(3), None),
    "box_27_bc": ((1, 37, 19, 8), lambda g: T.box(3), 1.5),
    "one_instance": ((1, 10, 64, 64), lambda g: T.laplace_jacobi(3), 1.0),
    "batch_past_65535": ((65_536 + 17, 3, 5, 8),
                         lambda g: T.laplace_jacobi(3), 1.5),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_stencil3d_stream_matches_plain(cuda, case, dtype):
    # The streaming kernel asked for by name (a small batch takes the cell
    # kernel by shape), then the kernel the shape picks.
    shape, make_spec, bc = STREAM_CASES[case]
    spec = make_spec(shape[1:])
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(shape)
                         .astype(np.float32)).to(cuda, dtype)
    ref = stencil3d_plain(x, spec, bc_value=bc)
    for kernel in ("stream", None):
        n = _build.LAUNCHES["stencil3d"]
        out = stencil3d(x, spec, bc_value=bc, kernel=kernel)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["stencil3d"] == n + len(
            _build.batch_slices(shape[0]))
        e = float((out.float() - ref.float()).abs().max())
        assert e == 0.0 if dtype == torch.float32 else e <= TOL[dtype], e


def test_stencil3d_kernel_follows_the_batch(cuda):
    # The paper batch and the deep grid stream down Z; one Fig-6 grid (a
    # step of a few microseconds either way), a Y the copies cannot take
    # and a table past the unrolled counts take the cell kernel.
    lib = _build.library("stencil3d")
    lib.stencil3d_kernel_for.restype = ctypes.c_int
    stream, cell = KERNELS["stream"], KERNELS["cell"]
    assert lib.stencil3d_kernel_for(6, 1, 50_000, 10, 64, 64) == stream
    assert lib.stencil3d_kernel_for(6, 1, 1, 256, 512, 512) == stream
    assert lib.stencil3d_kernel_for(13, 2, 32, 10, 64, 64) == stream
    assert lib.stencil3d_kernel_for(6, 1, 1, 10, 64, 64) == cell
    assert lib.stencil3d_kernel_for(6, 1, 50_000, 10, 64, 66) == cell
    assert lib.stencil3d_kernel_for(343, 3, 50_000, 10, 64, 64) == cell


def test_kernels_refuse_misaligned_operands(cuda):
    # A contiguous view 4 bytes past an aligned base: the streaming K4 and
    # K5 raise before they launch, the cell K4 takes it, and the context
    # stays usable.
    lap3 = T.laplace_jacobi(3)
    buf = torch.rand(1 + 512 * 10 * 64 * 64, device=cuda)
    x = buf[1:].view(512, 10, 64, 64)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="aligned"):
        stencil3d(x, lap3, bc_value=1.0, kernel="stream")
    with pytest.raises(ValueError, match="aligned"):
        stencil3d(x, lap3, bc_value=1.0)
    out = stencil3d(x, lap3, bc_value=1.0, kernel="cell")
    torch.cuda.synchronize()
    assert float((out - stencil3d_plain(x, lap3, bc_value=1.0))
                 .abs().max()) == 0.0
    v = buf[1:1 + 300 * 256].view(300, 256)
    w = torch.rand(256, 256, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        launch_split(v, 256)
    for dtype in (torch.float32, torch.bfloat16):
        vb = buf.to(dtype)[1:1 + 300 * 256].view(300, 256)
        with pytest.raises(ValueError, match="aligned"):
            dense_stencil_matmul(vb, w.to(dtype))
        with pytest.raises(ValueError, match="aligned"):
            dense_stencil_matmul(w[:8].to(dtype), vb[:256])
    torch.cuda.synchronize()
    assert torch.equal(dense_stencil_matmul(v.clone(), w),
                       dense_stencil_matmul(v.clone(), w))


@pytest.mark.parametrize("s,n", [(1, 64), (8, 130), (300, 257),
                                 (129, 1024)])
def test_dense_stencil_matches_plain(cuda, s, n):
    rng = np.random.default_rng(s + n)
    x = torch.from_numpy(rng.standard_normal((s, n)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
    x, w = x.to(cuda), w.to(cuda)
    k = _build.LAUNCHES["dense_stencil_matmul"]
    split = _build.LAUNCHES["split_bf16x3"]
    out = dense_stencil_matmul(x, w)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["dense_stencil_matmul"] == k + 1
    assert _build.LAUNCHES["split_bf16x3"] == split + 2   # x and w
    torch.testing.assert_close(out, dense_stencil_plain(x, w), rtol=1e-4,
                               atol=1e-4)


def _gemm_inputs(cuda, s, n, dtype):
    """x (s, n) and w (n, n) / sqrt(n), normal from a seed, as chip_smoke.py
    phase 2 makes them: out is O(1) at every n."""
    rng = np.random.default_rng(s + n)
    x = torch.from_numpy(rng.standard_normal((s, n)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((n, n)) / n ** 0.5)
                         .astype(np.float32))
    return x.to(cuda, dtype), w.to(cuda, dtype)


@pytest.mark.parametrize("s,n", GEMM_SHAPES)
def test_dense_stencil_fp32_matches_plain_per_element(cuda, s, n):
    # Per element within 1e-4 + 1e-4 * |plain| (chip_smoke.py's GEMM_TOL).
    x, w = _gemm_inputs(cuda, s, n, torch.float32)
    torch.testing.assert_close(dense_stencil_matmul(x, w),
                               dense_stencil_plain(x, w), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("s,n", GEMM_SHAPES)
def test_dense_stencil_fp32_against_fp64(cuda, s, n):
    # fp32-grade at any scale: normal x and W, unscaled.
    rng = np.random.default_rng(s * n + 1)
    x = torch.from_numpy(rng.standard_normal((s, n))).to(cuda)
    w = torch.from_numpy(rng.standard_normal((n, n))).to(cuda)
    y = dense_stencil_matmul(x.float(), w.float())
    assert norm_err(y, x, w) <= K5_NORM_ERR


@pytest.mark.parametrize("s,n", GEMM_SHAPES)
def test_dense_stencil_fp32_repeats_its_plain_arithmetic(cuda, s, n):
    # dense_stencil_split_plain sums the same six piece products: within
    # K5_NORM_ERR of the kernel on random inputs (only the order of the
    # fp32 sums inside a product differs), and equal to it where each
    # output is one exact product (perm_exact).
    x, w = _gemm_inputs(cuda, s, n, torch.float32)
    gap = (dense_stencil_matmul(x, w).double()
           - dense_stencil_split_plain(x, w).double()).abs()
    assert float((gap / (x.double().abs() @ w.double().abs())).max()) \
        <= K5_NORM_ERR
    x, w, exact = perm_exact_case(s, n, seed=n, device=cuda)
    out = dense_stencil_matmul(x, w)
    assert torch.equal(out, dense_stencil_split_plain(x, w))
    assert torch.equal(out, exact)


@pytest.mark.parametrize("s,n", GEMM_SHAPES)
def test_dense_stencil_bf16_matches_plain(cuda, s, n):
    # One bf16 product on the tensor cores: per element within 2e-2 +
    # 1e-2 * |plain| (one bf16 ulp plus the order of the fp32 sums).
    x, w = _gemm_inputs(cuda, s, n, torch.bfloat16)
    split = _build.LAUNCHES["split_bf16x3"]
    out = dense_stencil_matmul(x, w)
    again = dense_stencil_matmul(x, w)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["split_bf16x3"] == split
    assert out.dtype == torch.bfloat16 and torch.equal(out, again)
    torch.testing.assert_close(out.float(), dense_stencil_plain(x, w).float(),
                               rtol=1e-2, atol=2e-2)


@pytest.mark.parametrize("s,n", GEMM_SHAPES)
def test_split_kernel_equals_plain(cuda, s, n):
    rng = np.random.default_rng(s * n)
    v = torch.from_numpy(full_mantissa(rng, (s, n), -60, 60)).to(cuda)
    cols = padded_cols(n)
    assert torch.equal(launch_split(v, cols), split_bf16x3(v, cols))


@pytest.mark.parametrize("s,n", [(300, 257), (1000, 4096), (129, 1000)])
def test_dense_stencil_fp32_designed_cases(cuda, s, n):
    x, w, exact = perm_exact_case(s, n, seed=n, device=cuda)
    assert float((dense_stencil_matmul(x, w) - exact).abs().max()) == 0.0
    x, w, exact = w_pieces_case(s, n, seed=n, device=cuda)
    assert max_ulps(dense_stencil_matmul(x, w), exact) <= W_PIECES_ULPS


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


# --- batches past gridDim.z's 65,535 (K1-K4) ---------------------------------

BIG_BATCH = 65_536 + 17


@pytest.mark.parametrize("kernel", ["stencil2d", "trapezoid", "resident",
                                    "stencil3d"])
def test_batches_past_65535_equal_the_plain_versions(cuda, kernel):
    rng = np.random.default_rng(65_553)
    shape = (BIG_BATCH, 3, 5, 6) if kernel == "stencil3d" else (BIG_BATCH,
                                                                  9, 10)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x = x.to(cuda)
    if kernel == "stencil2d":
        key, spec = "stencil2d", T.laplace_jacobi(2)
        run = lambda: stencil2d(x, spec, bc_value=1.5)
        plain = lambda: stencil2d_plain(x, spec, bc_value=1.5)
    elif kernel == "stencil3d":
        key, spec = "stencil3d", T.laplace_jacobi(3)
        run = lambda: stencil3d(x, spec, bc_value=1.5)
        plain = lambda: stencil3d_plain(x, spec, bc_value=1.5)
    else:
        spec = T.laplace_jacobi(2)
        key = _counter(kernel, spec, 3, shape)
        run = lambda: jacobi2d_fused_step(x, spec, fuse=3, bc_value=1.5,
                                          rim=kernel)
        plain = lambda: jacobi2d_fused_plain(x, spec, fuse=3, bc_value=1.5)
    n = _build.LAUNCHES[key]
    out = run()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == n + 2   # two slices of the batch
    assert float((out - plain()).abs().max()) == 0.0


# --- K6/K7: the flash-attention forward ---------------------------------------

# (atol, rtol) per element.
FLASH_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (BF16_ATOL,
                                                          BF16_RTOL)}


def _flash_inputs(case, dtype, device):
    """(q, k, v, call keywords) of a FLASH_CASES case, or of
    ``p_rounding_case`` (bf16 only)."""
    if case == "p_rounding":
        return (*p_rounding_case(device), dict(causal=False))
    (B, Sq, Skv, H, KV, hd), causal, kv_offset = FLASH_CASES[case]
    g = torch.Generator(device=device).manual_seed(Sq + hd)
    q, k, v = (torch.randn(s, generator=g, device=device).to(dtype)
               for s in ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd)))
    return q, k, v, dict(causal=causal, kv_offset=kv_offset)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_kernels_match_plain(cuda, case, dtype):
    q, k, v, kw = _flash_inputs(case, dtype, cuda)
    B, Sq, H = q.shape[:3]
    n6, n7 = _build.LAUNCHES["flash_attention"], _build.LAUNCHES["flash_fwd"]
    out6 = flash_attention(q, k, v, **kw)
    out7, lse = flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (_build.LAUNCHES["flash_attention"], _build.LAUNCHES["flash_fwd"]
            ) == (n6 + 1, n7 + 1)
    ref, ref_lse = flash_fwd_plain(q, k, v, **kw)
    assert out6.dtype == out7.dtype == dtype and lse.shape == (B, H, Sq)
    atol, rtol = FLASH_TOL[dtype]
    for out in (out6, out7):
        torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                                   atol=atol)
    assert float((lse - ref_lse).abs().max()) <= 1e-5 * float(
        ref_lse.abs().max())


def test_flash_kernels_round_p_to_v_type(cuda):
    q, k, v, kw = _flash_inputs("p_rounding", torch.bfloat16, cuda)
    ref = flash_fwd_plain(q, k, v, **kw)[0].float()
    for out in (flash_attention(q, k, v, **kw), flash_fwd(q, k, v, **kw)[0]):
        torch.testing.assert_close(out.float(), ref, rtol=BF16_RTOL,
                                   atol=BF16_ATOL)
    assert float((ref + 0.0078).abs().max()) <= 1e-4


def test_flash_bf16_kernels_rerun_bit_equal(cuda):
    """The tensor-core kernel sums each row in a fixed order (no atomics,
    no split over kv): a rerun is bit-equal, out and lse."""
    q, k, v, kw = _flash_inputs("gqa_ragged_96", torch.bfloat16, cuda)
    first6 = flash_attention(q, k, v, **kw)
    first7, lse = flash_fwd(q, k, v, **kw)
    assert torch.equal(first6, flash_attention(q, k, v, **kw))
    again7, again_lse = flash_fwd(q, k, v, **kw)
    assert torch.equal(first7, again7) and torch.equal(lse, again_lse)


# One edit of csrc/flash_attention_sm90.cu (the bf16 kernel) each: (text,
# replacement).  p_not_rounded adds to each P . V product the part of p
# that rounding to bf16 took off (a second bf16 product), so p . v runs on
# p to about 16 bits, as a kernel that skips the rounding does.
PLANTED_FAULTS = {
    "p_not_rounded": (
        """        wgmma_rs<HD>(o, p + 4 * kk,
                     desc<HD>(sv + s * G::BYTES + kk * 16 * G::ROW, G::BLOCK));
""",
        """      {
        uint32_t lo[4];
        for (int j = 0; j < 4; ++j) {
          const int i = 4 * kk + j;
          const float2 hi = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&p[i]));
          lo[j] = pack_bf16(sc[2 * i] - hi.x, sc[2 * i + 1] - hi.y);
        }
        const uint64_t d =
            desc<HD>(sv + s * G::BYTES + kk * 16 * G::ROW, G::BLOCK);
        wgmma_rs<HD>(o, p + 4 * kk, d);
        wgmma_rs<HD>(o, lo, d);
      }
"""),
    "no_alpha_rescale": ("o[i] *= alpha[(i / 2) % 2];", "o[i] *= 1.f;"),
    "last_kv_tile_dropped": (
        "n_tiles = last < 0 ? 0 : min(n_tiles, last / BK + 1);\n  }\n",
        "n_tiles = last < 0 ? 0 : min(n_tiles, last / BK + 1);\n  }\n"
        "  n_tiles = max(n_tiles - 1, 0);\n"),
    "causal_mask_skipped_on_diagonal": (
        "(causal && kv0 + BK - 1 - kv_offset > q0 + wg * 64)", "false"),
}


@pytest.mark.parametrize("fault", list(PLANTED_FAULTS))
def test_flash_bf16_bound_rejects_planted_faults(cuda, fault, tmp_path,
                                                 monkeypatch):
    """Build the bf16 kernel with one fault planted, run it on the bf16
    cases in place of the real one, and require some case to fail the
    bound.  Prints each case's max of |out - plain| / (atol + rtol *
    |plain|)."""
    old, new = PLANTED_FAULTS[fault]
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    cu = src / "flash_attention_sm90.cu"
    text = cu.read_text()
    assert text.count(old) == 1
    cu.write_text(text.replace(old, new))
    so = tmp_path / "libflash_attention_sm90.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    monkeypatch.setitem(_build._libraries, "flash_attention_sm90", lib)
    ratios = {}
    for case in (*FLASH_CASES, "p_rounding"):
        q, k, v, kw = _flash_inputs(case, torch.bfloat16, cuda)
        out = flash_fwd(q, k, v, **kw)[0].float()
        ref = flash_fwd_plain(q, k, v, **kw)[0].float()
        ratios[case] = float(((out - ref).abs()
                              / (BF16_ATOL + BF16_RTOL * ref.abs())).max())
    print(f"planted fault {fault}: {ratios}")
    assert max(ratios.values()) > 1, ratios


def test_flash_wrappers_raise_rather_than_fall_back(cuda):
    q = torch.zeros(1, 8, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim 48"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_fwd(q.transpose(1, 2), q, q)
    # TMA needs 16-byte aligned bf16 operands: an offset view is refused.
    flat = torch.zeros(1 + 8 * 2 * 16, device=cuda, dtype=torch.bfloat16)
    q = flat[1:].view(1, 8, 2, 16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_fwd(q, q, q)


SMOKE_FLASH = dataclasses.replace(get_config("qwen3-0.6b", smoke=True),
                                  attn_impl="flash")


def test_smoke_prefill_launches_k7_once_a_layer(cuda):
    cfg = SMOKE_FLASH
    model = build(cfg, device=cuda, dtype=torch.float32)
    plain = Transformer(dataclasses.replace(cfg, attn_impl="xla"),
                        device=cuda)
    plain.load_state_dict(model.state_dict())
    tokens = torch.randint(0, cfg.vocab_size, (2, 70), device=cuda)
    _build.LAUNCHES.clear()
    h, _ = model.prefill(tokens, 80)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"flash_fwd": cfg.n_layers}
    hx, _ = plain.prefill(tokens, 80)
    assert dict(_build.LAUNCHES) == {"flash_fwd": cfg.n_layers}
    assert float((h - hx).abs().max()) <= 1e-4 * float(hx.abs().max())


def test_smoke_serve_launches_k7_in_prefill_only(cuda):
    r = serve(SMOKE_FLASH, batch=2, prompt_len=64, tokens=3, device=cuda)
    assert r["prefill_launches"] == {"flash_fwd": SMOKE_FLASH.n_layers}
    assert not r["decode_launches"] and r["generated"].shape == (2, 4)
    assert r["clock"] == "cuda events" and r["prefill_ms"] > 0
    assert r["decode_ms_per_token"] > 0 and r["peak_memory_GB"] > 0


# --- K8/K9: the flash-attention backward ---------------------------------------

# (atol, rtol) per element.
FLASH_BWD_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (BF16_ATOL,
                                                               BF16_RTOL)}


def _bwd_inputs(case, dtype, device):
    """(q, k, v, do, call keywords) of a FLASH_CASES case, or of
    ``ds_rounding_case`` or ``dv_p_rounding_case`` (bf16 only); o and lse
    come from K7."""
    if case == "ds_rounding":
        return (*ds_rounding_case(device), dict(causal=False))
    if case == "dv_p_rounding":
        return (*dv_p_rounding_case(device), dict(causal=False))
    q, k, v, kw = _flash_inputs(case, dtype, device)
    g = torch.Generator(device=device).manual_seed(q.shape[1] + 1)
    return q, k, v, torch.randn(q.shape, generator=g, device=device).to(
        dtype), kw


def _bwd_ratios(case, dtype, device):
    """max |kernel - plain| / (atol + rtol * |plain|) for dq, dk, dv; in
    bf16 on ``FLIP_CASES`` dq's and dk's atol also allow one flipped
    rounding of ds (``ds_flip_atol``)."""
    q, k, v, do, kw = _bwd_inputs(case, dtype, device)
    o, lse = flash_fwd(q, k, v, **kw)
    got = flash_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    ref = flash_bwd_plain(q, k, v, o, lse, do, **kw)
    atol, rtol = FLASH_BWD_TOL[dtype]
    flips = (0.0, 0.0)
    if dtype == torch.bfloat16 and case in FLIP_CASES:
        flips = ds_flip_atol(q, k, v, do, lse, flash_delta(o, do),
                             kw["causal"])
    for a, b, x in zip(got, ref, (q, k, v)):
        assert a.dtype == dtype and a.shape == x.shape
    return [float(((a.float() - b.float()).abs()
                   / (atol + extra + rtol * b.float().abs())).max())
            for a, b, extra in zip(got, ref, (*flips, 0.0))]


@pytest.mark.parametrize("case,dtype", [
    *((c, d) for d in (torch.float32, torch.bfloat16) for c in FLASH_CASES),
    ("ds_rounding", torch.bfloat16), ("dv_p_rounding", torch.bfloat16)])
def test_flash_backward_kernels_match_plain(cuda, case, dtype):
    n8, n9 = (_build.LAUNCHES["flash_bwd_dq"],
              _build.LAUNCHES["flash_bwd_dkv"])
    ratios = _bwd_ratios(case, dtype, cuda)
    assert (_build.LAUNCHES["flash_bwd_dq"],
            _build.LAUNCHES["flash_bwd_dkv"]) == (n8 + 1, n9 + 1)
    print(f"{case} {dtype}: dq, dk, dv error / bound {ratios}")
    assert max(ratios) <= 1, ratios


def test_flash_backward_is_deterministic(cuda):
    """K8 and K9 sum without atomics (K9 folds the GQA group in
    registers): a rerun is bit-equal, on a ragged GQA case and at the
    training shape."""
    for case in ("gqa_ragged_96", "serve_shape"):
        q, k, v, do, kw = _bwd_inputs(case, torch.bfloat16, cuda)
        o, lse = flash_fwd(q, k, v, **kw)
        first = flash_bwd(q, k, v, o, lse, do, **kw)
        for a, b in zip(first, flash_bwd(q, k, v, o, lse, do, **kw)):
            assert torch.equal(a, b), case


# One edit of csrc/flash_attention_bwd_sm90.cu (the bf16 K8/K9) each:
# (text, replacement).  ds_not_rounded_in_dq adds to each dS . K product the
# part of ds that rounding to bf16 took off (a second bf16 product), as a
# dq that skips the rounding computes it; group_reset_per_head zeroes dk and
# dv at the first q tile of each head of the group; last_q_tile_dropped
# stops K9's producer and consumers one q tile early; dv_p_lo_dropped feeds
# dv with bf16(p) alone.
PLANTED_BWD_FAULTS = {
    "ds_not_rounded_in_dq": (
        """        wgmma_rs<HD>(dq_acc, ds + 4 * kk,
                     smem_desc<KT::ROW>(sk + kk * 16 * KT::ROW, KT::BLOCK));
""",
        """      {
        uint32_t lo[4];
        for (int j = 0; j < 4; ++j) {
          const int i = 4 * kk + j;
          const float2 hi = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&ds[i]));
          lo[j] = pack_bf16(sc[2 * i] - hi.x, sc[2 * i + 1] - hi.y);
        }
        const uint64_t d =
            smem_desc<KT::ROW>(sk + kk * 16 * KT::ROW, KT::BLOCK);
        wgmma_rs<HD>(dq_acc, ds + 4 * kk, d);
        wgmma_rs<HD>(dq_acc, lo, d);
      }
"""),
    "group_reset_per_head": (
        "        mbar_wait(q_full + 8 * s, use & 1);\n",
        "        mbar_wait(q_full + 8 * s, use & 1);\n"
        "        if (iq == t0) {\n"
        "          zero(dk_acc);\n"
        "          zero(dv_acc);\n"
        "        }\n"),
    "last_q_tile_dropped": ("const int n_q = (Sq + DKV_Q - 1) / DKV_Q;",
                            "const int n_q = (Sq + DKV_Q - 1) / DKV_Q - 1;"),
    "dv_p_lo_dropped": (
        "          wgmma_rs<HD>(dv_acc, p_lo + 4 * kk, d_do);\n", ""),
}


@pytest.mark.parametrize("fault", list(PLANTED_BWD_FAULTS))
def test_flash_bwd_bf16_bound_rejects_planted_faults(cuda, fault, tmp_path,
                                                     monkeypatch):
    """Build the bf16 K8/K9 with one fault planted, run them on the bf16
    cases in place of the real ones, and require some case to fail the
    bound.  Prints each case's largest error / bound over dq, dk, dv."""
    old, new = PLANTED_BWD_FAULTS[fault]
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    cu = src / "flash_attention_bwd_sm90.cu"
    text = cu.read_text()
    assert text.count(old) == 1
    cu.write_text(text.replace(old, new))
    so = tmp_path / "libflash_attention_bwd_sm90.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    monkeypatch.setitem(_build._libraries, "flash_attention_bwd_sm90", lib)
    ratios = {case: max(_bwd_ratios(case, torch.bfloat16, cuda))
              for case in (*FLASH_CASES, "ds_rounding", "dv_p_rounding")}
    print(f"planted fault {fault}: {ratios}")
    assert max(ratios.values()) > 1, ratios


def test_flash_bwd_raises_rather_than_fall_back(cuda):
    q = torch.zeros(1, 8, 2, 48, device=cuda)
    lse = torch.zeros(1, 2, 8, device=cuda)
    with pytest.raises(ValueError, match="head_dim 48"):
        flash_bwd(q, q, q, q, lse, q)
    q = torch.zeros(1, 8, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_bwd(q, q, q, q, lse, q.transpose(1, 2).contiguous()
                  .transpose(1, 2))
    # TMA needs 16-byte aligned bf16 operands: an offset view is refused.
    flat = torch.zeros(1 + 8 * 2 * 16, device=cuda, dtype=torch.bfloat16)
    q = flat[1:].view(1, 8, 2, 16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_bwd(q, q, q, q, lse, q)


def test_smoke_train_step_launches_k7_k8_k9(cuda):
    """The fp32 loss and grads of one train step of the smoke config: K7
    twice a layer (the forward and the remat recompute), K8 and K9 once,
    and the plain-attention step's numbers."""
    cfg = dataclasses.replace(SMOKE_FLASH, remat_group=2)
    model = build(cfg, device=cuda, dtype=torch.float32)
    plain = Transformer(dataclasses.replace(cfg, attn_impl="xla"),
                        device=cuda)
    params = init_train_state(model)["params"]
    batch = token_batch(DataConfig(cfg.vocab_size, 70, 2), 0, device=cuda)
    _build.LAUNCHES.clear()
    loss, _, grads = value_and_grad(model, params, batch)
    torch.cuda.synchronize()
    n = cfg.n_layers
    assert dict(_build.LAUNCHES) == {"flash_fwd": 2 * n, "flash_bwd_dq": n,
                                     "flash_bwd_dkv": n}
    loss_x, _, grads_x = value_and_grad(plain, params, batch)
    assert dict(_build.LAUNCHES) == {"flash_fwd": 2 * n, "flash_bwd_dq": n,
                                     "flash_bwd_dkv": n}
    assert abs(float(loss) / float(loss_x) - 1) <= 1e-5
    for name, g in grads_x.items():
        assert float((grads[name] - g).abs().max()) <= 1e-4 * float(
            g.abs().max()), name


# --- the ssm and hybrid families (mamba2-370m, zamba2-1.2b) ---------------------

SSM_SMOKES = {arch: dataclasses.replace(get_config(arch, smoke=True),
                                        attn_impl="flash")
              for arch in ("mamba2-370m", "zamba2-1.2b")}


def _attn_uses(cfg):
    """Applications of an attention block in one forward."""
    return cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0


@pytest.mark.parametrize("arch", list(SSM_SMOKES))
def test_ssm_families_on_the_card_match_the_cpu(cuda, arch):
    """fp32, the same weights on both devices: the prefill hidden, every
    cache leaf and four decode steps' logits within 1e-4 of their max-abs
    (each device's run lies within 2.1e-5 of a float64 one,
    tests/_torch_ssm_noise.py --card); K7 once a use of the hybrid's
    shared block in a prefill, none in decode or for mamba2."""
    cfg = SSM_SMOKES[arch]
    model = build(cfg, device=cuda, dtype=torch.float32)
    cpu = Transformer(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    tokens = torch.randint(0, cfg.vocab_size, (2, 37), device=cuda)
    _build.LAUNCHES.clear()
    h, cache = model.prefill(tokens, 48)
    torch.cuda.synchronize()
    uses = _attn_uses(cfg)
    assert dict(_build.LAUNCHES) == ({"flash_fwd": uses} if uses else {})
    hc, cache_c = cpu.prefill(tokens.cpu(), 48)
    rel = lambda a, b: float((a.cpu() - b).abs().max() / b.abs().max())
    assert rel(h, hc) <= 1e-4
    flat = lambda c: {k: v for k, v in (
        (f"{a}.{b}", t) for a, sub in c.items()
        for b, t in (sub.items() if isinstance(sub, dict) else [("", sub)]))}
    for name, t in flat(cache_c).items():
        assert flat(cache)[name].dtype == t.dtype, name
        if t.abs().max() > 0:
            assert rel(flat(cache)[name], t) <= 1e-4, name
    tok = tokens[:, -1]
    for i in range(4):
        logits, cache = model.decode_step(tok, cache, 37 + i)
        want, cache_c = cpu.decode_step(tok.cpu(), cache_c, 37 + i)
        assert rel(logits, want) <= 1e-4, i
        tok = torch.argmax(want, -1).to(cuda)
    assert dict(_build.LAUNCHES) == ({"flash_fwd": uses} if uses else {})


@pytest.mark.parametrize("arch", list(SSM_SMOKES))
def test_ssm_families_train_step_on_the_card(cuda, arch):
    """The fp32 loss and gradients at ssm_chunk 256 over 512 tokens (where
    the reference's unmasked exponential gives NaN) against the CPU's within
    1e-3 of each gradient's max-abs, all finite (each device's gradients
    lie within 6.2e-4 of a float64 run's, sums of terms of both signs; the
    two devices read 1.2e-4 apart, tests/_torch_ssm_noise.py --card); the
    hybrid launches K7 twice a use of its shared block (forward and group
    recompute), K8 and K9 once."""
    cfg = dataclasses.replace(SSM_SMOKES[arch], ssm_chunk=256)
    model = build(cfg, device=cuda, dtype=torch.float32)
    cpu = Transformer(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    batch = token_batch(DataConfig(cfg.vocab_size, 512, 2), 0, device=cuda)
    _build.LAUNCHES.clear()
    loss, _, grads = value_and_grad(model, init_train_state(model)["params"],
                                    batch)
    torch.cuda.synchronize()
    uses = _attn_uses(cfg)
    assert dict(_build.LAUNCHES) == ({"flash_fwd": 2 * uses,
                                      "flash_bwd_dq": uses,
                                      "flash_bwd_dkv": uses} if uses else {})
    loss_c, _, grads_c = value_and_grad(
        cpu, init_train_state(cpu)["params"],
        {k: v.cpu() for k, v in batch.items()})
    assert abs(float(loss) / float(loss_c) - 1) <= 1e-5
    for name, g in grads_c.items():
        assert bool(torch.isfinite(grads[name]).all()), name
        assert float((grads[name].cpu() - g).abs().max()) <= 1e-3 * max(
            float(g.abs().max()), 1e-30), name


# --- the moe family on the card ----------------------------------------------

MOE_SMOKES = {arch: dataclasses.replace(get_config(arch, smoke=True),
                                        attn_impl="flash")
              for arch in ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b")}
# (B, Sq, Skv, H, KV, hd): GQA 8 on a ragged length, and the moe archs'
# attention at the serve and training shape (qwen3-moe GQA 8, moonshot MHA
# 16), which chip_smoke.py also holds (phases 12 and 16).
MOE_FLASH_SHAPES = {"gqa8_ragged_300": (2, 300, 300, 16, 2, 128),
                    "qwen3_moe_shape": (4, 2048, 2048, 32, 4, 128),
                    "moonshot_shape": (4, 2048, 2048, 16, 16, 128)}


@pytest.mark.parametrize("case,dtype", [
    ("gqa8_ragged_300", torch.float32), ("gqa8_ragged_300", torch.bfloat16),
    ("qwen3_moe_shape", torch.bfloat16), ("moonshot_shape", torch.bfloat16)])
def test_flash_kernels_at_the_moe_shapes_match_plain(cuda, case, dtype):
    """K7, K8 and K9 at a GQA group of 8 (K9 folds the group's eight query
    heads into each kv head's dk and dv) and at moonshot's MHA 16, against
    their plain versions within the bounds above; in bf16 dq's and dk's
    bounds also allow one flipped bf16 rounding of the largest ds term
    (``ds_flip_atol``: at a group of 8 one dk element in 4 M reads 1.5
    times the plain bound for that reason)."""
    B, Sq, Skv, H, KV, hd = MOE_FLASH_SHAPES[case]
    g = torch.Generator(device=cuda).manual_seed(Sq + H)
    q, k, v, do = (torch.randn(s, generator=g, device=cuda).to(dtype)
                   for s in ((B, Sq, H, hd), (B, Skv, KV, hd),
                             (B, Skv, KV, hd), (B, Sq, H, hd)))
    o, lse = flash_fwd(q, k, v, causal=True)
    got = flash_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    ref, ref_lse = flash_fwd_plain(q, k, v, causal=True)
    atol, rtol = FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), ref.float(), rtol=rtol, atol=atol)
    assert float((lse - ref_lse).abs().max()) <= 1e-5 * float(
        ref_lse.abs().max())
    want = flash_bwd_plain(q, k, v, o, lse, do, causal=True)
    atol, rtol = FLASH_BWD_TOL[dtype]
    flips = (ds_flip_atol(q, k, v, do, lse, flash_delta(o, do))
             if dtype == torch.bfloat16 else (0.0, 0.0))
    for name, a, b, extra in zip(("dq", "dk", "dv"), got, want,
                                 (*flips, 0.0)):
        assert a.shape == b.shape and a.dtype == dtype, name
        ratio = float(((a.float() - b.float()).abs()
                       / (atol + extra + rtol * b.float().abs())).max())
        assert ratio <= 1, (name, ratio)


def test_moe_dispatch_modes_agree_on_the_card(cuda):
    """Einsum and scatter dispatch on one layer (E 16, top 2, 2 x 512
    tokens in groups of 256, capacity factor 1.25: slots drop), fp32: the
    outputs within 1e-5 and every gradient within 1e-4 of its max-abs, each
    mode's output within 1e-5 of the CPU's, the aux loss equal across
    modes."""
    from repro_torch.models.layers import flatten
    from repro_torch.models.moe import MoE, moe_table
    D, E, F_, K = 256, 16, 128, 2
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 512, D, generator=gen, device=cuda)
    r = torch.randn(2, 512, D, generator=gen, device=cuda)
    res = {}
    for mode in ("einsum", "scatter"):
        for device in (cuda, torch.device("cpu")):
            layer = MoE(D, E, F_, 1, top_k=K, dispatch_mode=mode,
                        device=device)
            g = torch.Generator(device=cuda).manual_seed(2)
            for path, pd in flatten(moe_table(D, E, F_, 1)):
                pd.fill(layer.get_parameter(".".join(path)), g)
            xx = x.to(device).requires_grad_()
            out, aux = layer(xx, 256)
            grads = torch.autograd.grad((out * r.to(device)).sum() + aux,
                                        [*layer.parameters(), xx])
            res[(mode, device.type)] = (out.detach().cpu(), float(aux),
                                        [t.cpu() for t in grads])
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    e, s_ = res[("einsum", "cuda")], res[("scatter", "cuda")]
    assert rel(s_[0], e[0]) <= 1e-5 and s_[1] == e[1]
    for a, b in zip(s_[2], e[2]):
        assert rel(a, b) <= 1e-4
    for mode in ("einsum", "scatter"):
        assert rel(res[(mode, "cuda")][0], res[(mode, "cpu")][0]) <= 1e-5


@pytest.mark.parametrize("arch", list(MOE_SMOKES))
def test_moe_family_on_the_card_matches_the_cpu(cuda, arch):
    """fp32 smoke configs, the same weights on both devices: the prefill
    hidden, the caches and four decode steps' logits within 1e-4 of their
    max-abs; K7 once a layer in a prefill, none in decode; one train
    step's loss within 1e-5 relative and gradients within 1e-3 of their
    max-abs, K7/K8/K9 twice/once/once a layer."""
    cfg = MOE_SMOKES[arch]
    model = build(cfg, device=cuda, dtype=torch.float32)
    cpu = Transformer(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    tokens = torch.randint(0, cfg.vocab_size, (2, 27), device=cuda)
    _build.LAUNCHES.clear()
    h, cache = model.prefill(tokens, 32)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"flash_fwd": cfg.n_layers}
    hc, cache_c = cpu.prefill(tokens.cpu(), 32)
    rel = lambda a, b: float((a.cpu() - b).abs().max() / b.abs().max())
    assert rel(h, hc) <= 1e-4
    for name in ("k", "v"):
        assert rel(cache[name], cache_c[name]) <= 1e-4, name
    tok = tokens[:, -1]
    for i in range(4):
        logits, cache = model.decode_step(tok, cache, 27 + i)
        want, cache_c = cpu.decode_step(tok.cpu(), cache_c, 27 + i)
        assert rel(logits, want) <= 1e-4, i
        tok = torch.argmax(want, -1).to(cuda)
    assert dict(_build.LAUNCHES) == {"flash_fwd": cfg.n_layers}
    batch = token_batch(DataConfig(cfg.vocab_size, 32, 2), 0, device=cuda)
    _build.LAUNCHES.clear()
    loss, parts, grads = value_and_grad(
        model, init_train_state(model)["params"], batch)
    torch.cuda.synchronize()
    n = cfg.n_layers
    assert dict(_build.LAUNCHES) == {"flash_fwd": 2 * n, "flash_bwd_dq": n,
                                     "flash_bwd_dkv": n}
    loss_c, parts_c, grads_c = value_and_grad(
        cpu, init_train_state(cpu)["params"],
        {k: v.cpu() for k, v in batch.items()})
    assert abs(float(loss) / float(loss_c) - 1) <= 1e-5
    assert abs(float(parts["aux"]) / float(parts_c["aux"]) - 1) <= 1e-5
    for name, g in grads_c.items():
        assert bool(torch.isfinite(grads[name]).all()), name
        assert float((grads[name].cpu() - g).abs().max()) <= 1e-3 * max(
            float(g.abs().max()), 1e-30), name


# --- the vlm and encdec families (qwen2-vl-2b, whisper-tiny) -------------------

VLM_ENCDEC_SMOKES = {arch: dataclasses.replace(get_config(arch, smoke=True),
                                               attn_impl="flash")
                     for arch in ("qwen2-vl-2b", "whisper-tiny")}


def _family_inputs(cfg, batch, seq, device):
    return family_inputs(cfg, batch, seq, 9, device, torch.float32, width=4)


def _flash_uses(cfg):
    """K7 launches in one forward: a layer each, and encdec's encoder
    layers plus two a decoder layer (self and cross)."""
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


@pytest.mark.parametrize("arch", list(VLM_ENCDEC_SMOKES))
def test_vlm_encdec_families_on_the_card_match_the_cpu(cuda, arch):
    """fp32 smoke configs, the same weights and inputs on both devices: the
    prefill hidden, every cache leaf and four decode steps' logits within
    1e-4 (qwen2-vl) and 5e-4 (whisper, whose smoke model's fp32 runs lie
    up to 2.2e-4 from a float64 one, tests/test_torch_encdec.py) of their
    max-abs; K7 as ``_flash_uses`` in a prefill, none in decode; one train
    step's loss within 1e-5 relative and gradients within 2e-3 of their
    max-abs (whisper's fp32 gradients lie up to 8e-4 from float64's),
    K7/K8/K9 twice/once/once a use."""
    cfg = VLM_ENCDEC_SMOKES[arch]
    rtol = 5e-4 if cfg.family == "encdec" else 1e-4
    model = build(cfg, device=cuda, dtype=torch.float32)
    cpu = type(model)(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    S = 27
    tokens = torch.randint(0, cfg.vocab_size, (2, S), device=cuda)
    inputs = _family_inputs(cfg, 2, S, cuda)
    cpu_inputs = {k: v.cpu() for k, v in inputs.items()}
    _build.LAUNCHES.clear()
    h, cache = model.prefill(tokens, 32, **inputs)
    torch.cuda.synchronize()
    uses = _flash_uses(cfg)
    assert dict(_build.LAUNCHES) == {"flash_fwd": uses}
    hc, cache_c = cpu.prefill(tokens.cpu(), 32, **cpu_inputs)
    rel = lambda a, b: float((a.cpu() - b).abs().max() / b.abs().max())
    assert rel(h, hc) <= rtol
    flat = lambda c: {k: v for k, v in (
        (f"{a}.{b}", t) for a, sub in c.items()
        for b, t in (sub.items() if isinstance(sub, dict) else [("", sub)]))}
    for name, t in flat(cache_c).items():
        assert rel(flat(cache)[name], t) <= rtol, name
    tok = tokens[:, -1]
    for i in range(4):
        logits, cache = model.decode_step(tok, cache, S + i)
        want, cache_c = cpu.decode_step(tok.cpu(), cache_c, S + i)
        assert rel(logits, want) <= rtol, i
        tok = torch.argmax(want, -1).to(cuda)
    assert dict(_build.LAUNCHES) == {"flash_fwd": uses}
    batch = {**token_batch(DataConfig(cfg.vocab_size, 32, 2), 0,
                           device=cuda), **_family_inputs(cfg, 2, 32, cuda)}
    _build.LAUNCHES.clear()
    loss, _, grads = value_and_grad(model, init_train_state(model)["params"],
                                    batch)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"flash_fwd": 2 * uses,
                                     "flash_bwd_dq": uses,
                                     "flash_bwd_dkv": uses}
    loss_c, _, grads_c = value_and_grad(
        cpu, init_train_state(cpu)["params"],
        {k: v.cpu() for k, v in batch.items()})
    assert abs(float(loss) / float(loss_c) - 1) <= 1e-5
    for name, g in grads_c.items():
        assert bool(torch.isfinite(grads[name]).all()), name
        assert float((grads[name].cpu() - g).abs().max()) <= 2e-3 * max(
            float(g.abs().max()), 1e-30), name


# --- the dense family's last archs, and a restart -----------------------------

DENSE_SMOKES = {arch: dataclasses.replace(get_config(arch, smoke=True),
                                          attn_impl="flash")
                for arch in ("nemotron-4-15b", "glm4-9b", "phi3-medium-14b")}


@pytest.mark.parametrize("arch", list(DENSE_SMOKES))
def test_dense_archs_on_the_card_match_the_cpu(cuda, arch):
    """fp32 smoke configs (nemotron's squared-ReLU ungated MLP, glm4's GQA
    2:1, phi3's 5 heads on 5), the same weights on both devices: the
    prefill hidden, the caches and four decode steps' logits within 1e-4
    of their max-abs; K7 once a layer in a prefill, none in decode; one
    train step's loss within 1e-5 relative and gradients within 1e-3 of
    their max-abs, K7/K8/K9 twice/once/once a layer."""
    cfg = DENSE_SMOKES[arch]
    model = build(cfg, device=cuda, dtype=torch.float32)
    cpu = Transformer(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    tokens = torch.randint(0, cfg.vocab_size, (2, 27), device=cuda)
    rel = lambda a, b: float((a.cpu() - b).abs().max() / b.abs().max())
    _build.LAUNCHES.clear()
    h, cache = model.prefill(tokens, 32)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"flash_fwd": cfg.n_layers}
    hc, cache_c = cpu.prefill(tokens.cpu(), 32)
    assert rel(h, hc) <= 1e-4
    for name in ("k", "v"):
        assert rel(cache[name], cache_c[name]) <= 1e-4, name
    tok = tokens[:, -1]
    for i in range(4):
        logits, cache = model.decode_step(tok, cache, 27 + i)
        want, cache_c = cpu.decode_step(tok.cpu(), cache_c, 27 + i)
        assert rel(logits, want) <= 1e-4, i
        tok = torch.argmax(want, -1).to(cuda)
    assert dict(_build.LAUNCHES) == {"flash_fwd": cfg.n_layers}
    batch = token_batch(DataConfig(cfg.vocab_size, 32, 2), 0, device=cuda)
    _build.LAUNCHES.clear()
    loss, _, grads = value_and_grad(model, init_train_state(model)["params"],
                                    batch)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"flash_fwd": 2 * cfg.n_layers,
                                     "flash_bwd_dq": cfg.n_layers,
                                     "flash_bwd_dkv": cfg.n_layers}
    loss_c, _, grads_c = value_and_grad(
        cpu, init_train_state(cpu)["params"],
        {k: v.cpu() for k, v in batch.items()})
    assert abs(float(loss) / float(loss_c) - 1) <= 1e-5
    for name, g in grads_c.items():
        assert float((grads[name].cpu() - g).abs().max()) <= 1e-3 * max(
            float(g.abs().max()), 1e-30), name


def test_train_restart_is_bit_equal_on_the_card(cuda, tmp_path):
    """qwen3-0.6b at full width cut to 2 layers, bf16 train steps of 2 x 256
    tokens through ``launch.train.train``: a run checkpointed after step 1
    and killed before step 2, then restarted, ends on the uninterrupted
    run's loss and on every array of its last checkpoint (params, m, v,
    step), bit for bit; the restarted step launches K7/K8/K9 4/2/2 times."""
    from repro_torch.launch.train import train
    from repro_torch.runtime import InjectedFailure
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), attn_impl="flash",
                              n_layers=2)
    kw = dict(steps=2, global_batch=2, seq_len=256, device=cuda,
              checkpoint_every=1)
    with pytest.raises(InjectedFailure, match="step 1"):
        train(cfg, checkpoint_dir=str(tmp_path / "a"), fail_at_step=1, **kw)
    restarted = train(cfg, checkpoint_dir=str(tmp_path / "a"), **kw)
    whole = train(cfg, checkpoint_dir=str(tmp_path / "b"), **kw)
    assert restarted["start_step"] == 1 and len(restarted["steps"]) == 1
    assert restarted["steps"][0]["launches"] == {
        "flash_fwd": 4, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    assert [e["op"] for e in restarted["checkpoints"]] == ["restore", "save"]
    assert restarted["steps"][0]["loss"] == whole["steps"][-1]["loss"]
    with np.load(tmp_path / "a" / "ckpt_00000002.npz") as a, \
            np.load(tmp_path / "b" / "ckpt_00000002.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert np.array_equal(a[key], b[key]), key


# --- the serving tier on the card: autotuner, multigrid, cache, engine ------

def test_autotuner_measures_every_candidate(cuda):
    import warnings
    from repro_torch.core import autotune
    for spec, grid, iters in ((T.laplace_jacobi(2), (64, 64), 32),
                              (T.laplace_jacobi(3), (10, 64, 64), 8)):
        cands = autotune.schedule_candidates(spec, grid, iters, bc=1.0,
                                             device=cuda)
        with warnings.catch_warnings():
            warnings.simplefilter("error")   # a failed candidate warns
            table = autotune.autotune_cell(spec, grid, iters=iters, bc=1.0,
                                           repeats=1, device=cuda)
        assert len(table) == len(cands) >= 3
        assert not any(e.interpreted for e in table.entries)
        kind = torch.cuda.get_device_name(cuda)
        assert {e.device_kind for e in table.entries} == {kind}
        best = table.lookup(kind, autotune.spec_family(spec), grid,
                            "float32")
        assert best.us_per_iter == min(e.us_per_iter for e in table.entries)
        plan = T.make_plan(spec, grid, bc=1.0, iters=iters, device=cuda,
                           tuned=table)
        assert plan.source == "tuned" and plan.backend == best.backend


def test_multigrid_on_the_card_takes_the_cpu_cycles(cuda):
    kappa = 1.0 + 9.0 * np.random.default_rng(0).random((65, 65)) \
        .astype(np.float32)
    for spec, grid, cycles in ((T.laplace_jacobi(2), (64, 64), 13),
                               (T.heterogeneous_jacobi(kappa), (65, 65), 5)):
        runs = {b: T.multigrid_solve(spec, np.zeros(grid, np.float32),
                                     bc=1.0, rtol=1e-5, backend=b,
                                     transfer_backend=t)
                for b, t in (("cuda", "cuda"), ("reference", "reference"))}
        for r in runs.values():
            assert r.converged and r.cycles == cycles
            assert r.x.device.type == "cuda"
        torch.testing.assert_close(runs["cuda"].x, runs["reference"].x,
                                   rtol=0, atol=1e-6)


def test_plan_cache_probe_drops_none_and_buckets_exactly(cuda):
    cache = T.PlanCache(probe=True)
    kw = dict(bc=1.0, rtol=1e-5, check_every=16, max_iters=20_000)
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal((4, 60, 60)).astype(np.float32)
    src = (rng.standard_normal((4, 60, 60)) * 1e-3).astype(np.float32)
    cached = cache.solver(T.laplace_jacobi(2), (60, 60), **kw)
    assert cached.padded and cached.bucket == (64, 64)
    assert cache.stats.probe_dropped == 0 and cache.stats.rebuilds == 0
    got = cached.solve(x0, source=src)
    want = T.Solver(T.laplace_jacobi(2), (60, 60), backend=cached.backend,
                    device=cuda, **kw).solve(x0, source=src)
    np.testing.assert_array_equal(got.iterations, want.iterations)
    torch.testing.assert_close(got.x, want.x, rtol=0, atol=1e-6)


def test_engine_on_the_card_serves_what_a_solo_solve_gives(cuda):
    import asyncio
    from repro_torch.serve import ServingEngine
    cache = T.PlanCache()
    rng = np.random.default_rng(5)
    reqs = [(rng.standard_normal((g, g)).astype(np.float32),
             (rng.standard_normal((g, g)) * 1e-3).astype(np.float32), b)
            for g in (64, 48) for b in (1.0, 0.5) for _ in range(3)]
    kw = dict(rtol=1e-5)

    async def main():
        async with ServingEngine(cache, max_batch=16, max_wait=0.05) as eng:
            return eng, await asyncio.gather(*(
                eng.submit(T.laplace_jacobi(2), x0, bc=b, source=s, **kw)
                for x0, s, b in reqs))

    eng, results = asyncio.run(main())
    assert eng.stats.coalesced > 0 and cache.stats.rebuilds == 0
    assert cache.stats.misses == 1 and cache.stats.probe_dropped == 0
    for (x0, s, b), r in zip(reqs, results):
        alone = T.Solver(T.laplace_jacobi(2), x0.shape, backend=r.backend,
                         bc=b, device=cuda, **kw).solve(x0, source=s)
        assert r.x.device.type == "cuda" and r.converged
        assert r.iterations == alone.iterations
        torch.testing.assert_close(r.x, alone.x, rtol=0, atol=1e-6)


# --- the differentiable solve and tensor requests on the card --------------

def _adjoint_grads(device, spec, fields, src, tgt):
    """Grads of sum((x - tgt)^2) in (fields, source, scalar bc) of a
    converged conv solve on a default cache on ``device``."""
    old = T.set_default_plan_cache(T.PlanCache(device=device))
    try:
        ops = [torch.as_tensor(a, device=device).requires_grad_(True)
               for a in (fields, src, np.float32(0.7))]
        x0 = torch.zeros(src.shape, device=device, requires_grad=True)
        x = T.implicit_solve(spec, x0, fields=ops[0], source=ops[1],
                             bc_value=ops[2], backend="conv", rtol=1e-6,
                             max_iters=20_000)
        loss = torch.sum((x - torch.as_tensor(tgt, device=device)) ** 2)
        grads = torch.autograd.grad(loss, ops + [x0])
    finally:
        T.set_default_plan_cache(old)
    return [g.cpu() for g in grads]


def test_adjoint_gradients_on_the_card_equal_the_cpu_port(cuda):
    rng = np.random.default_rng(23)
    spec = T.heterogeneous_jacobi(1.0 + 9.0 * rng.random((32, 32)))
    fields = spec.field_stack()
    src = rng.standard_normal((32, 32)).astype(np.float32)
    tgt = rng.standard_normal((32, 32)).astype(np.float32)
    card = _adjoint_grads(cuda, spec, fields, src, tgt)
    host = _adjoint_grads("cpu", spec, fields, src, tgt)
    for g, h in zip(card[:3], host[:3]):
        assert g.shape == h.shape and torch.isfinite(g).all()
        assert float((g - h).abs().max()) <= 1e-4 * float(h.abs().max())
    assert torch.equal(card[3], torch.zeros_like(card[3]))


def test_adjoint_on_the_card_refuses_host_tensors(cuda):
    old = T.set_default_plan_cache(T.PlanCache())
    try:
        with pytest.raises(ValueError, match="plan cache runs on cuda"):
            T.implicit_solve(T.laplace_jacobi(2), torch.zeros(16, 16))
    finally:
        T.set_default_plan_cache(old)


def test_engine_serves_cuda_tensor_requests_as_solo_solves(cuda):
    import asyncio
    from repro_torch.serve import ServingEngine
    cache = T.PlanCache()
    rng = np.random.default_rng(29)
    xs = [torch.as_tensor(rng.standard_normal((48, 48)), device=cuda,
                          dtype=dt) for dt in (torch.float32, torch.bfloat16,
                                               torch.float32)]
    src = torch.full((48, 48), 1e-3, device=cuda)
    kw = dict(rtol=1e-5)

    async def main():
        async with ServingEngine(cache, max_wait=0.05) as eng:
            return eng, await asyncio.gather(*(
                eng.submit(T.laplace_jacobi(2), x0, bc=1.0, source=src,
                           **kw)
                for x0 in xs))

    eng, results = asyncio.run(main())
    assert eng.stats.coalesced == 3 and eng.stats.batches == 1
    for x0, r in zip(xs, results):
        alone = T.Solver(T.laplace_jacobi(2), (48, 48), backend=r.backend,
                         bc=1.0, device=cuda, **kw).solve(x0, source=src)
        assert r.x.device.type == "cuda" and r.converged
        assert r.iterations == alone.iterations
        torch.testing.assert_close(r.x, alone.x, rtol=0, atol=1e-6)


def test_conv_var_jacobi_reuses_its_kernels_on_the_card(cuda):
    from repro_torch.core import conv_encoding
    spec = T.heterogeneous_jacobi(
        1.0 + 9.0 * np.random.default_rng(31).random((64, 64)))
    x0 = torch.zeros(2, 64, 64, device=cuda)
    a = T.conv_var_jacobi(x0, spec, T.DirichletBC(1.0), 50)
    hits = conv_encoding._var_kernels.cache_info().hits
    b = T.conv_var_jacobi(x0, spec, T.DirichletBC(1.0), 50)
    assert conv_encoding._var_kernels.cache_info().hits == hits + 1
    assert torch.equal(a, b)
    want = T.conv_var_jacobi(x0.cpu(), spec, T.DirichletBC(1.0), 50)
    torch.testing.assert_close(a.cpu(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fuse", [1, 4])
def test_halo_runner_on_the_card_equals_reference(cuda, fuse):
    # a 2x4 tile mesh with every tile on cuda:0; the halo path is plain
    # PyTorch (fp32 sums in tap order), so it equals the reference backend
    # bit for bit, per-cell taps included
    from repro_torch.core.distributed import make_halo_runner
    from repro_torch.parallel import make_mesh
    mesh = make_mesh((2, 4), devices=[cuda] * 8)
    grid = (64, 128)
    x = torch.tensor(_rng.standard_normal((2, *grid)), dtype=torch.float32,
                     device=cuda)
    for spec in (T.laplace_jacobi(2), T.box(2),
                 T.heterogeneous_jacobi(1.0 + 9.0 * _rng.random(grid))):
        run = make_halo_runner(mesh, spec, H=grid[0], W=grid[1],
                               bc_value=1.5, iterations=8, fuse=fuse)
        ref = T.stencil_apply(spec, x, backend="reference", bc=1.5, iters=8,
                              device=cuda)
        out = run(x)
        assert out.device == x.device
        assert torch.equal(out, ref), (spec.name, fuse)
    kw = dict(bc=1.0, rtol=1e-4, check_every=20, max_iters=20_000,
              device=cuda)
    r = T.solve(T.laplace_jacobi(2), torch.zeros(32, 32), backend="halo",
                mesh=make_mesh((2, 2)), fuse=fuse, **kw)
    s = T.solve(T.laplace_jacobi(2), torch.zeros(32, 32),
                backend="reference", **kw)
    assert r.converged and r.iterations == s.iterations
    assert torch.equal(r.x, s.x)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "phi3-medium-14b"])
def test_sharded_dense_on_the_card_equals_unsharded(cuda, arch):
    # a 2x4 ("data", "model") mesh with every shard on cuda:0, fp32 smoke
    # config through the flash kernels: qwen3's tp shards hand K7-K9 one q
    # head and its kv head, phi3's sp shards their sequence offset
    import dataclasses
    import functools
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build
    from repro_torch.parallel import make_mesh
    from repro_torch.parallel.sharding import Sharder
    from repro_torch.train.serve_step import greedy_generate
    from repro_torch.train.train_step import (init_train_state, loss_fn,
                                              value_and_grad)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              attn_impl="flash")
    model = build(cfg, device=cuda, dtype=torch.float32)
    sh = Sharder(make_mesh((2, 4)), cfg.sharding_profile)
    assert {d.type for d in sh.mesh.devices} == {"cuda"}
    tokens = torch.tensor(_rng.integers(0, cfg.vocab_size, (4, 16)),
                          device=cuda)
    batch = {"tokens": tokens, "labels": tokens.roll(1, 1)}
    params = init_train_state(model)["params"]
    before = dict(_build.LAUNCHES)
    l1, _, g1 = value_and_grad(model, params, batch)
    l2, _, g2 = value_and_grad(model, params, batch,
                               functools.partial(loss_fn, sharder=sh))
    launched = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()}
    assert launched["flash_fwd"] == 2 * 2 * (1 + 8)   # remat: 2 a layer
    assert launched["flash_bwd_dq"] == launched["flash_bwd_dkv"] == 2 * 9
    assert abs(float(l2) / float(l1) - 1) <= 1e-5
    for n, g in g1.items():
        assert (g2[n] - g).abs().max() <= 1e-4 * max(float(g.abs().max()),
                                                     1e-3), n
    want = greedy_generate(model, {"tokens": tokens}, steps=3, max_len=20)
    got = greedy_generate(model, {"tokens": tokens}, steps=3, max_len=20,
                          sharder=sh)
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b",
                                  "mamba2-370m", "zamba2-1.2b",
                                  "qwen2-vl-2b", "whisper-tiny"])
def test_sharded_families_on_the_card_equal_unsharded(cuda, arch):
    # every other family's shard program on a 2x4 ("data", "model") mesh
    # with every shard on cuda:0, fp32 smoke config through the flash
    # kernels: the loss and grads, and the greedy tokens, as unsharded
    # (whisper-tiny's smoke model at 1 + 1 layers: chaotic past one, its
    # sp grads part by 1.2e-4 of a leaf's max-abs at 2 + 2)
    import dataclasses
    import functools
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import stub_inputs
    from repro_torch.models.model_zoo import build
    from repro_torch.parallel import make_mesh
    from repro_torch.parallel.sharding import Sharder
    from repro_torch.train.serve_step import greedy_generate
    from repro_torch.train.train_step import (init_train_state, loss_fn,
                                              value_and_grad)
    depth = ({"n_layers": 1, "n_enc_layers": 1} if arch == "whisper-tiny"
             else {})
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              attn_impl="flash", **depth)
    model = build(cfg, device=cuda, dtype=torch.float32)
    sh = Sharder(make_mesh((2, 4)), cfg.sharding_profile)
    tokens = torch.tensor(_rng.integers(0, cfg.vocab_size, (4, 16)),
                          device=cuda)
    extra = {k: torch.randn(v.shape, device=cuda)
             for k, v in stub_inputs(cfg, 4, 16, dtype=torch.float32,
                                     device=cuda).items()}
    batch = {"tokens": tokens, "labels": tokens.roll(1, 1), **extra}
    params = init_train_state(model)["params"]
    l1, _, g1 = value_and_grad(model, params, batch)
    l2, _, g2 = value_and_grad(model, params, batch,
                               functools.partial(loss_fn, sharder=sh))
    assert abs(float(l2) / float(l1) - 1) <= 1e-5
    for n, g in g1.items():
        assert (g2[n] - g).abs().max() <= 1e-4 * max(float(g.abs().max()),
                                                     1e-3), n
    serve = {"tokens": tokens, **extra}
    want = greedy_generate(model, serve, steps=3, max_len=20)
    got = greedy_generate(model, serve, steps=3, max_len=20, sharder=sh)
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ("qwen3-0.6b", "mamba2-370m",
                                  "zamba2-1.2b"))
def test_cost_counter_on_the_card_equals_meta(cuda, arch):
    # launch/hlo_cost.py: a smoke train step and a state_over_data
    # decode on a 2x4 mesh, every shard on cuda:0, count the same flops,
    # hbm bytes and collectives as on meta (the dry run's device, under
    # its native meta kernels); the kernels charge their analytic work on
    # both, and launch on the card only
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import native_meta_kernels
    from repro_torch.launch.hlo_cost import analyze
    from repro_torch.models.model_zoo import build
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import make_mesh
    from repro_torch.parallel.sharding import Sharder
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              attn_impl="flash")
    results, launched = [], {}
    for dev in (cuda, torch.device("meta")):
        model = build(cfg, device=dev, dtype=torch.float32)
        mesh = make_mesh((2, 4), devices=[dev] * 8)
        step = make_train_step(model, AdamWConfig(),
                               sharder=Sharder(mesh, cfg.sharding_profile))
        tokens = torch.randint(0, cfg.vocab_size, (4, 32), device=dev) \
            if dev.type == "cuda" else torch.empty(4, 32, dtype=torch.long,
                                                   device=dev)
        batch = {"tokens": tokens, "labels": tokens}
        state = init_train_state(model)
        sod = Sharder(mesh, cfg.sharding_profile, state_over_data=True)
        prompt = tokens[:1, :12]

        def serve():
            _, cache = model.prefill(prompt, 16, sharder=sod)
            model.decode_step(prompt[:, 0], cache, 12, sharder=sod)

        _build.LAUNCHES.clear()
        with (native_meta_kernels() if dev.type == "meta"
              else contextlib.nullcontext()):
            r = (analyze(step, state, batch), analyze(serve))
        launched[dev.type] = dict(_build.LAUNCHES)
        results.append([{k: x[k] for k in ("flops", "hbm_bytes",
                                           "collectives")} for x in r])
    assert results[0] == results[1]
    assert results[0][0]["flops"] > 0
    assert launched["meta"] == {}
    if cfg.family != "ssm":
        assert launched["cuda"]["flash_fwd"] > 0


def test_a_cuda_tensor_never_takes_the_meta_branch(cuda, monkeypatch):
    # the kernels' meta branch returns empty outputs: a cuda tensor must
    # launch the kernel instead (the launch count moves, the output is
    # the plain version's within the bf16 bound)
    from repro_torch.kernels import flash_attention_bwd as fab
    q, k, v, do = (torch.randn(s, device=cuda).to(torch.bfloat16)
                   for s in ((1, 64, 2, 16), (1, 64, 2, 16),
                             (1, 64, 2, 16), (1, 64, 2, 16)))
    _build.LAUNCHES.clear()
    out = flash_attention(q, k, v)
    o, lse = flash_fwd(q, k, v)
    dq, dk, dv = flash_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"flash_attention": 1, "flash_fwd": 1,
                                     "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    plain, plain_lse = flash_fwd_plain(q, k, v)
    assert (out.float() - plain.float()).abs().max() <= 2e-2
    assert (lse - plain_lse).abs().max() <= 1e-5 * plain_lse.abs().max()
    want = flash_bwd_plain(q, k, v, o, lse, do)
    for got, ref in zip((dq, dk, dv), want):
        assert (got.float() - ref.float()).abs().max() <= 2e-2
