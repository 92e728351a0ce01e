"""The port's kernels K1 (``stencil2d``), K2/K3 (``jacobi2d_fused_step``,
trapezoid and resident), K4 (``stencil3d``) and K5
(``dense_stencil_matmul``) against the JAX package's Pallas kernels, run
interpreted on the CPU as the JAX tests run them.

On a CPU tensor each wrapper runs its plain PyTorch version, so these hold
the plain versions against the TPU kernels.  test_torch_cuda.py holds the
CUDA kernels against the plain versions on the card.

Tolerances: fp32 1e-6 absolute (same arithmetic, same tap order — the
results are expected bit-equal); bf16 2e-2 absolute (one bf16 ulp at the
magnitudes of these inputs, for a rounding that lands differently).  K5's
are the JAX package's own (tests/test_kernels.py): its blocked sums run in
another order than one matrix product, 1e-4 in fp32, and 3e-2 relative
plus 3e-1 absolute in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.kernels as JK
import repro_torch.core as T
from repro_torch.kernels import (_build, dense_jacobi_kernel,
                                 dense_stencil_matmul, jacobi2d,
                                 jacobi2d_fused_step, jacobi3d, stencil2d,
                                 stencil3d)

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
    # A resident grid past the JAX package's 8 MiB (padded to (8, 128)).
    with pytest.raises(ValueError, match="resident"):
        jacobi2d_fused_step(torch.zeros(1, 1032, 2048), lap, fuse=2,
                            rim="resident")
    # A trapezoid deeper than one CTA's shared memory runs (in passes), and
    # a table past the kernels' 25 parameter taps too: both as JAX.
    jx = jnp.asarray(X)
    _close(JK.jacobi2d_fused_step(jx, J.laplace_jacobi(2), fuse=60),
           jacobi2d_fused_step(x, lap, fuse=60), "f32")
    jwide = J.StencilSpec({(i, j): 0.01 for i in range(-2, 3)
                           for j in range(-3, 3)})
    _close(JK.stencil2d(jx, jwide), stencil2d(x, to_torch_spec(jwide)),
           "f32")
    with pytest.raises(ValueError, match="past one CTA"):
        jacobi2d_fused_step(x, T.StencilSpec({(60, 0): 1.0}), fuse=1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        stencil2d(x.double(), lap)
    with pytest.raises(ValueError, match="fields must be shaped"):
        stencil2d(x, to_torch_spec(CASES["fields_bc"][0]),
                  fields=torch.zeros(4, 3, 3))
    box5 = T.StencilSpec({(i, j): 0.04 for i in range(-2, 3)
                          for j in range(-2, 3)})
    assert stencil2d(x, box5).shape == x.shape  # 25 taps fit


def test_deep_trapezoids_run_in_passes_that_fit():
    from repro_torch.kernels.jacobi_fused import (tile_smem_bytes,
                                                  trapezoid_passes,
                                                  trapezoid_smem_bytes)
    from repro_torch.kernels.tiling import MAX_SMEM_BYTES, STATIC_SMEM_BYTES
    # The stream kernel (K2): fuse levels of 4r + 2 rows of 256 fp32 each.
    assert trapezoid_passes(37, 1) == [37] and trapezoid_passes(38, 1) == [
        19, 19]
    assert trapezoid_passes(64, 1) == [32, 32]
    assert trapezoid_passes(64, 2) == [22, 21, 21]
    assert trapezoid_passes(22, 2) == [22]
    # The tile kernel, by name: a 64x64 tile with its fuse*r-deep halo.
    assert trapezoid_passes(53, 1, "tile") == [53]
    assert trapezoid_passes(54, 1, "tile") == [27, 27]
    assert trapezoid_passes(26, 2, "tile") == [26]
    for kernel, smem in (("stream", trapezoid_smem_bytes),
                         ("tile", tile_smem_bytes)):
        for fuse in (1, 8, 37, 38, 53, 54, 64, 200):
            for r in (1, 2, 3):
                passes = trapezoid_passes(fuse, r, kernel)
                assert sum(passes) == fuse and max(passes) - min(passes) <= 1
                assert (smem(max(passes), r) + STATIC_SMEM_BYTES
                        <= MAX_SMEM_BYTES)
                if len(passes) > 1:   # one pass fewer would not fit
                    deeper = -(-fuse // (len(passes) - 1))
                    assert (smem(deeper, r) + STATIC_SMEM_BYTES
                            > MAX_SMEM_BYTES)


def test_kernels_follow_the_shape():
    # The dispatch by shape (no card needed: it is arithmetic on shapes).
    from repro_torch.kernels.jacobi_fused import kernel_for, trapezoid_passes
    lap, box = T.laplace_jacobi(2), T.box(2)
    star2 = T.star(2, [0.15, 0.05], center=0.2)
    # Table 1 (one 64x64 grid, fuse 4, or a batch of them): the register
    # kernel, in either geometry; the box too; up to its largest patches.
    for batch in (1, 1024):
        for rim in ("trapezoid", "resident"):
            assert kernel_for(rim, lap, 4, batch, 64, 64) == "resident_regs"
            assert kernel_for(rim, box, 4, batch, 64, 64) == "resident_regs"
    for grid in ((33, 57), (128, 128), (256, 64), (16, 1024)):
        assert kernel_for("resident", lap, 8, 1, *grid) == "resident_regs"
    # Past the register kernel's patch or masks, one CTA: the cta kernel.
    assert kernel_for("resident", lap, 8, 1, 160, 160) == "resident_cta"
    assert kernel_for("resident", star2, 8, 1, 64, 64) == "resident_cta"
    # Past one CTA: the grid-wide resident kernel.
    for grid in ((169, 169), (512, 512), (1024, 2048)):
        assert kernel_for("resident", lap, 8, 1, *grid) == "resident_grid"
    # A one-CTA grid wider than the cta kernel's 512 columns.
    assert kernel_for("resident", lap, 8, 1, 20, 1000) == "resident_grid"
    # Trapezoids past the register kernel: the stream kernel on large
    # launches at fuse 1-3 ...
    assert kernel_for("trapezoid", lap, 1, 1, 8192, 8192) == "stream"
    assert kernel_for("trapezoid", lap, 1, 1, 4096, 4096) == "stream"
    assert kernel_for("trapezoid", lap, 1, 1, 2048, 2048) == "tile"
    assert kernel_for("trapezoid", lap, 2, 4, 1024, 1024) == "stream"
    assert kernel_for("trapezoid", lap, 3, 1, 1024, 1024) == "tile"
    # ... at fuse 4-8 on any grid ...
    assert kernel_for("trapezoid", star2, 4, 1, 64, 64) == "stream"
    assert kernel_for("trapezoid", lap, 4, 1, 40, 700) == "stream"
    assert kernel_for("trapezoid", lap, 8, 3, 129, 260) == "stream"
    # ... and deeper on grids of 8 fills' rows (a pass's T (2r + 1)).
    assert kernel_for("trapezoid", lap, 16, 1, 8192, 8192) == "stream"
    assert kernel_for("trapezoid", lap, 16, 1, 1024, 1024) == "stream"
    assert kernel_for("trapezoid", lap, 16, 1, 300, 517) == "tile"
    assert kernel_for("trapezoid", lap, 4, 3, 129, 260) == "stream"
    assert kernel_for("trapezoid", lap, 64, 1, 1024, 1024) == "stream"
    # Radius 54-56: only the stream kernel fits (the tile stops at 53);
    # past 56 no kernel does, and the trapezoid's passes raise.
    far = T.StencilSpec({(0, -56): 0.5, (0, 56): 0.5})
    assert kernel_for("trapezoid", far, 1, 1, 512, 512) == "stream"
    assert trapezoid_passes(1, 56) == [1]
    with pytest.raises(ValueError, match="past one CTA"):
        trapezoid_passes(1, 57)
    with pytest.raises(ValueError, match="past one CTA"):
        trapezoid_passes(1, 54, "tile")


@pytest.mark.parametrize("H,W", [(1, 1), (9, 10), (33, 57), (64, 64),
                                 (168, 168), (160, 160), (20, 1000),
                                 (2048, 8), (2800, 8), (50, 512)])
def test_register_patch_covers_the_grid(H, W):
    # The register kernel's patch: KC rows of two columns a thread, the
    # first KC of REGS_ROWS within its threads; none past them.
    from repro_torch.kernels.jacobi_fused import (REGS_MAX_THREADS,
                                                  REGS_ROWS, regs_patch)
    tx = -(-(-(-W // 2)) // 32) * 32
    patch = regs_patch(T.laplace_jacobi(2), H, W)
    fits = [kc for kc in REGS_ROWS if tx * -(-H // kc) <= REGS_MAX_THREADS]
    if patch is None:
        assert not fits
        return
    ty, kc = patch
    assert kc == fits[0] and ty == -(-H // kc) and ty * kc >= H
    assert tx * ty <= REGS_MAX_THREADS and 2 * tx >= W
    assert (H, W) != (64, 64) or patch == (16, 4)   # 16 warps, 8 cells
    # A table past the 3x3 window, or whose mask has no instance, has none.
    assert regs_patch(T.star(2, [0.15, 0.05]), H, W) is None
    assert regs_patch(T.star(2, [0.25], center=0.5), H, W) is None


@pytest.mark.parametrize("H,W", [(1, 1), (9, 10), (33, 57), (64, 64),
                                 (168, 168), (160, 160), (20, 1000),
                                 (2048, 8), (2800, 8), (50, 512)])
def test_cta_patch_covers_the_grid(H, W):
    from repro_torch.kernels.jacobi_fused import cta_patch
    patch = cta_patch(H, W)
    if patch is None:   # past 512 columns
        assert W > 512
        return
    ty, kc = patch
    assert kc % 8 == 0 and ty * kc >= H > ty * (kc - 8)
    assert (-(-W // 32) * 32) * ty <= 512
    assert (-(-W // 32) * 32) * ty > 512 - (-(-W // 32) * 32) or ty == H
    assert (H, W) != (64, 64) or patch == (8, 8)


@pytest.mark.parametrize("W,fuse,r", [(8192, 1, 1), (8192, 16, 1), (64, 4, 1),
                                    (57, 37, 1), (260, 22, 2), (4096, 1, 56),
                                    (10, 3, 1), (517, 16, 3)])
def test_stream_strips_cover_the_grid(W, fuse, r):
    from repro_torch.kernels.jacobi_fused import STREAM_W, stream_geometry
    strip_w, strips, waves, min_rows = stream_geometry(W, fuse, r)
    assert 1 <= strip_w <= STREAM_W - 2 * fuse * r
    assert strips * strip_w >= W > (strips - 1) * strip_w
    assert waves >= 1 and min_rows >= 1


def _resident_cases(grid):
    """name -> (JAX spec on this grid, bc_value), the cases of
    test_plain_fused_step_matches_pallas past one CTA's shared memory."""
    rng = np.random.default_rng(176)
    return {
        "laplace_bc": (J.laplace_jacobi(2), 1.5),
        "fields_bc": (J.heterogeneous_jacobi(1.0 + 9.0 * rng.random(grid)),
                      1.5),
        "radius2_bc": (J.star(2, [0.15, 0.05], center=0.2), 1.5),
        "box_raw": (J.box(2), None),
    }


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["laplace_bc", "fields_bc", "radius2_bc",
                                  "box_raw"])
@pytest.mark.parametrize("shape", [(1, 176, 200), (2, 264, 136)])
def test_resident_past_one_cta_matches_pallas(shape, case, dtype_name):
    # Grids JAX's resident geometry takes and one CTA's shared memory does
    # not (past 168x168): the port takes them too.
    jspec, bc = _resident_cases(shape[1:])[case]
    jd, td = DT[dtype_name]
    x = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    jout = JK.jacobi2d_fused_step(jnp.asarray(x, jd), jspec, fuse=8,
                                  bc_value=bc, rim="resident")
    tout = jacobi2d_fused_step(torch.from_numpy(x).to(td),
                               to_torch_spec(jspec), fuse=8, bc_value=bc,
                               rim="resident")
    assert tout.dtype == td and tout.shape == shape
    _close(jout, tout, dtype_name)


def test_both_packages_raise_just_past_8_mib():
    # 1032x2048 pads to 8.06 MiB: both refuse the resident geometry there;
    # 1024x2048 (8 MiB) both take.
    from repro.kernels.tiling import resident_fits as jax_fits
    from repro_torch.kernels.tiling import resident_fits
    lap = T.laplace_jacobi(2)
    with pytest.raises(ValueError, match="resident"):
        JK.jacobi2d_fused_step(jnp.zeros((1, 1032, 2048)),
                               J.laplace_jacobi(2), fuse=2, rim="resident")
    with pytest.raises(ValueError, match="8388608"):
        jacobi2d_fused_step(torch.zeros(1, 1032, 2048), lap, fuse=2,
                            rim="resident")
    assert jax_fits((1024, 2048)) and resident_fits((1024, 2048))
    x = torch.zeros(1, 1024, 2048)
    assert jacobi2d_fused_step(x, lap, fuse=1, bc_value=1.0,
                               rim="resident").shape == x.shape


def test_plain_path_launches_no_kernel():
    before = dict(_build.LAUNCHES)
    x = torch.from_numpy(X)
    stencil2d(x, T.laplace_jacobi(2), bc_value=1.0)
    jacobi2d_fused_step(x, T.laplace_jacobi(2), fuse=2, bc_value=1.0)
    stencil3d(x[None], T.laplace_jacobi(3), bc_value=1.0)
    dense_stencil_matmul(x[0], torch.zeros(57, 57))
    assert dict(_build.LAUNCHES) == before


# --- K4: stencil3d ----------------------------------------------------------

SHAPES_3D = [(1, 10, 16, 20), (2, 4, 9, 7), (1, 10, 64, 64)]


def _x3(shape):
    return np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)


def _cases_3d(grid):
    """name -> (JAX spec on this grid, bc_value)."""
    rng = np.random.default_rng(3)
    return {
        "laplace_raw": (J.laplace_jacobi(3), None),
        "laplace_bc": (J.laplace_jacobi(3), 0.5),
        "fields_bc": (J.heterogeneous_jacobi(1.0 + 9.0 * rng.random(grid)),
                      1.5),
        "radius2_bc": (J.star(3, [0.15, 0.05], center=0.2), 1.5),
        "box_raw": (J.box(3), None),
    }


@pytest.mark.parametrize("shape", SHAPES_3D)
def test_plain_stencil3d_raw_matches_pallas(shape):
    x = _x3(shape)
    jout = JK.stencil3d(jnp.asarray(x), J.laplace_jacobi(3), block_x=8)
    tout = stencil3d(torch.from_numpy(x), T.laplace_jacobi(3))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(_cases_3d((4, 9, 7))))
def test_plain_stencil3d_cases_match_pallas(case, dtype_name):
    shape = (2, 4, 9, 7)
    jspec, bc = _cases_3d(shape[1:])[case]
    jd, td = DT[dtype_name]
    x = _x3(shape)
    jout = JK.stencil3d(jnp.asarray(x, jd), jspec, block_x=8, bc_value=bc)
    tout = stencil3d(torch.from_numpy(x).to(td), to_torch_spec(jspec),
                     bc_value=bc)
    assert tout.dtype == td and tout.shape == shape
    _close(jout, tout, dtype_name)


def test_jacobi3d_loop_matches_pallas():
    x = _x3((1, 10, 16, 20))
    jout = JK.jacobi3d(jnp.asarray(x), J.laplace_jacobi(3), bc_value=0.5,
                       iterations=3, block_x=8)
    tout = jacobi3d(torch.from_numpy(x), T.laplace_jacobi(3), bc_value=0.5,
                    iterations=3)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("case", list(_cases_3d((4, 9, 7))))
def test_plain_stencil3d_equals_the_oracle(case):
    # Same taps, same order, same roundings: bit for bit in fp32.
    from repro_torch.kernels import ref as tref
    x = torch.from_numpy(_x3((2, 4, 9, 7)))
    jspec, bc = _cases_3d((4, 9, 7))[case]
    tspec = to_torch_spec(jspec)
    if bc is None:
        want = tref.stencil3d_ref(x, tspec)
    else:
        want = T.DirichletBC(bc).apply_mask_trick(
            torch.stack([T.apply_stencil(g, tspec) for g in x]), 3)
    torch.testing.assert_close(stencil3d(x, tspec, bc_value=bc), want,
                               rtol=0, atol=0)


def test_stencil3d_fields_override():
    jspec, _ = _cases_3d((4, 9, 7))["fields_bc"]
    tspec = to_torch_spec(jspec)
    x = torch.from_numpy(_x3((2, 4, 9, 7)))
    f = torch.from_numpy(
        (0.1 + 0.05 * np.random.default_rng(4).random((6, 4, 9, 7)))
        .astype(np.float32))
    override = T.heterogeneous_jacobi(np.ones((4, 9, 7)))
    want = T.DirichletBC(1.5).apply_mask_trick(
        torch.stack([T.apply_stencil(g, override, f) for g in x]), 3)
    torch.testing.assert_close(stencil3d(x, tspec, bc_value=1.5, fields=f),
                               want, rtol=0, atol=0)


# --- K5: dense_stencil_matmul -------------------------------------------------

@pytest.mark.parametrize("s,n", [(1, 64), (8, 130), (32, 96)])
def test_plain_dense_matmul_matches_pallas(s, n):
    rng = np.random.default_rng(s * n)
    x = rng.standard_normal((s, n)).astype(np.float32)
    w = rng.standard_normal((n, n)).astype(np.float32)
    jout = JK.dense_stencil_matmul(jnp.asarray(x), jnp.asarray(w), bm=8,
                                   bk=128, bn=128)
    tout = dense_stencil_matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-4)


def test_plain_dense_jacobi_kernel_matches_pallas():
    rng = np.random.default_rng(12)
    x0 = rng.standard_normal((2, 12, 10)).astype(np.float32)
    m = J.build_dense_matrix((12, 10), J.laplace_jacobi(2))
    bc = J.DirichletBC(1.0)
    jx0 = jnp.stack([bc.set_boundary(jnp.asarray(g)) for g in x0])
    jout = JK.dense_jacobi_kernel(jx0, jnp.asarray(m), iterations=4, bm=8,
                                  bk=128, bn=128)
    tx0 = T.DirichletBC(1.0).set_boundary(torch.from_numpy(x0), 2)
    tout = dense_jacobi_kernel(tx0, torch.from_numpy(m), iterations=4)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-4)
    ref = T.jacobi_reference(torch.from_numpy(x0), T.laplace_jacobi(2),
                             T.DirichletBC(1.0), 4)
    np.testing.assert_allclose(tout.numpy(), ref.numpy(), rtol=0, atol=1e-4)


def test_plain_dense_matmul_bf16_accumulates_fp32():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((8, 256)).astype(np.float32)
    w = rng.standard_normal((256, 256)).astype(np.float32)
    jout = JK.dense_stencil_matmul(jnp.asarray(x, jnp.bfloat16),
                                   jnp.asarray(w, jnp.bfloat16), bm=8,
                                   bk=128, bn=128)
    tout = dense_stencil_matmul(torch.from_numpy(x).bfloat16(),
                                torch.from_numpy(w).bfloat16())
    assert tout.dtype == torch.bfloat16
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               rtol=3e-2, atol=3e-1)


def test_3d_and_dense_oracles_match_jax():
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref
    x = _x3((2, 4, 9, 7))
    for case in ("laplace_raw", "radius2_bc", "fields_bc"):
        jspec, _ = _cases_3d((4, 9, 7))[case]
        np.testing.assert_array_equal(
            tref.stencil3d_ref(torch.from_numpy(x),
                               to_torch_spec(jspec)).numpy(),
            np.asarray(jref.stencil3d_ref(jnp.asarray(x), jspec)))
    rng = np.random.default_rng(14)
    a = rng.standard_normal((5, 40)).astype(np.float32)
    w = rng.standard_normal((40, 40)).astype(np.float32)
    np.testing.assert_allclose(
        tref.dense_stencil_ref(torch.from_numpy(a),
                               torch.from_numpy(w)).numpy(),
        np.asarray(jref.dense_stencil_ref(jnp.asarray(a), jnp.asarray(w))),
        rtol=1e-5, atol=1e-5)


def test_3d_and_dense_wrappers_reject_what_the_kernels_cannot_run():
    x = torch.zeros(1, 4, 9, 7)
    with pytest.raises(ValueError, match="need a 3D spec"):
        stencil3d(x, T.laplace_jacobi(2))
    with pytest.raises(ValueError, match="batch, Z, X, Y"):
        stencil3d(x[0], T.laplace_jacobi(3))
    # A table past the kernel's 125 parameter taps runs, as JAX's does.
    jwide = J.StencilSpec({(i, j, k): 0.001 for i in range(-3, 4)
                           for j in range(-2, 3) for k in range(-2, 3)})
    xr = _x3((1, 4, 9, 7))
    np.testing.assert_allclose(
        stencil3d(torch.from_numpy(xr), to_torch_spec(jwide)).numpy(),
        np.asarray(JK.stencil3d(jnp.asarray(xr), jwide, block_x=8)),
        rtol=0, atol=TOL["f32"])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        stencil3d(x.double(), T.laplace_jacobi(3))
    box5 = T.StencilSpec({(i, j, k): 0.008 for i in range(-2, 3)
                          for j in range(-2, 3) for k in range(-2, 3)})
    assert stencil3d(x, box5).shape == x.shape  # 125 taps fit
    with pytest.raises(ValueError, match="must be \\(5,5\\)"):
        dense_stencil_matmul(torch.zeros(3, 5), torch.zeros(5, 4))
    with pytest.raises(ValueError, match="float32 or both bfloat16"):
        dense_stencil_matmul(torch.zeros(3, 5), torch.zeros(5, 5).double())
