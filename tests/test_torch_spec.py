"""The port's spec layer, FLOP accounting and block geometry against the JAX
package's, on the same numbers."""
import importlib.util
import itertools
import os

import numpy as np
import pytest

import repro.core as J
import repro.kernels.tiling as JT
import repro_torch.core as T
import repro_torch.kernels.tiling as TT
from repro_torch.kernels import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_matrix_specs():
    """The stencil families of the JAX conformance matrix, as it builds them."""
    path = os.path.join(REPO, "tests", "conformance", "test_matrix.py")
    spec = importlib.util.spec_from_file_location("_jax_conformance_matrix",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SPECS


SPECS = _load_matrix_specs()


def to_torch_spec(jspec):
    """Carry a JAX spec's numbers across to the port."""
    return T.spec_from_taps(
        [(o, w.array if isinstance(w, J.WeightField) else w)
         for o, w in jspec.taps], name=jspec.name)


def _same_taps(jspec, tspec):
    assert len(jspec.taps) == len(tspec.taps)
    for (jo, jw), (to, tw) in zip(jspec.taps, tspec.taps):
        assert jo == to
        if isinstance(jw, J.WeightField):
            assert isinstance(tw, T.WeightField)
            assert tw.array.dtype == np.float32
            np.testing.assert_array_equal(tw.array, jw.array)
        else:
            assert type(tw) is float and tw == jw


@pytest.mark.parametrize("family", list(SPECS))
def test_spec_from_taps_round_trips_every_family(family):
    jspec = SPECS[family]
    tspec = to_torch_spec(jspec)
    _same_taps(jspec, tspec)
    for attr in ("ndim", "is_variable", "num_variable_taps", "weights_shape",
                 "radius", "footprint", "useful_flops_per_point",
                 "variable_offsets"):
        assert getattr(tspec, attr) == getattr(jspec, attr), attr
    assert tspec.delivered_flops_per_point_conv() == \
        jspec.delivered_flops_per_point_conv()
    if jspec.is_variable:
        np.testing.assert_array_equal(tspec.field_stack(),
                                      np.asarray(jspec.field_stack()))
    else:
        assert tspec.field_stack() is None
        np.testing.assert_array_equal(tspec.to_kernel(), jspec.to_kernel())
    # And back: a port spec's taps rebuild the JAX spec.
    back = J.StencilSpec(taps=tuple((o, w.array if isinstance(
        w, T.WeightField) else w) for o, w in tspec.taps), name=tspec.name)
    assert back == jspec


def test_factories_build_the_jax_specs():
    kappa = 1.0 + 9.0 * np.random.default_rng(3).random((9, 11))
    pairs = [
        (J.laplace_jacobi(2), T.laplace_jacobi(2)),
        (J.laplace_jacobi(3), T.laplace_jacobi(3)),
        (J.star(2, [0.15, 0.05], center=0.2), T.star(2, [0.15, 0.05], center=0.2)),
        (J.box(2), T.box(2)),
        (J.heterogeneous_jacobi(kappa), T.heterogeneous_jacobi(kappa)),
        (J.variable_coefficient(J.laplace_jacobi(2), {(0, 1): kappa}),
         T.variable_coefficient(T.laplace_jacobi(2), {(0, 1): kappa})),
    ]
    for jspec, tspec in pairs:
        assert tspec.name == jspec.name
        _same_taps(jspec, tspec)


def test_hash_and_equality_behave_like_jax():
    kappa = 1.0 + np.arange(12.0).reshape(3, 4)
    other = kappa.copy()
    other[1, 1] += 0.5
    jax_specs = [J.laplace_jacobi(2), J.laplace_jacobi(2), J.box(2),
                 J.StencilSpec(J.laplace_jacobi(2).taps, name="renamed"),
                 J.heterogeneous_jacobi(kappa), J.heterogeneous_jacobi(kappa),
                 J.heterogeneous_jacobi(other)]
    torch_specs = [to_torch_spec(s) for s in jax_specs]
    for (ja, ta), (jb, tb) in itertools.product(
            zip(jax_specs, torch_specs), repeat=2):
        assert (ja == jb) == (ta == tb)
        if ta == tb:
            assert hash(ta) == hash(tb)
    cache = {torch_specs[4]: "hit"}
    assert cache[to_torch_spec(jax_specs[5])] == "hit"
    wf = torch_specs[4].taps[0][1]
    with pytest.raises(AttributeError):
        wf.foo = 1
    with pytest.raises(ValueError):
        wf.array[0, 0] = 1.0  # read-only


@pytest.mark.parametrize("bad", [
    {(0, 1): "x"},                       # not a number
    {(0, 1): np.ones((3, 3, 3))},        # field of the wrong rank
    {(0, 1): np.ones((3, 3)), (1, 0): np.ones((4, 4))},  # shapes disagree
    {},                                  # no taps
])
def test_malformed_specs_are_rejected_like_jax(bad):
    with pytest.raises(ValueError):
        J.StencilSpec(taps=bad)
    with pytest.raises(ValueError):
        T.StencilSpec(taps=bad)


def test_encoding_flops_equal_jax_and_the_paper():
    for jspec in SPECS.values():
        tspec = to_torch_spec(jspec)
        for enc, mask in itertools.product(("conv", "direct", "dense"),
                                           (True, False)):
            assert T.encoding_flops_per_point(tspec, enc, 4096, mask) == \
                J.encoding_flops_per_point(jspec, enc, 4096, mask)
    lap = T.laplace_jacobi(2)
    assert T.encoding_flops_per_point(lap, "direct", mask_trick=False) == 7
    assert T.encoding_flops_per_point(lap, "conv", mask_trick=False) == 17
    assert T.encoding_flops_per_point(lap, "dense", n_total=64 * 64) == 8191
    assert T.dense_layer_bytes((64, 64), 7) == J.dense_layer_bytes((64, 64), 7)


def test_conv3d_channels_flops_equal_jax():
    # Fig 6's channels trick: a Z-deep band of kx*ky windows per element.
    for jspec in SPECS.values():
        if jspec.ndim != 3:
            continue
        for depth, mask in itertools.product((6, 10), (True, False)):
            assert T.encoding_flops_per_point(
                to_torch_spec(jspec), "conv3d_channels", depth, mask) == \
                J.encoding_flops_per_point(jspec, "conv3d_channels", depth,
                                           mask)
    assert T.encoding_flops_per_point(T.laplace_jacobi(3), "conv3d_channels",
                                      n_total=10) == 2 * 10 * 9 - 1 + 2


def test_tiling_functions_equal_jax():
    shapes = [(8, 8), (12, 17), (33, 57), (64, 64), (160, 160), (257, 300),
              (1024, 1024)]
    for (H, W), fuse, r in itertools.product(shapes, (1, 2, 4, 8, 16),
                                             (1, 2)):
        for rim in ("trapezoid", "resident"):
            assert TT.fused_block_geometry(H, W, fuse, r, rim=rim) == \
                JT.fused_block_geometry(H, W, fuse, r, rim=rim)
            assert TT.fuse_redundancy((H, W), fuse, r, rim=rim) == \
                JT.fuse_redundancy((H, W), fuse, r, rim=rim)
        assert TT.halo_fuse_redundancy((H, W), fuse, r) == \
            JT.halo_fuse_redundancy((H, W), fuse, r)
        assert TT.halo_exchange_bytes((H, W), fuse, r) == \
            JT.halo_exchange_bytes((H, W), fuse, r)
        assert TT.round_up(H, 8) == JT.round_up(H, 8)


def test_resident_fits_is_hopper_shared_memory():
    # The one-CTA resident kernels: two fp32 buffers of the r-ringed grid
    # plus the tap table in 232,448 bytes: 168x168 is the largest square
    # grid at radius 1.
    assert TT.resident_cta_fits((168, 168), 1)
    assert not TT.resident_cta_fits((169, 169), 1)
    assert TT.resident_cta_fits((160, 160), 2)
    assert not TT.resident_cta_fits((168, 168), 2)
    assert TT.resident_smem_bytes((64, 64), 1) == 2 * 66 * 66 * 4
    # The reserve for the static tap table covers csrc/taps.cuh's struct.
    assert _build.MAX_TAPS == 25


@pytest.mark.parametrize("itemsize", [2, 4])
def test_resident_fits_equals_jax(itemsize):
    # rim="resident" takes exactly the grids the JAX package takes: up to
    # 8 MiB padded to (8, 128), 1024x2048 and 1448x1408 in fp32.
    shapes = [(8, 8), (33, 57), (168, 168), (169, 169), (176, 200),
              (264, 136), (1024, 1024), (1024, 2048), (1025, 2048),
              (1032, 2048), (1448, 1408), (1449, 1408), (2048, 1024),
              (2048, 1025), (4096, 512), (4097, 512), (2896, 2896)]
    for shape in shapes:
        assert TT.resident_fits(shape, itemsize) == \
            JT.resident_fits(shape, itemsize), shape
    assert TT.RESIDENT_VMEM_BYTES == JT.RESIDENT_VMEM_BYTES
    assert TT.resident_fits((1024, 2048)) and TT.resident_fits((1448, 1408))
    assert not TT.resident_fits((1032, 2048))
    assert 404 == _build.ctypes.sizeof(_build.Taps) <= TT.STATIC_SMEM_BYTES
