"""The names the port gained to cover the JAX package's public API, each
held against JAX's on the CPU: ``dense_jacobi_with_bc``,
``causal_conv1d_spec``, ``conv2d_apply``'s "SAME"/"VALID",
``stencil_apply(tuned=)``, ``WeightField.values`` with
``StencilSpec.field_values``/``with_field_values``, ``is_causal_lm``,
``encdec_table(max_dec_positions=)``, ``stack_tables(dim_name=)``,
``flash_hbm_bytes``, and the shape helpers ``layers.param_shapes``,
``attn_cache_shapes``/``attn_cache_dims`` and ``state_shapes``.

Inputs are drawn from numpy seeds.  Tolerances: fp32 results 2e-5
absolute (test_matrix.py's), the conv 1e-5; tables, shapes, taps, names,
picks and byte counts exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.plan as JP
import repro_torch.core as T
import repro_torch.core.plan as TP
from repro.configs import get_config as j_config
from repro.configs import list_archs
from repro.core import autotune as JA
from repro.core.conv_encoding import conv2d_apply as j_conv2d_apply
from repro.kernels.flash_attention import flash_hbm_bytes as j_hbm
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model_zoo import build as j_build
from repro.train.train_step import state_shapes as j_state_shapes
from repro_torch.configs import get_config as t_config
from repro_torch.core import autotune as TA
from repro_torch.kernels.flash_attention import flash_hbm_bytes as t_hbm
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.model_zoo import build as t_build
from repro_torch.train.train_step import state_shapes as t_state_shapes

F32_TOL = 2e-5
CONV_TOL = 1e-5
TO_JAX = {"cuda": "pallas", "cuda_fused": "pallas_fused", "conv": "conv",
          "conv3d_native": "conv3d_native", "reference": "reference",
          "dense": "dense", "halo": "halo"}


def _close(got: torch.Tensor, want, atol: float) -> None:
    want = np.asarray(want, dtype=np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def test_dense_jacobi_with_bc_equals_jax():
    x0 = np.random.default_rng(0).standard_normal((2, 12, 17)) \
        .astype(np.float32)
    want = J.dense_jacobi_with_bc(jnp.asarray(x0), J.laplace_jacobi(2),
                                  J.DirichletBC(1.5), 5)
    got = T.dense_jacobi_with_bc(torch.from_numpy(x0), T.laplace_jacobi(2),
                                 T.DirichletBC(1.5), 5, device="cpu")
    assert got.dtype == torch.float32
    _close(got, want, F32_TOL)


def test_causal_conv1d_spec_equals_jax():
    w = [0.1, 0.2, 0.3, 0.4]
    ts, js = T.causal_conv1d_spec(w), J.causal_conv1d_spec(w)
    assert ts.name == js.name == "causal_conv1d_k4"
    assert ts.taps == tuple((o, float(v)) for o, v in js.taps)
    x = np.random.default_rng(1).standard_normal((3, 33)).astype(np.float32)
    legal = [(b, m) for b in T.BACKENDS for m in T.BoundaryMode
             if T.backend_support(b, ts, grid_shape=(33,), mode=m, bc=1.5)]
    assert ("reference", T.BoundaryMode.MASK) in legal
    assert ("dense", T.BoundaryMode.MATRIX) in legal
    for backend, mode in legal:
        want = J.stencil_apply(js, jnp.asarray(x), backend=TO_JAX[backend],
                               bc=1.5, mode=J.BoundaryMode(mode.value),
                               iters=3)
        got = T.stencil_apply(ts, torch.from_numpy(x), backend=backend,
                              bc=1.5, mode=mode, iters=3, device="cpu")
        _close(got, want, F32_TOL)


@pytest.mark.parametrize("kshape", [(3, 3), (2, 4), (5, 1)], ids=str)
def test_conv2d_apply_equals_jax_in_its_three_forms(kshape):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 1, 9, 11)).astype(np.float32)
    k = rng.standard_normal((1, 1, *kshape)).astype(np.float32)
    jx, jk = jnp.asarray(x), jnp.asarray(k)
    tx, tk = torch.from_numpy(x), torch.from_numpy(k)
    _close(T.conv2d_apply(tx, tk), j_conv2d_apply(jx, jk), CONV_TOL)
    for padding in ("SAME", "VALID"):
        _close(T.conv2d_apply(tx, tk, padding),
               j_conv2d_apply(jx, jk, padding), CONV_TOL)
    assert T.conv2d_apply(tx, tk).shape == tx.shape
    with pytest.raises(ValueError, match="padding"):
        T.conv2d_apply(tx, tk, "same")


@pytest.fixture
def _isolated_tables(monkeypatch, tmp_path):
    """Both packages' default tables point at a missing file."""
    monkeypatch.setenv("REPRO_TUNED_TABLE", str(tmp_path / "absent.json"))
    monkeypatch.setenv(TA.TABLE_ENV, str(tmp_path / "absent.json"))
    JA.set_default_tuned_table(None)
    TA.set_default_tuned_table(None)
    yield
    JA.set_default_tuned_table(None)
    TA.set_default_tuned_table(None)


def _one_entry_tables(grid):
    kw = dict(device_kind="cpu", family="2d/r1/t4", bucket=grid,
              dtype="float32", us_per_iter=1.0, fuse=4, rim="trapezoid",
              interpreted=False)
    jt, tt = JA.TunedTable(), TA.TunedTable()
    jt.add(JA.TunedEntry(backend="pallas_fused", **kw))
    tt.add(TA.TunedEntry(backend="cuda_fused", **kw))
    return jt, tt


def _spy(monkeypatch, module):
    """Record every plan that ``module.stencil_apply`` makes."""
    plans, make = [], module.make_plan

    def recording(*args, **kwargs):
        plans.append(make(*args, **kwargs))
        return plans[-1]
    monkeypatch.setattr(module, "make_plan", recording)
    return plans


@pytest.mark.parametrize("tuned", ["table", "default", None])
def test_stencil_apply_tuned_picks_what_jax_picks(tuned, monkeypatch,
                                                  _isolated_tables):
    grid = (16, 16)
    jt, tt = _one_entry_tables(grid)
    if tuned == "default":
        JA.set_default_tuned_table(jt)
        TA.set_default_tuned_table(tt)
        j_arg = t_arg = "default"
    elif tuned == "table":
        j_arg, t_arg = jt, tt
    else:
        j_arg = t_arg = None
    jplans, tplans = _spy(monkeypatch, JP), _spy(monkeypatch, TP)
    x = np.random.default_rng(3).standard_normal((2, *grid)) \
        .astype(np.float32)
    want = J.stencil_apply(J.laplace_jacobi(2), jnp.asarray(x), bc=1.0,
                           iters=8, device_kind="cpu", tuned=j_arg)
    got = T.stencil_apply(T.laplace_jacobi(2), torch.from_numpy(x), bc=1.0,
                          iters=8, device="cpu", tuned=t_arg)
    (jp,), (tp,) = jplans, tplans
    assert (TO_JAX[tp.backend], tp.fuse, tp.source) == \
        (jp.backend, jp.fuse, jp.source)
    if tuned is not None:
        assert (tp.backend, tp.fuse, tp.source) == ("cuda_fused", 4,
                                                    "tuned")
    _close(got, want, F32_TOL)


def _hetero(pkg):
    kappa = 1.0 + np.random.default_rng(4).random((6, 7)).astype(np.float32)
    return pkg.heterogeneous_jacobi(kappa)


def test_field_values_round_trip_equals_jax():
    js, ts = _hetero(J), _hetero(T)
    jv, tv = js.field_values(), ts.field_values()
    assert len(tv) == len(jv) == 4
    for a, b in zip(tv, jv):
        np.testing.assert_array_equal(a, np.asarray(b))
    for (_, jw), (_, tw) in zip(js.taps, ts.taps):
        np.testing.assert_array_equal(tw.values, jw.values)
        assert tw.values is tw.array
    new = np.random.default_rng(5).random((4, 6, 7)).astype(np.float32)
    jn = js.with_field_values(jnp.asarray(new), name="swapped")
    for values in (new, list(new), torch.from_numpy(new),
                   [torch.from_numpy(v) for v in new]):
        tn = ts.with_field_values(values, name="swapped")
        assert tn.name == jn.name == "swapped"
        np.testing.assert_array_equal(tn.field_stack(),
                                      np.asarray(jn.field_stack()))
        assert tn == T.spec_from_taps(
            [(o, np.asarray(w.values)) for o, w in jn.taps], "swapped")
    assert ts.with_field_values(ts.field_values()) == ts
    assert js.with_field_values(list(new)).name == \
        ts.with_field_values(list(new)).name == ts.name
    with pytest.raises(ValueError) as je:
        js.with_field_values(new[:3])
    with pytest.raises(ValueError) as te:
        ts.with_field_values(new[:3])
    assert str(te.value) == str(je.value)
    assert T.laplace_jacobi(2).field_values() == J.laplace_jacobi(2) \
        .field_values() == ()


def test_with_field_values_refuses_a_tensor_that_requires_grad():
    ts = _hetero(T)
    g = torch.ones(4, 6, 7, requires_grad=True)
    for values in (g, list(g)):
        with pytest.raises(ValueError, match="fields="):
            ts.with_field_values(values)


@pytest.mark.parametrize("arch", list_archs())
def test_is_causal_lm_equals_jax(arch):
    assert t_config(arch).is_causal_lm == j_config(arch).is_causal_lm
    assert t_config(arch, smoke=True).is_causal_lm == \
        j_config(arch, smoke=True).is_causal_lm


def test_encdec_table_max_dec_positions_equals_jax():
    cfg_t, cfg_j = t_config("whisper-tiny"), j_config("whisper-tiny")
    for kw in ({}, {"max_dec_positions": 1500}):
        assert TE.encdec_table(cfg_t, **kw)["dec_pos"].shape == \
            JE.encdec_table(cfg_j, **kw)["dec_pos"].shape
    assert TE.encdec_table(cfg_t, 1500)["dec_pos"].shape[0] == 1500


def _tree_shapes(tree):
    if isinstance(tree, dict):
        return {k: _tree_shapes(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and len(tree) == 2 and \
            isinstance(tree[0], tuple):
        shape, dt = tree                # the port's (shape, dtype) leaf
    else:
        shape, dt = tree.shape, tree.dtype
    return tuple(shape), str(dt).removeprefix("torch.")


def test_stack_tables_and_param_shapes_equal_jax():
    cfg_t, cfg_j = t_config("qwen3-0.6b", smoke=True), \
        j_config("qwen3-0.6b", smoke=True)
    tt = TL.stack_tables(TT.block_table(cfg_t), 3, dim_name="blocks")
    jt = JL.stack_tables(JT.block_table(cfg_j, "dense"), 3, dim_name="blocks")
    assert tt == TL.stack_tables(TT.block_table(cfg_t), 3)
    assert _tree_shapes(TL.param_shapes(tt, torch.bfloat16)) == \
        _tree_shapes(JL.param_shapes(jt, jnp.bfloat16))
    for leaf in TL.flatten(TL.param_shapes(tt, torch.float32)):
        assert leaf[1].device.type == "meta"


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-1.2b"])
def test_cache_and_state_shapes_equal_jax(arch):
    cfg_t, cfg_j = t_config(arch, smoke=True), j_config(arch, smoke=True)
    assert _tree_shapes(TT.attn_cache_shapes(cfg_t, 2, 16, torch.float32)) \
        == _tree_shapes(JT.attn_cache_shapes(cfg_j, 2, 16, jnp.float32))
    assert TT.attn_cache_dims() == JT.attn_cache_dims()
    model = t_build(cfg_t, device="meta", dtype=torch.float32)
    assert _tree_shapes(model.cache_shapes(2, 16)) == \
        _tree_shapes(JT.cache_shapes(cfg_j, 2, 16, jnp.float32))
    assert model.cache_dims() == JT.cache_dims(cfg_j)
    assert _tree_shapes(t_state_shapes(model)) == \
        _tree_shapes(j_state_shapes(j_build(cfg_j)))


@pytest.mark.parametrize("shape", [
    (1, 512, 512, 8, 8, 64),        # MHA, one q block
    (2, 4096, 4096, 16, 8, 128),    # GQA 2, causal passes
    (1, 2048, 2048, 32, 4, 128),    # GQA 8
    (4, 300, 300, 12, 12, 64),      # Sq under one block
    (1, 1, 32768, 16, 8, 128),      # one decode row against a long cache
], ids=str)
def test_flash_hbm_bytes_equals_jax(shape):
    for bpe in (2, 4):
        assert t_hbm(*shape, bytes_per_el=bpe) == j_hbm(*shape,
                                                        bytes_per_el=bpe)
    assert t_hbm(*shape) == j_hbm(*shape)
