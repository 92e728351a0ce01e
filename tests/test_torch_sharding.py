"""The port's sharding rules, dims trees, meshes and placement
(``parallel/sharding.py``, ``launch/mesh.py``, ``ParamDef.dims``) against
the JAX package's, on the CPU, in-process.

JAX's ``Sharder`` needs only ``mesh.shape`` and ``mesh.axis_names`` (as
``tests/test_loss_and_sharding.py`` drives it), so its rules run on a
stand-in mesh; the port's run on ``make_production_mesh`` built from
``"meta"`` devices, which places nothing.  Every comparison is exact.
"""
import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jax_config
from repro.models.model_zoo import build as jax_build
from repro.parallel.sharding import Sharder as JaxSharder
from repro.train.train_step import state_dims as jax_state_dims
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.layers import flatten
from repro_torch.models.model_zoo import build, model_class
from repro_torch.models.solver_layer import solver_table
from repro_torch.parallel.halo import make_mesh
from repro_torch.parallel.sharding import (PartitionSpec, Sharded, Sharder,
                                           all_gather, gather, groups,
                                           local_slices, local_view, pmax,
                                           psum, shard, tree_specs)
from repro_torch.train.train_step import state_dims

ARCHS = list_archs() + ["learned-stencil"]
LM_ARCHS = list_archs()
MESHES = {"16x16": dict(data=16, model=16),
          "2x16x16": dict(pod=2, data=16, model=16)}
RULES = [(a, m, p, s) for a in ARCHS for m in MESHES for p in ("tp", "sp")
         for s in (False, True)]
RULE_IDS = [f"{a}-{m}-{p}{'-sod' if s else ''}" for a, m, p, s in RULES]
CACHE_SHAPES = ((256, 4096), (1, 32768))   # a decode batch; batch 1


class _FakeMesh:
    """Duck-typed mesh: JAX's Sharder.spec only needs shape + axis_names."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _meshes(name):
    jmesh = _FakeMesh(**MESHES[name])
    tmesh = make_production_mesh(multi_pod=name == "2x16x16",
                                 devices="meta")
    assert dict(zip(tmesh.axis_names, tmesh.shape)) == MESHES[name]
    return jmesh, tmesh


def _tables(arch):
    """{path: (shape, dims)} of both packages' full-size parameter
    tables."""
    jcfg, cfg = jax_config(arch), get_config(arch)
    japi = jax_build(jcfg)
    jdims = dict(flatten(japi.dims()))
    jshapes = {tuple(k.key for k in path): tuple(v.shape) for path, v in
               jax.tree_util.tree_flatten_with_path(japi.shapes())[0]}
    table = (solver_table(cfg) if cfg.family == "solver"
             else model_class(cfg).param_table(cfg))
    ours = {path: (pd.shape, pd.dims) for path, pd in flatten(table)}
    assert set(ours) == set(jdims)
    return {p: ((jshapes[p], jdims[p]), ours[p]) for p in ours}


def _smoke_pair(arch):
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    return jax_build(jcfg), build(cfg, device="cpu", dtype=torch.float32)


# --- the dims trees -----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_dims_equal_jax(arch):
    japi, model = _smoke_pair(arch)
    assert model.dims() == japi.dims()
    assert sorted(flatten(model.dims())) == sorted(flatten(japi.dims()))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_dims_equal_jax(arch):
    japi, model = _smoke_pair(arch)
    assert model.cache_dims() == japi.cache_dims()


@pytest.mark.parametrize("arch", ARCHS)
def test_state_dims_equal_jax(arch):
    japi, model = _smoke_pair(arch)
    assert state_dims(model) == jax_state_dims(japi)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_dims_by_parameter_name_cover_the_module(arch):
    # each module parameter's dims are its table leaf's without the
    # stacked axes, and its rank
    _, model = _smoke_pair(arch)
    by_name = model.param_dims_by_name()
    params = dict(model.named_parameters())
    assert set(by_name) == set(params)
    for name, p in params.items():
        assert len(by_name[name]) == p.dim(), name


# --- the rules ----------------------------------------------------------------

@pytest.mark.parametrize("arch,mesh,profile,sod", RULES, ids=RULE_IDS)
def test_param_specs_equal_jax(arch, mesh, profile, sod):
    jmesh, tmesh = _meshes(mesh)
    js = JaxSharder(mesh=jmesh, profile=profile, state_over_data=sod)
    ts = Sharder(tmesh, profile=profile, state_over_data=sod)
    for path, ((jshape, jdims), (shape, dims)) in _tables(arch).items():
        assert tuple(shape) == jshape, path
        ours, theirs = ts.spec(dims, shape), js.spec(jdims, jshape)
        assert isinstance(ours, PartitionSpec)
        assert tuple(ours) == tuple(theirs) and JP(*ours) == theirs, path


@pytest.mark.parametrize("arch,mesh,profile,sod", RULES, ids=RULE_IDS)
def test_opt_specs_equal_jax(arch, mesh, profile, sod):
    jmesh, tmesh = _meshes(mesh)
    js = JaxSharder(mesh=jmesh, profile=profile, state_over_data=sod)
    ts = Sharder(tmesh, profile=profile, state_over_data=sod)
    for path, ((jshape, jdims), (shape, dims)) in _tables(arch).items():
        ours, theirs = ts.opt_spec(dims, shape), js.opt_spec(jdims, jshape)
        assert tuple(ours) == tuple(theirs), path


@pytest.mark.parametrize("arch,mesh,profile,sod", RULES, ids=RULE_IDS)
def test_cache_specs_equal_jax(arch, mesh, profile, sod):
    jcfg, cfg = jax_config(arch), get_config(arch)
    japi = jax_build(jcfg)
    jmesh, tmesh = _meshes(mesh)
    js = JaxSharder(mesh=jmesh, profile=profile, state_over_data=sod)
    ts = Sharder(tmesh, profile=profile, state_over_data=sod)
    cls = model_class(cfg) if cfg.family != "solver" else None
    if cls is None:
        assert japi.cache_dims() == {}
        return
    bare = cls.__new__(cls)          # the dims need the config only
    bare.cfg = cfg
    ours_dims = dict(flatten(bare.cache_dims()))
    assert ours_dims == dict(flatten(japi.cache_dims()))
    for batch, max_len in CACHE_SHAPES:
        shapes = {tuple(k.key for k in path): tuple(v.shape)
                  for path, v in jax.tree_util.tree_flatten_with_path(
                      japi.cache_shapes(batch, max_len))[0]}
        for path, dims in ours_dims.items():
            assert tuple(ts.spec(dims, shapes[path])) == tuple(
                js.spec(dims, shapes[path])), (batch, max_len, path)


# JAX's own rule cases (tests/test_loss_and_sharding.py::TestSharderRules)
RULE_CASES = [
    ("16x16", "tp", False, ("embed", "heads", "head_dim"), (64, 48, 128),
     (None, "model", None)),
    ("16x16", "tp", False, ("embed", "heads", "head_dim"), (384, 6, 64),
     (None, None, None)),
    ("16x16", "tp", False, ("vocab", "dff"), (1600, 1600), ("model", None)),
    ("2x16x16", "tp", False, ("batch", "seq"), (256, 4096),
     (("pod", "data"), None)),
    ("2x16x16", "tp", False, ("batch", "seq"), (1, 4096), (None, None)),
    ("16x16", "sp", False, ("batch", "seq", "embed"), (256, 4096, 5120),
     ("data", "model", None)),
    ("16x16", "sp", False, ("embed", "dff"), (5120, 17920), ("data", None)),
    ("16x16", "tp", True, ("batch", "ssm_heads", "ssm_headdim", "ssm_state"),
     (1, 32, 64, 128), (None, "model", "data", None)),
    ("2x16x16", "sp", False, ("tokens", "vocab"), (512 * 4096, 151936),
     (("pod", "data", "model"), None)),
    ("16x16", "tp", True, ("batch", "kv_seq", "kv_heads", "head_dim"),
     (1, 32768, 8, 128), (None, ("model", "data"), None, None)),
]


@pytest.mark.parametrize("mesh,profile,sod,dims,shape,want", RULE_CASES)
def test_rule_cases_equal_jax(mesh, profile, sod, dims, shape, want):
    jmesh, tmesh = _meshes(mesh)
    ours = Sharder(tmesh, profile, sod).spec(dims, shape)
    assert tuple(ours) == want
    assert tuple(JaxSharder(jmesh, profile, sod).spec(dims, shape)) == want


def test_opt_spec_adds_the_data_axis_and_tree_specs():
    _, tmesh = _meshes("16x16")
    sh = Sharder(tmesh, "tp")
    assert tuple(sh.opt_spec(("embed", "dff"), (64, 128))) == (
        "data", "model")
    tree = {"a": ("embed", "dff"), "b": {"c": ("vocab", "embed")}}
    shapes = {"a": (64, 128), "b": {"c": (1024, 64)}}
    assert tree_specs(sh, tree, shapes) == {
        "a": (None, "model"), "b": {"c": ("model", None)}}
    assert tree_specs(sh, tree, shapes, opt=True) == {
        "a": ("data", "model"), "b": {"c": ("model", "data")}}
    with pytest.raises(ValueError, match="dims"):
        sh.spec(("embed",), (4, 4))


# --- meshes ---------------------------------------------------------------------

def test_meshes_build_without_a_card():
    m = make_production_mesh(devices="meta")
    assert m.shape == (16, 16) and m.axis_names == ("data", "model")
    assert m.size == 256 and m.shape["model"] == 16
    m = make_production_mesh(multi_pod=True, devices=["meta"] * 512)
    assert m.shape == (2, 16, 16) and m.shape.get("pod") == 2
    assert m.coords()[-1] == (1, 15, 15) and m.index((1, 0, 3)) == 259
    h = make_host_mesh(4, devices=["cpu"] * 8)
    assert h.shape == (2, 4) and h.axis_names == ("data", "model")
    assert make_host_mesh(3, devices=["cpu"] * 8).shape == (8, 1)
    assert make_host_mesh(devices="cpu").shape == (1, 1)
    assert Sharder(make_host_mesh(devices="cpu")).trivial
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            make_host_mesh()
        with pytest.raises(RuntimeError, match="devices='cpu'"):
            make_production_mesh()
    with pytest.raises(ValueError, match="distinct axis names"):
        make_mesh((2, 2), ("data", "data"), devices="cpu")
    with pytest.raises(ValueError, match="3-axis mesh"):
        make_mesh((2, 2, 2), ("data", "model"), devices="cpu")


# --- placement and the collectives ------------------------------------------------

PLACEMENTS = [("2x4", (2, 4), ("data", "model")),
              ("2x2x2", (2, 2, 2), ("pod", "data", "model"))]
SPECS = [(None, None, None), ("data", None, "model"), ("model", "data", None),
         (("data", "model"), None, None), (None, ("model", "data"), None),
         (("pod", "data"), "model", None)]


ROUND_TRIPS = [(name, shape, axes, spec)
               for name, shape, axes in PLACEMENTS for spec in SPECS
               if all(a in axes for e in spec if e
                      for a in ((e,) if isinstance(e, str) else e))]


@pytest.mark.parametrize("name,shape,axes,spec", ROUND_TRIPS,
                         ids=[f"{r[0]}-{r[3]}" for r in ROUND_TRIPS])
def test_shard_and_gather_round_trip(name, shape, axes, spec):
    mesh = make_mesh(shape, axes, devices="cpu")
    x = torch.arange(8 * 8 * 4, dtype=torch.float32).reshape(8, 8, 4)
    pieces = shard(x, PartitionSpec(*spec), mesh)
    assert len(pieces) == mesh.size
    for coord, piece in zip(mesh.coords(), pieces):
        assert torch.equal(piece, x[local_slices(spec, x.shape, mesh,
                                                 coord)])
    assert torch.equal(gather(pieces, spec, mesh), x)
    held = Sharded(pieces, PartitionSpec(*spec), tuple(x.shape), mesh)
    assert torch.equal(held.gather(), x)


def test_replicas_on_one_device_are_one_tensor_and_gradients_add():
    mesh = make_mesh((2, 4), devices="cpu")
    x = torch.randn(8, 4, requires_grad=True)
    pieces = shard(x, PartitionSpec("model", None), mesh)
    assert pieces[0] is pieces[4] and pieces[0] is not pieces[1]
    # every shard uses its piece: the replicas' gradients add into x
    total = sum((p * (k + 1)).sum() for k, p in enumerate(pieces))
    (g,) = torch.autograd.grad(total, x)
    want = torch.tensor([1 + 5, 2 + 6, 3 + 7, 4 + 8],
                        dtype=torch.float32).repeat_interleave(2)
    assert torch.equal(g, want[:, None].expand(8, 4))


def test_collectives_sum_in_block_order_over_their_axes():
    mesh = make_mesh((2, 4), devices="cpu")
    vals = [torch.tensor([float(10 * i + j)]) for i, j in mesh.coords()]
    assert groups(mesh, "model") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert groups(mesh, ("data",)) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert groups(mesh, ("model", "data")) == [[0, 4, 1, 5, 2, 6, 3, 7]]
    s = psum(vals, mesh, "model")
    assert [float(t) for t in s] == [6.0] * 4 + [46.0] * 4
    assert s[0] is s[3]            # one device: one result a group
    assert [float(t) for t in pmax(vals, mesh, "data")] == [
        10.0, 11.0, 12.0, 13.0] * 2
    g = all_gather(vals, mesh, "model", 0)
    assert g[5].tolist() == [10.0, 11.0, 12.0, 13.0]
    assert psum(vals, mesh, ()) == vals
    # local_view gathers every entry not on a kept axis
    x = torch.arange(32.0).reshape(8, 4)
    pieces, kept = local_view(x, PartitionSpec("data", "model"), mesh)
    assert tuple(kept) == (None, "model")
    assert torch.equal(pieces[6], x[:, 2:3])


def test_sharded_values_do_not_mix_devices_of_a_mesh():
    # shards on distinct devices each get their own copy (here: the
    # meta device stands for a second one)
    mesh = make_mesh((1, 2), devices=["cpu", "meta"])
    x = torch.ones(2, 4)
    pieces = shard(x, PartitionSpec(None, "model"), mesh)
    assert [p.device.type for p in pieces] == ["cpu", "meta"]
    assert pieces[0] is not pieces[1]
    assert gather(pieces, PartitionSpec(None, "model"), mesh,
                  device="meta").shape == (2, 4)
    out = psum([torch.ones(1, device="meta")] * 2,
               make_mesh((1, 2), devices="meta"), "model")
    assert out[1].device.type == "meta" and out[1].shape == (1,)
