"""The port's launch tooling (``launch/specs.py``, ``dryrun.py``,
``dryrun_pp.py``, ``sweep.py``) against the JAX package's, on the CPU.

Every (arch x shape) cell's input stand-ins (shapes, types, logical dims),
their shardings on both production meshes, the applicability rule, the
``state_over_data`` flag, ``model_flops``, ``n_params`` and
``n_active_params`` equal JAX's ``repro.launch.specs`` and
``analytic_model_flops`` exactly (nothing compiled: JAX's
``input_shardings`` runs with a ``Sharder`` whose shardings are its specs,
on a stand-in mesh, as ``tests/test_torch_sharding.py`` drives JAX's
rules).  JAX's dry-run test cells (``tests/test_launch.py``): glm4-9b
``long_500k`` is a SKIP and qwen3-0.6b ``decode_32k`` runs on the
512-shard mesh here; its ``train_4k`` cell is ``tests/test_torch_
dryrun.py`` (about 50 s alone), mamba2-370m ``long_500k`` runs through
the CLI in ``tests/test_torch_launch_cli.py``.
"""
import os

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jax_config
from repro.launch import specs as jspecs
from repro.parallel.sharding import Sharder as JaxSharder
from repro_torch.configs import list_archs
from repro_torch.launch import specs
from repro_torch.launch.dryrun import analytic_model_flops, run_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel.sharding import PartitionSpec

CELLS = [(a, s) for a in list_archs() for s in specs.SHAPES]


def _jax_model_flops(cfg, kind, batch, seq):
    """JAX's ``analytic_model_flops`` (its module sets XLA_FLAGS for 512
    host devices at import: restored after)."""
    old = os.environ.get("XLA_FLAGS")
    from repro.launch.dryrun import analytic_model_flops as f
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return f(cfg, kind, batch, seq)


class _FakeMesh:
    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


class _SpecSharder(JaxSharder):
    """JAX's Sharder with its specs standing for its NamedShardings."""

    def sharding(self, dims, shape):
        return self.spec(dims, shape)

    def opt_sharding(self, dims, shape):
        return self.opt_spec(dims, shape)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, (*prefix, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, (*prefix, i))
    else:
        yield prefix, tree


def _jflat(tree, leaf=lambda v: (tuple(v.shape), str(v.dtype)),
           is_leaf=None):
    """{path: leaf(v)} of a JAX tree (dict keys, sequence indices)."""
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=is_leaf)[0]:
        key = tuple(getattr(k, "key", getattr(k, "idx", None))
                    for k in path)
        out[key] = leaf(v)
    return out


def _spec_flat(tree, prefix=()):
    """{path: spec entries} of the port's tree of ``PartitionSpec``s."""
    if isinstance(tree, PartitionSpec):
        return {prefix: tuple(tree)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_spec_flat(v, (*prefix, k)))
    return out


@pytest.fixture(scope="module")
def meshes():
    return {mp: (_FakeMesh(**dict(zip(m.axis_names, m.shape))), m)
            for mp in (False, True)
            for m in (make_production_mesh(multi_pod=mp, devices="meta"),)}


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_specs_equal_jax(arch, shape, meshes):
    jcell = jspecs.make_cell(arch, shape)
    cell = specs.make_cell(arch, shape)
    assert (cell.kind, cell.seq, cell.batch) == (jcell.kind, jcell.seq,
                                                 jcell.batch)
    assert (specs.cell_is_applicable(cell.cfg, shape)
            == jspecs.cell_is_applicable(jcell.cfg, shape))
    jstructs, jdims = jspecs.input_specs(jcell)
    structs, dims = specs.input_specs(cell)
    assert dims == jdims
    mine = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in _flat(structs)}
    assert mine == _jflat(jstructs)
    assert all(t.device.type == "meta" for _, t in _flat(structs))
    for mp, (jmesh, mesh) in meshes.items():
        jsh = jspecs.make_sharder(jcell, jmesh)
        jsh = _SpecSharder(mesh=jmesh, profile=jsh.profile,
                           state_over_data=jsh.state_over_data)
        sh = specs.make_sharder(cell, mesh)
        assert (sh.profile, sh.state_over_data) == (jsh.profile,
                                                    jsh.state_over_data)
        want = _jflat(jspecs.input_shardings(jcell, jsh, jstructs, jdims),
                      leaf=tuple, is_leaf=lambda x: isinstance(x, JP))
        got = _spec_flat(specs.input_shardings(cell, sh, structs, dims))
        assert got == want, mp
    jcfg = jax_config(arch)
    assert analytic_model_flops(cell.cfg, cell.kind, cell.batch,
                                cell.seq) == _jax_model_flops(
        jcfg, jcell.kind, jcell.batch, jcell.seq)
    assert cell.cfg.param_count() == jcfg.param_count()
    assert cell.cfg.active_param_count() == jcfg.active_param_count()


def test_long_context_flag_and_skip():
    """batch 1 < data ways: state_over_data on both meshes; a
    full-attention arch's long_500k cell is a SKIP with JAX's reason."""
    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp, devices="meta")
        for arch, sod in (("mamba2-370m", True), ("zamba2-1.2b", True)):
            assert specs.make_sharder(specs.make_cell(arch, "long_500k"),
                                      mesh).state_over_data is sod
        assert not specs.make_sharder(specs.make_cell(
            "qwen3-0.6b", "decode_32k"), mesh).state_over_data
    rec = run_cell("glm4-9b", "long_500k", False, "", smoke=True)
    assert rec["status"] == "SKIP"
    assert "full-attention" in rec["skip_reason"]


def test_decode_cell_on_the_multipod_mesh():
    rec = run_cell("qwen3-0.6b", "decode_32k", True, "", smoke=True)
    assert rec["status"] == "OK" and rec["n_devices"] == 512
    assert rec["hlo_cost"]["flops"] > 0
    assert rec["memory_analysis"]["temp_size_in_bytes"] > 0
    assert rec["collectives_static"] == rec["hlo_cost"]["collectives"]
    # decode 128 rows over 32 data ways: the cache's kv_seq over model
    assert rec["state_over_data"] is False
