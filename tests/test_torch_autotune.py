"""The port's autotuner against the JAX package's: the cell keys, the table
schema and its lookups, validation, the candidate schedules, and the tuned
wiring of ``make_plan``/``choose_backend``/``select_fuse``/``Solver``.

Everything here is exact (strings, tuples, entry-for-entry equality of the
parsed tables, the same pick for the same table): no tolerance applies.
The port's ``cuda``/``cuda_fused`` are JAX's ``pallas``/``pallas_fused``.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core import autotune as JA
from repro.core.solver import select_fuse as j_select_fuse
from repro_torch.core import autotune as TA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TABLE = os.path.join(REPO, "TUNED_stencil.json")
PORT_TABLE = os.path.join(REPO, "TUNED_stencil_cuda.json")
TO_JAX = {"cuda": "pallas", "cuda_fused": "pallas_fused", "conv": "conv",
          "conv3d_native": "conv3d_native", "reference": "reference",
          "dense": "dense"}
GRID = (64, 64)


@pytest.fixture(autouse=True)
def _isolate_default_tables(monkeypatch, tmp_path):
    """Both packages' default tables point at a missing file, so no test
    reads (or is steered by) a committed artifact."""
    monkeypatch.setenv("REPRO_TUNED_TABLE", str(tmp_path / "absent.json"))
    monkeypatch.setenv(TA.TABLE_ENV, str(tmp_path / "absent.json"))
    JA.set_default_tuned_table(None)
    TA.set_default_tuned_table(None)
    yield
    JA.set_default_tuned_table(None)
    TA.set_default_tuned_table(None)


def _specs(pkg):
    kappa = 1.0 + np.random.default_rng(0).random((6, 7)).astype(np.float32)
    kappa3 = 1.0 + np.random.default_rng(1).random((3, 4, 5)) \
        .astype(np.float32)
    return [pkg.laplace_jacobi(2), pkg.laplace_jacobi(3),
            pkg.star(2, [0.15, 0.05], center=0.2), pkg.box(2), pkg.box(3),
            pkg.heterogeneous_jacobi(kappa), pkg.heterogeneous_jacobi(kappa3)]


SHAPES = [(60, 64), (65, 1), (64, 64), (1, 1), (3, 5, 7), (10, 64, 64),
          (1025, 1025), (4097,), (8192, 8192)]


@pytest.mark.parametrize("i", range(7))
def test_spec_family_equals_jax(i):
    assert TA.spec_family(_specs(T)[i]) == JA.spec_family(_specs(J)[i])


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_shape_bucket_and_distance_equal_jax(shape):
    assert TA.shape_bucket(shape) == JA.shape_bucket(shape)
    for other in SHAPES:
        assert TA.bucket_distance(shape, other) == \
            JA.bucket_distance(shape, other)
        assert TA.bucket_distance(TA.shape_bucket(shape),
                                  TA.shape_bucket(other)) == \
            JA.bucket_distance(JA.shape_bucket(shape),
                               JA.shape_bucket(other))


def test_dtype_and_device_keys():
    for t, j in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
                 (np.float32, np.float32), ("float32", "float32")):
        assert TA.dtype_key(t) == JA.dtype_key(j)
    assert TA.device_kind("cpu") == TA.device_kind(torch.device("cpu")) \
        == "cpu"


def _queries():
    fams = ["2d/r1/t4", "3d/r1/t6", "2d/r1/t4/var", "2d/r2/t8"]
    shapes = [(64, 64), (60, 60), (100, 100), (4096, 4096), (8, 16, 16),
              (10, 16, 16), (128, 256), (16, 64, 64)]
    for fam in fams:
        for shape in shapes:
            for dt in ("float32", "bfloat16"):
                for mesh in (None, (2, 4), (2, 2)):
                    yield fam, shape, dt, mesh


def test_jax_table_parses_and_looks_up_entry_for_entry():
    with open(JAX_TABLE) as f:
        data = json.load(f)
    jt, tt = JA.TunedTable.parse(data), TA.TunedTable.parse(data)
    assert len(tt) == len(jt) == len(data["entries"]) == 10
    assert [e.to_json() for e in tt.entries] == \
        [e.to_json() for e in jt.entries]
    assert tt.to_json() == jt.to_json()
    hits = 0
    for fam, shape, dt, mesh in _queries():
        for dist in (None, 0.0, 3.0):
            want = jt.lookup_cell("cpu", fam, shape, dt, max_distance=dist,
                                  mesh_shape=mesh)
            got = tt.lookup_cell("cpu", fam, shape, dt, max_distance=dist,
                                 mesh_shape=mesh)
            assert [e.to_json() for e in got] == [e.to_json() for e in want]
            hits += bool(got)
            w = jt.lookup("cpu", fam, shape, dt, max_distance=dist,
                          mesh_shape=mesh)
            g = tt.lookup("cpu", fam, shape, dt, max_distance=dist,
                          mesh_shape=mesh)
            assert (g and g.to_json()) == (w and w.to_json())
    assert hits >= 40
    # The JAX package's entries are the CPU's: they never price the card.
    assert tt.lookup("NVIDIA H100 80GB HBM3", "2d/r1/t4", GRID,
                     "float32") is None


def _entry(backend="conv", **kw):
    d = dict(device_kind="cpu", family="2d/r1/t4", bucket=[64, 64],
             dtype="float32", backend=backend, us_per_iter=5.0, fuse=1,
             block_h=None, rim=None, interpreted=False, iters=8)
    d.update(kw)
    return d


BROKEN = {
    "not_an_object": [],
    "wrong_schema": {"schema": 99, "entries": []},
    "no_entries": {"schema": 1},
    "unknown_field": {"schema": 1, "entries": [_entry(bogus=1)]},
    "missing_field": {"schema": 1, "entries": [
        {k: v for k, v in _entry().items() if k != "us_per_iter"}]},
    "unknown_backend": {"schema": 1, "entries": [
        _entry("tensorcore9000")]},
    "non_positive_time": {"schema": 1, "entries": [_entry(us_per_iter=0.0)]},
    "fuse_zero": {"schema": 1, "entries": [_entry(fuse=0)]},
    "bad_bucket": {"schema": 1, "entries": [_entry(bucket=[0, 64])]},
    "mesh_on_conv": {"schema": 1, "entries": [_entry(mesh=[2, 2])]},
    "bad_family": {"schema": 1, "entries": [_entry(family="xd/rq/t4")]},
    "illegal_cell": {"schema": 1, "entries": [
        _entry(family="1d/r1/t2", bucket=[64])]},
    "several": {"schema": 1, "entries": [
        _entry(us_per_iter=-1.0, fuse=0), _entry("reference"),
        _entry("conv3d_native")]},
    "valid": {"schema": 1, "entries": [_entry(), _entry("reference")]},
}


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_validate_table_reports_jax_errors(name):
    data = BROKEN[name]
    errors = TA.validate_table(data)
    assert errors == JA.validate_table(data)
    assert (errors == []) == (name == "valid")


def test_check_cli(tmp_path, capsys):
    good, bad = tmp_path / "good.json", tmp_path / "bad.json"
    good.write_text(json.dumps(BROKEN["valid"]))
    bad.write_text(json.dumps(BROKEN["illegal_cell"]))
    assert TA.main(["--check", str(good)]) == 0
    assert TA.main(["--check", str(bad)]) == 1
    out = capsys.readouterr().out
    assert "tune-check OK" in out and "TUNE-CHECK FAIL" in out


def test_committed_cuda_table_validates_and_covers_the_cells():
    assert TA.check_table_file(PORT_TABLE) == []
    table = TA.TunedTable.load(PORT_TABLE)
    cells = {(e.family, e.bucket) for e in table.entries}
    assert {("2d/r1/t4", (64, 64)), ("3d/r1/t6", (16, 64, 64))} <= cells
    kinds = {e.device_kind for e in table.entries}
    assert "cpu" not in kinds and "cuda" not in kinds
    assert not any(e.interpreted for e in table.entries)
    # Keyed by a card's name: the CPU never takes its schedules.
    for fam, shape in (("2d/r1/t4", GRID), ("3d/r1/t6", (10, 64, 64))):
        assert table.lookup("cpu", fam, shape, "float32") is None


def test_load_degrades_like_jax(tmp_path):
    p = tmp_path / "t.json"
    p.write_text("{not json")
    with pytest.warns(UserWarning, match="ignoring tuned table"):
        assert len(TA.TunedTable.load(str(p))) == 0
    p.write_text(json.dumps({"schema": 2, "entries": []}))
    with pytest.warns(UserWarning, match="stale or future"):
        assert len(TA.TunedTable.load(str(p))) == 0
    assert len(TA.TunedTable.load(str(tmp_path / "none.json"))) == 0
    with pytest.raises(TA.TableError):
        TA.TunedTable.parse({"schema": 1, "entries": [{"bogus": 1}]})


def test_default_table_follows_its_own_variable(monkeypatch, tmp_path):
    table = TA.TunedTable()
    table.add(TA.TunedEntry(**{**_entry("cuda_fused", us_per_iter=1.0,
                                        fuse=8, rim="trapezoid"),
                               "bucket": (64, 64)}))
    p = tmp_path / "mine.json"
    table.save(str(p))
    monkeypatch.setenv(TA.TABLE_ENV, str(p))
    TA.set_default_tuned_table(None)
    assert TA.default_table_path() == str(p)
    plan = T.make_plan(T.laplace_jacobi(2), GRID, bc=1.0, iters=16,
                       device="cpu")
    assert (plan.source, plan.backend, plan.fuse) == ("tuned", "cuda_fused",
                                                      8)
    # The JAX package's variable does not steer the port, nor the reverse.
    assert JA.default_table_path() != str(p)


def _pair(*entries):
    """The same table for both packages: (backend, us, fuse, rim,
    interpreted, bucket) in the port's backend names."""
    jt, tt = JA.TunedTable(), TA.TunedTable()
    for backend, us, fuse, rim, interp, bucket in entries:
        kw = dict(device_kind="cpu", family="2d/r1/t4", bucket=bucket,
                  dtype="float32", us_per_iter=us, fuse=fuse, rim=rim,
                  interpreted=interp)
        jt.add(JA.TunedEntry(backend=TO_JAX[backend], **kw))
        tt.add(TA.TunedEntry(backend=backend, **kw))
    return jt, tt


TABLES = {
    "fused_wins": [("conv", 100.0, 1, None, False, GRID),
                   ("cuda_fused", 5.0, 8, "trapezoid", False, GRID)],
    "resident_wins": [("conv", 100.0, 1, None, False, GRID),
                      ("cuda_fused", 2.0, 32, "resident", False, GRID),
                      ("cuda_fused", 5.0, 8, "trapezoid", False, GRID)],
    "conv_wins": [("conv", 10.0, 1, None, False, GRID),
                  ("cuda", 50.0, 1, None, False, GRID)],
    "interpreted_only": [("cuda", 1.0, 1, None, True, GRID),
                         ("cuda_fused", 1.0, 4, None, True, GRID)],
    "interpreted_loses": [("cuda", 1.0, 1, None, True, GRID),
                          ("conv", 50.0, 1, None, False, GRID)],
    "far_bucket": [("cuda_fused", 5.0, 8, None, False, (4096, 4096))],
    "empty": [],
}


@pytest.mark.parametrize("name", sorted(TABLES))
@pytest.mark.parametrize("shape", [GRID, (60, 60), (100, 100), (17, 17)],
                         ids=str)
def test_tuned_wiring_routes_where_jax_routes(name, shape):
    jt, tt = _pair(*TABLES[name])
    spec_j, spec_t = J.laplace_jacobi(2), T.laplace_jacobi(2)
    for iters in (12, 16, 32):
        jp = J.make_plan(spec_j, shape, backend="auto", bc=1.0, iters=iters,
                         device_kind="cpu", tuned=jt)
        tp = T.make_plan(spec_t, shape, backend="auto", bc=1.0, iters=iters,
                         device="cpu", tuned=tt)
        assert TO_JAX[tp.backend] == jp.backend
        assert (tp.source, tp.fuse, tp.rim) == (jp.source, jp.fuse, jp.rim)
        jn, jc = J.choose_backend(spec_j, shape, iters=iters,
                                  device_kind="cpu", tuned=jt)
        tn, tc = T.choose_backend(spec_t, shape, iters=iters,
                                  device_kind="cpu", tuned=tt)
        assert TO_JAX[tn] == jn
        if jp.source == "tuned":
            assert {TO_JAX[b]: c for b, c in tc.items()} == jc
    for ce in (16, 20, 12, 7):
        for backend in ("cuda_fused", "cuda", "conv"):
            assert T.select_fuse(backend, spec_t, shape, ce, "cpu",
                                 tuned=tt) == \
                j_select_fuse(TO_JAX[backend], spec_j, shape, ce, "cpu",
                              tuned=jt)
    js = J.Solver(spec_j, shape, bc=1.0, rtol=None, atol=None, max_iters=16,
                  device_kind="cpu", tuned=jt)
    ts = T.Solver(spec_t, shape, bc=1.0, rtol=None, atol=None, max_iters=16,
                  device="cpu", tuned=tt)
    assert TO_JAX[ts.backend] == js.backend
    assert (ts.plan.source, ts.fuse, ts.plan.rim) == \
        (js.plan.source, js.fuse, js.plan.rim)


def test_tuned_plan_still_matches_the_oracle():
    _, tt = _pair(("cuda_fused", 1.0, 4, "resident", False, (8, 8)))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 8))
                         .astype(np.float32))
    plan = T.make_plan(T.laplace_jacobi(2), (8, 8), bc=1.0, iters=4,
                       device="cpu", tuned=tt)
    assert (plan.source, plan.rim, plan.fuse) == ("tuned", "resident", 4)
    want = T.jacobi_reference(x, T.laplace_jacobi(2), T.DirichletBC(1.0), 4)
    torch.testing.assert_close(plan(x), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("ndim", [2, 3])
def test_schedule_candidates_on_the_cpu_are_jax_s(ndim):
    shape = (64, 64) if ndim == 2 else (10, 64, 64)
    got = TA.schedule_candidates(T.laplace_jacobi(ndim), shape, 32,
                                 device="cpu")
    want = JA.schedule_candidates(J.laplace_jacobi(ndim), shape, 32)
    assert [(TO_JAX[c.backend], c.fuse, c.block_h, c.rim) for c in got] == \
        [(c.backend, c.fuse, c.block_h, c.rim) for c in want]


def test_autotune_cell_on_the_cpu_records_interpreted_kernels():
    spec = T.laplace_jacobi(2)
    cands = TA.schedule_candidates(spec, (16, 16), 4, bc=1.0, device="cpu")
    table = TA.autotune_cell(spec, (16, 16), iters=4, bc=1.0, repeats=1,
                             device="cpu")
    assert len(table) == len(cands) == 3
    by = {e.backend: e for e in table.entries}
    assert by["cuda"].interpreted and by["cuda_fused"].interpreted
    assert not by["conv"].interpreted and by["conv"].us_per_iter > 0
    assert {e.device_kind for e in table.entries} == {"cpu"}
    # The plain versions' times never win the cell.
    assert table.lookup("cpu", "2d/r1/t4", (16, 16), "float32").backend \
        == "conv"
    jt = JA.autotune_cell(J.laplace_jacobi(2), (16, 16), iters=4, bc=1.0,
                          repeats=1)
    assert sorted((TO_JAX[e.backend], e.fuse, e.rim, e.interpreted)
                  for e in table.entries) == \
        sorted((e.backend, e.fuse, e.rim, e.interpreted)
               for e in jt.entries)
