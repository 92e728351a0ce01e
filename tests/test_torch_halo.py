"""The port's halo distribution (``parallel/halo.py``, ``core/distributed.py``
and the ``halo`` backend through plan, solver and autotuner) against the
JAX package's, on the CPU.

The JAX side needs a multi-device mesh, so it runs once in a subprocess
under ``XLA_FLAGS=--xla_force_host_platform_device_count=8``, its meshes
built with ``AxisType.Auto`` axes (jax 0.9's ``make_mesh`` defaults to
Explicit axes, which the JAX runner's ``with_sharding_constraint``
refuses).  It reads the inputs this module draws with
``numpy.random.default_rng`` and writes every output to one ``.npz``.  The
port side runs in-process on CPU ``TileMesh``es.

Tolerances: the port's halo runner equals its own ``reference`` backend
bit for bit (fp32 sums in tap order on every tile).  It equals JAX's
compiled shard_map program bit for bit on the 5-point cells and the
solves; on the 9-point box, the radius-2 star and the per-cell taps XLA's
compiled sums differ by up to 6e-8 and 1.2e-7 here, so those are held to
``JAX_ATOL`` (5e-6, as ROADMAP §3 holds the compiled 3D path).
"""
import ast
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.autotune as JA
import repro.core.distributed as JD
import repro.core.solver as JS
import repro_torch.core as T
import repro_torch.core.autotune as TA
import repro_torch.core.distributed as TD
import repro_torch.core.solver as TS
from repro_torch.parallel.halo import (exchange_1d, exchange_halo_2d,
                                       make_mesh)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ATOL = 5e-6

# --- the cases, shared by both sides ------------------------------------------
# Exchanges: an 8x16 grid over 2x4 (4x4 tiles) at r = 1, 2 and the deepest
# legal halo, 4 (one phase forwards a whole neighbouring tile).
EXCHANGE_GRID, EXCHANGE_MESH, EXCHANGE_RADII = (2, 8, 16), (2, 4), (1, 2, 4)

# Runners: (name, spec, mesh, batch shape, bc, iterations, fuse), JAX's
# shapes from tests/solver/test_distributed_solver.py: 2x4 with the 5-point,
# 9-point and radius-2 stars; 2x2 at fuse 1, 2, 4 on even (8x8) and odd
# (9x9) tiles.
SPECS = {"laplace": ("laplace_jacobi", (2,), {}),
         "box": ("box", (2,), {}),
         "star_r2": ("star", (2, [0.15, 0.05]), {"center": 0.2})}
RUNNERS = [
    ("laplace_2x4", "laplace", (2, 4), (2, 16, 16), 1.0, 10, 1),
    ("box_2x4", "box", (2, 4), (1, 8, 16), 0.5, 3, 1),
    ("star_r2_2x4_f2", "star_r2", (2, 4), (1, 16, 32), 0.5, 6, 2),
    ("box_2x4_f2", "box", (2, 4), (1, 16, 32), 0.5, 6, 2),
] + [(f"laplace_2x2_n{n}_f{f}", "laplace", (2, 2), (2, n, n), 1.0, 8, f)
     for n in (16, 18) for f in (1, 2, 4)]
# The batch split over a third axis: a 2x2x2 ("batch", "data", "model")
# mesh, each batch block's tiles exchanging among themselves; a batch of 3
# does not divide.
BATCH_MESH = ((2, 2, 2), ("batch", "data", "model"))
BATCH_RUNNERS = [
    ("batch_laplace", "laplace", (4, 16, 16), 1.0, 8, 1),
    ("batch_box_f2", "box", (2, 16, 16), 0.5, 6, 2),
]
# Per-cell taps split with the grid (2x4), fuse 1 and 3.
VAR_GRID, VAR_BATCH, VAR_ITERS, VAR_FUSES = (16, 16), 2, 6, (1, 3)
# Batched solves on 2x2 to rtol 1e-6: (name, x0, check_every, fuse).
SOLVES = [("batched_16", "zeros_half", 10, None),
          ("random_18_f4", "random", 16, 4)]


def _spec(pkg, name):
    fn, args, kw = SPECS[name]
    return getattr(pkg, fn)(*args, **kw)


def _inputs():
    rng = np.random.default_rng(27)
    d = {"exchange": np.arange(1, np.prod(EXCHANGE_GRID) + 1,
                               dtype=np.float32).reshape(EXCHANGE_GRID)}
    for name, _, _, shape, *_ in RUNNERS:
        d[f"runner/{name}"] = rng.standard_normal(shape).astype(np.float32)
    for name, _, shape, *_ in BATCH_RUNNERS:
        d[f"runner/{name}"] = rng.standard_normal(shape).astype(np.float32)
    d["var/kappa"] = (1.0 + 9.0 * rng.random(VAR_GRID)).astype(np.float32)
    d["var/x"] = rng.standard_normal(
        (VAR_BATCH, *VAR_GRID)).astype(np.float32)
    d["solve/batched_16"] = np.stack(
        [np.zeros((16, 16)), 0.5 * np.ones((16, 16))]).astype(np.float32)
    d["solve/random_18_f4"] = rng.standard_normal(
        (2, 18, 18)).astype(np.float32)
    return d


JAX_SIDE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, PartitionSpec as P
import repro.core as J
from repro.core.distributed import make_halo_runner
from repro.parallel.halo import exchange_halo_2d, shard_map_compat

cfg = json.loads(sys.argv[1])
inp = dict(np.load(cfg["inputs"]))
out = {}


def mesh(shape, names=("data", "model")):
    return jax.make_mesh(tuple(shape), names,
                         axis_types=(AxisType.Auto, AxisType.Auto))


def spec(name):
    fn, args, kw = cfg["specs"][name]
    return getattr(J, fn)(*args, **kw)


# exchanged windows: each device returns its augmented tile
nr, nc = cfg["exchange_mesh"]
m = mesh((nr, nc), ("row", "col"))
for r in cfg["exchange_radii"]:
    f = shard_map_compat(
        lambda xl, r=r: exchange_halo_2d(xl, "row", "col", nr, nc, r),
        m, (P(None, "row", "col"),), P(None, "row", "col"))
    out[f"exchange/r{r}"] = np.asarray(jax.jit(f)(jnp.asarray(
        inp["exchange"])))

for name, sname, shape, xshape, bc, iters, fuse in cfg["runners"]:
    run = make_halo_runner(mesh(shape), spec(sname), H=xshape[1],
                           W=xshape[2], bc_value=bc, iterations=iters,
                           fuse=fuse)
    out[f"runner/{name}"] = np.asarray(jax.jit(run)(jnp.asarray(
        inp[f"runner/{name}"])))

bshape, bnames = cfg["batch_mesh"]
bmesh = jax.make_mesh(tuple(bshape), tuple(bnames),
                      axis_types=(AxisType.Auto,) * 3)
for name, sname, xshape, bc, iters, fuse in cfg["batch_runners"]:
    run = make_halo_runner(bmesh, spec(sname), H=xshape[1], W=xshape[2],
                           bc_value=bc, iterations=iters, fuse=fuse,
                           batch_axis="batch")
    out[f"runner/{name}"] = np.asarray(jax.jit(run)(jnp.asarray(
        inp[f"runner/{name}"])))
try:
    make_halo_runner(bmesh, spec("laplace"), H=16, W=16, bc_value=1.0,
                     iterations=2, batch_axis="batch")(
        jnp.zeros((3, 16, 16), jnp.float32))
    raised = ""
except Exception as err:
    raised = type(err).__name__
out["batch_indivisible_raises"] = np.asarray(raised)

vspec = J.heterogeneous_jacobi(inp["var/kappa"])
for fuse in cfg["var_fuses"]:
    r = J.solve(vspec, jnp.asarray(inp["var/x"]), backend="halo",
                mesh=mesh((2, 4)), bc=1.0, fuse=fuse, rtol=None, atol=None,
                max_iters=cfg["var_iters"], tuned=None)
    out[f"var/f{fuse}"] = np.asarray(r.x)

for name, _, ce, fuse in cfg["solves"]:
    r = J.solve(J.laplace_jacobi(2), jnp.asarray(inp[f"solve/{name}"]),
                backend="halo", mesh=mesh((2, 2)), bc=1.0, rtol=1e-6,
                check_every=ce, max_iters=2000, fuse=fuse, tuned=None)
    out[f"solve/{name}/x"] = np.asarray(r.x)
    out[f"solve/{name}/iterations"] = np.asarray(r.iterations)
    out[f"solve/{name}/fuse"] = np.asarray(r.fuse)
    out[f"solve/{name}/history"] = np.asarray(r.residual_history)
np.savez(cfg["out"], **out)
print("jax side ok")
"""


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory, inputs):
    """Every JAX output, from one subprocess with 8 forced host devices."""
    d = tmp_path_factory.mktemp("jax_halo")
    np.savez(d / "inputs.npz", **inputs)
    cfg = {"inputs": str(d / "inputs.npz"), "out": str(d / "out.npz"),
           "specs": SPECS, "exchange_mesh": EXCHANGE_MESH,
           "exchange_radii": EXCHANGE_RADII, "runners": RUNNERS,
           "batch_mesh": BATCH_MESH, "batch_runners": BATCH_RUNNERS,
           "var_fuses": VAR_FUSES, "var_iters": VAR_ITERS,
           "solves": SOLVES}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", JAX_SIDE, json.dumps(cfg)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0 and "jax side ok" in r.stdout, r.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


def cpu_mesh(shape, names=("data", "model")):
    return make_mesh(shape, names, devices="cpu")


def _tiles(g, n_row, n_col):
    h, w = g.shape[-2] // n_row, g.shape[-1] // n_col
    return [g[..., i * h:(i + 1) * h, j * w:(j + 1) * w]
            for i in range(n_row) for j in range(n_col)]


# --- parallel/halo.py ---------------------------------------------------------

@pytest.mark.parametrize("r", EXCHANGE_RADII)
def test_exchange_windows_equal_the_padded_grid_and_jax(r, inputs, jax_out):
    nr, nc = EXCHANGE_MESH
    g = torch.tensor(inputs["exchange"])
    aug = exchange_halo_2d(_tiles(g, nr, nc), nr, nc, r)
    h, w = g.shape[1] // nr, g.shape[2] // nc
    gp = torch.nn.functional.pad(g, (r, r, r, r))   # zero-padded global grid
    # JAX's augmented tiles, laid side by side by the out spec
    jaug = _tiles(torch.tensor(jax_out[f"exchange/r{r}"]), nr, nc)
    for k, (a, ja) in enumerate(zip(aug, jaug)):
        i, j = divmod(k, nc)
        want = gp[:, i * h:i * h + h + 2 * r, j * w:j * w + w + 2 * r]
        assert a.shape == (2, h + 2 * r, w + 2 * r)
        assert torch.equal(a, want), (r, i, j)   # corners included
        assert torch.equal(a, ja), (r, i, j)


def test_exchange_1d_extents_zero_edges_and_depth_guard():
    n, loc, r = 4, 4, 2
    g = torch.arange(1, n * loc + 1, dtype=torch.float32)  # no zeros inside
    line = [g[i * loc:(i + 1) * loc] for i in range(n)]
    halos = exchange_1d(line, 0, r)
    gp = torch.nn.functional.pad(g, (r, r))
    for i, (lo, hi) in enumerate(halos):
        assert lo.shape == hi.shape == (r,)
        assert torch.equal(lo, gp[i * loc:i * loc + r])
        assert torch.equal(hi, gp[(i + 1) * loc + r:(i + 1) * loc + 2 * r])
    assert not halos[0][0].any() and not halos[-1][1].any()  # no wrap
    import repro.parallel.halo as JH
    with pytest.raises(ValueError, match="exceeds the local extent") as e:
        exchange_1d(line, 0, loc + 1)
    jmsg = None
    try:  # JAX's guard runs before any collective: a stand-in axis serves
        JH.exchange_1d(np.zeros(loc, np.float32), "x", n, 0, loc + 1)
    except ValueError as err:
        jmsg = str(err)
    assert str(e.value) == jmsg


def test_tile_mesh_reads_as_jax_mesh():
    m = cpu_mesh((2, 4))
    assert m.shape == (2, 4) and m.shape["data"] == 2 \
        and m.shape["model"] == 4
    assert T.plan._mesh_tiling(m) == J.plan._mesh_tiling((2, 4)) == (2, 4)
    assert len(m.devices) == 8 and {d.type for d in m.devices} == {"cpu"}
    assert make_mesh((1, 2), devices=["cpu", "cpu"]).devices[1].type == "cpu"
    with pytest.raises(ValueError, match="devices for a 2x2 mesh"):
        make_mesh((2, 2), devices=["cpu"] * 3)


def test_make_mesh_without_devices_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default placement is usable")
    with pytest.raises(RuntimeError, match="devices='cpu'"):
        make_mesh((2, 2))
    # the halo solve's default device is the card too
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.solve(T.laplace_jacobi(2), np.zeros((8, 8), np.float32),
                backend="halo", mesh=cpu_mesh((2, 2)), bc=1.0)


# --- core/distributed.py ------------------------------------------------------

@pytest.mark.parametrize("case", RUNNERS, ids=[c[0] for c in RUNNERS])
def test_runner_equals_reference_bit_for_bit(case, inputs):
    name, sname, shape, xshape, bc, iters, fuse = case
    spec = _spec(T, sname)
    run = TD.make_halo_runner(cpu_mesh(shape), spec, H=xshape[1],
                              W=xshape[2], bc_value=bc, iterations=iters,
                              fuse=fuse)
    x = torch.tensor(inputs[f"runner/{name}"])
    ref = T.stencil_apply(spec, x, backend="reference", bc=bc, iters=iters,
                          device="cpu")
    out = run(x)
    assert out.shape == x.shape and out.dtype == x.dtype
    assert torch.equal(out, ref), float((out - ref).abs().max())


@pytest.mark.parametrize("case", RUNNERS, ids=[c[0] for c in RUNNERS])
def test_runner_equals_jax(case, inputs, jax_out):
    name, sname, shape, xshape, bc, iters, fuse = case
    run = TD.make_halo_runner(cpu_mesh(shape), _spec(T, sname), H=xshape[1],
                              W=xshape[2], bc_value=bc, iterations=iters,
                              fuse=fuse)
    out = run(torch.tensor(inputs[f"runner/{name}"])).numpy()
    if sname == "laplace":
        np.testing.assert_array_equal(out, jax_out[f"runner/{name}"])
    np.testing.assert_allclose(out, jax_out[f"runner/{name}"], rtol=0,
                               atol=JAX_ATOL)


@pytest.mark.parametrize("case", BATCH_RUNNERS,
                         ids=[c[0] for c in BATCH_RUNNERS])
def test_runner_splits_the_batch_over_a_third_axis(case, inputs, jax_out):
    """``batch_axis``: each batch block on its own 2x2 tiles, equal to the
    ``reference`` backend bit for bit and to JAX's runner on its 2x2x2
    mesh at the two-axis runner's bound."""
    name, sname, xshape, bc, iters, fuse = case
    spec = _spec(T, sname)
    mesh = cpu_mesh(*BATCH_MESH)
    run = TD.make_halo_runner(mesh, spec, H=xshape[1], W=xshape[2],
                              bc_value=bc, iterations=iters, fuse=fuse,
                              batch_axis="batch")
    x = torch.tensor(inputs[f"runner/{name}"])
    out = run(x)
    ref = T.stencil_apply(spec, x, backend="reference", bc=bc, iters=iters,
                          device="cpu")
    assert out.shape == x.shape and torch.equal(out, ref)
    if sname == "laplace":
        np.testing.assert_array_equal(out.numpy(), jax_out[f"runner/{name}"])
    np.testing.assert_allclose(out.numpy(), jax_out[f"runner/{name}"],
                               rtol=0, atol=JAX_ATOL)


def test_runner_batch_axis_places_blocks_and_refuses_a_ragged_batch(
        jax_out):
    """Block b's tile (i, j) on ``mesh.device_at({batch: b, data: i,
    model: j})`` (read off a mesh that records what it is asked), and a
    batch of 3 over 2 shards raises as JAX's runner does."""
    class Recording:
        def __init__(self):
            self.mesh, self.asked = cpu_mesh(*BATCH_MESH), []
            self.shape = self.mesh.shape

        def device_at(self, pos):
            self.asked.append(dict(pos))
            return self.mesh.device_at(pos)

    mesh = Recording()
    run = TD.make_halo_runner(mesh, T.laplace_jacobi(2), H=16, W=16,
                              bc_value=1.0, iterations=2, batch_axis="batch")
    assert mesh.asked == [{"batch": b, "data": i, "model": j}
                          for b in range(2) for i in range(2)
                          for j in range(2)]
    with pytest.raises(ValueError, match="does not divide") as e:
        run(torch.zeros(3, 16, 16))
    assert type(e.value).__name__ == str(jax_out["batch_indivisible_raises"])


def test_runner_without_the_split_on_narrow_tiles(inputs):
    # 2x4 over a 16x8 grid leaves 8x2 tiles: a radius-2 star needs 4 to
    # split, so the one-piece update runs; it too equals the reference.
    spec = T.star(2, [0.15, 0.05], center=0.2)
    x = torch.tensor(inputs["runner/laplace_2x4"][:, :, :8])
    run = TD.make_halo_runner(cpu_mesh((2, 4)), spec, H=16, W=8,
                              bc_value=0.5, iterations=4, fuse=1)
    ref = T.stencil_apply(spec, x, backend="reference", bc=0.5, iters=4,
                          device="cpu")
    assert torch.equal(run(x), ref)


def test_runner_axes_named_in_either_order(inputs):
    # rows over the mesh's second axis: a 4x2 tiling of the 2x4 mesh
    spec = T.laplace_jacobi(2)
    x = torch.tensor(inputs["runner/laplace_2x4"])
    run = TD.make_halo_runner(cpu_mesh((2, 4)), spec, H=16, W=16,
                              bc_value=1.0, iterations=4, row_axis="model",
                              col_axis="data", fuse=2)
    ref = T.stencil_apply(spec, x, backend="reference", bc=1.0, iters=4,
                          device="cpu")
    assert torch.equal(run(x), ref)


@pytest.mark.parametrize("fuse", VAR_FUSES)
def test_per_cell_taps_split_with_the_grid(fuse, inputs, jax_out):
    spec = T.heterogeneous_jacobi(inputs["var/kappa"])
    x = torch.tensor(inputs["var/x"])
    r = T.solve(spec, x, backend="halo", mesh=cpu_mesh((2, 4)), bc=1.0,
                fuse=fuse, rtol=None, atol=None, max_iters=VAR_ITERS,
                device="cpu", tuned=None)
    ref = T.solve(spec, x, backend="reference", bc=1.0, rtol=None,
                  atol=None, max_iters=VAR_ITERS, device="cpu")
    assert (r.backend, r.fuse) == ("halo", fuse)
    assert torch.equal(r.x, ref.x)
    np.testing.assert_allclose(r.x.numpy(), jax_out[f"var/f{fuse}"], rtol=0,
                               atol=JAX_ATOL)


def test_comm_accounting_equals_jax():
    assert TD.HALO_PHASES_PER_EXCHANGE == JD.HALO_PHASES_PER_EXCHANGE
    for it, f, var in [(16, 1, False), (16, 4, False), (5, 2, False),
                       (8, 2, True), (16, 16, True)]:
        assert TD.halo_comm_rounds(it, f, variable=var) == \
            JD.halo_comm_rounds(it, f, variable=var)
    for r, h, w in [(1, 8, 8), (2, 8, 8), (1, 8, 6), (3, 2, 2), (2, 4096,
                                                                  2048)]:
        assert TD.max_halo_fuse(r, h, w) == JD.max_halo_fuse(r, h, w)


def _messages(fn_port, fn_jax):
    with pytest.raises(ValueError) as e:
        fn_port()
    with pytest.raises(ValueError) as je:
        fn_jax()
    assert str(e.value) == str(je.value)
    return str(e.value)


@pytest.mark.parametrize("case", [
    ("fuse_not_dividing", dict(H=8, W=8, iterations=5, fuse=2), (1, 1),
     "not divisible"),
    ("fuse_below_one", dict(H=8, W=8, iterations=4, fuse=0), (1, 1),
     "fuse must be >= 1"),
    ("depth_past_tile", dict(H=8, W=8, iterations=16, fuse=16), (1, 1),
     "max fuse 8"),
    ("radius2_budget", dict(H=8, W=8, iterations=8, fuse=8, r2=True), (1, 1),
     "max fuse 4"),
    ("depth_past_2x4_tile", dict(H=16, W=32, iterations=16, fuse=16),
     (2, 4), "max fuse 8"),
    ("grid_not_tiling", dict(H=12, W=17, iterations=4, fuse=1), (2, 4),
     "must tile over 2x4"),
    ("three_d", dict(H=8, W=8, iterations=4, fuse=1, nd=3), (1, 1),
     "is 2D"),
], ids=lambda c: c[0])
def test_runner_validation_equals_jax(case):
    _, kw, shape, match = case
    kw = dict(kw)
    r2, nd = kw.pop("r2", False), kw.pop("nd", 2)

    def specs(pkg):
        if r2:
            return pkg.star(2, [0.15, 0.05], center=0.2)
        return pkg.laplace_jacobi(nd)

    # JAX's checks read only the mesh's shape before they raise, so a
    # stand-in with its ``shape`` mapping serves on one host device.
    jmesh = types.SimpleNamespace(shape={"data": shape[0],
                                         "model": shape[1]},
                                  axis_names=("data", "model"))
    msg = _messages(
        lambda: TD.make_halo_runner(cpu_mesh(shape), specs(T), bc_value=0.0,
                                    **kw),
        lambda: JD.make_halo_runner(jmesh, specs(J), bc_value=0.0, **kw))
    assert match in msg


def test_the_smallest_legal_schedules_run():
    # the radius-2 budget at its edge (R = 8 on 8x8) and a 1x1 mesh
    spec = T.star(2, [0.15, 0.05], center=0.2)
    x = torch.tensor(np.random.default_rng(5).standard_normal((1, 8, 8)),
                     dtype=torch.float32)
    ref = T.stencil_apply(spec, x, backend="reference", bc=0.0, iters=8,
                          device="cpu")
    run = TD.make_halo_runner(cpu_mesh((1, 1)), spec, H=8, W=8,
                              bc_value=0.0, iterations=8, fuse=4)
    assert torch.equal(run(x), ref)


# --- the halo backend through plan, solver and autotuner ----------------------

def test_halo_plan_contract():
    lap = T.laplace_jacobi(2)
    x = torch.tensor(np.random.default_rng(6).standard_normal((2, 12, 17)),
                     dtype=torch.float32)
    plan = T.make_plan(lap, (12, 17), backend="halo", bc=1.0, iters=6,
                       fuse=3, device="cpu")   # no mesh: one tile
    assert (plan.backend, plan.fuse, plan.rim, plan.operands) == \
        ("halo", 3, None, frozenset())
    assert not plan.interpreted
    ref = T.stencil_apply(lap, x, backend="reference", bc=1.0, iters=6,
                          device="cpu")
    assert torch.equal(plan(x), ref)
    assert torch.equal(plan(x[0]), ref[0])   # a bare grid round-trips
    with pytest.raises(ValueError, match="not divisible"):
        T.make_plan(lap, (12, 17), backend="halo", bc=1.0, iters=5, fuse=2,
                    device="cpu")
    with pytest.raises(ValueError, match="does not tile over the 2x4"):
        T.make_plan(lap, (12, 17), backend="halo", bc=1.0, iters=4,
                    mesh=cpu_mesh((2, 4)), device="cpu")
    with pytest.raises(ValueError, match="bakes in the Dirichlet fixup"):
        T.make_plan(lap, (12, 16), backend="halo", bc=None, iters=4,
                    device="cpu")
    meta = make_mesh((1, 2), devices="meta")
    with pytest.raises(ValueError, match="takes a mesh of cpu tiles"):
        T.make_plan(lap, (12, 16), backend="halo", bc=1.0, iters=4,
                    mesh=meta, device="cpu")
    # stencil_apply passes the mesh through
    out = T.stencil_apply(lap, x[:, :, :16], backend="halo", bc=1.0, iters=4,
                          fuse=2, mesh=cpu_mesh((2, 4)), device="cpu")
    assert torch.equal(out, T.stencil_apply(
        lap, x[:, :, :16], backend="reference", bc=1.0, iters=4,
        device="cpu"))


@pytest.mark.parametrize("case", SOLVES, ids=[c[0] for c in SOLVES])
def test_batched_solve_equals_reference_and_jax(case, inputs, jax_out):
    name, _, ce, fuse = case
    x0 = torch.tensor(inputs[f"solve/{name}"])
    kw = dict(bc=1.0, rtol=1e-6, check_every=ce, max_iters=2000,
              device="cpu", tuned=None)
    d = T.solve(T.laplace_jacobi(2), x0, backend="halo",
                mesh=cpu_mesh((2, 2)), fuse=fuse, **kw)
    s = T.solve(T.laplace_jacobi(2), x0, backend="reference", **kw)
    assert d.backend == "halo" and d.converged.all() and s.converged.all()
    np.testing.assert_array_equal(d.iterations, s.iterations)
    assert torch.equal(d.x, s.x)
    np.testing.assert_array_equal(d.iterations,
                                  jax_out[f"solve/{name}/iterations"])
    assert d.fuse == int(jax_out[f"solve/{name}/fuse"])
    np.testing.assert_array_equal(d.x.numpy(), jax_out[f"solve/{name}/x"])
    # the port sums its norms in float64, JAX in fp32 (ROADMAP §3)
    np.testing.assert_allclose(d.residual_history,
                               jax_out[f"solve/{name}/history"], rtol=5e-6,
                               equal_nan=True)


def test_select_fuse_on_cpu_profile_makes_jax_picks():
    lap, star2 = T.laplace_jacobi(2), T.star(2, [0.15, 0.05], center=0.2)
    jspecs = {lap.name: J.laplace_jacobi(2),
              star2.name: J.star(2, [0.15, 0.05], center=0.2)}
    picks = set()
    for spec, grid, mesh, ce in [
            (s, g, m, ce) for s in (lap, star2)
            for g in ((16, 16), (18, 18), (64, 64), (128, 256), (8192, 8192))
            for m in (None, (1, 1), (2, 2), (2, 4), (4, 2), (3, 3))
            for ce in (7, 10, 12, 16, 20, 32)]:
        want = JS.select_fuse("halo", jspecs[spec.name], grid, ce,
                              device_kind="cpu", tuned=None, mesh=mesh)
        got = TS.select_fuse("halo", spec, grid, ce, "cpu", tuned=None,
                             mesh=mesh)
        assert got == want, (spec.name, grid, mesh, ce)
        picks.add(got)
    assert len(picks) > 2   # the sweep reaches several depths


def test_solver_auto_with_a_mesh_prices_halo():
    # backend="auto" with a mesh weighs halo beside the local encodings and
    # picks what JAX picks on the CPU profile; the solve still matches.
    x0 = np.random.default_rng(8).standard_normal((16, 16)).astype(
        np.float32)
    mesh = cpu_mesh((2, 4))
    tsv = T.Solver(T.laplace_jacobi(2), (16, 16), bc=1.0, rtol=1e-6,
                   check_every=12, max_iters=1200, device="cpu", tuned=None,
                   mesh=mesh)
    # JAX's Solver prices the same way: the whole solve, at the depth the
    # fused kernel would run a chunk at (a tuple mesh prices the tiling).
    pricing = JS.select_fuse("pallas_fused", J.laplace_jacobi(2), (16, 16),
                             12, device_kind="cpu", tuned=None)
    jb, jcosts = J.choose_backend(J.laplace_jacobi(2), (16, 16), bc=1.0,
                                  iters=1200, device_kind="cpu",
                                  mesh=(2, 4), fuse=pricing, tuned=None)
    assert "halo" in tsv.costs and tsv.backend == jb.replace("pallas",
                                                              "cuda")
    assert {k.replace("pallas", "cuda"): v for k, v in jcosts.items()} \
        == pytest.approx(tsv.costs, rel=1e-12)
    assert tsv.mesh_shape == (2, 4)
    d = T.solve(T.laplace_jacobi(2), x0, backend="halo", mesh=mesh, bc=1.0,
                rtol=1e-6, check_every=12, max_iters=1200, device="cpu",
                tuned=None)
    assert 12 % d.fuse == 0 and d.fuse * 1 <= min(16 // 2, 16 // 4)
    s = T.solve(T.laplace_jacobi(2), x0, backend="reference", bc=1.0,
                rtol=1e-6, check_every=12, max_iters=1200, device="cpu")
    assert d.iterations == s.iterations and torch.equal(d.x, s.x)


# The scaling bench's cells (benchmarks/scaling_bench.py): weak scaling at
# a 64x64 tile, strong scaling at 128x128 (32 iterations), the fuse sweep
# at 128x256 on 2x4 (16), the converged solve at 16x24 on 2x4 (16).
SCALING_CELLS = (
    [((64 * m[0], 64 * m[1]), m, 32)
     for m in ((1, 1), (1, 2), (2, 2), (2, 4))]
    + [((128, 128), m, 32) for m in ((1, 1), (1, 2), (2, 2), (2, 4))]
    + [((128, 256), (2, 4), 16), ((16, 24), (2, 4), 16),
       ((12, 17), (2, 4), 16), ((8, 8), (2, 2), 32)])


def test_halo_schedule_candidates_equal_jax():
    for spec, jspec in ((T.laplace_jacobi(2), J.laplace_jacobi(2)),
                        (T.star(2, [0.15, 0.05], center=0.2),
                         J.star(2, [0.15, 0.05], center=0.2))):
        for grid, mesh, iters in SCALING_CELLS:
            got = TA.halo_schedule_candidates(spec, grid, mesh, iters)
            want = JA.halo_schedule_candidates(jspec, grid, mesh, iters)
            assert [(c.backend, c.fuse) for c in got] == \
                [(c.backend, c.fuse) for c in want], (grid, mesh, iters)
    assert TA.HALO_FUSE_CANDIDATES == JA.HALO_FUSE_CANDIDATES


def test_autotune_halo_cell_records_the_mesh_and_table_keys_on_it():
    spec = T.laplace_jacobi(2)
    mesh = cpu_mesh((2, 4))
    table = TA.autotune_halo_cell(spec, (16, 32), mesh, iters=8, repeats=1,
                                  device="cpu")
    assert sorted(e.fuse for e in table.entries) == [1, 2, 4, 8]
    for e in table.entries:
        assert (e.backend, e.mesh, e.device_kind) == ("halo", (2, 4), "cpu")
        assert not e.interpreted and e.us_per_iter > 0
    assert TA.validate_table(table.to_json()) == []
    # mesh-exact: another tiling, or none, does not see the entries
    fam, dt = TA.spec_family(spec), TA.dtype_key(torch.float32)
    assert table.lookup("cpu", fam, (16, 32), dt, mesh_shape=(2, 4))
    assert table.lookup("cpu", fam, (16, 32), dt, mesh_shape=(2, 2)) is None
    assert table.lookup("cpu", fam, (16, 32), dt) is None
    # a halo entry must record its mesh, and a grid that cannot tile over
    # it is no legal cell: JAX's validation rules
    data = table.to_json()
    del data["entries"][0]["mesh"]
    assert any("must record the mesh" in e for e in TA.validate_table(data))
    assert TA.validate_table(data) == JA.validate_table(data)
    data = table.to_json()
    data["entries"][0]["mesh"] = [3, 4]
    assert any("does not tile" in e for e in TA.validate_table(data))
    # the tuned depth reaches the solver, clamped to the chunk
    sv = T.Solver(spec, (16, 32), backend="halo", bc=1.0, rtol=1e-6,
                  check_every=4, device="cpu", tuned=table, mesh=mesh)
    best = table.lookup("cpu", fam, (16, 32), dt, mesh_shape=(2, 4))
    assert sv.fuse == min(best.fuse, 4)
    cap = min(best.fuse, 6)      # the chunk's largest divisor under it
    assert TS.select_fuse("halo", spec, (16, 32), 6, "cpu", tuned=table,
                          mesh=mesh) == max(f for f in range(1, cap + 1)
                                            if 6 % f == 0)


def test_halo_modules_import_no_process_group():
    pkg = os.path.join(REPO, "src", "repro_torch")
    for d, _, fs in os.walk(pkg):
        for f in fs:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(d, f)).read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else
                         [node.module or ""]
                         if isinstance(node, ast.ImportFrom) else [])
                for n in names:
                    assert n != "repro" and not n.startswith(
                        ("torch.distributed", "jax", "repro.")), (f, n)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        sys.path.insert(0, {os.path.join(REPO, 'src')!r})
        import repro_torch.parallel, repro_torch.core.distributed
        print(sorted(m for m in sys.modules if sys.modules[m] is not None
                     and m.split(".")[0] in ("jax", "jaxlib", "repro")))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip() == "[]", out.stdout


def test_heat3d_example_runs_its_distributed_solve(capsys):
    import importlib.util
    path = os.path.join(REPO, "examples", "torch_heat3d.py")
    spec = importlib.util.spec_from_file_location("_torch_heat3d", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    dist, single = mod.main(["--device", "cpu", "--distributed", "--iters",
                             "3", "--tiles", "4", "--max-iters", "200"])
    assert dist.backend == "halo"
    np.testing.assert_array_equal(dist.iterations, single.iterations)
    assert torch.equal(dist.x, single.x)
    assert "distributed halo-exchange solve (mesh {'data': 2, 'model': 2}" \
        in capsys.readouterr().out


def test_mask_zones_equals_the_two_selections():
    # the line fills give what JAX's where(interior, acc, where(in_domain,
    # bc, 0)) gives, on regions inside, across and past the grid's edges
    rng = np.random.default_rng(9)
    H, W, bc = 12, 10, 0.7
    for row0, col0, nr, nc in [(3, 3, 4, 4), (-3, -2, 18, 15), (-1, 4, 3, 9),
                               (10, -1, 5, 3), (0, 0, 12, 10), (11, 9, 2, 2),
                               (-4, 2, 2, 3), (5, 1, 1, 8)]:
        acc = torch.tensor(rng.standard_normal((2, nr, nc)),
                           dtype=torch.float32)
        g = torch.arange(row0, row0 + nr)[:, None]
        c = torch.arange(col0, col0 + nc)[None, :]
        interior = (g >= 1) & (g < H - 1) & (c >= 1) & (c < W - 1)
        domain = (g >= 0) & (g < H) & (c >= 0) & (c < W)
        want = torch.where(interior, acc,
                           torch.where(domain, np.float32(bc), 0.0))
        got = TD._mask_zones(acc.clone(), bc, range(row0, row0 + nr),
                             range(col0, col0 + nc), H, W, torch.float32)
        assert torch.equal(got, want), (row0, col0, nr, nc)
