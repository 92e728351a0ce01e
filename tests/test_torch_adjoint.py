"""The port's differentiable solve (core/adjoint.py) against the JAX
package's, on the CPU.

Pinned as tests/solver/test_adjoint.py pins JAX's, and against JAX:

  * algebra — tap reflection is a true transpose (⟨Sx, u⟩ = ⟨x, S^T u⟩,
    in float64) and an involution; ``transpose_spec`` and
    ``transpose_fields`` equal JAX's bit for bit on the same numpy inputs;
  * forward — ``implicit_solve`` equals JAX's at a fixed iteration count
    (``rtol=None, atol=None``: the port sums residual norms in float64 and
    JAX in fp32, so converged solves may stop a chunk apart) within 1e-6;
  * gradients — ``torch.autograd.grad`` equals ``jax.grad`` of the same
    loss at fixed iterations within 1e-4 of the largest entry, and central
    finite differences of converged solves within JAX's TOL;
  * structure — x0's gradient is exactly zero, a batched gradient is the
    sum of the instances', a shared source's gradient sums the batch, the
    forward and adjoint solves share one bucket entry, and the kernel
    backends are refused.

Every solve runs on a CPU default plan cache, set per test and restored.
``exact`` runs each backend by name (no bucket: a pad ratio of at most 1),
``bucket`` on the bucketed entries a default cache gives (whose backend the
cache picks, as in JAX).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch.core import conv_encoding

GRID = (8, 9)
FIXED = dict(rtol=None, atol=None, max_iters=300)
CONVERGED = dict(rtol=1e-7, max_iters=4000)
GRAD_RTOL = 1e-4            # of the largest entry, against jax.grad
TOL = dict(rtol=1e-3, atol=2e-3)   # JAX's, against finite differences
EPS = 1e-2


@pytest.fixture(params=["bucket", "exact"])
def cache(request):
    kw = {"max_pad_ratio": 1.0} if request.param == "exact" else {}
    new = T.PlanCache(device="cpu", probe=False, **kw)
    old = T.set_default_plan_cache(new)
    yield new
    T.set_default_plan_cache(old)


@pytest.fixture
def bucket_cache():
    new = T.PlanCache(device="cpu", probe=False)
    old = T.set_default_plan_cache(new)
    yield new
    T.set_default_plan_cache(old)


def _rng(seed):
    return np.random.default_rng(20261017 + seed)


def _kappa(grid=GRID, seed=0):
    return 1.0 + 9.0 * _rng(seed).random(grid)


def _specs(name, grid=GRID):
    """(port spec, JAX spec) built from the same numpy values."""
    if name == "laplace":
        return T.laplace_jacobi(len(grid)), J.laplace_jacobi(len(grid))
    if name == "hetero":
        k = _kappa(grid)
        return T.heterogeneous_jacobi(k), J.heterogeneous_jacobi(k)
    if name == "asymmetric":   # a one-sided tap whose reflection is new
        f = {(1, 1): 0.1 + 0.05 * _rng(1).random(grid),
             (0, 1): 0.2 + 0.1 * _rng(2).random(grid)}
        return (T.variable_coefficient(T.laplace_jacobi(2), f),
                J.variable_coefficient(J.laplace_jacobi(2), f))
    if name == "hetero3d":
        k = _kappa((4, 5, 6))
        return T.heterogeneous_jacobi(k), J.heterogeneous_jacobi(k)
    raise KeyError(name)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _fd(f, x, idx, eps=EPS):
    """Central differences of scalar f at the entries ``idx`` of x."""
    x = np.asarray(x, np.float64)
    out = []
    for i in idx:
        xp, xm = x.copy(), x.copy()
        xp[i] += eps
        xm[i] -= eps
        out.append((f(_t(xp)) - f(_t(xm))) / (2 * eps))
    return np.array(out)


def _entries(shape, n, seed):
    """n distinct multi-indices of an array of ``shape``."""
    flat = _rng(seed).choice(int(np.prod(shape)), size=n, replace=False)
    return [np.unravel_index(int(i), shape) for i in flat]


def _close_to_largest(got, want, rtol=GRAD_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


# -- algebra -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["laplace", "hetero", "asymmetric"])
def test_pairing_identity(name):
    spec, _ = _specs(name)
    rng = _rng(3)
    x = torch.as_tensor(rng.standard_normal(GRID))
    u = torch.as_tensor(rng.standard_normal(GRID))
    lhs = torch.sum(T.apply_stencil(x, spec) * u)
    rhs = torch.sum(x * T.apply_stencil(u, T.transpose_spec(spec)))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)


@pytest.mark.parametrize("name", ["hetero", "asymmetric"])
def test_double_transpose_is_the_operator(name):
    # Fields round-trip up to their dead border entries (weights whose
    # reads fall outside the grid), so compare as operators.
    spec, _ = _specs(name)
    back = T.transpose_spec(T.transpose_spec(spec))
    assert [o for o, _ in back.taps] == [o for o, _ in spec.taps]
    x = torch.as_tensor(_rng(4).standard_normal(GRID), dtype=torch.float32)
    assert torch.equal(T.apply_stencil(x, spec), T.apply_stencil(x, back))


@pytest.mark.parametrize("name", ["laplace", "hetero", "asymmetric",
                                  "hetero3d"])
def test_transpose_spec_and_fields_equal_jax(name):
    spec, jspec = _specs(name)
    tspec, jt = T.transpose_spec(spec), J.transpose_spec(jspec)
    assert tspec.name == jt.name
    assert [o for o, _ in tspec.taps] == [o for o, _ in jt.taps]
    for (_, w), (_, jw) in zip(tspec.taps, jt.taps):
        if isinstance(w, T.WeightField):
            np.testing.assert_array_equal(w.array, jw.array)
        else:
            assert w == jw
    if not spec.is_variable:
        return
    # A random stack (not the baked one), in the forward spec's order.
    stack = _rng(5).standard_normal(spec.field_stack().shape)
    got = T.transpose_fields(spec, _t(stack))
    want = J.transpose_fields(jspec, _j(stack))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # ... which is the transposed spec's own stack for the baked values.
    np.testing.assert_array_equal(
        T.transpose_fields(spec, _t(spec.field_stack())).numpy(),
        tspec.field_stack())


def test_transpose_fields_is_differentiable():
    spec, _ = _specs("asymmetric")
    f = _t(spec.field_stack()).requires_grad_(True)
    w = torch.as_tensor(_rng(6).standard_normal((2, *GRID)),
                        dtype=torch.float32)
    (g,) = torch.autograd.grad(torch.sum(T.transpose_fields(spec, f) * w), f)
    # The adjoint of a permuted zero-filled shift: w shifted back.
    back = T.transpose_fields(T.transpose_spec(spec), w)
    mask = T.transpose_fields(T.transpose_spec(spec),
                              T.transpose_fields(spec, torch.ones_like(f)))
    assert torch.equal(g, back * mask)


# -- forward -------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["reference", "dense", "conv"])
def test_forward_equals_jax_at_fixed_iterations(cache, backend):
    spec, jspec = _specs("hetero")
    rng = _rng(7)
    fields = spec.field_stack()
    src = 0.1 * rng.standard_normal((2, *GRID))
    x0 = rng.standard_normal((2, *GRID))
    kw = dict(backend=backend, bc_value=0.5, **FIXED)
    got = T.implicit_solve(spec, _t(x0), fields=_t(fields), source=_t(src),
                           **kw)
    want = J.implicit_solve(jspec, _j(x0), fields=_j(fields),
                            source=_j(src), **kw)
    assert got.dtype == torch.float32 and got.shape == (2, *GRID)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_forward_is_the_masked_fixed_point(bucket_cache):
    # As JAX's test: hand-iterate the masked update with the oracle.
    spec, _ = _specs("hetero")
    src = _t(0.1 * _rng(8).standard_normal(GRID))
    out = T.implicit_solve(spec, torch.zeros(GRID), fields=_t(
        spec.field_stack()), source=src, backend="conv", **CONVERGED)
    x = torch.zeros(GRID)
    m = T.DirichletBC(0.0).interior_mask(GRID)
    for _ in range(4000):
        x = m * (T.apply_stencil(x, spec) + src)
    torch.testing.assert_close(out, x, rtol=0, atol=1e-5)


# -- gradients against jax.grad --------------------------------------------------

def _grad_case(case):
    """(port spec, JAX spec, grid, batch, {operand: numpy value}, wrt,
    backend)."""
    rng = _rng(9)
    hetero = _specs("hetero")
    b = (3, *GRID)
    if case == "fields":
        s = hetero[0]
        return (*hetero, GRID, 3, {"fields": s.field_stack(),
                                   "source": 0.3 * rng.standard_normal(b)},
                "fields")
    if case == "batched_source":
        return (*hetero, GRID, 3, {"source": 0.3 * rng.standard_normal(b),
                                   "bc_value": 0.5}, "source")
    if case == "shared_source":
        return (*hetero, GRID, 3, {"source": 0.3 * rng.standard_normal(GRID),
                                   "bc_value": 0.5}, "source")
    if case == "scalar_bc":
        return (*hetero, GRID, 3, {"fields": hetero[0].field_stack(),
                                   "bc_value": np.float32(0.7)}, "bc_value")
    if case == "grid_bc":
        return (*hetero, GRID, 3, {"bc_value": rng.standard_normal(GRID)},
                "bc_value")
    raise KeyError(case)


@pytest.mark.parametrize("backend", ["reference", "dense", "conv"])
@pytest.mark.parametrize("case", ["fields", "batched_source",
                                  "shared_source", "scalar_bc", "grid_bc"])
def test_grad_equals_jax_grad(cache, case, backend):
    spec, jspec, grid, batch, ops, wrt = _grad_case(case)
    rng = _rng(10)
    x0 = rng.standard_normal((batch, *grid))
    tgt = rng.standard_normal((batch, *grid))
    kw = dict(backend=backend, **FIXED)

    def jloss(v):
        x = J.implicit_solve(jspec, _j(x0), **kw,
                             **{**{k: _j(a) for k, a in ops.items()},
                                wrt: v})
        return jnp.sum((x - _j(tgt)) ** 2)

    v = _t(ops[wrt]).requires_grad_(True)
    x = T.implicit_solve(spec, _t(x0), **kw,
                         **{**{k: _t(a) for k, a in ops.items()}, wrt: v})
    loss = torch.sum((x - _t(tgt)) ** 2)
    (got,) = torch.autograd.grad(loss, v)
    want = jax.grad(jloss)(_j(ops[wrt]))
    assert got.shape == v.shape and got.dtype == torch.float32
    np.testing.assert_allclose(float(loss.detach()),
                               float(jloss(_j(ops[wrt]))),
                               rtol=1e-5)
    _close_to_largest(got.numpy(), np.asarray(want))


def test_grad_through_1d_dense_equals_jax(bucket_cache):
    spec, jspec, n = T.laplace_jacobi(1), J.laplace_jacobi(1), 17
    rng = _rng(11)
    tgt, s0 = rng.standard_normal(n), 0.3 * rng.standard_normal(n)
    kw = dict(backend="dense", **FIXED)

    def jloss(s):
        x = J.implicit_solve(jspec, jnp.zeros(n), source=s, **kw)
        return jnp.sum((x - _j(tgt)) ** 2)

    s = _t(s0).requires_grad_(True)
    loss = torch.sum((T.implicit_solve(spec, torch.zeros(n), source=s, **kw)
                      - _t(tgt)) ** 2)
    (got,) = torch.autograd.grad(loss, s)
    _close_to_largest(got.numpy(), np.asarray(jax.grad(jloss)(_j(s0))))


# -- gradients against finite differences ----------------------------------------

@pytest.mark.parametrize("backend", ["reference", "dense", "conv"])
@pytest.mark.parametrize("wrt", ["fields", "source", "bc_value"])
def test_grad_equals_central_differences(bucket_cache, wrt, backend):
    spec, _ = _specs("hetero")
    rng = _rng(12)
    tgt = _t(rng.standard_normal(GRID))
    ops = {"fields": spec.field_stack(),
           "source": 0.3 * rng.standard_normal(GRID),
           "bc_value": np.float32(0.7)}
    kw = dict(backend=backend, **CONVERGED)

    def solve(v):
        args = {k: _t(a) for k, a in ops.items()}
        args[wrt] = v
        return T.implicit_solve(spec, torch.zeros(GRID), **args, **kw)

    def loss(v):
        return float(torch.sum((solve(v) - tgt) ** 2))

    v = _t(ops[wrt]).requires_grad_(True)
    (got,) = torch.autograd.grad(torch.sum((solve(v) - tgt) ** 2), v)
    shape = np.shape(ops[wrt])
    idx = _entries(shape, 10, 13) if shape else [()]
    want = _fd(loss, ops[wrt], idx)
    np.testing.assert_allclose(
        np.array([float(got[i]) for i in idx]), want,
        **(TOL if shape else dict(rtol=1e-3)))


# -- structure -------------------------------------------------------------------

def test_x0_gradient_is_exactly_zero(bucket_cache):
    x0 = _t(_rng(14).standard_normal(GRID)).requires_grad_(True)
    x = T.implicit_solve(T.laplace_jacobi(2), x0, bc_value=1.0, rtol=1e-6,
                         max_iters=2000)
    (g,) = torch.autograd.grad(torch.sum(x ** 2), x0)
    assert g is not None and g.shape == x0.shape
    assert torch.equal(g, torch.zeros_like(x0))


def test_batched_grad_equals_per_instance_sum(bucket_cache):
    spec, _ = _specs("hetero")
    rng = _rng(15)
    srcs = _t(0.3 * rng.standard_normal((3, *GRID)))
    tgts = _t(rng.standard_normal((3, *GRID)))
    kw = dict(backend="conv", **CONVERGED)

    def grad(x0, src, tgt):
        f = _t(spec.field_stack()).requires_grad_(True)
        x = T.implicit_solve(spec, x0, fields=f, source=src, **kw)
        return torch.autograd.grad(torch.sum((x - tgt) ** 2), f)[0]

    batched = grad(torch.zeros((3, *GRID)), srcs, tgts)
    loop = sum(grad(torch.zeros(GRID), srcs[i], tgts[i]) for i in range(3))
    torch.testing.assert_close(batched, loop, rtol=2e-4, atol=1e-5)


def test_shared_source_grad_sums_over_batch(bucket_cache):
    src = _t(0.3 * _rng(16).standard_normal(GRID))
    kw = dict(rtol=1e-7, max_iters=2000)

    def grad(make):
        s = src.clone().requires_grad_(True)
        x = T.implicit_solve(T.laplace_jacobi(2), torch.zeros((4, *GRID)),
                             source=make(s), **kw)
        return torch.autograd.grad(torch.sum(x ** 2), s)[0]

    shared = grad(lambda s: s)
    summed = grad(lambda s: s.expand(4, *GRID))
    torch.testing.assert_close(shared, summed, rtol=1e-5, atol=1e-6)


def test_forward_and_adjoint_share_one_bucket_entry(bucket_cache):
    spec, _ = _specs("hetero", (12, 14))
    f = _t(spec.field_stack()).requires_grad_(True)
    x = T.implicit_solve(spec, torch.zeros((12, 14)), fields=f,
                         source=torch.ones((12, 14)), backend="conv",
                         rtol=1e-5, max_iters=200)
    torch.autograd.grad(torch.sum(x), f)
    # The 5-point reflection keeps the offset set: one entry, built once.
    assert len(bucket_cache) == 1
    assert bucket_cache.stats.misses == 1 and bucket_cache.stats.hits == 1
    (key,) = bucket_cache.keys()
    assert key[0] == "bucket" and key[2] == (16, 16)


def test_o1_memory_fixed_solve_equals_jax(bucket_cache):
    # 5000 fixed iterations differentiate through one adjoint solve: the
    # graph holds no iteration.
    grid, kw = (6, 6), dict(rtol=None, atol=None, max_iters=5000,
                            backend="conv")
    s0 = 0.3 * _rng(17).standard_normal(grid)
    s = _t(s0).requires_grad_(True)
    x = T.implicit_solve(T.laplace_jacobi(2), torch.zeros(grid), source=s,
                         **kw)
    solve_node = x.grad_fn.next_functions[0][0]    # under the squeeze
    assert type(solve_node).__name__ == "_SolveFPBackward"
    (got,) = torch.autograd.grad(torch.sum(x ** 2), s)
    want = jax.grad(lambda v: jnp.sum(J.implicit_solve(
        J.laplace_jacobi(2), jnp.zeros(grid), source=v, **kw) ** 2))(_j(s0))
    _close_to_largest(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", ["cuda", "cuda_fused", "pallas"])
def test_kernel_backends_are_refused(bucket_cache, backend):
    with pytest.raises(ValueError, match="differentiable"):
        T.implicit_solve(T.laplace_jacobi(2), torch.zeros(GRID),
                         backend=backend)


def test_operands_are_checked(bucket_cache):
    spec, _ = _specs("hetero")
    with pytest.raises(ValueError, match="fields operand must be shaped"):
        T.implicit_solve(spec, torch.zeros(GRID),
                         fields=torch.zeros((3, *GRID)))
    with pytest.raises(ValueError, match="incompatible"):
        T.implicit_solve(spec, torch.zeros((1, 1, *GRID)))
    # A tensor off the cache's device raises: nothing is copied quietly.
    with pytest.raises(ValueError, match="plan cache runs on cpu"):
        T.implicit_solve(spec, torch.zeros(GRID, device="meta"))
    with pytest.raises(ValueError, match="source is on meta"):
        T.implicit_solve(spec, torch.zeros(GRID),
                         source=torch.zeros(GRID, device="meta"))
    # numpy operands are placed on the cache's device.
    x = T.implicit_solve(spec, np.zeros(GRID, np.float32),
                         source=np.ones(GRID, np.float32), rtol=1e-5)
    assert x.device.type == "cpu" and x.shape == GRID


def test_auto_backend_is_differentiable(bucket_cache):
    for nd, grid in ((1, (33,)), (2, GRID), (3, (4, 5, 6))):
        out = T.implicit_solve(T.laplace_jacobi(nd), torch.zeros(grid),
                               bc_value=1.0, rtol=1e-6)
        want = J.implicit_solve(J.laplace_jacobi(nd), jnp.zeros(grid),
                                bc_value=1.0, rtol=1e-6)
        assert out.shape == grid
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4)


# -- conv_var_jacobi's kernels, split once -----------------------------------------

def test_conv_var_jacobi_caches_its_kernels_bit_equal():
    spec, _ = _specs("asymmetric")
    rng = _rng(18)
    x0 = _t(rng.standard_normal((2, *GRID)))
    src = _t(0.1 * rng.standard_normal(GRID))
    fields = _t(spec.field_stack() * 1.5)
    bc = T.DirichletBC(0.5)

    def uncached(fields):
        # The loop as it was: split and upload on every call.
        scalar_k, gather_k, baked = map(torch.as_tensor,
                                        T.split_var_kernels(spec))
        f = (baked if fields is None else fields)[None]
        x, mask, drive = conv_encoding._seed_and_drive(
            GRID, bc, None, src, torch.float32, x0)
        x, mask, drive = x[:, None], mask[None, None], drive[:, None]
        pad = conv_encoding._padding(spec)
        for _ in range(20):
            y = conv_encoding.conv2d_apply(x, scalar_k, pad)
            g = conv_encoding.conv2d_apply(x, gather_k, pad)
            x = (y + torch.sum(g * f, dim=1, keepdim=True)) * mask + drive
        return x[:, 0]

    for fl in (None, fields):
        before = conv_encoding._var_kernels.cache_info()
        a = T.conv_var_jacobi(x0, spec, bc, 20, fields=fl, source=src)
        b = T.conv_var_jacobi(x0, spec, bc, 20, fields=fl, source=src)
        after = conv_encoding._var_kernels.cache_info()
        assert after.hits >= before.hits + 1
        assert torch.equal(a, b) and torch.equal(a, uncached(fl))
