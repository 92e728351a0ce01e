"""Shared plan/solver cache: the serving tier's artifact store.

The JAX package's ``core/plan_cache.py``.  There the expensive artifact is
a compiled ``Solver`` loop; here a ``Solver`` compiles nothing, but building
one still costs a backend choice, a probe, constants and baked fields on
the device, and on the card the first call of a cuDNN shape.  ``PlanCache``
admits solves through a bounded LRU cache keyed so that *near-miss*
requests reuse an already-built solver.

Two entry kinds:

* **Bucketed** entries (the default for masked Dirichlet solves) are keyed
  by ``autotune``'s canonicalization (the tap-offset signature of the spec,
  not its weight values, and the power-of-two ``shape_bucket`` of the grid)
  and hold one Solver built on the *bucket* shape with every tap lifted to
  a runtime ``WeightField`` operand.  A request on any member shape executes
  by embedding its problem in the bucket grid ("pad-to-bucket"):

    - tap weights are streamed as the ``fields`` operand: the request's
      weights at original-interior cells, zero everywhere else;
    - original-*shell* cells that are not on the padded outer ring have zero
      weights, so pinning them to the Dirichlet value rides the ``source``
      operand; shell cells that do land on the ring ride the ``bc_value``
      grid operand;
    - padding ("junk") cells have zero weights, zero source, zero init:
      they stay exactly 0.0 through every iteration, read as the same zeros
      an unpadded plan's zero-filled boundary reads would produce, and
      contribute exact zeros to both residual norms.

  The padded solve therefore reproduces the unpadded solve on the same
  arithmetic: field, iteration counts, convergence decisions, residual
  history, for any tap radius.  (The cached path seeds ``x0``'s shell with
  the boundary value before the loop, as every plan does internally.  A
  backend that sums a scalar spec's taps in another order than the lifted
  template's, as cuDNN may for ``conv``, can move the field by an ulp; the
  solver's float64 norms keep the convergence decisions.)

  Scalar-weight variations of one operator family share a single solver,
  as do all shapes in a bucket and all Dirichlet values.  The backend for a
  bucket entry is chosen by a short *measured probe* over the
  operand-capable backends (CUDA events on the card); the probe never
  writes to the tuned table.

* **Exact** entries fall back to a Solver keyed by the full request (spec,
  exact shape, backend, bc, mode, ...) when the request cannot ride the
  embedding: MATRIX mode (dense), ``bc=None`` raw application, array-valued
  static BCs, the CUDA kernel backends (no ``source`` operand, as the
  Pallas paths have none), or a pad ratio above ``max_pad_ratio``.
  Multigrid hierarchies cache the same way via :meth:`PlanCache.multigrid`.

Stats (hits / misses / evictions / rebuilds / build seconds) are surfaced
on the cache object; corrupt entries are evicted and rebuilt once.  The
module-level :func:`default_plan_cache` is the process-wide instance that
``serve.engine`` shares.  A cache lives on one device (None: the card).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.boundary import BoundaryMode, DirichletBC
from repro_torch.core.plan import resolve_device
from repro_torch.core.stencil import StencilSpec, WeightField

# Backends whose plans take the full runtime-operand signature the embedding
# streams (fields + source + bc_value), per spec rank.  Dense is excluded
# (MATRIX-mode semantics), the CUDA kernels bake the BC and take no source.
_PAD_BACKENDS = {
    1: ("reference",),
    2: ("reference", "conv"),
    3: ("reference", "conv3d_native"),
}


@dataclasses.dataclass
class CacheStats:
    """Counters surfaced on a :class:`PlanCache`.

    ``probe_dropped`` counts probe candidates that raised and were skipped
    (the JAX package skips them silently): on the card a nonzero count is a
    kernel or library path that failed.
    """

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    rebuilds: int = 0
    compile_seconds: float = 0.0
    probe_seconds: float = 0.0
    probe_dropped: int = 0

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "rebuilds": self.rebuilds,
                "compile_seconds": self.compile_seconds,
                "probe_seconds": self.probe_seconds,
                "probe_dropped": self.probe_dropped,
                "hit_rate": self.hit_rate}


@dataclasses.dataclass
class _Entry:
    kind: str              # "bucket" | "exact" | "multigrid"
    key: tuple
    obj: object            # Solver or Multigrid
    backend: str
    bucket: tuple | None
    compile_seconds: float


def _bc_key(bc):
    """Hashable identity of a static BC (scalar, array, DirichletBC, None)."""
    if bc is None:
        return None
    if isinstance(bc, DirichletBC):
        bc = bc.value
    if isinstance(bc, (int, float)):
        return ("s", float(bc))
    arr = np.asarray(bc.cpu() if isinstance(bc, torch.Tensor) else bc)
    return ("a", arr.shape, arr.tobytes())


def _bc_scalar(bc) -> float | None:
    """The scalar Dirichlet value, or None if bc is not a plain scalar."""
    if isinstance(bc, DirichletBC):
        bc = bc.value
    if isinstance(bc, (int, float)):
        return float(bc)
    return None


class CachedSolver:
    """Handle to one cached Solver, adapted to the caller's request.

    ``solve``/``run`` mirror :class:`core.solver.Solver`.  For a bucketed
    entry both embed the request in the bucket grid (module docstring) and
    slice the result back to the original shape; for an exact entry they
    delegate directly.  A call that blows up inside the cached object evicts
    and rebuilds the entry once before re-raising.
    """

    def __init__(self, cache: "PlanCache", entry: _Entry, builder,
                 spec: StencilSpec, grid_shape: tuple[int, ...], dtype,
                 bc_scalar: float | None):
        self._cache = cache
        self._entry = entry
        self._builder = builder
        self.spec = spec
        self.grid_shape = tuple(grid_shape)
        self.dtype = dtype
        self.padded = entry.kind == "bucket"
        self.bucket = entry.bucket
        self.backend = entry.backend
        self._static_bc = bc_scalar
        if self.padded:
            self._prepare_embedding()

    # -- embedding constants (built once, on the cache's device) -----------

    def _prepare_embedding(self):
        orig, bucket = self.grid_shape, self.bucket
        self._embed = tuple(slice(0, n) for n in orig)

        mask_o = np.zeros(orig, np.float32)
        mask_o[tuple(slice(1, -1) for _ in orig)] = 1.0
        shell_o = 1.0 - mask_o
        ring_p = np.ones(bucket, np.float32)
        ring_p[tuple(slice(1, -1) for _ in bucket)] = 0.0
        shell_embed = np.zeros(bucket, np.float32)
        shell_embed[self._embed] = shell_o

        # Template tap order == the request spec's canonical tap order (both
        # are sorted by offset), so row k of the fields operand is tap k.
        base = np.zeros((len(self.spec.taps),) + bucket, np.float32)
        var_idx = []
        for k, (off, w) in enumerate(self.spec.taps):
            if isinstance(w, WeightField):
                var_idx.append(k)
                w_o = w.array
            else:
                w_o = np.full(orig, float(w), np.float32)
            base[k][self._embed] = w_o * mask_o
        self._var_idx = tuple(var_idx)

        dev, dt = self._cache.device, self.dtype

        def const(a):
            return torch.as_tensor(a, device=dev).to(dt)

        self._mask_o = const(mask_o)
        self._shell_o = const(shell_o)
        self._pin_nonring = const(shell_embed * (1.0 - ring_p))
        self._pin_ring = const(shell_embed * ring_p)
        self._base_fields = const(base)

    def _padded_operands(self, x0, fields, source, bc_value):
        """(x0p, fields, source, bc_value, squeeze) on the bucket grid, as
        tensors on the cache's device."""
        nd = self.spec.ndim
        dev, dt = self._cache.device, self.dtype
        x0 = torch.as_tensor(x0, device=dev).to(dt)
        squeeze = x0.ndim == nd
        if squeeze:
            x0 = x0[None]
        if tuple(x0.shape[1:]) != self.grid_shape:
            raise ValueError(
                f"cached solver built for grid {self.grid_shape}, got "
                f"{tuple(x0.shape[1:])}")
        b = x0.shape[0]
        batch_embed = (slice(None),) + self._embed

        v = torch.as_tensor(self._static_bc if bc_value is None else bc_value,
                            device=dev).to(dt)
        if v.ndim not in (0, nd):
            raise ValueError(
                f"bc_value must be a scalar or a {nd}D grid, got shape "
                f"{tuple(v.shape)}")
        pinned = torch.broadcast_to(v, self.grid_shape) * self._shell_o
        pin_embed = torch.zeros(self.bucket, dtype=dt, device=dev)
        pin_embed[self._embed] = pinned

        x0p = torch.zeros((b,) + self.bucket, dtype=dt, device=dev)
        x0p[batch_embed] = x0 * self._mask_o + pinned

        F = self._base_fields
        if fields is not None:
            fields = torch.as_tensor(fields, device=dev).to(dt)
            want = (len(self._var_idx), *self.grid_shape)
            if tuple(fields.shape) != want:
                raise ValueError(
                    f"fields operand must be shaped {want}, got "
                    f"{tuple(fields.shape)}")
            F = F.clone()
            for row, k in enumerate(self._var_idx):
                F[(k,) + self._embed] = fields[row] * self._mask_o

        src_p = pin_embed * self._pin_nonring
        if source is not None:
            s = torch.as_tensor(source, device=dev).to(dt)
            if s.ndim == nd:
                sp = torch.zeros(self.bucket, dtype=dt, device=dev)
                sp[self._embed] = s * self._mask_o
            elif s.ndim == nd + 1:
                sp = torch.zeros((s.shape[0],) + self.bucket, dtype=dt,
                                 device=dev)
                sp[batch_embed] = s * self._mask_o
            else:
                raise ValueError(
                    f"source must be (*grid) or (batch, *grid), got shape "
                    f"{tuple(s.shape)}")
            src_p = sp + src_p

        return x0p, F, src_p, pin_embed * self._pin_ring, squeeze

    # -- degradation: evict + rebuild a corrupt entry once -----------------

    def _attempt(self, fn):
        try:
            return fn(self._entry.obj)
        except Exception:
            self._entry = self._cache._replace(self._entry.key, self._builder)
            self.backend = self._entry.backend
            return fn(self._entry.obj)

    # -- public API --------------------------------------------------------

    def run(self, x0, *, fields=None, source=None, bc_value=None):
        """``(x, iterations, converged, residual)`` as device tensors."""
        if not self.padded:
            return self._attempt(lambda s: s.run(
                x0, fields=fields, source=source, bc_value=bc_value))
        x0p, F, src, bcg, squeeze = self._padded_operands(
            x0, fields, source, bc_value)
        x, iters, conv, res = self._attempt(lambda s: s.run(
            x0p, fields=F, source=src, bc_value=bcg))
        x = x[(slice(None),) + self._embed]
        if squeeze:
            return x[0], iters[0], conv[0], res[0]
        return x, iters, conv, res

    def solve(self, x0, *, fields=None, source=None, bc_value=None):
        """Run the cached time loop; returns a ``SolveResult``."""
        if not self.padded:
            return self._attempt(lambda s: s.solve(
                x0, fields=fields, source=source, bc_value=bc_value))
        x0p, F, src, bcg, squeeze = self._padded_operands(
            x0, fields, source, bc_value)
        res = self._attempt(lambda s: s.solve(
            x0p, fields=F, source=src, bc_value=bcg))
        x = res.x[(slice(None),) + self._embed]
        if squeeze:
            return dataclasses.replace(
                res, x=x[0], iterations=int(res.iterations[0]),
                converged=bool(res.converged[0]),
                residual=float(res.residual[0]),
                residual_history=res.residual_history[:, 0])
        return dataclasses.replace(res, x=x)

    __call__ = solve


class PlanCache:
    """Bounded LRU cache of built Solver / Multigrid artifacts on one device.

    Args:
      capacity: max cached entries; the least-recently-used is evicted.
      max_pad_ratio: bucketed requests whose bucket volume exceeds this
        multiple of the request volume degrade to an exact entry.
      probe: time the operand-capable backends per bucket cell (a few short
        plan calls, once per cell) instead of trusting the analytic
        roofline.  Probe time counts toward ``compile_seconds``.
      probe_iters: iterations per probe measurement.
      tuned: tuned-table handle forwarded to Solver construction ("default"
        = the committed TUNED_stencil_cuda.json); consulted, never written.
      device: where every entry runs; None means the card.
    """

    def __init__(self, capacity: int = 32, *, max_pad_ratio: float = 4.0,
                 probe: bool = True, probe_iters: int = 8, tuned="default",
                 device=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.max_pad_ratio = float(max_pad_ratio)
        self.probe = bool(probe)
        self.probe_iters = int(probe_iters)
        self.tuned = tuned
        self.device = resolve_device(device)
        self.stats = CacheStats()
        self._entries: OrderedDict[tuple, _Entry] = OrderedDict()
        self._building: dict[tuple, threading.Event] = {}
        self._probe_winners: dict[tuple, str] = {}
        self._lock = threading.RLock()

    # -- bookkeeping -------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def keys(self) -> list[tuple]:
        with self._lock:
            return list(self._entries)

    def _acquire(self, key: tuple, build) -> _Entry:
        """Entry for ``key``, building under a per-key latch on miss."""
        for _ in range(2):
            with self._lock:
                ent = self._entries.get(key)
                if ent is not None:
                    self._entries.move_to_end(key)
                    self.stats.hits += 1
                    return ent
                self.stats.misses += 1
                latch = self._building.get(key)
                if latch is None:
                    latch = threading.Event()
                    self._building[key] = latch
                    building = True
                else:
                    building = False
            if not building:
                latch.wait(timeout=600.0)
                with self._lock:
                    ent = self._entries.get(key)
                    if ent is not None:
                        self._entries.move_to_end(key)
                        return ent
                continue  # builder failed; retry (possibly becoming builder)
            try:
                ent = build()
            finally:
                with self._lock:
                    self._building.pop(key, None)
                latch.set()
            self._insert(ent)
            return ent
        raise RuntimeError(f"plan-cache build for {key!r} failed repeatedly")

    def _insert(self, ent: _Entry) -> None:
        with self._lock:
            self._entries[ent.key] = ent
            self._entries.move_to_end(ent.key)
            self.stats.compile_seconds += ent.compile_seconds
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.stats.evictions += 1

    def _replace(self, key: tuple, build) -> _Entry:
        """Evict ``key`` and rebuild it (corrupt-entry degradation)."""
        with self._lock:
            self._entries.pop(key, None)
            self.stats.rebuilds += 1
        ent = build()
        self._insert(ent)
        return ent

    # -- backend choice for bucket cells -----------------------------------

    def _template(self, offsets, bucket) -> StencilSpec:
        taps = {off: WeightField(np.zeros(bucket, np.float32))
                for off in offsets}
        return StencilSpec(taps=taps, name=f"cache_template_{len(offsets)}t")

    def _bucket_backend(self, template: StencilSpec, bucket, dtype) -> str:
        from repro_torch.core import autotune
        from repro_torch.core.plan import (DEVICE_PROFILES, backend_support,
                                           estimate_seconds, make_plan)
        nd = template.ndim
        cands = [b for b in _PAD_BACKENDS.get(nd, ("reference",))
                 if backend_support(b, template, grid_shape=bucket,
                                    mode=BoundaryMode.MASK,
                                    bc=DirichletBC(0.0))]
        if not cands:
            return "reference"
        if len(cands) == 1:
            return cands[0]
        offsets = tuple(off for off, _ in template.taps)
        memo_key = (offsets, tuple(bucket), autotune.dtype_key(dtype))
        with self._lock:
            if memo_key in self._probe_winners:
                return self._probe_winners[memo_key]

        if not self.probe:
            entry = autotune.lookup_entry(self.tuned, template, bucket, dtype,
                                          self.device)
            if entry is not None and entry.backend in cands:
                return entry.backend
            device = DEVICE_PROFILES[self.device.type]
            return min(cands, key=lambda b: estimate_seconds(
                b, template, tuple(bucket), 100, device))

        # Measured probe: a short var-operand plan per candidate, timed
        # after one warmup (the warmup absorbs one-time set-up).
        t_probe = time.perf_counter()
        dev = self.device
        fields = torch.as_tensor(template.field_stack(), device=dev).to(dtype)
        x = torch.zeros((1,) + tuple(bucket), dtype=dtype, device=dev)
        src = torch.zeros(tuple(bucket), dtype=dtype, device=dev)
        bcg = torch.zeros(tuple(bucket), dtype=dtype, device=dev)
        best, best_t = cands[0], float("inf")
        for cand in cands:
            try:
                plan = make_plan(template, tuple(bucket), backend=cand,
                                 bc=DirichletBC(0.0), mode=BoundaryMode.MASK,
                                 iters=self.probe_iters, dtype=dtype,
                                 device=dev, tuned=None)
                dt_c = autotune._median_seconds(
                    lambda v: plan(v, fields=fields, source=src,
                                   bc_value=bcg), x, repeats=1)
            except Exception:
                with self._lock:
                    self.stats.probe_dropped += 1
                continue
            if dt_c < best_t:
                best, best_t = cand, dt_c
        with self._lock:
            self.stats.probe_seconds += time.perf_counter() - t_probe
            self._probe_winners[memo_key] = best
        return best

    # -- entry builders ----------------------------------------------------

    def _build_bucket(self, key, offsets, bucket, dtype, cfg) -> _Entry:
        from repro_torch.core.solver import Solver
        rtol, atol, norm, check_every, max_iters = cfg
        t0 = time.perf_counter()
        template = self._template(offsets, bucket)
        backend = self._bucket_backend(template, bucket, dtype)
        solver = Solver(
            template, bucket, backend=backend, bc=DirichletBC(0.0),
            mode=BoundaryMode.MASK, rtol=rtol, atol=atol, norm=norm,
            check_every=check_every, max_iters=max_iters, dtype=dtype,
            device=self.device, tuned=self.tuned)
        return _Entry(kind="bucket", key=key, obj=solver, backend=backend,
                      bucket=tuple(bucket),
                      compile_seconds=time.perf_counter() - t0)

    def _build_exact(self, key, spec, grid_shape, dtype, backend, bc, mode,
                     cfg, fuse) -> _Entry:
        from repro_torch.core.solver import Solver
        rtol, atol, norm, check_every, max_iters = cfg
        t0 = time.perf_counter()
        solver = Solver(
            spec, grid_shape, backend=backend, bc=bc, mode=mode, rtol=rtol,
            atol=atol, norm=norm, check_every=check_every,
            max_iters=max_iters, fuse=fuse, dtype=dtype, device=self.device,
            tuned=self.tuned)
        return _Entry(kind="exact", key=key, obj=solver,
                      backend=solver.backend, bucket=None,
                      compile_seconds=time.perf_counter() - t0)

    # -- public API --------------------------------------------------------

    def solver(
        self,
        spec: StencilSpec,
        grid_shape: tuple[int, ...],
        *,
        dtype=torch.float32,
        backend: str = "auto",
        bc: DirichletBC | float | None = 0.0,
        mode: BoundaryMode = BoundaryMode.MASK,
        rtol: float | None = 1e-5,
        atol: float | None = 0.0,
        norm: str = "l2",
        check_every: int | None = None,
        max_iters: int = 10_000,
        fuse: int | None = None,
    ) -> CachedSolver:
        """A :class:`CachedSolver` for this request (building on miss).

        Masked scalar-Dirichlet requests on an operand-capable backend ride
        a bucketed entry (module docstring): every shape in the power-of-two
        bucket, every scalar-weight variation of the tap-offset family, and
        every Dirichlet value share one solver.  Everything else, and
        bucketed requests whose padding overhead exceeds ``max_pad_ratio``,
        gets an exact entry keyed by the full request.
        """
        from repro_torch.core import autotune
        grid_shape = tuple(int(n) for n in grid_shape)
        if spec.ndim != len(grid_shape):
            raise ValueError(
                f"spec is {spec.ndim}D but grid is {len(grid_shape)}D")
        cfg = (rtol, atol, norm, check_every, max_iters)
        dkey = autotune.dtype_key(dtype)
        bc_scalar = _bc_scalar(bc)

        bucket = autotune.shape_bucket(grid_shape)
        pad_ratio = float(np.prod(bucket)) / max(float(np.prod(grid_shape)), 1)
        bucketable = (
            mode is BoundaryMode.MASK
            and bc is not None and bc_scalar is not None
            and (backend == "auto"
                 or backend in _PAD_BACKENDS.get(spec.ndim, ()))
            and pad_ratio <= self.max_pad_ratio
        )

        if bucketable:
            offsets = tuple(off for off, _ in spec.taps)
            key = ("bucket", offsets, bucket, dkey, backend, cfg)
            builder = lambda: self._build_bucket(  # noqa: E731
                key, offsets, bucket, dtype, cfg)
        else:
            key = ("exact", spec, grid_shape, dkey, backend, _bc_key(bc),
                   mode, cfg, fuse)
            builder = lambda: self._build_exact(  # noqa: E731
                key, spec, grid_shape, dtype, backend, bc, mode, cfg, fuse)
        entry = self._acquire(key, builder)
        return CachedSolver(self, entry, builder, spec, grid_shape, dtype,
                            bc_scalar)

    def solve(self, spec: StencilSpec, x0, **kwargs):
        """One-shot cached solve: ``core.solver.solve`` through the cache.

        Solve-time operands (``fields``/``source``/``bc_value``) pass
        through; everything else configures :meth:`solver`.
        """
        operands = {k: kwargs.pop(k, None)
                    for k in ("fields", "source", "bc_value")}
        x0 = torch.as_tensor(x0)
        if x0.ndim not in (spec.ndim, spec.ndim + 1):
            raise ValueError(
                f"x0.ndim={x0.ndim} incompatible with a {spec.ndim}D spec "
                f"(expect grid or batch+grid)")
        grid_shape = tuple(x0.shape[-spec.ndim:])
        if "dtype" not in kwargs and x0.is_floating_point():
            kwargs["dtype"] = x0.dtype
        return self.solver(spec, grid_shape, **kwargs).solve(x0, **operands)

    def multigrid(self, spec: StencilSpec, grid_shape: tuple[int, ...],
                  **kwargs):
        """A cached :class:`core.multigrid.Multigrid` hierarchy.

        Exact-keyed (hierarchies bake their level shapes); shares the LRU
        store and stats with the solver entries.
        """
        from repro_torch.core.multigrid import Multigrid
        grid_shape = tuple(int(n) for n in grid_shape)
        bc = kwargs.get("bc", 0.0)
        key = ("multigrid", spec, grid_shape, _bc_key(bc),
               tuple(sorted((k, v) for k, v in kwargs.items() if k != "bc")))

        def builder():
            t0 = time.perf_counter()
            mg = Multigrid(spec, grid_shape, device=self.device, **kwargs)
            return _Entry(kind="multigrid", key=key, obj=mg,
                          backend=mg.backend, bucket=None,
                          compile_seconds=time.perf_counter() - t0)

        return self._acquire(key, builder).obj


# ---------------------------------------------------------------------------
# Process-wide default instance (shared by serve.engine)
# ---------------------------------------------------------------------------

_default_cache: PlanCache | None = None
_default_lock = threading.Lock()


def default_plan_cache() -> PlanCache:
    """The process-wide shared cache (created on first use on the card,
    capacity 64)."""
    global _default_cache
    with _default_lock:
        if _default_cache is None:
            _default_cache = PlanCache(capacity=64)
        return _default_cache


def set_default_plan_cache(cache: PlanCache | None) -> PlanCache | None:
    """Swap the process-wide cache (pass None to reset); returns the old one."""
    global _default_cache
    with _default_lock:
        old, _default_cache = _default_cache, cache
        return old
