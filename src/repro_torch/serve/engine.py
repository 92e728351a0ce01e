"""Async stencil-solve serving engine: coalescing, admission control, fan-out.

The JAX package's ``serve/engine.py`` on the port's plan cache.

The serving shape of the paper's workflow is compile-once/solve-many: the
compiled solver loop is the expensive artifact, and throughput comes from
streaming as many requests as possible through each compiled dispatch.  The
engine implements that in three layers:

* **Admission control** — a bounded queue.  ``submit`` rejects immediately
  with :class:`RejectedError` (carrying a reason) once ``max_queue``
  requests are pending, so overload produces fast feedback instead of
  unbounded latency.

* **Coalescing** — the dispatcher drains the queue into batches of up to
  ``max_batch`` requests, waiting at most ``max_wait`` seconds for
  stragglers, then groups them by compatibility: same operator (spec), grid
  shape, dtype, Dirichlet value, and convergence configuration.  Each group
  runs as ONE batched ``solve()`` on the shared plan cache — per-request
  ``x0`` (and optional per-request ``source``) stack on the instance axis,
  and per-instance convergence freezing guarantees each request gets exactly
  the result it would have gotten alone.  While a batch executes on device,
  new arrivals accumulate in the queue, so sustained load batches naturally.

* **Fan-out** — each request's future resolves to its own per-instance
  :class:`core.solver.SolveResult` (its slice of the field, iteration count,
  convergence flag, residual history column); its field stays on the
  cache's device.

``method="multigrid"`` routes a request through the same cache's
:meth:`PlanCache.multigrid` entries (hierarchies don't batch — they run
serially within the dispatch) and resolves to an ``MGResult``.

Typical use::

    async with ServingEngine(max_batch=16, max_wait=0.01) as eng:
        results = await asyncio.gather(
            *(eng.submit(spec, x0, bc=1.0, rtol=1e-6) for x0 in problems))
"""
from __future__ import annotations

import asyncio
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core.plan_cache import PlanCache, default_plan_cache
from repro_torch.core.solver import SolveResult
from repro_torch.core.stencil import StencilSpec


class RejectedError(RuntimeError):
    """A request was refused admission; ``reason`` says why."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


@dataclasses.dataclass
class EngineStats:
    """Counters surfaced on :attr:`ServingEngine.stats`."""

    accepted: int = 0
    rejected: int = 0
    completed: int = 0
    failed: int = 0
    batches: int = 0
    coalesced: int = 0    # requests that shared a batched dispatch
    max_batch: int = 0

    @property
    def mean_batch(self) -> float:
        return self.completed / self.batches if self.batches else 0.0

    def as_dict(self) -> dict:
        return {"accepted": self.accepted, "rejected": self.rejected,
                "completed": self.completed, "failed": self.failed,
                "batches": self.batches, "coalesced": self.coalesced,
                "max_batch": self.max_batch, "mean_batch": self.mean_batch}


@dataclasses.dataclass
class _Request:
    spec: StencilSpec
    x0: object
    source: object
    method: str
    group_key: tuple
    solver_kwargs: dict
    future: asyncio.Future


class ServingEngine:
    """Coalescing solve server over a shared :class:`PlanCache`.

    Args:
      cache: plan cache to route through (default: the process-wide
        :func:`default_plan_cache`).
      max_batch: most requests one batched dispatch carries.
      max_wait: seconds the dispatcher waits for stragglers after the first
        request of a batch arrives.
      max_queue: pending-request bound; submissions beyond it are rejected.

    Use as an async context manager, or call :meth:`start`/:meth:`stop`.
    Blocking solver work runs on a single worker thread so the event loop
    stays responsive while solves execute; on the card that thread issues
    the CUDA work on the default stream, and a result reaches the event
    loop only after ``Solver.solve``'s final device sync.
    """

    def __init__(self, cache: PlanCache | None = None, *, max_batch: int = 16,
                 max_wait: float = 0.01, max_queue: int = 64):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self.cache = cache if cache is not None else default_plan_cache()
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait)
        self.max_queue = int(max_queue)
        self.stats = EngineStats()
        self._queue: asyncio.Queue[_Request] | None = None
        self._pending = 0          # admitted but not yet resolved
        self._task: asyncio.Task | None = None
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="stencil-serve")
        self._paused: asyncio.Event | None = None

    # -- lifecycle ---------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._task is not None and not self._task.done()

    async def start(self) -> "ServingEngine":
        if self.running:
            return self
        self._queue = asyncio.Queue()
        self._paused = asyncio.Event()
        self._paused.set()
        self._task = asyncio.get_running_loop().create_task(self._dispatch())
        return self

    async def stop(self, drain: bool = True) -> None:
        """Stop dispatching.  ``drain=True`` finishes queued work first;
        otherwise queued requests are rejected."""
        if not self.running:
            return
        if drain:
            self._paused.set()
            while self._pending:
                await asyncio.sleep(0.005)
        self._task.cancel()
        try:
            await self._task
        except asyncio.CancelledError:
            pass
        while not self._queue.empty():
            req = self._queue.get_nowait()
            if not req.future.done():
                self.stats.rejected += 1
                req.future.set_exception(RejectedError("engine stopped"))
        self._task = None

    async def __aenter__(self) -> "ServingEngine":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop(drain=exc[0] is None)

    def pause(self) -> None:
        """Hold the dispatcher (requests queue up; admission still applies)."""
        self._paused.clear()

    def resume(self) -> None:
        self._paused.set()

    # -- submission --------------------------------------------------------

    async def submit(
        self,
        spec: StencilSpec,
        x0,
        *,
        bc: float = 0.0,
        source=None,
        method: str = "jacobi",
        backend: str = "auto",
        dtype=torch.float32,
        rtol: float | None = 1e-5,
        atol: float | None = 0.0,
        norm: str = "l2",
        check_every: int | None = None,
        max_iters: int = 10_000,
        **method_kwargs,
    ):
        """Queue one solve; awaits its per-request result.

        ``x0`` is one bare grid (requests batch on the instance axis — to
        solve a pre-batched stack, submit its instances individually and
        gather).  ``bc`` must be a scalar (the group's shared Dirichlet
        value); ``source`` may differ per request.  ``method="jacobi"``
        resolves to a :class:`SolveResult`, ``method="multigrid"`` to an
        ``MGResult`` (extra ``method_kwargs`` reach the ``Multigrid``
        constructor).  Raises :class:`RejectedError` when the queue is full
        or the engine is stopped.
        """
        if method not in ("jacobi", "multigrid"):
            raise ValueError(f"unknown method {method!r}")
        if not isinstance(bc, (int, float)):
            raise ValueError("engine requests need a scalar Dirichlet value")
        if not self.running:
            raise RejectedError("engine is not running")
        if self._pending >= self.max_queue:
            self.stats.rejected += 1
            raise RejectedError(
                f"queue full ({self._pending} pending >= max_queue="
                f"{self.max_queue})")

        # A tensor stays a tensor (any dtype, any device): the group's stack
        # takes it to the cache's device in one copy.
        if not isinstance(x0, torch.Tensor):
            x0 = np.asarray(x0)
        if x0.ndim != spec.ndim:
            raise ValueError(
                f"x0 must be one bare {spec.ndim}D grid, got shape "
                f"{tuple(x0.shape)}")
        grid_shape = tuple(x0.shape)
        cfg = (rtol, atol, norm, check_every, max_iters)
        if method == "multigrid":
            kwargs = dict(bc=float(bc), backend=backend, rtol=rtol,
                          atol=atol, norm=norm, dtype=dtype, **method_kwargs)
            group_key = ("multigrid", spec, grid_shape, str(dtype),
                         float(bc), cfg,
                         tuple(sorted(method_kwargs.items())))
        else:
            if method_kwargs:
                raise ValueError(
                    f"unknown arguments for method='jacobi': "
                    f"{sorted(method_kwargs)}")
            kwargs = dict(dtype=dtype, backend=backend, bc=float(bc),
                          rtol=rtol, atol=atol, norm=norm,
                          check_every=check_every, max_iters=max_iters)
            group_key = ("jacobi", spec, grid_shape, str(dtype), backend,
                         float(bc), cfg)

        fut = asyncio.get_running_loop().create_future()
        req = _Request(spec=spec, x0=x0, source=source, method=method,
                       group_key=group_key, solver_kwargs=kwargs, future=fut)
        self.stats.accepted += 1
        self._pending += 1
        fut.add_done_callback(self._resolved)
        self._queue.put_nowait(req)
        return await fut

    def _resolved(self, _fut) -> None:
        self._pending -= 1

    # -- dispatch loop -----------------------------------------------------

    async def _dispatch(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            first = await self._queue.get()
            # A pause taken while we were blocked on the queue holds the
            # dequeued request here until resume.
            await self._paused.wait()
            batch = [first]
            deadline = loop.time() + self.max_wait
            while len(batch) < self.max_batch:
                timeout = deadline - loop.time()
                if timeout <= 0:
                    break
                try:
                    batch.append(await asyncio.wait_for(
                        self._queue.get(), timeout))
                except asyncio.TimeoutError:
                    break
            while len(batch) < self.max_batch and not self._queue.empty():
                batch.append(self._queue.get_nowait())

            groups: dict[tuple, list[_Request]] = {}
            for req in batch:
                groups.setdefault(req.group_key, []).append(req)
            for group in groups.values():
                try:
                    results = await loop.run_in_executor(
                        self._pool, self._run_group, group)
                except Exception as e:
                    self.stats.failed += len(group)
                    for req in group:
                        if not req.future.done():
                            req.future.set_exception(e)
                else:
                    self.stats.batches += 1
                    self.stats.completed += len(group)
                    self.stats.max_batch = max(self.stats.max_batch,
                                               len(group))
                    if len(group) > 1:
                        self.stats.coalesced += len(group)
                    for req, res in zip(group, results):
                        if not req.future.done():
                            req.future.set_result(res)

    # -- blocking group execution (worker thread) --------------------------

    def _run_group(self, group: list[_Request]) -> list:
        req0 = group[0]
        if req0.method == "multigrid":
            mg = self.cache.multigrid(req0.spec, tuple(req0.x0.shape),
                                      **req0.solver_kwargs)
            return [mg.solve(req.x0) for req in group]

        solver = self.cache.solver(req0.spec, tuple(req0.x0.shape),
                                   **req0.solver_kwargs)
        # Pad the instance axis to the next power of two (with copies of the
        # first request) so one solver signature serves every batch size in
        # its bucket; per-instance freezing keeps results exact and the
        # padding instances converge with their original.  Each operand
        # goes to the cache's device once, in the solve's dtype (the cast
        # the solver makes anyway), and stacks there.
        b = len(group)
        n_pad = (1 << (b - 1).bit_length()) - b
        dev, dtype = self.cache.device, req0.solver_kwargs["dtype"]

        def stacked(operands):
            ts = [torch.as_tensor(a).to(dev, dtype) for a in operands]
            return torch.stack(ts + [ts[0]] * n_pad)

        xb = stacked([req.x0 for req in group])
        source = None
        if any(req.source is not None for req in group):
            zeros = torch.zeros(tuple(req0.x0.shape), dtype=dtype, device=dev)
            source = stacked([zeros if req.source is None else req.source
                              for req in group])
        res = solver.solve(xb, source=source)
        return [
            SolveResult(
                x=res.x[i], iterations=int(res.iterations[i]),
                converged=bool(res.converged[i]),
                residual=float(res.residual[i]),
                residual_history=res.residual_history[:, i],
                backend=res.backend, fuse=res.fuse,
                check_every=res.check_every, wall_seconds=res.wall_seconds,
                est_seconds=res.est_seconds, costs=res.costs)
            for i in range(len(group))
        ]
