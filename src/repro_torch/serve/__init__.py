"""Stencil-solve serving: the request-facing layer over the solver stack.

``serve.engine`` turns :class:`core.solver.Solver` into a service: an async
request queue with admission control that coalesces compatible pending
solves into one batched ``solve()`` (per-instance convergence freezing makes
a batched solve reproduce each request solved alone) and routes every plan
through the shared :class:`core.plan_cache.PlanCache`.  The LM-side server
is ``launch/serve.py``; this is the stencil entry point.
"""
from repro_torch.serve.engine import EngineStats, RejectedError, ServingEngine

__all__ = ["EngineStats", "RejectedError", "ServingEngine"]
