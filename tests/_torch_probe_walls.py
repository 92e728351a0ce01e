"""Print what the plan cache's probe measures for the 64x64 bucket of the
5-point family on the card: the ms of one var-operand plan call (the
template's all-field taps, a source and a bc grid, as
``PlanCache._bucket_backend`` builds it) through ``conv`` and through
``reference``, at the probe's 8 iterations and at the adjoint benchmark
cell's 200, ``REPEATS`` calls each in turns after a warm-up, as one JSON
object {backend: {iterations: [ms, ...]}}.  Run it from two checkouts on
one card, alternating, to compare them:

    PYTHONPATH=<checkout>/src python3 <checkout>/tests/_torch_probe_walls.py
"""
import json

import numpy as np
import torch

import repro_torch.core as T

REPEATS = 15
BUCKET = (64, 64)
ITERS = (8, 200)


def main():
    dev = torch.device("cuda")
    taps = {off: T.WeightField(np.zeros(BUCKET, np.float32))
            for off, _ in T.laplace_jacobi(2).taps}
    template = T.StencilSpec(taps=taps, name="probe_template")
    fields = torch.as_tensor(template.field_stack(), device=dev)
    x = torch.zeros((1, *BUCKET), device=dev)
    src = torch.zeros(BUCKET, device=dev)
    bcg = torch.zeros(BUCKET, device=dev)
    plans = {(b, n): T.make_plan(template, BUCKET, backend=b,
                                 bc=T.DirichletBC(0.0), mode=T.BoundaryMode
                                 .MASK, iters=n, device=dev, tuned=None)
             for b in ("conv", "reference") for n in ITERS}
    out = {b: {n: [] for n in ITERS} for b in ("conv", "reference")}

    def call(plan):
        return plan(x, fields=fields, source=src, bc_value=bcg)

    for plan in plans.values():
        call(plan)
    torch.cuda.synchronize(dev)
    for _ in range(REPEATS):
        for (b, n), plan in plans.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call(plan)
            end.record()
            end.synchronize()
            out[b][n].append(start.elapsed_time(end))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
