"""Learn a stencil from steady states on the PyTorch port — the adjoint
solve as a layer (the port of examples/learned_stencil.py).

Inverse problem: a hidden heterogeneous conductivity field ``kappa`` defines
a diffusion operator; we observe (source, steady-state) pairs produced by
solving it, and recover the operator by gradient descent *through the
solver*.  The forward pass is ``implicit_solve`` run to convergence; the
backward pass is one adjoint solve with the transposed stencil (see
src/repro_torch/core/adjoint.py), so the whole thing trains under the
port's ``make_train_step`` + AdamW, with a checkpoint round trip mid-run:
the train state is saved, restored into a fresh state, and the next step
from it must give the loss the step from the live state gives, bit for bit.

  PYTHONPATH=src python examples/torch_learned_stencil.py       # on the card
  PYTHONPATH=src python examples/torch_learned_stencil.py --smoke \\
      --device cpu --steps 20 --assert-decreasing               # CPU smoke
"""
import argparse
import sys
import tempfile

sys.path.insert(0, "src")

import numpy as np
import torch


def make_dataset(cfg, n_batches, batch, device, seed=0):
    """(source, target) pairs from a hidden ground-truth operator."""
    from repro_torch.core import heterogeneous_jacobi, implicit_solve

    rng = np.random.default_rng(seed)
    kappa = 1.0 + 9.0 * rng.random(cfg.grid)
    true_spec = heterogeneous_jacobi(kappa, name="hidden-kappa")
    true_fields = torch.as_tensor(true_spec.field_stack(), device=device)
    data = []
    for _ in range(n_batches):
        src = torch.as_tensor(rng.standard_normal((batch, *cfg.grid)),
                              dtype=torch.float32, device=device)
        with torch.no_grad():
            tgt = implicit_solve(
                true_spec, torch.zeros_like(src), fields=true_fields,
                source=src, backend=cfg.backend, rtol=1e-6,
                max_iters=2 * cfg.max_iters)
        data.append({"source": src, "target": tgt})
    return data, true_fields


def _clone(state):
    return {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                else v.clone()) for k, v in state.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="small grid / few iterations (CPU CI)")
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--assert-decreasing", action="store_true",
                    help="exit nonzero unless loss drops >= 10x")
    args = ap.parse_args(argv)

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.core import PlanCache, set_default_plan_cache
    from repro_torch.core.plan import resolve_device
    from repro_torch.models.model_zoo import build
    from repro_torch.models.solver_layer import solver_loss_fn
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import (init_train_state, load_params,
                                              make_train_step)

    dev = resolve_device(args.device)
    # The differentiable solve runs on the default plan cache: this device's.
    old_cache = set_default_plan_cache(PlanCache(device=dev))
    cfg = get_config("learned-stencil", smoke=args.smoke)
    model = build(cfg, device=dev)
    print(f"== learned-stencil on {cfg.grid}, backend={cfg.backend}, "
          f"{args.steps} steps, {dev} ==")

    # Full-batch training: the inverse problem is deterministic, and batch
    # rotation only adds optimizer churn that short runs cannot average out.
    data, true_fields = make_dataset(cfg, 1, args.batch, dev)
    state = init_train_state(model)
    opt = AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps,
                      weight_decay=0.0, grad_clip=1.0)
    step = make_train_step(model, opt)

    # The 10x criterion is judged on one fixed batch — per-step train losses
    # come from rotating batches and are not comparable to each other.
    @torch.no_grad()
    def eval_loss(params):
        load_params(model, params)
        return float(solver_loss_fn(model, data[0])[0])

    first = eval_loss(state["params"])
    ckpt_at = max(1, args.steps // 2)
    with tempfile.TemporaryDirectory() as ckdir:
        ck = Checkpointer(ckdir, keep=2)
        for i in range(args.steps):
            state, metrics = step(state, data[i % len(data)])
            loss = float(metrics["loss"])
            if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
                print(f"step {i:4d}  loss {loss:.3e}  "
                      f"lr {float(metrics['lr']):.2e}  "
                      f"|g| {float(metrics['grad_norm']):.2e}")
            if i + 1 == ckpt_at:
                # Round-trip the full train state through a checkpoint into
                # a fresh state and keep training from the restored copy —
                # the restored solve must continue bit-for-bit.  The step
                # updates its state in place, so each probe steps a copy.
                ck.save(i + 1, state)
                fresh = init_train_state(build(cfg, device=dev))
                _, restored = ck.restore_latest(into=fresh)
                before = step(_clone(state), data[0])[1]["loss"]
                after = step(_clone(restored), data[0])[1]["loss"]
                assert float(before) == float(after), (before, after)
                state = restored
                print(f"step {i+1:4d}  checkpoint round-trip OK "
                      f"(loss identical: {float(after):.3e})")

    last = eval_loss(state["params"])
    taps = state["params"]["taps"]
    tap_err = float((taps - true_fields).abs().mean())
    print(f"eval loss {last:.3e} ({first / max(last, 1e-30):.0f}x down "
          f"from {first:.3e}); mean |taps - true| = {tap_err:.3f}")
    set_default_plan_cache(old_cache)
    if args.assert_decreasing and not last <= first / 10.0:
        print("FAIL: loss did not decrease 10x", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
