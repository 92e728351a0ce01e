#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the root of a checkout

The main path is the paper's Table-1 experiment — the 5-point Laplace Jacobi
solve on a 64x64 grid with bc=1, rtol=1e-6 and check_every=20, run to
convergence — through ``repro_torch``'s spec -> plan -> solver and its three
CUDA kernels, plus the sizes at which the card does real work.  Phases, one
JSON line each:

  1. the card and the build: nvidia-smi's name and power limit, torch and
     CUDA versions, then every ``csrc/*.cu`` compiled with nvcc;
  2. each kernel against its plain PyTorch version on the card (K1
     stencil2d, K2 trapezoid, K3 resident), fp32 within 1e-5 and bf16
     within 2e-2 absolute;
  3. the Table-1 solve through cuda_fused, cuda, conv and reference (7960
     iterations on the CPU; within one 20-iteration chunk here), each solved
     twice and the second timed, then the same number of fixed iterations
     in one resident pass;
  4. a heterogeneous 1024x1024 solve through K1, against the plain version;
  5. full size: an 8192x8192 fp32 grid, 1024 iterations through cuda_fused
     (trapezoid, fuse 16) and 64 through cuda at fuse 1;
  6. a batch of 1024 Table-1 instances in one Solver call;
  7. the kernel inventory: launches on the main path (phases 3-6), errors,
     and times of each kernel, its plain version and a library call, the
     kernels' read from CUDA-graph replays (device time without the host's
     gaps between launches), with the eager times beside them.

Any failed check raises and the script exits nonzero.  The last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits nonzero
before printing any result.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM data-sheet rates (fp32 outside the tensor cores; HBM3).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TABLE1 = dict(bc=1.0, rtol=1e-6, check_every=20, max_iters=20_000)
TABLE1_ITERS = 7960  # the JAX package's and the port's count on the CPU
HET_GRID = (1024, 1024)   # phase 4
BIG_GRID = (8192, 8192)   # phase 5: 256 MiB a sweep, far past the 50 MB L2
BATCH = 1024              # phase 6
DEVICE = "cuda"


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    import repro_torch.core as T
    from repro_torch.kernels import (_build, jacobi2d_fused_plain,
                                     jacobi2d_fused_step, stencil2d,
                                     stencil2d_plain)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device(DEVICE)

    def sync():
        torch.cuda.synchronize()

    def time_ms(fn, reps, warmup=1):
        for _ in range(warmup):
            fn()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def graph_ms(fn, reps):
        """Device ms of one call of ``fn``: ``reps`` calls captured in one
        CUDA graph and replayed, so the host's time between launches (the
        wrappers' Python) does not count as the kernel's."""
        fn()  # warm: library and module load, allocator
        sync()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    # -- 1. the card and the build ---------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for name in libs for ln in _build.build_log(name)
             .splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": 1, "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "build_s": build_s, "libraries": sorted(libs), "ptxas": ptxas})

    # -- 2. each kernel against its plain version ---------------------------
    rng = np.random.default_rng(0)

    def specs(grid):
        kappa = 1.0 + 9.0 * rng.random(grid)
        return {
            "laplace_bc": (T.laplace_jacobi(2), 1.5),
            "laplace_raw": (T.laplace_jacobi(2), None),
            "fields_bc": (T.heterogeneous_jacobi(kappa), 1.5),
            "star_r2_bc": (T.star(2, [0.15, 0.05], center=0.2), 1.5),
            "box_raw": (T.box(2), None),
        }

    def field(shape, dtype=torch.float32):
        g = torch.Generator(device=dev).manual_seed(1)
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    worst = {}   # kernel -> (max fp32 error, max bf16 error)
    cases = {}

    def record(kernel, dtype, e, label):
        key = str(dtype).split(".")[1]
        check(e <= TOL[key], f"{kernel} {label} {key}: {e} > {TOL[key]}")
        w = worst.setdefault(kernel, {"float32": 0.0, "bfloat16": 0.0})
        w[key] = max(w[key], e)
        cases[kernel] = cases.get(kernel, 0) + 1

    for shape in ((3, 33, 57), (2, *HET_GRID)):
        for name, (spec, bc) in specs(shape[1:]).items():
            for dtype in (torch.float32, torch.bfloat16):
                x = field(shape, dtype)
                out = stencil2d(x, spec, bc_value=bc)
                sync()
                record("stencil2d", dtype,
                       err(out, stencil2d_plain(x, spec, bc_value=bc)),
                       f"{name} {shape}")
        sp = specs(shape[1:])
        for fuse in (1, 2, 4, 8, 16):
            for name in ("laplace_bc", "fields_bc"):
                spec, bc = sp[name]
                x = field(shape)
                out = jacobi2d_fused_step(x, spec, fuse=fuse, bc_value=bc)
                sync()
                record("jacobi2d_trapezoid", torch.float32,
                       err(out, jacobi2d_fused_plain(x, spec, fuse=fuse,
                                                     bc_value=bc)),
                       f"{name} fuse={fuse} {shape}")
        x = field(shape, torch.bfloat16)
        spec, bc = sp["star_r2_bc"]
        out = jacobi2d_fused_step(x, spec, fuse=8, bc_value=bc)
        sync()
        record("jacobi2d_trapezoid", torch.bfloat16,
               err(out, jacobi2d_fused_plain(x, spec, fuse=8, bc_value=bc)),
               f"star_r2_bc fuse=8 {shape}")
    for grid in ((64, 64), (160, 160)):
        sp = specs(grid)
        for fuse in (1, 8, 64, 512):
            for name in ("laplace_bc", "fields_bc", "star_r2_bc", "box_raw"):
                spec, bc = sp[name]
                x = field((2, *grid))
                out = jacobi2d_fused_step(x, spec, fuse=fuse, bc_value=bc,
                                          rim="resident")
                sync()
                record("jacobi2d_resident", torch.float32,
                       err(out, jacobi2d_fused_plain(x, spec, fuse=fuse,
                                                     bc_value=bc)),
                       f"{name} fuse={fuse} {grid}")
    emit({"phase": 2, "cases": cases, "max_abs_err": worst, "tol": TOL})

    # -- 3-6. the main path, with the launch counts from zero ----------------
    _build.LAUNCHES.clear()
    lap = T.laplace_jacobi(2)

    solves, cold_ms = {}, {}
    for backend in ("cuda_fused", "cuda", "conv", "reference"):
        # Twice: the first solve pays one-time costs (library load, cuDNN
        # set-up, allocator growth); the second is the one reported.
        solver = T.Solver(lap, (64, 64), backend=backend, device=dev,
                          **TABLE1)
        cold_ms[backend] = solver.solve(
            torch.zeros(64, 64)).wall_seconds * 1e3
        r = solver.solve(torch.zeros(64, 64))
        check(r.converged and r.x.shape == (64, 64)
              and bool(torch.isfinite(r.x).all()), f"table1 {backend}")
        check(abs(r.iterations - TABLE1_ITERS) <= TABLE1["check_every"],
              f"table1 {backend}: {r.iterations} iterations")
        solves[backend] = r
    ref = solves["reference"]
    for backend, r in solves.items():
        # Iterates a chunk apart differ by at most that chunk's residual.
        chunks = abs(r.iterations - ref.iterations) // TABLE1["check_every"]
        check(err(r.x, ref.x) <= TOL["float32"] + chunks * 2 * ref.residual,
              f"table1 {backend} field vs reference")
    n_iters = solves["cuda_fused"].iterations
    resident = T.make_plan(lap, (64, 64), backend="cuda_fused", bc=1.0,
                           iters=n_iters, rim="resident", device=dev)
    res_x = resident(torch.zeros(64, 64, device=dev))
    sync()
    res_err = err(res_x, solves["cuda_fused"].x)
    check(resident.fuse == n_iters and res_err <= TOL["float32"],
          f"resident {n_iters} iterations vs the converged field: {res_err}")
    emit({"phase": 3, "table1": {
        b: {"iterations": r.iterations, "residual": r.residual,
            "wall_ms": r.wall_seconds * 1e3, "cold_wall_ms": cold_ms[b],
            "fuse": r.fuse}
        for b, r in solves.items()},
        "resident": {"iterations": n_iters, "max_abs_err_vs_converged":
                     res_err}})

    kappa = 1.0 + 9.0 * np.random.default_rng(0).random(HET_GRID)
    het = T.heterogeneous_jacobi(kappa)
    het_solver = T.Solver(het, HET_GRID, backend="cuda", bc=1.0,
                          rtol=None, atol=None, max_iters=200, fuse=1,
                          device=dev)
    het_x0 = torch.zeros(1, *HET_GRID, device=dev)
    t0 = time.perf_counter()
    het_r = het_solver.solve(het_x0)
    het_ms = (time.perf_counter() - t0) * 1e3
    y = T.DirichletBC(1.0).set_boundary(het_x0, 2)
    het_fields = torch.as_tensor(het.field_stack(), device=dev)
    for _ in range(200):
        y = stencil2d_plain(y, het, bc_value=1.0, fields=het_fields)
    het_err = err(het_r.x, y)
    check(het_err <= TOL["float32"], f"hetero vs plain: {het_err}")
    emit({"phase": 4, "grid": list(HET_GRID), "iterations": 200,
          "wall_ms": het_ms, "max_abs_err_vs_plain": het_err})

    big = BIG_GRID
    n_big = big[0] * big[1]
    g = torch.Generator(device=dev).manual_seed(2)
    xb = torch.rand((1, *big), generator=g, device=dev)
    full = {}
    outs = {}
    for backend, iters, fuse in (("cuda_fused", 1024, 16), ("cuda", 64, 1)):
        plan = T.make_plan(lap, big, backend=backend, bc=1.0, iters=iters,
                           fuse=fuse, device=dev)

        def run(plan=plan, backend=backend):
            outs[backend] = plan(xb)
        ms = time_ms(run, 1)
        check(bool(torch.isfinite(outs[backend]).all()),
              f"full-size {backend} finite")
        per_iter = ms / iters
        full[backend] = {
            "iters": iters, "fuse": plan.fuse, "ms": ms,
            "ms_per_iter": per_iter,
            # as if each iteration read and wrote the grid once
            "effective_GBps": 2 * n_big * 4 / (per_iter * 1e-3) / 1e9,
            # what each pass really moves
            "device_GBps": 2 * n_big * 4 / (per_iter * plan.fuse * 1e-3)
            / 1e9,
            "bound_GBps": PEAK_BYTES / 1e9}
    k33 = torch.as_tensor(lap.to_kernel(), device=dev)[None, None]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        conv_big_ms = graph_ms(lambda: F.conv2d(xb[None], k33, padding=1),
                               5)
    full["library_ms_conv2d_one_sweep"] = conv_big_ms
    emit({"phase": 5, "grid": list(big), **full})

    batch = T.Solver(lap, (64, 64), backend="cuda_fused", device=dev,
                     **TABLE1)
    t0 = time.perf_counter()
    br = batch.solve(torch.zeros(BATCH, 64, 64, device=dev))
    batch_ms = (time.perf_counter() - t0) * 1e3
    check(bool((br.iterations == n_iters).all()) and br.converged.all(),
          f"batch iterations {sorted(set(br.iterations.tolist()))} vs "
          f"{n_iters}")
    check(err(br.x, solves["cuda_fused"].x[None].expand_as(br.x)) == 0.0,
          "batch instances equal the single solve")
    emit({"phase": 6, "instances": BATCH, "iterations": n_iters,
          "wall_ms": batch_ms, "fuse": br.fuse})

    launches = dict(_build.LAUNCHES)
    for k in ("stencil2d", "jacobi2d_trapezoid", "jacobi2d_resident"):
        check(launches.get(k, 0) > 0, f"main path never launched {k}")

    # -- 7. kernel inventory: times at the main path's shapes ----------------
    # "ms" and "plain_ms" replay a CUDA graph of the calls (device time);
    # "eager_ms" times the same calls issued one by one from Python, which
    # at small sizes is the wrapper's host time, not the kernel's.
    # K1 at the heterogeneous 1024x1024 step (4 field taps, bc).
    x1 = field((1, *HET_GRID))

    def k1():
        stencil2d(x1, het, bc_value=1.0, fields=het_fields)
    k1_ms, k1_eager = graph_ms(k1, 50), time_ms(k1, 50)
    k1_plain = graph_ms(lambda: stencil2d_plain(x1, het, bc_value=1.0,
                                                fields=het_fields), 10)
    n1 = x1.numel()
    k1_bytes = 2 * n1 * 4 + het_fields.numel() * 4
    k1_ops = (2 * len(het.taps) - 1) * n1
    # K2 at the 8192x8192 fuse-1 sweep (the cuda backend's pass), where
    # F.conv2d computes the same 5-point sweep (less the shell pinning).
    xs = T.DirichletBC(1.0).set_boundary(xb, 2)

    def k2():
        jacobi2d_fused_step(xs, lap, fuse=1, bc_value=1.0)
    k2_ms, k2_eager = graph_ms(k2, 10), time_ms(k2, 10)
    k2_plain = graph_ms(lambda: jacobi2d_fused_plain(xs, lap, fuse=1,
                                                     bc_value=1.0), 3)
    k2_err = err(jacobi2d_fused_step(xs, lap, fuse=16, bc_value=1.0),
                 jacobi2d_fused_plain(xs, lap, fuse=16, bc_value=1.0))
    check(k2_err <= TOL["float32"], f"K2 fuse 16 at full size: {k2_err}")
    k2_f16 = graph_ms(lambda: jacobi2d_fused_step(xs, lap, fuse=16,
                                                  bc_value=1.0), 5)
    k2_ops = (2 * len(lap.taps) - 1) * n_big
    # K3 at the Table-1 resident pass: n_iters steps on one 64x64 grid.  Its
    # plain version (n_iters sweeps of a dozen small ops) is timed eagerly.
    x3 = T.DirichletBC(1.0).set_boundary(torch.zeros(1, 64, 64, device=dev),
                                         2)
    k3_ms = graph_ms(lambda: jacobi2d_fused_step(x3, lap, fuse=n_iters,
                                                 bc_value=1.0,
                                                 rim="resident"), 3)
    k3_plain = time_ms(lambda: jacobi2d_fused_plain(x3, lap, fuse=n_iters,
                                                    bc_value=1.0), 1, 0)
    k3_ops = n_iters * (2 * len(lap.taps) - 1) * 64 * 64
    # K2 as the Table-1 solve runs it (64x64, fuse 4): with the launch count
    # this splits the solve's wall time into kernel time and the rest.
    t1_fuse = solves["cuda_fused"].fuse

    def k2_t1():
        jacobi2d_fused_step(x3, lap, fuse=t1_fuse, bc_value=1.0)
    k2_t1_ms, k2_t1_eager = graph_ms(k2_t1, 200), time_ms(k2_t1, 200)
    t1_kernel_ms = n_iters // t1_fuse * k2_t1_ms
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        conv64_ms = graph_ms(lambda: F.conv2d(x3[None], k33, padding=1), 50)
    emit({"phase": 7, "launches": launches, "table1_cuda_fused": {
        "wall_ms": solves["cuda_fused"].wall_seconds * 1e3,
        "launches": n_iters // t1_fuse, "kernel_ms": t1_kernel_ms,
        "kernel_share": t1_kernel_ms
        / (solves["cuda_fused"].wall_seconds * 1e3)}})

    def entry(name, source, replaces, ms, plain_ms, nbytes, ops, lib_ms,
              extra):
        tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32_FLOPS * 1e3
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": worst[name]["float32"], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": max(tb, to),
                "bound_by": "bytes" if tb >= to else "operations",
                "library_ms": lib_ms, **extra}

    kernels = [
        entry("stencil2d", "src/repro_torch/csrc/stencil2d.cu",
              "src/repro/kernels/stencil2d.py:125", k1_ms, k1_plain,
              k1_bytes, k1_ops, None,
              {"shape": [1, *HET_GRID], "fields": 4, "eager_ms": k1_eager,
               "max_abs_err_bf16": worst["stencil2d"]["bfloat16"]}),
        entry("jacobi2d_trapezoid", "src/repro_torch/csrc/jacobi_fused.cu",
              "src/repro/kernels/jacobi_fused.py:247", k2_ms, k2_plain,
              2 * n_big * 4, k2_ops, conv_big_ms,
              {"shape": [1, *big], "fuse": 1, "eager_ms": k2_eager,
               "fuse16_ms": k2_f16,
               "table1_launch_ms": k2_t1_ms,
               "table1_launch_eager_ms": k2_t1_eager,
               "fuse16_bound_ms": max(2 * n_big * 4 / PEAK_BYTES,
                                      16 * k2_ops / PEAK_FP32_FLOPS) * 1e3,
               "max_abs_err_bf16": worst["jacobi2d_trapezoid"]["bfloat16"]}),
        entry("jacobi2d_resident", "src/repro_torch/csrc/jacobi_fused.cu",
              "src/repro/kernels/jacobi_fused.py:215", k3_ms, k3_plain,
              2 * 64 * 64 * 4, k3_ops, None,
              {"shape": [1, 64, 64], "fuse": n_iters,
               "plain_timing": "eager", "conv2d_one_sweep_ms": conv64_ms}),
    ]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
