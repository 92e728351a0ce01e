"""Time K2/K3's kernels (csrc/jacobi_fused.cu) against one another on the
card, at the shapes their dispatch by shape decides between, and print one
JSON line a measurement with the card's name and power limit:

    PYTHONPATH=src python tests/_torch_jacobi_sweep.py [SECTION ...]

with no SECTION all of them.  Every time is device ms a call, by CUDA-graph
replay, fp32, the 5-point Laplace Jacobi with bc=1:

- ``k2``: 8192x8192 at fuse 1-32, the stream kernel (K2) and the tile
  kernel before it;
- ``waves``: the stream kernel's launch in 1, 2 and 4 waves of CTAs with no
  fewest rows a chunk;
- ``variants``: the stream kernel (the radius-1 offsets as immediates, four
  levels' loads in flight) against ``stream_r0`` (the radius a runtime
  value) and ``stream_u1`` (one level at a time), at fuse 4-32;
- ``k3``: Table 1's launch (64x64, fuse 4) on 1 and 1024 instances through
  every kernel that runs it; 7960 steps on one grid through the register
  kernel (K3) at each of its rows a thread, the cta kernel and the one-CTA
  kernel before both; and the register kernel's ptxas report;
- ``one_cta``: trapezoids at fuse 1-4 on one grid that fits one CTA
  (64x64, 128x128, 160x160, 30x700; and 40x700, just past one CTA): the
  dispatch's choice and each kernel that runs there; a resident 30x700 at
  fuse 64;
- ``resident``: the grid-wide resident kernel against the stream kernel's
  passes on a 1024x1024 grid at fuse 64 and 512;
- ``dispatch``: the stream and tile kernels at fuse 1-64 on grids from
  300x517 to 4096x4096 and batches of 1024x1024 grids, where the dispatch
  by shape (kernel_for) chooses between them, with its choice.

The jacobi_fused module constants STREAM_WAVES, STREAM_MIN_ROWS and
REGS_ROWS are set for a measurement and put back after it.  Needs a CUDA
device; imports no JAX.
"""
import json
import subprocess
import sys

import torch

import repro_torch.core as T
import repro_torch.kernels.jacobi_fused as JF
from repro_torch.kernels import _build

SECTIONS = ("k2", "waves", "variants", "k3", "one_cta", "resident",
            "dispatch")


def graph_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / reps


def emit(what, **times):
    print(json.dumps({"what": what, **times}), flush=True)


def main(sections) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    emit("card", nvidia_smi=smi, torch=torch.__version__)
    lap = T.laplace_jacobi(2)

    def grid(shape):
        return T.DirichletBC(1.0).set_boundary(
            torch.rand(shape, device=dev), 2)

    def step(x, fuse, kernel=None, rim="trapezoid"):
        return lambda: JF.jacobi2d_fused_step(x, lap, fuse=fuse, bc_value=1.0,
                                              rim=rim, kernel=kernel)

    def runs(kernel, x, fuse):
        try:
            JF._plan(kernel, fuse, lap, *x.shape[1:])
        except ValueError:
            return False
        return True

    if "k2" in sections or "waves" in sections or "variants" in sections:
        x = grid((1, 8192, 8192))
    if "k2" in sections:
        for fuse in (1, 2, 4, 8, 16, 32):
            emit("8192x8192", fuse=fuse, stream_ms=graph_ms(step(x, fuse), 5),
                 tile_ms=graph_ms(step(x, fuse, "tile"), 5))
    if "waves" in sections:
        chosen = JF.STREAM_WAVES, JF.STREAM_MIN_ROWS
        for fuse in (1, 2, 16):
            waves = {}
            for w in (1, 2, 4):
                JF.STREAM_WAVES, JF.STREAM_MIN_ROWS = (w, w), (1, 1)
                waves[f"waves_{w}_ms"] = graph_ms(step(x, fuse), 5)
            JF.STREAM_WAVES, JF.STREAM_MIN_ROWS = chosen
            emit("8192x8192 stream waves", fuse=fuse, **waves)
    if "variants" in sections:
        for fuse in (4, 8, 16, 32):
            emit("8192x8192 stream variants", fuse=fuse, **{
                f"{k}_ms": graph_ms(step(x, fuse, k), 5)
                for k in ("stream", "stream_r0", "stream_u1")})
        y = grid((1, 1024, 1024))
        for fuse in (4, 16):
            emit("1024x1024 stream variants", fuse=fuse, **{
                f"{k}_ms": graph_ms(step(y, fuse, k), 20)
                for k in ("stream", "stream_r0", "stream_u1")})
    x = None

    if "k3" in sections:
        for batch in (1, 1024):
            x = grid((batch, 64, 64))
            emit("Table-1 launch, fuse 4", batch=batch,
                 by_shape=JF.kernel_for("trapezoid", lap, 4, *x.shape), **{
                     f"{k}_ms": graph_ms(step(x, 4, k),
                                         200 if batch == 1 else 20)
                     for k in ("resident_regs", "resident_cta",
                               "resident_smem", "stream", "tile")})
        x = grid((1, 64, 64))
        k3 = {}
        rows = JF.REGS_ROWS
        for kc in rows:
            JF.REGS_ROWS = (kc,)
            k3[f"regs_{kc}_rows_ms"] = graph_ms(step(x, 7960, rim="resident"),
                                                3)
        JF.REGS_ROWS = rows
        for k in ("resident_cta", "resident_smem"):
            k3[f"{k}_ms"] = graph_ms(step(x, 7960, k, "resident"), 3)
        emit("64x64 resident, 7960 steps", patch=JF.regs_patch(lap, 64, 64),
             **k3)
        log = _build.build_log("jacobi_fused").splitlines()
        emit("ptxas, regs_kernel", lines=[
            line.strip() for i, entry in enumerate(log)
            if "Compiling entry" in entry and "regs_kernel" in entry
            for line in log[i:i + 4]])

    if "one_cta" in sections:
        kernels = ("resident_regs", "resident_cta", "stream", "tile")
        for shape in ((1, 64, 64), (1, 128, 128), (1, 160, 160),
                      (1, 40, 700), (1, 30, 700)):
            x = grid(shape)
            for fuse in (1, 2, 3, 4):
                emit("one-CTA trapezoid", shape=shape, fuse=fuse,
                     by_shape=JF.kernel_for("trapezoid", lap, fuse, *shape),
                     **{f"{k}_ms": graph_ms(step(x, fuse, k), 50)
                        for k in kernels if runs(k, x, fuse)})
        x = grid((1, 30, 700))
        emit("30x700 resident, fuse 64",
             by_shape=JF.kernel_for("resident", lap, 64, 1, 30, 700), **{
                 f"{k}_ms": graph_ms(step(x, 64, k, "resident"), 5)
                 for k in ("resident_grid", "resident_smem", "stream")})

    if "resident" in sections:
        x = grid((1, 1024, 1024))
        for fuse in (64, 512):
            emit("1024x1024 resident", fuse=fuse,
                 resident_grid_ms=graph_ms(step(x, fuse, rim="resident"), 3),
                 stream_ms=graph_ms(step(x, fuse, "stream", "resident"), 3),
                 stream_passes=len(JF.trapezoid_passes(fuse, 1)))

    if "dispatch" in sections:
        for shape in ((1, 300, 517), (3, 129, 260), (1, 1024, 1024),
                      (4, 1024, 1024), (1, 2048, 2048), (16, 1024, 1024),
                      (1, 4096, 4096)):
            x = grid(shape)
            for fuse in (1, 2, 3, 4, 8, 16, 64):
                emit("stream against tile", shape=shape, fuse=fuse,
                     by_shape=JF.kernel_for("trapezoid", lap, fuse, *shape),
                     stream_ms=graph_ms(step(x, fuse, "stream"), 5),
                     tile_ms=graph_ms(step(x, fuse, "tile"), 5))
    return 0


if __name__ == "__main__":
    chosen = sys.argv[1:] or SECTIONS
    unknown = set(chosen) - set(SECTIONS)
    if unknown:
        sys.exit(f"unknown sections {sorted(unknown)}; choose from "
                 f"{SECTIONS}")
    sys.exit(main(chosen))
