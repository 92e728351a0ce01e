"""Production-mesh dry run: trace every (arch x shape) cell on the 16 x 16
(or 2 x 16 x 16) mesh and count its work — the port of the JAX package's
``launch/dryrun.py``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape train_4k [--mesh pod|multipod] [--out artifacts/dryrun] \\
      [--smoke]

JAX lowers and compiles each cell for fake host devices and reads the
compiled artifact.  The port runs the cell's step once, eagerly, on
``meta`` tensors: every shard of the mesh a ``meta`` device, the model and
its arguments shapes without storage, the kernels' cost charged without a
launch (``launch/hlo_cost.py``).  Nothing is allocated and no accelerator
is touched, JAX's dry run's own contract.  ``run_cell(..., devices=)``
runs a cell on other devices (the card, every shard on cuda:0): the same
step, counted the same way.

JAX compiles one device's program; the port's one process runs every
shard's.  On ``meta`` a ``tp`` cell counts its data replicas the way JAX
multiplies a loop body by its trips (``count_collapsed``): the shards of
the batch axes ("pod", "data") run one program on the same shapes, so the
step is traced with the first replica's shards and with the first two's
(``Replicas``), and the full mesh's count is the first plus (replicas - 1)
times the difference, exactly (a count is affine in the replicas: each
adds its shards' ops, its collective members and the adds that gather its
gradients into what the replicas share).  A pod cell then traces 3 of 16
replicas, a multipod cell 3 of 32.  ``sp`` cells (weights sharded over
data) and ``state_over_data`` cells (the cache over data) trace every
shard, as do counts on ``cpu`` and ``cuda``.

Per cell it writes ``<out>/<arch>__<shape>__<pod16x16|pod2x16x16>.json``
with JAX's keys:

  status            OK, or SKIP with ``skip_reason``
  memory_analysis   per shard: ``argument_size_in_bytes`` and
                    ``output_size_in_bytes`` from the step's arguments and
                    results laid by their specs (``specs.input_shardings``;
                    the outputs: the updated train state and five fp32
                    metrics, or the token (B,) int32 and the cache), exact;
                    ``temp_size_in_bytes``: the counter's peak of live
                    bytes made during the step over the whole mesh, divided
                    by the shard count (one process runs every shard, so a
                    tensor is charged to the shard that made it; a piece or
                    result shared by replicas on one device counts once);
                    collapsed, the peak extrapolated from the one- and
                    two-replica traces as the counts are (a peak is not
                    affine in the replicas: within a few percent of the
                    full trace's on the smoke cells, 23% under on the moe
                    train cell, a decode's 4x under)
  hlo_cost          the counter's flops, hbm_bytes and collectives, per
                    shard: the mesh's total over the shard count (every
                    shard runs the same program)
  collectives_static  the same collectives: eager PyTorch has no loop body
                    to count once, so the static count is the per-call one
  model_flops       ``analytic_model_flops``: 6·N·D train, 2·N·D serve
  n_params, n_active_params, n_devices
  lower_s           seconds to build the cell's model, arguments and step
  compile_s         seconds of the counted trace of the step (both traces
                    where collapsed)
  replicas_counted  "every shard", or the replica axes collapsed
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time

import torch

MESH_NAMES = {False: "pod16x16", True: "pod2x16x16"}
METRICS = 5          # loss, nll, aux, grad_norm, lr


# What torch/_meta_registrations.py's activate_meta leaves to C++.
_NO_PYTHON_META = {"aten::empty_strided", "aten::clone", "aten::_to_copy",
                   "aten::copy_", "aten::constant_pad_nd", "aten::rot90",
                   "aten::as_strided_scatter"}


def _python_metas():
    """(op, fn) of the aten ops PyTorch gives a Python meta function
    (activate_meta's choice: meta, then post- and pre-autograd
    decompositions; no composite, view or excluded op)."""
    from torch._decomp import global_decomposition_table
    table: dict = {}
    for typ in ("meta", "post_autograd", "pre_autograd"):
        for op, fn in global_decomposition_table[typ].items():
            table.setdefault(op, fn)
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    for op, fn in table.items():
        if not isinstance(op, torch._ops.OpOverload):
            continue
        name = op.name()
        if (name.startswith("aten::") and not op.is_view
                and name not in _NO_PYTHON_META
                and not has(name, "CompositeImplicitAutograd")):
            yield op, fn


def _row_major(t: torch.Tensor) -> bool:
    """Whether ``t``'s strides fall from its first dim to its last (size-1
    and broadcast dims aside): an elementwise op over such operands lays
    its output out contiguously, as TensorIterator orders dims by their
    operands' strides."""
    last = 0
    for size, stride in zip(reversed(t.shape), reversed(t.stride())):
        if size == 1 or stride == 0:
            continue
        if stride < last:
            return False
        last = stride
    return True


def _broadcast(*shapes):
    """The broadcast of ``shapes``, or None where they do not broadcast."""
    out = [1] * max(len(s) for s in shapes)
    for s in shapes:
        for i, d in enumerate(s, len(out) - len(s)):
            if d != 1:
                if out[i] not in (1, d):
                    return None
                out[i] = d
    return out


def _fast_where(python_meta):
    """``where.self``'s meta (no C++ one): the broadcast shape and the
    promoted type, contiguous where every operand is row-major, else
    PyTorch's Python function (about 300 us a call)."""
    def meta(cond, a, b):
        shape = _broadcast(cond.shape, a.shape, b.shape)
        if shape is not None and all(map(_row_major, (cond, a, b))):
            return torch.empty(shape, dtype=torch.result_type(a, b),
                               device="meta")
        return python_meta(cond, a, b)
    return meta


def _fast_masked_fill(python_meta):
    """``masked_fill.Scalar``'s meta: a clone of a contiguous ``self`` (the
    kernel clones, then fills in place), else PyTorch's Python function."""
    def meta(a, mask, value):
        if a.is_contiguous() and _broadcast(a.shape,
                                            mask.shape) == list(a.shape):
            return torch.empty_like(a)
        return python_meta(a, mask, value)
    return meta


_FAST_META = {"aten::where.self": _fast_where,
              "aten::masked_fill.Scalar": _fast_masked_fill}


@contextlib.contextmanager
def native_meta_kernels():
    """PyTorch registers Python meta functions over the C++ meta kernels of
    many aten ops (``torch/_meta_registrations.py``): on torch 2.13 an
    elementwise op on ``meta`` then costs about 180 us, against 3 us in
    C++, and a trace of a full-width cell is mostly that.  Inside this
    context the ops that have a C++ meta kernel use it: PyTorch's Python
    registrations are dropped and those of the ops without one registered
    again; on exit every Python registration is restored.  Shapes, types
    and strides are the C++ kernels', the ones a CPU or CUDA run computes.
    A torch without that registry runs the context as a no-op."""
    import torch._meta_registrations as registrations
    if not hasattr(registrations, "_meta_lib_dont_use_me_use_register_meta"):
        yield
        return
    original = registrations._meta_lib_dont_use_me_use_register_meta
    metas = [(op, fn) for op, fn in _python_metas()
             if op.name().replace("::", "/") + "/Meta" in original._op_impls]
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    original._destroy()
    lib = torch.library.Library("aten", "IMPL", "Meta")
    try:
        for op, fn in metas:
            if not has(op.name(), "Meta"):
                lib.impl(op, _FAST_META.get(op.name(), lambda f: f)(fn))
        yield
    finally:
        lib._destroy()
        full = torch.library.Library("aten", "IMPL", "Meta")
        for op, fn in metas:
            full.impl(op, fn)
        registrations._meta_lib_dont_use_me_use_register_meta = full


def analytic_model_flops(cfg, kind: str, batch: int, seq: int) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) for train; 2*N*D for inference."""
    n_active = cfg.active_param_count()
    tokens = batch * (seq if kind in ("train", "prefill") else 1)
    mult = 6 if kind == "train" else 2
    return float(mult * n_active * tokens)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def shard_bytes(structs, specs, mesh) -> int:
    """Bytes one shard holds of ``structs`` laid by ``specs`` (the same
    tree; a sharded dim splits evenly over its axes)."""
    total = 0
    for t, spec in zip(_leaves(structs), _specs(specs)):
        ways = 1
        for entry in spec:
            for a in (() if entry is None else
                      (entry,) if isinstance(entry, str) else entry):
                ways *= mesh.shape[mesh.axis_names.index(a)]
        total += t.numel() * t.element_size() // ways
    return total


def _specs(tree):
    """The ``PartitionSpec`` leaves of a tree of specs (a spec is a tuple
    too: it is a leaf where its entries are names or None)."""
    from repro_torch.parallel.sharding import PartitionSpec
    if isinstance(tree, PartitionSpec):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _specs(v)
    else:
        for v in tree:
            yield from _specs(v)


def per_shard(cost: dict, n: int) -> dict:
    return {
        "flops": cost["flops"] / n,
        "hbm_bytes": cost["hbm_bytes"] / n,
        "collectives": {k: {f: v / n for f, v in c.items()}
                        for k, c in cost["collectives"].items()},
        "collective_bytes_total": cost["collective_bytes_total"] / n,
    }


def memory_analysis(cell, sharder, structs, specs, peak_live: int) -> dict:
    from repro_torch.launch.specs import cache_shapes, struct_specs
    mesh, n = sharder.mesh, math.prod(sharder.mesh.shape)
    args = shard_bytes(structs, specs, mesh)
    if cell.kind == "train":
        out = shard_bytes(structs[0], specs[0], mesh) + 4 * METRICS
    else:
        model = cell.model
        cache = cache_shapes(model, cell.batch, cell.seq)
        cspecs = struct_specs(sharder, model.cache_dims(), cache)
        out = 4 * cell.batch + shard_bytes(cache, cspecs, mesh)
    return {"argument_size_in_bytes": int(args),
            "output_size_in_bytes": int(out),
            "temp_size_in_bytes": int(math.ceil(peak_live / n))}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             smoke: bool = False, devices=None, fill=None) -> dict:
    """One cell's record (module docstring).  ``devices``: the mesh's
    devices (default every shard on ``meta``); the model and arguments go
    on the first.  ``fill``: as ``specs.step_args`` (None: left empty).
    On ``meta`` the trace runs under ``native_meta_kernels`` and counts
    the data replicas ``replica_axes`` names from one and two of them
    (``count_collapsed``)."""

    n = 512 if multi_pod else 256
    devices = ["meta"] * n if devices is None else list(devices)
    meta = torch.device(devices[0]).type == "meta"
    with native_meta_kernels() if meta else contextlib.nullcontext():
        return _run_cell(arch, shape_name, multi_pod, smoke, devices, fill,
                         meta)


def replica_axes(sharder) -> tuple[str, ...]:
    """The mesh axes whose shards are data replicas: with the ``tp``
    profile the batch axes ("pod", "data"), over which every shard runs
    its block's program on the same shapes (its batch rows, its ZeRO-1
    slice); none under ``sp``, which shards weights over data, or under
    ``state_over_data``, whose cache splits over data."""
    if sharder.state_over_data or sharder.profile != "tp":
        return ()
    return tuple(a for a in ("pod", "data") if a in sharder.mesh.axis_names)


class Replicas:
    """The shards of ``mesh`` in its first ``ways`` blocks over ``axes``:
    the full mesh's shape and names, its coordinates and devices cut to
    those shards.  The shard programs run over ``coords()``; a collective
    or a gather fills the blocks of the shards left out with a listed
    one's (``parallel.sharding.groups``), so every tensor keeps its
    shape.  For ``meta`` counts only: nothing else of those blocks is
    computed."""

    def __init__(self, mesh, axes: tuple[str, ...], ways: int):
        from repro_torch.parallel.sharding import block_index
        self.shape, self.axis_names = mesh.shape, mesh.axis_names
        self._coords = [c for c in mesh.coords()
                        if block_index(mesh, c, axes) < ways]
        self.devices = tuple(mesh.devices[mesh.index(c)]
                             for c in self._coords)

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self) -> list[tuple[int, ...]]:
        return list(self._coords)


def count_step(cell, sharder, fill=None) -> tuple[dict, int]:
    """The cell's step on every shard of the sharder's mesh, counted: (the
    counter's result, its peak live bytes)."""
    from repro_torch.launch.hlo_cost import CostCounter
    from repro_torch.launch.specs import make_step_fn, step_args
    step = make_step_fn(cell, sharder)
    args = step_args(cell, sharder, fill=fill)
    with CostCounter() as counter:
        step(*args)
    return counter.result(), counter.peak_live_bytes


def _affine(one, two, full: int):
    """``one`` + (full - 1)(``two`` - ``one``), through nested dicts."""
    if isinstance(one, dict):
        return {k: _affine(one[k], two[k], full) for k in one}
    return one + (full - 1) * (two - one)


def count_collapsed(cell, sharder, fill=None) -> tuple[dict, int]:
    """The full mesh's count of ``cell`` from its first one and first two
    data replicas (``replica_axes``, ``Replicas``): each replica runs the
    same program on the same shapes, so a count is affine in the number
    of replicas (each adds its shards' ops, its members of each
    collective, and the adds that gather its gradients into what the
    replicas share), and the full mesh's is the first count plus
    (replicas - 1) times the difference.  -> (the result, the peak of
    live bytes extrapolated alike)."""
    from repro_torch.parallel.sharding import Sharder
    axes = replica_axes(sharder)
    full = math.prod(sharder.mesh.shape[a] for a in axes)
    (one, p1), (two, p2) = (
        count_step(cell, Sharder(Replicas(sharder.mesh, axes, w),
                             sharder.profile), fill) for w in (1, 2))
    return _affine(one, two, full), _affine(p1, p2, full)


def _run_cell(arch, shape_name, multi_pod, smoke, devices, fill,
              collapse) -> dict:
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import (cell_is_applicable,
                                          input_shardings, input_specs,
                                          make_cell, make_sharder)

    mesh_name = MESH_NAMES[multi_pod]
    t0 = time.time()
    cell = make_cell(arch, shape_name, smoke=smoke, device=devices[0])
    record: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": cell.kind, "seq": cell.seq, "batch": cell.batch,
        "profile": cell.cfg.sharding_profile,
    }
    ok, why = cell_is_applicable(cell.cfg, shape_name)
    if not ok:
        record["status"] = "SKIP"
        record["skip_reason"] = why
        return record

    mesh = make_production_mesh(multi_pod=multi_pod, devices=devices)
    sharder = make_sharder(cell, mesh)
    structs, dims = input_specs(cell)
    specs = input_shardings(cell, sharder, structs, dims)
    collapse = collapse and bool(replica_axes(sharder))
    t_lower = time.time() - t0

    t0 = time.time()
    if collapse:
        total, peak = count_collapsed(cell, sharder, fill)
    else:
        total, peak = count_step(cell, sharder, fill)
    t_trace = time.time() - t0

    cost = per_shard(total, mesh.size)
    record["memory_analysis"] = memory_analysis(
        cell, sharder, structs, specs, peak)
    record["hlo_cost"] = cost
    record["collectives_static"] = cost["collectives"]
    record["model_flops"] = analytic_model_flops(
        cell.cfg, cell.kind, cell.batch, cell.seq)
    record["n_params"] = cell.cfg.param_count()
    record["n_active_params"] = cell.cfg.active_param_count()
    record["lower_s"] = round(t_lower, 2)
    record["compile_s"] = round(t_trace, 2)
    record["n_devices"] = mesh.size
    record["state_over_data"] = sharder.state_over_data
    record["replicas_counted"] = ("collapsed over " + "+".join(
        replica_axes(sharder)) if collapse else "every shard")
    record["status"] = "OK"
    print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
          f"trace {t_trace:.1f}s, flops={cost['flops']:.3e}", flush=True)
    print(f"  memory_analysis: {record['memory_analysis']}", flush=True)
    return record


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(
        ("train_4k", "prefill_32k", "decode_32k", "long_500k")))
    ap.add_argument("--mesh", default="pod", choices=("pod", "multipod"))
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CI sanity only)")
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    rec = run_cell(args.arch, args.shape, args.mesh == "multipod", args.out,
                   smoke=args.smoke)
    mesh_name = rec["mesh"]
    path = os.path.join(
        args.out, f"{args.arch}__{args.shape}__{mesh_name}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[dryrun] wrote {path} status={rec['status']}")
    return 0 if rec["status"] in ("OK", "SKIP") else 1


if __name__ == "__main__":
    sys.exit(main())
