"""Op-level cost counter — the port of the JAX package's
``launch/hlo_cost.py``.

JAX parses the optimised HLO of a compiled step and multiplies each loop
body by its trip count.  Eager PyTorch has neither HLO nor loops to
multiply: a step is the sequence of ops it dispatches.  ``analyze(fn,
*args, **kwargs)`` runs ``fn`` once under ``CostCounter``, a
``TorchDispatchMode`` that sees every aten op the step runs, forward and
backward (a checkpointed region's recompute included, as JAX's remat
counts twice), and returns JAX's keys:

  flops                   matrix products and convolutions (JAX's MXU
                          term): ``torch.utils.flop_counter``'s formulas,
                          plus each hand-written kernel's analytic count
  hbm_bytes               sum of operand and result bytes over every op
                          that materialises; views (``view``, ``slice``,
                          ``transpose``, ``expand``, ...) and allocations
                          without a write (``empty``) count nothing.
                          Eager PyTorch fuses nothing, so this is what the
                          eager program moves, not JAX's number (which
                          charges a fusion its operands and result once)
  collectives             per kind {count, operand_bytes, result_bytes}
  collective_bytes_total  the operand bytes of every kind

Kernels.  A hand-written kernel's wrapper charges its analytic work once
a call (``kernel_cost``), whether it launches on the card (one launch or
several: K2's trapezoid passes, a batch in slices), runs its plain
version on the CPU or, on ``meta``, only makes its outputs' shapes; the
ops inside are not counted again.  So a counted step or solve gives the
same numbers on ``cpu``, ``meta`` and ``cuda``.  The bytes are what JAX
charges a Pallas ``custom-call`` as a memory-level instruction: its
operands read and its result written once (the port's operands, which
its kernels do not pad).  The flops: K6/K7 4·hd a visible (query, key)
pair and head, K8 6·hd, K9 8·hd; K5 its product's 2·S·N²; K1-K4 none,
since JAX's flops count only matrix products and convolutions and a
stencil's shifted adds are neither (K1-K4 charge x, a variable spec's
fp32 field stack and the result: ``kernels/stencil2d.stencil_bytes``).

Collectives are counted logically, in the function that performs them
(``parallel/sharding._collective``: ``psum`` and ``pmax`` as
``all-reduce``, ``all_gather`` as ``all-gather``; ``parallel/pipeline.
hand_off`` as ``collective-permute``), once a member of each group, as if
every shard were on its own device: on one device (the meta dry run, the
card with every shard on cuda:0) shards share pieces and results and copy
nothing, so no copy would show.  A member's operand is its own piece, its
result the combined tensor; both bytes also go to ``hbm_bytes``, as JAX's
analyser charges a collective instruction.  The ops inside a collective
are not counted again.  Where autograd runs back through a collective its
transpose is counted when the gradient arrives: ``all-reduce`` (of
``psum``) again, ``reduce-scatter`` (of ``all_gather``),
``collective-permute`` (of a hand-off).

The counts are totals over every shard of the mesh the step runs on: one
process drives all of them.  ``launch/dryrun.py`` divides by the shard
count to give JAX's per-device figures.

``peak_live_bytes``: the most bytes held at once by tensors the step made
(outputs of materialising ops, the kernels' and collectives' included),
tracked by their storages: each is held by the counter and dropped once
nothing else uses it, a sweep each time the bytes made since the last one
pass ``SWEEP_FRACTION`` of the bytes then live and the storages made
since pass that fraction of those held or ``SWEEP_MIN_STORAGES`` (so a
sweep's cost, a look at every storage held, is spread over the storages
made since; the peak may count a tensor freed since the last sweep).  Tensors made before the count (the
step's arguments) are not charged.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
# The transpose counted when a collective's gradient arrives.
TRANSPOSE = {"all-reduce": "all-reduce", "all-gather": "reduce-scatter",
             "collective-permute": "collective-permute"}
SWEEP_FRACTION = 0.05
SWEEP_MIN_STORAGES = 256

_ACTIVE: list = []          # the counters recording, innermost last
_QUIET = [0]                # depth of kernel and collective bodies

# Ops that make no bytes of their own: aliases and bare allocations.
_FREE = frozenset((
    "detach", "alias", "lift_fresh", "_unsafe_view", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "_local_scalar_dense",
    "resize_", "set_", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "is_same_size", "_has_compatible_shallow_copy_type",
    "record_stream"))


_TO_COPY = torch.ops.aten._to_copy.default
_UNSEEN = object()


def counting() -> bool:
    """Whether a ``CostCounter`` is recording."""
    return bool(_ACTIVE)


def nbytes(t) -> int:
    """Bytes of a tensor's elements (0 for anything else)."""
    return t.nbytes if isinstance(t, torch.Tensor) else 0


def _tensors_bytes(xs) -> int:
    total = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            total += x.nbytes
        elif isinstance(x, (list, tuple)):
            total += _tensors_bytes(x)
    return total


@contextlib.contextmanager
def quiet():
    """Ops inside are not counted (their cost is charged another way)."""
    _QUIET[0] += 1
    try:
        yield
    finally:
        _QUIET[0] -= 1


@contextlib.contextmanager
def kernel_cost(flops: float, hbm: float):
    """Charge a hand-written kernel its analytic ``flops`` and ``hbm``
    bytes in every active counter; the ops of its body (a launch's
    allocations, a plain version, a meta branch) are not counted."""
    for c in _ACTIVE:
        c.flops += flops
        c.hbm_bytes += hbm
    with quiet():
        yield


def collective(kind: str, operand: int, result: int, members: int = 1,
               grad_of=None) -> None:
    """Count ``members`` members of a ``kind`` collective, each moving
    ``operand`` bytes in and ``result`` out; where ``grad_of`` (the
    result tensor) will take a gradient, its transpose is counted when the
    gradient arrives."""
    for c in _ACTIVE:
        c.add_collective(kind, operand, result, members)
    if (grad_of is not None and grad_of.requires_grad
            and torch.is_grad_enabled()):
        counters = list(_ACTIVE)
        back = TRANSPOSE[kind]

        def hook(grad):
            for c in counters:
                c.add_collective(back, result, operand, members)

        grad_of.register_hook(hook)


def visible_pairs(Sq: int, Skv: int, causal: bool, kv_offset: int) -> int:
    """The (query, key) pairs the flash kernels attend: key j at position
    j - kv_offset is seen by query i where j - kv_offset < Skv and, when
    causal, j - kv_offset <= i (``kernels/flash_attention.py``)."""
    U = max(0, min(Skv, Skv + kv_offset))
    if not causal:
        return Sq * U
    c = kv_offset + 1                  # query i sees min(U, i + c) keys
    lo = min(max(0, 1 - c), Sq)
    hi = min(max(U - c, lo), Sq)
    ramp = (hi - lo) * c + (hi - lo) * (lo + hi - 1) // 2
    return ramp + (Sq - hi) * U


def attention_cost(q, k, causal: bool, kv_offset: int,
                   flops_per_pair: int) -> float:
    """``flops_per_pair`` · hd flops a visible pair, head and batch row."""
    B, Sq, H, hd = q.shape
    return float(flops_per_pair * hd * B * H
                 * visible_pairs(Sq, k.shape[1], causal, kv_offset))


class CostCounter(TorchDispatchMode):
    """Counts the ops dispatched inside it (module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.collectives = {k: {"count": 0.0, "operand_bytes": 0.0,
                                "result_bytes": 0.0} for k in KINDS}
        self.peak_live_bytes = 0
        self._held: dict = {}       # storage key -> (storage, bytes)
        self._live = 0              # bytes held at the last sweep + since
        self._made = 0              # bytes made since the last sweep
        self._new = 0               # storages made since the last sweep
        self._ops: dict = {}        # op -> None (free) or (flop formula
                                    # or None, whether it makes storage)

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        self._sweep()
        self._held.clear()
        return super().__exit__(*exc)

    def add_collective(self, kind, operand, result, members) -> None:
        c = self.collectives[kind]
        c["count"] += members
        c["operand_bytes"] += members * operand
        c["result_bytes"] += members * result
        self.hbm_bytes += members * (operand + result)

    def _classify(self, func):
        name = func._schema.name.split("::")[-1]
        if func.is_view or name in _FREE:
            entry = None
        else:
            # An in-place or out= op writes storage made elsewhere.
            entry = (flop_registry.get(func._overloadpacket),
                     not func._schema.is_mutable)
        self._ops[func] = entry
        return entry

    def _track(self, out) -> None:
        if not isinstance(out, torch.Tensor):
            if isinstance(out, (list, tuple)):
                for o in out:
                    self._track(o)
            return
        st = out.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = (st, n)
        self._live += n
        self._made += n
        self._new += 1
        if self._live > self.peak_live_bytes:
            self.peak_live_bytes = self._live
        if (self._made > SWEEP_FRACTION * self._live
                and self._new >= min(SWEEP_MIN_STORAGES,
                                     SWEEP_FRACTION * len(self._held))):
            self._sweep()

    def _sweep(self) -> None:
        """Drop the storages only the counter still holds."""
        use = torch._C._storage_Use_Count
        dead = [k for k in self._held if use(k) <= 1]
        for k in dead:
            self._live -= self._held.pop(k)[1]
        self._made = self._new = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        entry = self._ops.get(func, _UNSEEN)
        if entry is _UNSEEN:
            entry = self._classify(func)
        if entry is None:
            return out
        flop, makes = entry
        if makes:
            self._track(out)
        if _QUIET[0] or (func is _TO_COPY and args[0].device.type == "cpu"
                         and out.device.type != "cpu"):
            # A host tensor put on the device (a table made with numpy):
            # JAX's constant, which its analyser charges nothing.
            return out
        moved = _tensors_bytes(args) + (out.nbytes if isinstance(
            out, torch.Tensor) else _tensors_bytes((out,)))
        if kwargs:
            moved += _tensors_bytes(kwargs.values())
        self.hbm_bytes += moved
        if flop is not None:
            self.flops += flop(*args, **kwargs, out_val=out)
        return out

    def result(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collectives": {k: dict(v) for k, v in self.collectives.items()},
            "collective_bytes_total": sum(c["operand_bytes"] for c in
                                          self.collectives.values()),
        }


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under a ``CostCounter``: JAX's
    ``analyze`` keys (module docstring)."""
    with CostCounter() as c:
        fn(*args, **kwargs)
    return c.result()
