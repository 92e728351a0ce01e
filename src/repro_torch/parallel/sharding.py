"""Logical-axis sharding rules, divisibility-aware — the port of the JAX
package's ``parallel/sharding.py``, with the placement and the collectives
that PyTorch, having no GSPMD, must spell out.

Every parameter and activation of the model zoo is named by *logical* dims
(``ParamDef.dims``: ("vocab", "embed"), ("batch", "seq", "embed"), ...).  A
``Sharder`` resolves them to mesh axes through a rule table, with JAX's two
safety valves, so one rule set serves every arch on a fixed 16 x 16 (or
2 x 16 x 16) mesh:

  * divisibility — a dim shards only where the mesh axes divide its size,
    else it replicates (whisper-tiny's 6 heads on a 16-wide model axis);
  * profile — "tp" (Megatron tensor parallelism: heads, d_ff, vocab and
    experts on the model axis) or "sp" (sequence parallelism: activations
    seq-sharded on the model axis, weights sharded over data on their embed
    dim and gathered at use).

Batch shards over ("pod", "data") or ("data",); decode caches shard their
sequence over the model axis (flash-decoding).  ``spec`` returns a
``PartitionSpec`` that reads entry for entry as JAX's: None, an axis name,
or a tuple of them.

The placement follows ``parallel/halo.py``'s design: one process drives
every shard of a ``TileMesh``, each shard's tensors on its recorded device.
``shard`` cuts a global tensor into one local piece a mesh coordinate
(row-major), ``gather`` rebuilds it, and a collective (``psum``, ``pmax``,
``all_gather``) is a set of ``.to(device)`` copies and adds in a fixed
shard order over the coordinates that differ only on its axes.  Shards on
one device share a piece or a collective's result (a replica there is the
same tensor); on distinct devices each holds its own copy.  Every step is
an ordinary PyTorch op, so autograd runs through the collectives.  No
process group is used.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch

from repro_torch.launch import hlo_cost

# Logical dim -> candidate mesh axes, tried in order; first divisible wins.
_TP_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod+data",),     # composite: shards over pod AND data
    "tokens": ("pod+data",),    # flattened batch*seq (loss chunks)
    "seq": (),                  # replicated in tp profile (per-device full seq)
    "kv_seq": ("model",),       # decode cache: sequence-sharded (flash-decode)
    "embed": (),
    "heads": ("model",),
    "kv_heads": (),             # kv replicated; q heads carry the TP
    "q_per_kv": (),
    "head_dim": (),
    "dff": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "moe_groups": ("pod+data",),
    "expert_dff": (),
    "ssm_heads": ("model",),
    "ssm_headdim": (),
    "ssm_state": (),
    "conv_kernel": (),
    "conv_channels": ("model",),
    "groups": (),
    "enc_seq": (),
    "patches": (),
    "stage": ("pod",),          # pipeline stages ride the pod axis if used
    # Solver-family (learned-stencil) params: the tap dim is tiny (2*ndim),
    # so it replicates; grid rows may shard over data, columns/depth stay
    # local so each shard holds contiguous stencil rows.
    "taps": (),
    "grid_row": ("data",),
    "grid_col": (),
    "grid_depth": (),
}

_SP_RULES: dict[str, tuple[str, ...]] = dict(
    _TP_RULES,
    seq=("model",),
    tokens=("pod+data+model", "pod+data"),
    heads=(),
    dff=(),
    conv_channels=(),
    ssm_heads=(),
    # ZeRO-3-style: weights shard over data on their embed dim and are
    # all-gathered at use (activations' embed dim stays unsharded because
    # batch claims the data axis first — one axis is used at most once).
    embed=("data",),
    # vocab stays model-sharded: the lm_head matmul contracts embed (local)
    # and the xent reduction over vocab sums over the model axis.
)

PROFILES = {"tp": _TP_RULES, "sp": _SP_RULES}

Dims = tuple  # of str | None, one a tensor dim


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: one entry a dim, each None (replicated), a
    mesh axis name, or a tuple of axis names (sharded over their product,
    the first axis major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, in order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _is_dims(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


@dataclasses.dataclass(frozen=True)
class Sharder:
    """The rules of ``profile`` on ``mesh`` (anything with ``shape[name]``
    and ``axis_names``: a ``TileMesh``, or a stand-in for the rule tests).
    ``state_over_data``: batch-1 decode, where batch cannot shard, spreads
    the cache state over the data axis instead (ssm head-dim, kv seq)."""

    mesh: Any
    profile: str = "tp"
    state_over_data: bool = False

    def _axis_size(self, name: str) -> int:
        return self.mesh.shape[name]

    def _resolve(self, dim_name: str, size: int) -> Any:
        rules = dict(PROFILES[self.profile])
        if self.state_over_data:
            rules["ssm_headdim"] = ("data",)
            rules["kv_seq"] = ("model+data", "model")
        for cand in rules.get(dim_name, ()):
            axes = tuple(cand.split("+")) if "+" in cand else (cand,)
            axes = tuple(a for a in axes if a in self.mesh.axis_names)
            if not axes:
                continue
            total = 1
            for a in axes:
                total *= self._axis_size(a)
            if size % total == 0 and size > 0:
                return axes if len(axes) > 1 else axes[0]
        return None

    def spec(self, dims: Dims, shape: tuple[int, ...]) -> PartitionSpec:
        if len(dims) != len(shape):
            raise ValueError(f"dims {dims} vs shape {shape}")
        taken: set[str] = set()
        entries = []
        for d, s in zip(dims, shape):
            r = None if d is None else self._resolve(d, s)
            # one mesh axis may appear at most once in a spec
            flat = spec_axes(r)
            if r is not None and any(a in taken for a in flat):
                r = None
            if r is not None:
                taken.update(flat)
            entries.append(r)
        return P(*entries)

    def opt_spec(self, dims: Dims, shape: tuple[int, ...]) -> PartitionSpec:
        """ZeRO-1 spec for optimizer state / master params: the normal spec,
        plus the largest still-unsharded dim additionally sharded over the
        data axes.  Grads reduce into it; updated params gather out of
        it (``optim.adamw.apply_update`` with a sharder)."""
        base = self.spec(dims, shape)
        taken = set()
        for e in base:
            taken.update(spec_axes(e))
        axes = tuple(a for a in ("pod", "data") if a in self.mesh.axis_names
                     and a not in taken)
        if not axes:
            return base
        ways = 1
        for a in axes:
            ways *= self._axis_size(a)
        # largest unsharded dim divisible by the data ways
        cands = [(s, i) for i, s in enumerate(shape)
                 if base[i] is None and s % ways == 0 and s >= ways]
        if not cands:
            return base
        _, idx = max(cands)
        entries = list(base) + [None] * (len(shape) - len(base))
        entries[idx] = axes if len(axes) > 1 else axes[0]
        return P(*entries)

    @property
    def trivial(self) -> bool:
        """One shard: the sharded entry points take the unsharded path."""
        return math.prod(self.mesh.shape) == 1


def tree_specs(sharder: Sharder, tree_dims, tree_shapes, *,
               opt: bool = False):
    """Map a tree of logical-dims tuples and shapes to ``PartitionSpec``s
    (JAX's ``tree_shardings``; ``opt``: the ZeRO-1 ``opt_spec``)."""
    rule = sharder.opt_spec if opt else sharder.spec
    if _is_dims(tree_dims):
        return rule(tuple(tree_dims), tuple(tree_shapes))
    return {k: tree_specs(sharder, v, tree_shapes[k], opt=opt)
            for k, v in tree_dims.items()}


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def axes_size(mesh, axes: Sequence[str]) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def block_index(mesh, coord: tuple[int, ...], axes: Sequence[str]) -> int:
    """``coord``'s block along a dim sharded over ``axes`` (mixed radix, the
    first axis major, as JAX lays a tuple entry)."""
    k = 0
    for a in axes:
        i = mesh.axis_names.index(a)
        k = k * mesh.shape[i] + coord[i]
    return k


def local_slices(spec, shape: tuple[int, ...], mesh,
                 coord: tuple[int, ...]) -> tuple[slice, ...]:
    """The slices of a global tensor that the shard at ``coord`` holds."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for size, entry in zip(shape, entries):
        axes = spec_axes(entry)
        n = axes_size(mesh, axes)
        if size % n:
            raise ValueError(f"dim of {size} does not split over {axes}")
        b = size // n
        i = block_index(mesh, coord, axes)
        out.append(slice(i * b, (i + 1) * b))
    return tuple(out)


def shard(x: torch.Tensor, spec, mesh) -> list[torch.Tensor]:
    """One local piece of ``x`` a mesh coordinate (row-major), each on its
    shard's device; replicas on one device are the same tensor, on
    distinct devices copies.  Differentiable: a piece's gradient flows
    back into ``x``."""
    seen: dict = {}
    out = []
    for c, dev in zip(mesh.coords(), mesh.devices):
        sl = local_slices(spec, tuple(x.shape), mesh, c)
        key = (tuple((s.start, s.stop) for s in sl), dev)
        if key not in seen:
            seen[key] = x[sl].to(dev)
        out.append(seen[key])
    return out


def gather(pieces: Sequence[torch.Tensor], spec, mesh,
           device=None) -> torch.Tensor:
    """The global tensor from its pieces (``shard``'s inverse), on
    ``device`` (default the first shard's): each block from the first
    shard that holds it, concatenated in block order.  Differentiable."""
    device = torch.device(device) if device is not None else mesh.devices[0]
    ndim = pieces[0].dim()
    entries = tuple(spec) + (None,) * (ndim - len(spec))
    sharded = [(d, spec_axes(e)) for d, e in enumerate(entries) if e]
    blocks: dict = {}
    for k, c in enumerate(mesh.coords()):
        key = tuple(block_index(mesh, c, axes) for _, axes in sharded)
        blocks.setdefault(key, pieces[k])

    # A mesh that lists only some shards fills the others' blocks as
    # ``groups`` does (every block has one shape).
    fill = next(iter(blocks.values()))

    def build(prefix: tuple, level: int) -> torch.Tensor:
        if level == len(sharded):
            return blocks.get(prefix, fill).to(device)
        d, axes = sharded[level]
        return torch.cat([build(prefix + (i,), level + 1)
                          for i in range(axes_size(mesh, axes))], dim=d)

    return build((), 0)


def local_view(x: torch.Tensor, spec, mesh, keep=("model",)):
    """A tensor's pieces at use: ``shard``'s, then every spec entry whose
    axes are not all in ``keep`` all-gathered along its dim (sp's weights,
    sharded over data on their embed dim, gathered at use).  Returns
    (pieces, the spec they follow)."""
    pieces = shard(x, spec, mesh)
    kept = []
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axes and not set(axes) <= set(keep):
            pieces = all_gather(pieces, mesh, axes, d)
            entry = None
        kept.append(entry)
    return pieces, P(*kept)


def zeros_pieces(shape: tuple[int, ...], spec, mesh,
                 dtype: torch.dtype) -> list[torch.Tensor]:
    """``shard`` of a zero tensor of ``shape``, made piece by piece on the
    shards' devices (replicas on one device the same tensor)."""
    made: dict = {}
    out = []
    for c, dev in zip(mesh.coords(), mesh.devices):
        sl = local_slices(spec, shape, mesh, c)
        key = (tuple((s.start, s.stop) for s in sl), dev)
        if key not in made:
            made[key] = torch.zeros([s.stop - s.start for s in sl],
                                    dtype=dtype, device=dev)
        out.append(made[key])
    return out


def block_start(mesh, coord, entry, size: int) -> int:
    """The first index of ``coord``'s block along a dim of ``size`` laid
    by spec ``entry``."""
    axes = spec_axes(entry)
    return block_index(mesh, coord, axes) * (size // axes_size(mesh, axes))


@dataclasses.dataclass
class Sharded:
    """A global tensor of ``shape`` held as ``pieces``, one a shard of
    ``mesh`` (row-major), laid by ``spec``: what a sharded entry point
    returns (a prefill's cache, a decode step's logits)."""

    pieces: list[torch.Tensor]
    spec: PartitionSpec
    shape: tuple[int, ...]
    mesh: Any

    def gather(self, device=None) -> torch.Tensor:
        return gather(self.pieces, self.spec, self.mesh, device)


# ---------------------------------------------------------------------------
# Collectives: copies and adds in a fixed shard order
# ---------------------------------------------------------------------------

def groups(mesh, axes) -> list[list[int]]:
    """The shards (positions in ``mesh.coords()``) that agree on every
    axis but ``axes``, each group in block order over ``axes``.  A mesh
    that lists only some of its shards (``launch/dryrun.py``'s replicas,
    on ``meta``) fills a block no listed shard holds with the group's
    first member, whose piece has its shape."""
    axes = spec_axes(axes)
    n = axes_size(mesh, axes)
    out: dict = {}
    for k, c in enumerate(mesh.coords()):
        rest = tuple(i for a, i in zip(mesh.axis_names, c) if a not in axes)
        out.setdefault(rest, {})[block_index(mesh, c, axes)] = k
    return [[g.get(b, g[min(g)]) for b in range(n)] for g in out.values()]


def _collective(values: Sequence[torch.Tensor], mesh, axes, combine,
                kind: str):
    """``combine`` of the group's values, copied to each shard's device in
    group order; shards on one device share the result.  A counting
    ``launch.hlo_cost.CostCounter`` sees one ``kind`` collective a group
    member (its piece in, the result out), not the copies and adds."""
    if not spec_axes(axes):
        return list(values)
    out: list = [None] * len(values)
    done: dict = {}
    counting = hlo_cost.counting()
    with hlo_cost.quiet():
        for group in groups(mesh, axes):
            for k in dict.fromkeys(group):
                dev = mesh.devices[k]
                key = (dev, tuple(id(values[j]) for j in group))
                if key not in done:
                    done[key] = [combine([values[j].to(dev) for j in group]),
                                 0, hlo_cost.nbytes(values[k])]
                done[key][1] += 1
                out[k] = done[key][0]
    if counting:
        # One count a member; the gradient's transpose once a shared
        # result, for the members that share it.
        for result, members, operand in done.values():
            hlo_cost.collective(kind, operand, hlo_cost.nbytes(result),
                                members, grad_of=result)
    return out


def _sum(ts):
    total = ts[0]
    for t in ts[1:]:
        total = total + t
    return total


def _max(ts):
    total = ts[0]
    for t in ts[1:]:
        total = torch.maximum(total, t)
    return total


def psum(values, mesh, axes) -> list[torch.Tensor]:
    """All-reduce sum over ``axes``, added in block order."""
    return _collective(values, mesh, axes, _sum, "all-reduce")


def row_product(a: torch.Tensor, w: torch.Tensor,
                partial: bool) -> torch.Tensor:
    """``a @ w`` for a row-parallel weight: where its rows split
    (``partial``), the partial product in fp32 (the operands in their type,
    each product exact in fp32), to be added by ``psum_rounded``; else as
    on one device."""
    if partial:
        return a.float() @ w.float()
    return a @ w


def psum_rounded(values, mesh, axes, dtype) -> list[torch.Tensor]:
    """``psum`` of row-parallel partial products (``row_product``), added
    in fp32 and rounded once to ``dtype``: JAX's SPMD program all-reduces
    the f32 dot outputs and converts after (its all-reduces are f32 on the
    host devices), so a sharded bf16 product rounds once, as the
    unsharded one does."""
    return [t.to(dtype) for t in psum(values, mesh, axes)]


def pmax(values, mesh, axes) -> list[torch.Tensor]:
    """All-reduce max over ``axes``."""
    return _collective(values, mesh, axes, _max, "all-reduce")


def all_gather(values, mesh, axes, dim: int) -> list[torch.Tensor]:
    """Concatenate the group's pieces along ``dim`` in block order."""
    return _collective(values, mesh, axes,
                       lambda ts: torch.cat(ts, dim=dim), "all-gather")
