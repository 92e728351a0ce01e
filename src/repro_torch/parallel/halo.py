"""Halo exchange over a grid of tiles: the JAX package's ``parallel/halo.py``.

The WSE's fabric places grid tiles on a 2D mesh of PEs with single-hop
neighbour links.  The JAX package maps that onto a device mesh under
``shard_map``: one program, each device a tile, halos traded by
``lax.ppermute``.  The port keeps the one-program model without a process
group: a :class:`TileMesh` records an ``n_row x n_col`` grid of tiles, each
on a ``torch.device``, one process holds every tile, and an exchange is a
set of edge copies between tiles (``.to(device)`` where the neighbour sits
on another device).  So every tile may sit on one card, or on the CPU.

Exchanges run columns first, then rows of the column-augmented tiles, so
the corner halos ride along; the shifts do not wrap, so edge tiles receive
zeros (the zero padding of the stencil oracle).  A halo may be deeper than
the stencil radius (deep-halo temporal fusion, ``core/distributed.py``) but
never deeper than the local extent: one phase reaches one neighbour.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Sequence

import torch


class MeshShape(tuple):
    """The mesh's axis sizes that also answer ``shape[axis_name]``, as a
    JAX mesh's ``shape`` does."""

    def __new__(cls, sizes, axis_names):
        obj = super().__new__(cls, sizes)
        obj.axis_names = tuple(axis_names)
        return obj

    def __getitem__(self, key):
        if isinstance(key, str):
            return tuple.__getitem__(self, self.axis_names.index(key))
        return tuple.__getitem__(self, key)

    def get(self, key: str, default=None):
        return self[key] if key in self.axis_names else default


@dataclasses.dataclass(frozen=True)
class TileMesh:
    """A grid of shards over named axes: ``devices`` holds each shard's
    device in row-major order over ``axis_names``.  The halo path tiles a
    2D grid over two axes; the LM's sharder (``parallel/sharding.py``) and
    the pipeline (``parallel/pipeline.py``) take any number."""

    shape: MeshShape
    axis_names: tuple[str, ...]
    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self) -> list[tuple[int, ...]]:
        """Every shard's coordinate, one index an axis, row-major."""
        return list(itertools.product(*(range(n) for n in self.shape)))

    def index(self, coord) -> int:
        """The row-major position of ``coord`` in ``devices``."""
        k = 0
        for i, n in zip(coord, self.shape):
            k = k * n + i
        return k

    def device_at(self, pos: dict) -> torch.device:
        """The device of the shard at ``pos`` ({axis name: index}; an axis
        not named sits at 0)."""
        return self.devices[self.index(
            tuple(pos.get(a, 0) for a in self.axis_names))]


def make_mesh(shape: tuple[int, ...],
              axis_names: tuple[str, ...] = ("data", "model"),
              devices=None) -> TileMesh:
    """A :class:`TileMesh` of ``shape`` shards over ``axis_names`` (one a
    dim of ``shape``).

    ``devices`` is one device for every shard, or one a shard in row-major
    order; any ``torch.device`` will do (``"meta"`` places nothing, for
    meshes that only price or resolve specs).  Without it the shards go
    round-robin on the visible CUDA devices, and where there is none this
    raises: the CPU is used only when named.
    """
    sizes = tuple(int(s) for s in shape)
    if not sizes or min(sizes) < 1:
        raise ValueError(f"mesh shape must be positive, got {tuple(shape)}")
    if len(axis_names) != len(sizes) or \
            len(set(axis_names)) != len(axis_names):
        raise ValueError(f"a {len(sizes)}-axis mesh needs {len(sizes)} "
                         f"distinct axis names, got {tuple(axis_names)}")
    n = math.prod(sizes)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh places shards on the CUDA devices by default and "
                "none is available here; pass devices='cpu' to shard on "
                "the CPU")
        count = torch.cuda.device_count()
        devs = [torch.device("cuda", k % count) for k in range(n)]
    elif isinstance(devices, (str, torch.device)):
        devs = [torch.device(devices)] * n
    else:
        devs = [torch.device(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"{len(devs)} devices for a "
                             f"{'x'.join(map(str, sizes))} mesh of {n} "
                             f"shards")
    return TileMesh(MeshShape(sizes, axis_names), tuple(axis_names),
                    tuple(devs))


def _shift_perm(n: int, direction: int) -> list[tuple[int, int]]:
    """Pairs (source, destination) sending tile i -> i+direction
    (non-wrapping)."""
    if direction > 0:
        return [(i, i + 1) for i in range(n - 1)]
    return [(i + 1, i) for i in range(n - 1)]


def _permute(edges: Sequence[torch.Tensor],
             dst_like: Sequence[torch.Tensor],
             perm: list[tuple[int, int]]) -> list[torch.Tensor]:
    """``edges[src]`` delivered to each destination's device; zeros where
    no tile sends (the non-wrapping ends)."""
    out: list[torch.Tensor | None] = [None] * len(edges)
    for src, dst in perm:
        out[dst] = edges[src].to(dst_like[dst].device)
    return [torch.zeros_like(e, device=d.device) if o is None else o
            for o, e, d in zip(out, edges, dst_like)]


def exchange_1d(tiles: Sequence[torch.Tensor], dim: int,
                r: int = 1) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Gather r-deep halos along ``dim`` from both neighbours in a line of
    tiles.

    Returns (lo_halo, hi_halo) for each tile: each has extent r along
    ``dim``, zeros at the ends of the line.  ``r`` may exceed the stencil
    radius but never the local extent: one exchange phase reaches only the
    adjacent tile.
    """
    size = tiles[0].shape[dim]
    if r > size:
        raise ValueError(
            f"halo depth {r} exceeds the local extent {size} along dim {dim} "
            f"— one exchange phase can only fetch what the adjacent shard "
            f"owns (shrink the fuse depth or the device mesh)")
    n = len(tiles)
    hi_edges = [t.narrow(dim, size - r, r) for t in tiles]
    lo_edges = [t.narrow(dim, 0, r) for t in tiles]
    # neighbour i-1's high edge arrives as our low halo
    lo = _permute(hi_edges, tiles, _shift_perm(n, +1))
    hi = _permute(lo_edges, tiles, _shift_perm(n, -1))
    return list(zip(lo, hi))


def exchange_halo_2d(tiles: Sequence[torch.Tensor], n_row: int, n_col: int,
                     r: int = 1) -> list[torch.Tensor]:
    """Row-major tiles (..., h, w) -> (..., h+2r, w+2r) with halos filled.

    Phase 1 exchanges columns along each row of tiles, phase 2 rows of the
    column-augmented tiles along each column, so corner halos ride along:
    any radius-r box stencil, any depth ``r <= min(h, w)``.
    """
    if len(tiles) != n_row * n_col:
        raise ValueError(f"{len(tiles)} tiles for a {n_row}x{n_col} mesh")
    wdim = tiles[0].ndim - 1
    hdim = tiles[0].ndim - 2
    wide: list[torch.Tensor] = []
    for i in range(n_row):
        line = tiles[i * n_col:(i + 1) * n_col]
        for t, (left, right) in zip(line, exchange_1d(line, wdim, r)):
            wide.append(torch.cat([left, t, right], dim=wdim))
    out: list[torch.Tensor | None] = [None] * len(tiles)
    for j in range(n_col):
        col = wide[j::n_col]
        for i, (t, (top, bot)) in enumerate(zip(col,
                                                exchange_1d(col, hdim, r))):
            out[i * n_col + j] = torch.cat([top, t, bot], dim=hdim)
    return out
