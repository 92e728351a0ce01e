"""Distributed Jacobi: the paper's wafer-fabric decomposition on a tile mesh
(the JAX package's ``core/distributed.py``).

The CS-1 compiler placed the grid across PEs with neighbour routing; here
the grid splits into ``n_row x n_col`` tiles of a :class:`TileMesh`
(``parallel/halo.py``) and each exchange gathers radius-``r*fuse`` halos
before ``fuse`` *local* stencil iterations on every tile: communication
O(perimeter), compute O(area), the classic HPC decomposition the WSE
performs in hardware.  One process drives every tile, as one JAX program
drives every shard.

Two communication-avoiding tricks from the wafer-scale scaling papers
(Rocki et al. 2010.03660; Jacquelin et al. 2204.03775):

* **Deep-halo temporal fusion** (``fuse=k``): one ``r*k``-deep exchange buys
  ``k`` local iterations.  The valid region of the halo-augmented tile
  shrinks by ``r`` per local step (the trapezoid), so the chunk runs
  ``iterations/k`` exchanges at the price of recomputing the shrinking rim
  (priced by ``kernels/tiling.py::halo_fuse_redundancy``).

* **Interior/rim split**: the step consuming the exchange computes the tile
  *interior* (no halo dependency) from the local tile before the exchange
  is issued; only the four rim strips read the augmented tile, and the
  pieces are concatenated into a fresh buffer.  Where the tiles sit on
  different devices the interior's launches are queued before the edge
  copies.

The local update is plain PyTorch, as the JAX package's is plain ``jnp``:
shifted multiply-adds summed in fp32 in the spec's tap order, so an fp32
tile update equals the ``reference`` backend's bit for bit.  The batch
rides whole on every tile, or splits over a third mesh axis
(``batch_axis``): each batch block then exchanges among its own tiles.

Variable-coefficient specs split their per-cell ``WeightField`` taps with
the grid: the stacked fields are exchanged *once per chunk* (they are
iteration-invariant) at the depth the fused output margins need, then every
local step slices the cell-aligned weights out of the augmented field tile.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.boundary import DirichletBC
from repro_torch.core.stencil import StencilSpec, WeightField
from repro_torch.parallel.halo import exchange_halo_2d

# One exchange_halo_2d call = two directions x two mesh axes.
HALO_PHASES_PER_EXCHANGE = 4


def halo_comm_rounds(iterations: int, fuse: int = 1, *,
                     variable: bool = False) -> int:
    """Exchange rounds a chunk of ``iterations`` executes at depth ``fuse``
    — the quantity deep-halo fusion divides by ``fuse``.  Variable specs
    pay one extra exchange for the weight fields per chunk."""
    rounds = HALO_PHASES_PER_EXCHANGE * -(-iterations // fuse)
    if variable:
        rounds += HALO_PHASES_PER_EXCHANGE
    return rounds


def max_halo_fuse(radius: int, h_loc: int, w_loc: int) -> int:
    """Deepest legal fuse on a (h_loc, w_loc) tile: one exchange phase only
    reaches the adjacent tile, so the halo depth ``radius*fuse`` cannot
    exceed the local extent."""
    return max(1, min(h_loc, w_loc) // max(radius, 1))


def _stencil_acc(xb: torch.Tensor, spec: StencilSpec, r: int,
                 fields: torch.Tensor | None) -> torch.Tensor:
    """Raw shifted-add stencil: (..., oh+2r, ow+2r) -> (..., oh, ow) in f32.

    ``fields`` is the output-aligned stack of per-cell weights for the
    spec's variable taps, (n_var, oh, ow), or None for all-scalar specs.
    """
    oh, ow = xb.shape[-2] - 2 * r, xb.shape[-1] - 2 * r
    acc = None
    ti = 0
    for off, wgt in spec.taps:
        sl = xb[..., r + off[0]: r + off[0] + oh,
                r + off[1]: r + off[1] + ow].float()
        if isinstance(wgt, WeightField):
            term = sl * fields[ti]
            ti += 1
        else:
            term = sl * float(np.float32(wgt))
        acc = term if acc is None else acc + term
    return acc


def _span(lo: int, hi: int, coords: range) -> slice:
    """Local indices of the global coordinates [lo, hi) within ``coords``
    (a contiguous range of global coordinates)."""
    n = len(coords)
    return slice(min(max(lo - coords.start, 0), n),
                 min(max(hi - coords.start, 0), n))


def _mask_zones(acc, bc_value, grows: range, gcols: range, H, W, dtype):
    """Dirichlet semantics over the (possibly domain-exceeding) region:
    interior cells keep the stencil result, the domain shell is pinned to
    ``bc_value``, cells outside the global grid are zero — exactly the
    oracle's zero padding, so fused rim cells iterate to the same values a
    single-device solve produces.  ``grows`` and ``gcols`` are the region's
    global row and column coordinates.

    The fixup writes only the region's lines that leave the interior, in
    place on ``acc`` (a fresh sum): what JAX's two ``where`` selections give
    cell by cell, at O(perimeter) work, and nothing where the region lies
    inside the interior."""
    bc = float(np.float32(bc_value))
    for rs in (_span(grows.start, 0, grows), _span(H, grows.stop, grows)):
        if rs.start < rs.stop:
            acc[..., rs, :].fill_(0.0)
    for cs in (_span(gcols.start, 0, gcols), _span(W, gcols.stop, gcols)):
        if cs.start < cs.stop:
            acc[..., :, cs].fill_(0.0)
    rows, cols = _span(0, H, grows), _span(0, W, gcols)
    for rs in {_span(0, 1, grows), _span(H - 1, H, grows)}:
        if rs.start < rs.stop and cols.start < cols.stop:
            acc[..., rs, cols].fill_(bc)
    for cs in {_span(0, 1, gcols), _span(W - 1, W, gcols)}:
        if cs.start < cs.stop and rows.start < rows.stop:
            acc[..., rows, cs].fill_(bc)
    return acc.to(dtype)


def make_halo_runner(mesh, spec: StencilSpec, *, H: int, W: int,
                     bc_value: float, iterations: int,
                     row_axis: str = "data", col_axis: str = "model",
                     batch_axis: str | None = None, fuse: int = 1):
    """Builds a (batch, H, W) -> (batch, H, W) halo-exchange stepper.

    The input is split into the mesh's tiles (rows over ``row_axis``,
    columns over ``col_axis``, and with ``batch_axis`` the batch into as
    many blocks as that axis has shards: JAX's P(batch_axis, row_axis,
    col_axis)), each moved to its tile's device (block b's tile (i, j) at
    ``mesh.device_at({batch_axis: b, row_axis: i, col_axis: j})``); the
    chunk runs there, each block's halos traded among its own tiles, and
    the tiles are gathered back onto the input's device.  A batch that the
    batch axis does not divide raises, as JAX's sharding does.
    This is the distribution primitive the ``halo`` backend of
    ``core.plan.make_plan`` wraps; user-facing entry points are
    ``stencil_apply(..., backend="halo", mesh=...)`` for a fixed step count
    and ``core.solver.solve(..., backend="halo", mesh=...)`` for a full
    run-to-convergence time loop.

    ``fuse=k`` exchanges an ``r*k``-deep halo once per ``k`` local
    iterations (must divide ``iterations``; depth bounded by the local tile
    extent — see :func:`max_halo_fuse`).
    """
    if spec.ndim != 2:
        raise ValueError("distributed jacobi is 2D (the paper's fig-5 path)")
    r = spec.radius
    n_row = mesh.shape[row_axis]
    n_col = mesh.shape[col_axis]
    if H % n_row or W % n_col:
        raise ValueError(f"grid {H}x{W} must tile over {n_row}x{n_col}")
    h_loc, w_loc = H // n_row, W // n_col
    if fuse < 1:
        raise ValueError(f"fuse must be >= 1, got {fuse}")
    if iterations % fuse:
        raise ValueError(
            f"iterations={iterations} not divisible by fuse={fuse}")
    R = r * fuse                 # exchanged halo depth
    Rf = R - r                   # field halo depth = deepest output margin
    if R > min(h_loc, w_loc):
        raise ValueError(
            f"fuse={fuse} needs a {R}-deep halo but the local tile is only "
            f"{h_loc}x{w_loc} over the {n_row}x{n_col} mesh (max fuse "
            f"{max_halo_fuse(r, h_loc, w_loc)})")
    var_fields = spec.field_stack() if spec.is_variable else None
    # The interior/rim split needs a non-empty interior window; degenerate
    # tiles (extent < 2r) fall back to the monolithic rim-only update.
    split = min(h_loc, w_loc) >= 2 * r

    # Block b's tile (i, j) sits b along batch_axis, i along row_axis and j
    # along col_axis; its device is the mesh's, whichever order the mesh
    # names its axes in.
    n_batch = 1 if batch_axis is None else mesh.shape[batch_axis]
    blocks = [[mesh.device_at({batch_axis: b, row_axis: i, col_axis: j})
               for i in range(n_row) for j in range(n_col)]
              for b in range(n_batch)]

    def zones(acc, row0, col0, dtype):
        """The Dirichlet fixup of a region whose first cell is global
        (row0, col0)."""
        return _mask_zones(acc, bc_value, range(row0, row0 + acc.shape[-2]),
                           range(col0, col0 + acc.shape[-1]), H, W, dtype)

    def field_slice(f_aug, m):
        """Output-aligned weight fields for the margin-``m`` region."""
        if f_aug is None:
            return None
        return f_aug[:, Rf - m: Rf + h_loc + m, Rf - m: Rf + w_loc + m]

    def update(xb, m, row0, col0, f_aug, dtype):
        """Full margin-``m`` update from a margin-``m+r`` input block."""
        return zones(_stencil_acc(xb, spec, r, field_slice(f_aug, m)),
                     row0 - m, col0 - m, dtype)

    def interior_update(x, row0, col0, f_local):
        """The tile's interior, which needs no halo: from the local tile."""
        return zones(_stencil_acc(
            x, spec, r,
            None if f_local is None
            else f_local[:, r:h_loc - r, r:w_loc - r]),
            row0 + r, col0 + r, x.dtype)

    def split_update(xp, m, row0, col0, interior, f_aug, dtype):
        """The exchange-consuming step: four rim strips read the augmented
        tile ``xp`` (margin m+r) and join the interior into a fresh
        margin-``m`` buffer."""
        h, w = h_loc, w_loc

        def strip(rows, cols, out_rows, out_cols):
            # f_aug carries margin Rf == m, so its index space coincides
            # with the output's — the out ranges slice both.
            acc = _stencil_acc(
                xp[..., rows[0]:rows[1], cols[0]:cols[1]], spec, r,
                None if f_aug is None
                else f_aug[:, out_rows[0]:out_rows[1],
                           out_cols[0]:out_cols[1]])
            return zones(acc, row0 - m + out_rows[0],
                         col0 - m + out_cols[0], dtype)

        s = m + r  # rim strip width (in output cells)
        top = strip((0, s + 2 * r), (0, w + 2 * m + 2 * r),
                    (0, s), (0, w + 2 * m))
        bot = strip((h + m - r, h + 2 * m + 2 * r), (0, w + 2 * m + 2 * r),
                    (h + m - r, h + 2 * m), (0, w + 2 * m))
        left = strip((s, h + m + r), (0, s + 2 * r),
                     (s, h + m - r), (0, s))
        right = strip((s, h + m + r), (w + m - r, w + 2 * m + 2 * r),
                      (s, h + m - r), (w + m - r, w + 2 * m))
        mid = torch.cat([left, interior, right], dim=-1)
        return torch.cat([top, mid, bot], dim=-2)

    origins = [(i * h_loc, j * w_loc) for i in range(n_row)
               for j in range(n_col)]

    def run(x0: torch.Tensor) -> torch.Tensor:
        x0 = DirichletBC(bc_value).set_boundary(x0, 2)
        if n_batch == 1:
            return chunk(x0, blocks[0])
        B = x0.shape[0]
        if B % n_batch:
            raise ValueError(
                f"the batch of {B} grids does not divide over the "
                f"{n_batch} shards of mesh axis {batch_axis!r}")
        b = B // n_batch
        return torch.cat([chunk(x0[k * b:(k + 1) * b], devices)
                          for k, devices in enumerate(blocks)], dim=0)

    def chunk(x0: torch.Tensor, devices: list) -> torch.Tensor:
        """The chunk on one batch block's tiles, gathered onto x0's
        device."""
        dtype = x0.dtype
        tiles = [x0[..., r0:r0 + h_loc, c0:c0 + w_loc].to(d)
                 for (r0, c0), d in zip(origins, devices)]
        f_local = f_aug = [None] * len(tiles)
        if var_fields is not None:
            f_local = [torch.as_tensor(
                var_fields[:, r0:r0 + h_loc, c0:c0 + w_loc], device=d)
                for (r0, c0), d in zip(origins, devices)]
            f_aug = f_local if Rf == 0 else exchange_halo_2d(
                f_local, n_row, n_col, Rf)
        for _ in range(iterations // fuse):
            m = R - r
            if split:
                interiors = [interior_update(t, r0, c0, f)
                             for t, (r0, c0), f in zip(tiles, origins,
                                                       f_local)]
            aug = exchange_halo_2d(tiles, n_row, n_col, R)
            nxt = []
            for k, (xp, (r0, c0), fa) in enumerate(zip(aug, origins, f_aug)):
                if split:
                    y = split_update(xp, m, r0, c0, interiors[k], fa, dtype)
                else:
                    y = update(xp, m, r0, c0, fa, dtype)
                mm = m
                for _s in range(1, fuse):
                    mm -= r
                    y = update(y, mm, r0, c0, fa, dtype)
                nxt.append(y)
            tiles = nxt
        rows = [torch.cat([t.to(x0.device) for t in
                           tiles[i * n_col:(i + 1) * n_col]], dim=-1)
                for i in range(n_row)]
        return torch.cat(rows, dim=-2)

    return run
