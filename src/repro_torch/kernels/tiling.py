"""Block-geometry helpers shared by the kernels and the cost model.

``round_up``, ``fused_block_geometry``, ``fuse_redundancy``,
``halo_fuse_redundancy`` and ``halo_exchange_bytes`` are the JAX package's
functions, kept equal to them so that the roofline prices schedules the same
way in both packages.  ``resident_fits`` is the JAX package's rule too, so
that ``rim="resident"`` takes the same grids in both; ``resident_cta_fits``
is the port's own: whether the two fp32 ping-pong copies of the zero-ringed
grid fit one CTA's shared memory, where the one-CTA resident kernels run
(a larger grid takes the grid-wide kernel, csrc/jacobi_fused.cu).
"""
from __future__ import annotations

# Shared memory one H100 CTA may use after opting in with
# cudaFuncAttributeMaxDynamicSharedMemorySize (227 KB of the SM's 256 KB),
# and what the kernels' static tap table (404 bytes, csrc/taps.cuh) takes of
# it, rounded up for alignment.
MAX_SMEM_BYTES = 232_448
STATIC_SMEM_BYTES = 512

# The JAX package's limit on a resident grid (src/repro/kernels/tiling.py,
# RESIDENT_VMEM_BYTES: the padded grid in one VMEM block), copied so that
# the port admits exactly the grids JAX admits.
RESIDENT_VMEM_BYTES = 8 * 1024 * 1024


def round_up(v: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``v``."""
    return (v + m - 1) // m * m


def resident_smem_bytes(grid_shape: tuple[int, int], radius: int = 1) -> int:
    """Shared memory of the resident kernel: two fp32 buffers of the grid
    with a zero ring ``radius`` deep on every side."""
    H, W = grid_shape
    return 2 * (H + 2 * radius) * (W + 2 * radius) * 4


def resident_fits(grid_shape: tuple[int, int], itemsize: int = 4) -> bool:
    """Whether ``rim="resident"`` takes the grid: the JAX package's rule,
    round_up(H, 8) * round_up(W, 128) * itemsize <= 8 MiB (up to 1024x2048
    or 1448x1408)."""
    H, W = grid_shape
    return round_up(H, 8) * round_up(W, 128) * itemsize <= RESIDENT_VMEM_BYTES


def resident_cta_fits(grid_shape: tuple[int, int], radius: int = 1) -> bool:
    """Whether the whole grid fits one CTA's shared memory (up to 168×168
    at radius 1): where the one-CTA resident kernels can run."""
    return (resident_smem_bytes(grid_shape, radius) + STATIC_SMEM_BYTES
            <= MAX_SMEM_BYTES)


def fused_block_geometry(H: int, W: int, fuse: int, r: int,
                         block_h: int = 256,
                         rim: str = "trapezoid") -> tuple[int, int, int, int]:
    """Block geometry the JAX package's fused kernel tiles with.

    Returns ``(bh, Hp, Wp, halo)``: the row-block height, the padded grid
    extents, and the per-side halo depth.  The roofline prices the rim
    recompute from it (:func:`fuse_redundancy`); the CUDA kernels pick
    their own tiles.
    """
    Wp = round_up(W, 128)
    if rim == "resident":
        Hp = round_up(H, 8)
        return Hp, Hp, Wp, r
    if rim != "trapezoid":
        raise ValueError(f"unknown rim strategy {rim!r} "
                         f"(expected 'trapezoid' or 'resident')")
    halo = fuse * r
    bh = min(block_h, round_up(H, 8))
    Hp = round_up(H, bh)
    return bh, Hp, Wp, halo


def fuse_redundancy(grid_shape: tuple[int, int], fuse: int, r: int,
                    block_h: int = 256, rim: str = "trapezoid") -> float:
    """Rim-recompute factor of the depth-``fuse`` schedule: elements each
    block touches divided by elements it owns.  1.0 means no redundant work;
    the resident strategy recomputes nothing.
    """
    if rim == "resident":
        return 1.0
    H, W = grid_shape
    bh, _, Wp, halo = fused_block_geometry(H, W, fuse, r, block_h, rim)
    return ((bh + 2 * halo) * (Wp + 2 * halo)) / (bh * Wp)


def halo_fuse_redundancy(local_shape: tuple[int, int], fuse: int,
                         r: int) -> float:
    """Rim-recompute factor of a depth-``fuse`` deep-halo schedule on one
    (h_loc, w_loc) device tile: cells updated across the fused sweep divided
    by cells owned."""
    h, w = local_shape
    if h <= 0 or w <= 0 or fuse <= 1:
        return 1.0
    total = sum((h + 2 * (fuse - s) * r) * (w + 2 * (fuse - s) * r)
                for s in range(1, fuse + 1))
    return total / (fuse * h * w)


def halo_exchange_bytes(local_shape: tuple[int, int], fuse: int, r: int,
                        itemsize: int = 4) -> int:
    """Bytes one device moves per deep-halo exchange: two ``r*fuse``-deep
    edge strips per mesh axis, the row phase widened by the already-attached
    column halos (the corner transit)."""
    h, w = local_shape
    R = r * fuse
    return int(2 * R * (h + w + 2 * R) * itemsize)
