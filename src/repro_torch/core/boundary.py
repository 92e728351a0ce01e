"""Boundary-condition handling — the paper's mask trick and its alternatives.

The Cerebras TF stack lacked ``tf.pad`` and ``concatenate`` (paper §3), so
non-zero Dirichlet boundary conditions had to be applied as

    out = conv(x) * interior_mask + bc_values        (MASK mode)

where ``interior_mask`` is 1 in the interior and 0 on the boundary, and
``bc_values`` holds the Dirichlet values on the boundary and 0 inside.

  PAD    — 'valid' stencil application on an input whose shell holds the BC
           values (the approach the paper says it wanted).
  MATRIX — BCs folded into the dense-encoding matrix (identity rows).

All modes compute identical results.
"""
from __future__ import annotations

import dataclasses
import enum

import torch


class BoundaryMode(enum.Enum):
    MASK = "mask"      # paper-faithful: conv('same') then mask-mult + bc-add
    PAD = "pad"        # stencil applied 'valid', shell re-written from x
    MATRIX = "matrix"  # dense encoding only: identity rows in the matrix


def _interior(shape: tuple[int, ...], dtype, device) -> torch.Tensor:
    # Built where it is used: no host array, no copy to the device.  The
    # fill is an explicit ``fill_``: an indexed assignment of a number runs
    # other ops on meta than on cpu or cuda, and a counted solve
    # (launch/hlo_cost.py) must read the same on all three.
    m = torch.zeros(shape, dtype=dtype, device=device)
    m[tuple(slice(1, -1) for _ in shape)].fill_(1.0)
    return m


@dataclasses.dataclass(frozen=True)
class DirichletBC:
    """Fixed boundary values on the outermost shell of the grid.

    ``value`` may be a scalar or a full-grid array (numpy or tensor) whose
    boundary shell holds the BC values (interior entries are ignored).
    """

    value: "float | torch.Tensor" = 0.0

    def interior_mask(self, shape: tuple[int, ...], dtype=torch.float32,
                      device=None) -> torch.Tensor:
        """1 in the interior, 0 on the boundary shell (paper §3 'mask')."""
        return _interior(tuple(shape), dtype, device)

    def bc_grid(self, shape: tuple[int, ...], dtype=torch.float32,
                device=None) -> torch.Tensor:
        """BC values on the boundary shell, 0 in the interior."""
        shape = tuple(shape)
        if isinstance(self.value, (int, float)):
            g = torch.full(shape, float(self.value), dtype=torch.float32,
                           device=device).to(dtype)
        else:
            g = torch.as_tensor(self.value, device=device).to(dtype)
            if tuple(g.shape) != shape:
                raise ValueError(f"bc grid shape {tuple(g.shape)} != {shape}")
        return g * (1.0 - self.interior_mask(shape, dtype, device))

    def apply_mask_trick(self, out: torch.Tensor,
                         ndim: int | None = None) -> torch.Tensor:
        """The paper's post-iteration fixup: zero the boundary, add BCs back.

        The grid is the trailing ``ndim`` dims of ``out`` (all of them by
        default); leading dims are a batch.
        """
        shape = tuple(out.shape[out.ndim - (ndim or out.ndim):])
        return (out * self.interior_mask(shape, out.dtype, out.device)
                + self.bc_grid(shape, out.dtype, out.device))

    # Writing the BC values onto the shell is the same product.
    set_boundary = apply_mask_trick


def runtime_bc_grids(shape: tuple[int, ...], bc_value, dtype=torch.float32,
                     device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(interior_mask, bc_grid) for a Dirichlet value passed at call time.

    ``bc_value`` may be a Python scalar, a 0-d tensor, or a full-grid array
    whose shell holds the values.
    """
    mask = _interior(tuple(shape), dtype, device)
    v = torch.as_tensor(bc_value, device=device).to(dtype)
    if v.ndim not in (0, len(shape)):
        raise ValueError(
            f"bc_value must be a scalar or a {len(shape)}D grid, got "
            f"shape {tuple(v.shape)}")
    if v.ndim and tuple(v.shape) != tuple(shape):
        raise ValueError(f"bc grid shape {tuple(v.shape)} != {tuple(shape)}")
    return mask, v * (1.0 - mask)
