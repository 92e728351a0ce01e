"""Stencil specification — the paper's computational object.

A stencil is a fixed pattern of weighted contributions from neighbouring grid
cells (paper §2): ``out[i] = sum_k w_k * x[i + off_k]``.  The paper's running
example is the Jacobi update for Laplace's equation:

  2D (5-point):  out[i,j] = 0.25*(x[i-1,j] + x[i+1,j] + x[i,j-1] + x[i,j+1])

``StencilSpec`` is dimension-agnostic: offsets are integer tuples, weights are
floats or per-cell weight fields (``WeightField``) for variable-coefficient
operators, ``out[i] = sum_k w_k(i) * x[i + off_k]``.  Every encoding (oracle,
dense, conv, CUDA kernels) consumes the same spec and sums its taps in the
same canonical order (sorted by offset), so every backend computes the same
operator.

Specs are plain numpy-backed values: hashable, comparable, and free of any
device state, so they serve as cache keys.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

Offset = tuple[int, ...]


class WeightField:
    """A read-only float32 per-cell weight array, hashable by value.

    ``StencilSpec`` instances are used as dict keys, so a field freezes its
    array and hashes its bytes lazily; equality compares values, so two
    specs built from equal fields coincide.
    """

    __slots__ = ("_np", "_hash")

    def __init__(self, array):
        if isinstance(array, WeightField):
            array = array.array
        arr = np.array(array, dtype=np.float32)  # always a private copy
        if arr.ndim == 0:
            raise ValueError("WeightField needs an array, not a scalar "
                             "(pass plain floats for constant taps)")
        arr.setflags(write=False)
        object.__setattr__(self, "_np", arr)
        object.__setattr__(self, "_hash", None)

    def __setattr__(self, name, value):
        raise AttributeError("WeightField is immutable")

    @property
    def array(self) -> np.ndarray:
        """The read-only float32 ndarray."""
        return self._np

    # JAX's name for it.
    values = array

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self._np.shape)

    @property
    def ndim(self) -> int:
        return self._np.ndim

    def __hash__(self):
        if self._hash is None:
            object.__setattr__(self, "_hash",
                               hash((self.shape, self._np.tobytes())))
        return self._hash

    def __eq__(self, other):
        if not isinstance(other, WeightField):
            return NotImplemented
        return self is other or (self.shape == other.shape and
                                 np.array_equal(self._np, other._np))

    def __repr__(self):
        return f"WeightField(shape={self.shape})"


def _canon_weight(off: Offset, w) -> "float | WeightField":
    """Scalar-like weights become floats; array-like become WeightFields."""
    if isinstance(w, WeightField):
        return w
    if isinstance(w, (list, tuple, np.ndarray)) or getattr(w, "ndim", 0) > 0:
        return WeightField(np.asarray(w))
    try:
        return float(w)
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"malformed weight for offset {off}: {w!r} is neither a scalar "
            f"nor an array-like per-cell weight field") from e


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """A fixed neighbourhood-weight pattern.

    Attributes:
      taps: tuple of (offset, weight) pairs — offset is an integer tuple (one
        entry per grid dim), weight a float for constant-coefficient taps or
        a grid-shaped ``WeightField`` for spatially-varying taps.  A Mapping
        may be passed at construction; it is canonicalized to a tuple sorted
        by offset so the spec is hashable.
      name: for reporting.
    """

    taps: tuple[tuple[Offset, "float | WeightField"], ...]
    name: str = "stencil"

    def __post_init__(self):
        pairs = self.taps.items() if isinstance(self.taps, Mapping) \
            else self.taps
        canon = []
        for o, w in pairs:
            off = tuple(int(c) for c in o)
            canon.append((off, _canon_weight(off, w)))
        object.__setattr__(self, "taps", tuple(sorted(canon,
                                                      key=lambda t: t[0])))
        if not self.taps:
            raise ValueError(f"{self.name}: a stencil needs at least one tap")
        ndims = {len(o) for o, _ in self.taps}
        if len(ndims) != 1:
            raise ValueError(f"inconsistent offset ranks in {self.name}: {ndims}")
        nd = next(iter(ndims))
        shapes = {w.shape for _, w in self.taps if isinstance(w, WeightField)}
        for off, w in self.taps:
            if isinstance(w, WeightField) and w.ndim != nd:
                raise ValueError(
                    f"{self.name}: weight field for offset {off} has rank "
                    f"{w.ndim} (shape {w.shape}) but the stencil is {nd}D — "
                    f"per-cell fields must be grid-shaped")
        if len(shapes) > 1:
            raise ValueError(
                f"{self.name}: weight fields disagree on the grid shape: "
                f"{sorted(shapes)} — every per-cell field must cover the "
                f"same grid")

    @property
    def ndim(self) -> int:
        return len(self.taps[0][0])

    @property
    def is_variable(self) -> bool:
        """Whether any tap carries a per-cell weight field."""
        return any(isinstance(w, WeightField) for _, w in self.taps)

    @property
    def num_variable_taps(self) -> int:
        return sum(1 for _, w in self.taps if isinstance(w, WeightField))

    @property
    def weights_shape(self) -> tuple[int, ...] | None:
        """The grid shape the weight fields cover; None for all-scalar specs."""
        for _, w in self.taps:
            if isinstance(w, WeightField):
                return w.shape
        return None

    @property
    def radius(self) -> int:
        """Max Chebyshev distance of any tap — the halo depth one application needs."""
        return max(max(abs(c) for c in off) for off, _ in self.taps)

    @property
    def footprint(self) -> tuple[int, ...]:
        """Bounding-box shape of the kernel window."""
        lo = [min(off[d] for off, _ in self.taps) for d in range(self.ndim)]
        hi = [max(off[d] for off, _ in self.taps) for d in range(self.ndim)]
        return tuple(h - l + 1 for l, h in zip(lo, hi))

    @property
    def useful_flops_per_point(self) -> int:
        """FLOPs that contribute to the result: one mul per tap + (taps-1)
        adds — 7 for 2D Laplace, as in §4 of the paper."""
        return 2 * len(self.taps) - 1

    def delivered_flops_per_point_conv(self) -> int:
        """FLOPs the conv encoding performs per output element: the full
        footprint window, zero taps included (17 for the 3×3 2D Laplace)."""
        return 2 * int(np.prod(self.footprint)) - 1

    def delivered_flops_per_point_dense(self, n_total: int) -> int:
        """FLOPs the dense encoding performs per output element: (2N-1),
        8191 for X=Y=64."""
        return 2 * n_total - 1

    def to_kernel(self, dtype=np.float32) -> np.ndarray:
        """Materialize the footprint window as a dense array (the conv
        kernel; Figure 2 of the paper for 2D Laplace)."""
        if self.is_variable:
            raise ValueError(
                f"{self.name}: a variable-coefficient spec has no single "
                f"conv kernel — its taps carry per-cell weight fields; use "
                f"the dense/gather encodings or iterate the taps directly")
        lo = [min(off[d] for off, _ in self.taps) for d in range(self.ndim)]
        ker = np.zeros(self.footprint, dtype=dtype)
        for off, w in self.taps:
            ker[tuple(o - l for o, l in zip(off, lo))] = w
        return ker

    @property
    def variable_offsets(self) -> tuple[Offset, ...]:
        """Offsets of the per-cell taps, in canonical tap order."""
        return tuple(o for o, w in self.taps if isinstance(w, WeightField))

    def field_stack(self) -> np.ndarray | None:
        """The per-cell taps stacked tap-major: shape (V, *grid); None if none.

        This is the runtime-operand layout every backend streams — pass a
        tensor of this shape as ``fields=`` to a plan or solver to override
        the spec's baked values.
        """
        vals = self.field_values()
        return np.stack(vals) if vals else None

    def field_values(self) -> tuple[np.ndarray, ...]:
        """Value arrays of the per-cell taps, in canonical tap order."""
        return tuple(w.array for _, w in self.taps
                     if isinstance(w, WeightField))

    def with_field_values(self, values, name: str | None = None) -> "StencilSpec":
        """A spec whose per-cell taps take their values from ``values``.

        ``values`` is a (V, *grid) stack or a sequence of V grid-shaped
        arrays or tensors, matched to the variable taps in canonical tap
        order.  A spec holds its fields as numpy values (it is a cache
        key), so a tensor that requires grad is refused: gradients reach
        the fields as the ``fields=`` operand of a plan or solver, as
        ``models/solver_layer.SolverLayer`` passes them.
        """
        offs = self.variable_offsets
        if len(values) != len(offs):
            raise ValueError(
                f"{self.name}: got {len(values)} field value arrays for "
                f"{len(offs)} variable taps")
        if getattr(values, "requires_grad", False) or any(
                getattr(v, "requires_grad", False) for v in values):
            raise ValueError(
                f"{self.name}: a spec holds its weight fields as numpy "
                f"values and drops gradients; pass a tensor that requires "
                f"grad as fields= to a plan or solver instead (as "
                f"SolverLayer does)")
        repl = {off: WeightField(_host(v)) for off, v in zip(offs, values)}
        taps = tuple((o, repl.get(o, w)) for o, w in self.taps)
        return StencilSpec(taps=taps, name=name or self.name)


def _host(v):
    """A tensor's values on the host in fp32 (an array passes through)."""
    return v.detach().float().cpu().numpy() if hasattr(v, "detach") else v


def spec_from_taps(taps, name: str = "stencil") -> StencilSpec:
    """A spec from plain ``(offset, float | np.ndarray)`` pairs.

    This is how a spec crosses from another implementation: the pairs carry
    only numbers, so the same operator is rebuilt here from them.
    """
    return StencilSpec(taps=tuple((tuple(o), w) for o, w in taps), name=name)


def laplace_jacobi(ndim: int) -> StencilSpec:
    """The paper's benchmark stencil: Jacobi iteration for Laplace's equation."""
    w = 1.0 / (2 * ndim)
    taps = {}
    for d in range(ndim):
        for s in (-1, 1):
            off = [0] * ndim
            off[d] = s
            taps[tuple(off)] = w
    return StencilSpec(taps=taps, name=f"laplace{ndim}d")


def star(ndim: int, weights_by_distance: Sequence[float], center: float = 0.0) -> StencilSpec:
    """Star stencil of arbitrary radius (e.g. higher-order finite differences)."""
    taps = {}
    if center != 0.0:
        taps[(0,) * ndim] = center
    for r, w in enumerate(weights_by_distance, start=1):
        if w == 0.0:
            continue
        for d in range(ndim):
            for s in (-r, r):
                off = [0] * ndim
                off[d] = s
                taps[tuple(off)] = w
    return StencilSpec(taps=taps, name=f"star{ndim}d_r{len(weights_by_distance)}")


def box(ndim: int, weight: float | None = None) -> StencilSpec:
    """Dense 3^ndim box average — a stencil with no zero taps."""
    w = weight if weight is not None else 1.0 / 3**ndim
    taps = {tuple(i - 1 for i in idx): w for idx in np.ndindex(*(3,) * ndim)}
    return StencilSpec(taps=taps, name=f"box{ndim}d")


def variable_coefficient(
    base: StencilSpec, fields: Mapping[Offset, "np.ndarray"],
    name: str | None = None,
) -> StencilSpec:
    """Replace chosen taps of ``base`` with per-cell weight fields.

    ``fields`` maps offsets (which may be new or already present in ``base``)
    to grid-shaped arrays; the remaining taps keep their scalar weights.
    """
    taps: dict = dict(base.taps)
    for off, f in fields.items():
        taps[tuple(int(c) for c in off)] = WeightField(np.asarray(f))
    return StencilSpec(taps=taps, name=name or f"{base.name}_var")


def heterogeneous_jacobi(kappa, name: str | None = None) -> StencilSpec:
    """Variable-coefficient Jacobi step for heterogeneous diffusion.

    ``kappa`` is a positive per-cell conductivity field of any rank; the
    returned spec averages the face neighbours with harmonic-mean face
    conductivities, normalized per cell so the weights sum to 1 — the Jacobi
    relaxation of ``div(kappa grad u) = 0`` on a unit grid.  With constant
    ``kappa`` this reduces exactly to :func:`laplace_jacobi`.
    """
    kappa = np.asarray(kappa, dtype=np.float64)
    if kappa.ndim == 0:
        raise ValueError("heterogeneous_jacobi needs a per-cell kappa field")
    if not np.all(kappa > 0):
        raise ValueError("kappa must be positive everywhere")
    ndim = kappa.ndim
    faces: dict[Offset, np.ndarray] = {}
    for d in range(ndim):
        n = kappa.shape[d]
        for s in (-1, 1):
            # neighbour kappa with edge replication (the edge faces are under
            # the Dirichlet shell anyway, so their weights never matter)
            nbr = np.take(kappa, np.clip(np.arange(n) + s, 0, n - 1), axis=d)
            off = [0] * ndim
            off[d] = s
            faces[tuple(off)] = 2.0 * kappa * nbr / (kappa + nbr)
    total = sum(faces.values())
    taps = {off: w / total for off, w in faces.items()}
    return StencilSpec(taps=taps, name=name or f"hetero{ndim}d")


def causal_conv1d_spec(weights: Sequence[float]) -> StencilSpec:
    """1D causal stencil: out[t] = sum_k w[k] * x[t - (K-1) + k].

    The depthwise causal convolution inside Mamba2 blocks (d_conv=4)
    expressed as a stencil.
    """
    K = len(weights)
    taps = {(-(K - 1) + k,): float(w) for k, w in enumerate(weights)}
    return StencilSpec(taps=taps, name=f"causal_conv1d_k{K}")
