"""Measured autotuner for the stencil hot path: schedules priced by the
clock, not by the roofline.

``choose_backend`` (core/plan.py) prices every backend from an analytic
roofline, which cannot see launch overheads, cache effects or the real
crossover between temporal-fusion rim recompute and memory savings.  This
module lowers candidate schedules (backend x temporal fuse depth x rim
strategy) through ``make_plan``, times each one, and records the results in
a versioned table keyed by ``(device_kind, spec family, shape bucket,
dtype)``.  It is the JAX package's ``core/autotune.py``, with one schema
for both packages' files.

Dispatch (``choose_backend``/``make_plan``/``select_fuse``) consults the
table *before* the roofline, with nearest-shape-bucket matching and an
explicit roofline fallback when no entry applies.  ``device_kind`` is the
card's name (``torch.cuda.get_device_name``) on CUDA and ``"cpu"`` on the
CPU, so an entry measured on another card, or on the CPU, never wins a
cell here.  A kernel backend measured on a CPU tensor ran its plain
PyTorch version: the entry is tagged ``interpreted`` and never wins.

The port's table is ``TUNED_stencil_cuda.json`` at the repo root
(``REPRO_TORCH_TUNED_TABLE`` names another); validate it with
``python -m repro_torch.core.autotune --check``.  The CUDA kernels choose
their own block geometry (``kernels/jacobi_fused.py::kernel_for``), so
``block_h`` is always None here.  ``halo`` schedules are tuned per tile
mesh (``autotune_halo_cell``): their entries record the (n_row, n_col)
tiling, and lookups match it exactly.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
import warnings

import numpy as np
import torch

from repro_torch.core.boundary import BoundaryMode, DirichletBC
from repro_torch.core.stencil import StencilSpec, WeightField, star

SCHEMA_VERSION = 1
DEFAULT_TABLE_NAME = "TUNED_stencil_cuda.json"
TABLE_ENV = "REPRO_TORCH_TUNED_TABLE"

# Schedule-search space of cuda_fused.  Interpreted candidates (the plain
# versions on the CPU) are measured once, at one schedule, for the record:
# they can never win, so sweeping them would waste tuner time.
FUSE_CANDIDATES = (1, 2, 4, 8, 16)
RESIDENT_FUSE_CANDIDATES = (16, 32, 64)
# Deep-halo fuse depths swept per mesh shape (clamped to the local tile).
HALO_FUSE_CANDIDATES = (1, 2, 4, 8)


class TableError(ValueError):
    """A tuned table failed schema validation."""


# ---------------------------------------------------------------------------
# Cell keys: family + shape bucket
# ---------------------------------------------------------------------------

def spec_family(spec: StencilSpec) -> str:
    """Structural family key of a spec: what tuned timings transfer across.

    A schedule's speed depends on the tap geometry (ndim, radius, tap count)
    and on whether taps carry per-cell weight fields, not on the scalar
    weight values, so two Laplace-like specs with different coefficients
    share a family (and a tuned schedule).
    """
    fam = f"{spec.ndim}d/r{spec.radius}/t{len(spec.taps)}"
    if spec.is_variable:
        fam += "/var"
    return fam


def shape_bucket(grid_shape: tuple[int, ...]) -> tuple[int, ...]:
    """Round every extent up to a power of two: the bucket key."""
    return tuple(1 if d <= 1 else 1 << (int(d) - 1).bit_length()
                 for d in grid_shape)


def bucket_distance(a: tuple[int, ...], b: tuple[int, ...]) -> float:
    """Sum of |log2| extent ratios; inf across ranks (no transfer)."""
    if len(a) != len(b):
        return math.inf
    return float(sum(abs(math.log2(x / y)) for x, y in zip(a, b)))


def family_representative(family: str,
                          bucket: tuple[int, ...]) -> StencilSpec:
    """A canonical spec for a family string, for legality checks.

    ``backend_support`` depends only on ndim / radius / variability (never on
    tap values), so a star stencil of the right rank and radius answers "is
    this backend legal for this cell" for every member of the family.
    """
    parts = family.split("/")
    try:
        nd = int(parts[0].rstrip("d"))
        radius = int(parts[1].lstrip("r"))
    except (IndexError, ValueError) as e:
        raise TableError(f"malformed family key {family!r}") from e
    spec = star(nd, [1.0 / (2 * nd * radius)] * radius)
    if "var" in parts[2:]:
        off, w = spec.taps[0]
        taps = dict(spec.taps)
        taps[off] = WeightField(np.full(bucket, float(w), np.float32))
        spec = StencilSpec(taps=taps, name=f"{spec.name}_var")
    return spec


# ---------------------------------------------------------------------------
# Entries and the table
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TunedEntry:
    """One measured schedule for one (device, family, bucket, dtype) cell."""

    device_kind: str
    family: str
    bucket: tuple[int, ...]
    dtype: str
    backend: str
    us_per_iter: float
    fuse: int = 1
    block_h: int | None = None
    rim: str | None = None
    interpreted: bool = False
    iters: int = 1          # iterations per timed call during measurement
    # Tile-mesh tiling (n_row, n_col) a halo schedule was measured on:
    # halo timings do not transfer across mesh shapes, so lookups filter on
    # it.  None for every single-device backend.
    mesh: tuple[int, int] | None = None

    @property
    def cell(self) -> tuple:
        return (self.device_kind, self.family, self.bucket, self.dtype)

    def seconds(self, iters: int) -> float:
        return self.us_per_iter * 1e-6 * iters

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["bucket"] = list(self.bucket)
        if self.mesh is not None:
            d["mesh"] = list(self.mesh)
        else:
            del d["mesh"]
        return d

    @classmethod
    def from_json(cls, d: dict) -> "TunedEntry":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise TableError(f"unknown entry fields {sorted(unknown)}")
        missing = {"device_kind", "family", "bucket", "dtype", "backend",
                   "us_per_iter"} - set(d)
        if missing:
            raise TableError(f"entry missing fields {sorted(missing)}")
        d = dict(d)
        d["bucket"] = tuple(int(v) for v in d["bucket"])
        if d.get("mesh") is not None:
            d["mesh"] = tuple(int(v) for v in d["mesh"])
        return cls(**d)


class TunedTable:
    """A set of measured schedules with nearest-bucket lookup.

    Lookup semantics (the contract dispatch relies on):

      * entries group into cells by (device_kind, family, bucket, dtype);
      * ``lookup_cell`` bucketizes the query shape and returns the entries of
        the nearest recorded bucket within ``max_distance`` (sum of per-dim
        |log2| ratios; the default 1.0/dim tolerates one power of two of
        extrapolation per axis on average);
      * interpreted entries never win: ``lookup`` returns the fastest
        *non-interpreted* entry, or None (-> roofline fallback).
    """

    def __init__(self, entries: tuple[TunedEntry, ...] = (), source=None):
        self.entries: list[TunedEntry] = list(entries)
        self.source = source

    def __len__(self) -> int:
        return len(self.entries)

    def add(self, entry: TunedEntry) -> None:
        """Insert, replacing any entry with the same cell + schedule key."""
        key = (entry.cell, entry.backend, entry.fuse, entry.block_h,
               entry.rim, entry.mesh)
        self.entries = [
            e for e in self.entries
            if (e.cell, e.backend, e.fuse, e.block_h, e.rim, e.mesh) != key
        ]
        self.entries.append(entry)

    # -- lookup ------------------------------------------------------------

    def lookup_cell(
        self,
        device_kind: str,
        family: str,
        grid_shape: tuple[int, ...],
        dtype: str,
        *,
        max_distance: float | None = None,
        mesh_shape: tuple[int, int] | None = None,
    ) -> list[TunedEntry]:
        """Entries of the nearest recorded bucket; [] if none is close.

        ``mesh_shape`` is the (n_row, n_col) device tiling the caller will
        run on: mesh-keyed (halo) entries only apply when it matches, while
        mesh-less entries (every single-device schedule) always do.
        """
        want = shape_bucket(tuple(grid_shape))
        if max_distance is None:
            max_distance = float(len(want))
        near = [e for e in self.entries
                if e.device_kind == device_kind and e.family == family
                and e.dtype == dtype
                and (e.mesh is None
                     or (mesh_shape is not None
                         and tuple(e.mesh) == tuple(mesh_shape)))]
        if not near:
            return []
        best = min({e.bucket for e in near},
                   key=lambda b: bucket_distance(b, want))
        if bucket_distance(best, want) > max_distance:
            return []
        return [e for e in near if e.bucket == best]

    def lookup(
        self,
        device_kind: str,
        family: str,
        grid_shape: tuple[int, ...],
        dtype: str,
        *,
        max_distance: float | None = None,
        mesh_shape: tuple[int, int] | None = None,
    ) -> TunedEntry | None:
        """The fastest non-interpreted schedule for the cell, or None."""
        cell = self.lookup_cell(device_kind, family, grid_shape, dtype,
                                max_distance=max_distance,
                                mesh_shape=mesh_shape)
        live = [e for e in cell if not e.interpreted]
        if not live:
            return None
        return min(live, key=lambda e: e.us_per_iter)

    # -- persistence -------------------------------------------------------

    def to_json(self) -> dict:
        return {
            "schema": SCHEMA_VERSION,
            "entries": [e.to_json() for e in sorted(
                self.entries, key=lambda e: (e.cell, e.backend, e.fuse,
                                             e.block_h or 0, e.rim or ""))],
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def parse(cls, data: dict, source=None) -> "TunedTable":
        """Strict parse: raises :class:`TableError` on any schema problem."""
        if not isinstance(data, dict):
            raise TableError(f"tuned table must be a JSON object, "
                             f"got {type(data).__name__}")
        if data.get("schema") != SCHEMA_VERSION:
            raise TableError(
                f"tuned table schema {data.get('schema')!r} != supported "
                f"{SCHEMA_VERSION} (stale or future table)")
        entries = data.get("entries")
        if not isinstance(entries, list):
            raise TableError("tuned table lacks an 'entries' list")
        return cls(tuple(TunedEntry.from_json(e) for e in entries),
                   source=source)

    @classmethod
    def load(cls, path: str) -> "TunedTable":
        """Forgiving load: a corrupt/stale/missing table degrades to an
        empty one with a warning; dispatch falls back to the roofline and
        never crashes on a bad artifact."""
        if not os.path.exists(path):
            return cls(source=path)
        try:
            with open(path) as f:
                data = json.load(f)
            return cls.parse(data, source=path)
        except (json.JSONDecodeError, TableError, OSError) as e:
            warnings.warn(
                f"ignoring tuned table {path}: {e}; dispatch falls back to "
                f"the roofline model (regenerate it with autotune_cell on "
                f"the card)", stacklevel=2)
            return cls(source=path)


# ---------------------------------------------------------------------------
# Default (committed) table
# ---------------------------------------------------------------------------

_default_table: TunedTable | None = None


def default_table_path() -> str:
    env = os.environ.get(TABLE_ENV)
    if env:
        return env
    here = os.path.abspath(__file__)      # src/repro_torch/core/autotune.py
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(here))))
    return os.path.join(root, DEFAULT_TABLE_NAME)


def default_tuned_table() -> TunedTable:
    """The committed table, loaded once per process (lazily)."""
    global _default_table
    if _default_table is None:
        _default_table = TunedTable.load(default_table_path())
    return _default_table


def set_default_tuned_table(table: TunedTable | None) -> None:
    """Override (or with None, force a reload of) the process-wide table."""
    global _default_table
    _default_table = table


def resolve_table(tuned) -> TunedTable | None:
    """The table a ``tuned=`` argument denotes: "default" -> the committed
    table, None -> disabled (pure roofline), else the TunedTable itself."""
    if tuned is None:
        return None
    if isinstance(tuned, str) and tuned == "default":
        return default_tuned_table()
    return tuned


def dtype_key(dtype) -> str:
    """The dtype's name as the JAX package writes it ("float32",
    "bfloat16"), so one schema covers both packages' tables."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def device_kind(device=None) -> str:
    """The table's device key: the card's name on CUDA and on ``meta`` (a
    dry run of the card's program), "cpu" on the CPU.

    ``device`` is a torch.device or its string ("cuda", "cuda:1", "cpu");
    None means the card.  Where CUDA is named but absent (a roofline priced
    for the card on a CPU host) the key is "cuda", which no measured entry
    carries.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "meta"):
        return dev.type
    if not torch.cuda.is_available():
        return "cuda"
    return torch.cuda.get_device_name(dev if dev.type == "cuda" else None)


def lookup_entry(tuned, spec: StencilSpec, grid_shape, dtype, device, *,
                 mesh_shape=None) -> TunedEntry | None:
    """The winning entry of ``tuned``'s table for this cell on ``device``
    (halo entries only on the ``mesh_shape`` tiling), or None (no table,
    empty table, or no entry close enough)."""
    table = resolve_table(tuned)
    if table is None or not len(table):
        return None
    return table.lookup(device_kind(device), spec_family(spec),
                        tuple(grid_shape), dtype_key(dtype),
                        mesh_shape=mesh_shape)


# ---------------------------------------------------------------------------
# The measured search
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Candidate:
    backend: str
    fuse: int = 1
    block_h: int | None = None
    rim: str | None = None


def _median_seconds(fn, x, *, warmup: int = 1, repeats: int = 3) -> float:
    """Median of ``repeats`` timed calls after ``warmup`` untimed ones: CUDA
    events around each call on the card (the host's time between launches
    counts, as it does for a caller), the host clock on the CPU."""
    for _ in range(warmup):
        fn(x)
    cuda = x.device.type == "cuda"
    times = []
    for _ in range(repeats):
        if cuda:
            torch.cuda.synchronize(x.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(x)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn(x)
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def schedule_candidates(
    spec: StencilSpec,
    grid_shape: tuple[int, ...],
    iters: int,
    *,
    mode: BoundaryMode = BoundaryMode.MASK,
    bc: DirichletBC | float | None = 0.0,
    device=None,
) -> list[Candidate]:
    """Legal (backend, fuse, rim) schedules for one cell on ``device``.

    The ``reference`` oracle is excluded, and so is ``halo`` (a
    distribution strategy, tuned per mesh by :func:`autotune_halo_cell`).
    ``cuda_fused`` on a 2D spec of
    scalar taps gets the schedule sweep: every depth of FUSE_CANDIDATES
    dividing ``iters`` as a trapezoid, and those of RESIDENT_FUSE_CANDIDATES
    as resident passes where ``tiling.resident_fits`` takes the grid.  On
    the CPU, where the kernel backends run their plain versions, one
    schedule is measured: the row exists to be *recorded as interpreted*,
    not to compete.
    """
    from repro_torch.core.plan import (BACKENDS, DEVICE_PROFILES,
                                       backend_support, resolve_device)
    from repro_torch.kernels.tiling import resident_fits

    dev = resolve_device(device)
    interp = not DEVICE_PROFILES[dev.type].kernels_native
    out: list[Candidate] = []
    for backend in BACKENDS:
        if backend in ("reference", "halo"):
            continue
        if not backend_support(backend, spec, grid_shape=grid_shape,
                               mode=mode, bc=bc):
            continue
        sweeps = backend == "cuda_fused" and spec.ndim == 2 \
            and not spec.is_variable
        if not sweeps:
            out.append(Candidate(backend))
            continue
        if interp:
            out.append(Candidate(backend, fuse=1))
            continue
        for fuse in FUSE_CANDIDATES:
            if iters % fuse == 0:
                out.append(Candidate(backend, fuse, rim="trapezoid"))
        if resident_fits(grid_shape):
            for fuse in RESIDENT_FUSE_CANDIDATES:
                if iters % fuse == 0:
                    out.append(Candidate(backend, fuse, rim="resident"))
    return out


def measure_candidate(
    spec: StencilSpec,
    grid_shape: tuple[int, ...],
    cand: Candidate,
    *,
    iters: int,
    dtype=torch.float32,
    mode: BoundaryMode = BoundaryMode.MASK,
    bc: DirichletBC | float | None = 0.0,
    batch: int = 1,
    repeats: int = 3,
    device=None,
    mesh=None,
) -> TunedEntry:
    """Lower one schedule through ``make_plan`` and time it on ``device``.

    ``mesh`` is required for (and only used by) halo candidates; the entry
    records its (n_row, n_col) tiling so lookups stay mesh-exact.
    """
    from repro_torch.core.plan import _mesh_tiling, make_plan
    plan = make_plan(
        spec, grid_shape, backend=cand.backend, bc=bc, mode=mode,
        iters=iters, fuse=cand.fuse if cand.rim or cand.fuse > 1 else None,
        rim=cand.rim, dtype=dtype, device=device, tuned=None, mesh=mesh)
    # Drawn on the device: the values do not move the time, and a host draw
    # of a full-size grid takes longer than its measurement.
    gen = torch.Generator(device=plan.device).manual_seed(0)
    x = torch.randn((batch, *grid_shape), generator=gen,
                    device=plan.device).to(dtype)
    sec = _median_seconds(plan, x, repeats=repeats)
    return TunedEntry(
        device_kind=device_kind(plan.device),
        family=spec_family(spec),
        bucket=shape_bucket(tuple(grid_shape)),
        dtype=dtype_key(dtype),
        backend=cand.backend,
        us_per_iter=sec / iters * 1e6,
        fuse=plan.fuse,
        block_h=None,
        rim=cand.rim,
        interpreted=plan.interpreted,
        iters=iters,
        mesh=_mesh_tiling(mesh) if cand.backend == "halo" else None,
    )


def autotune_cell(
    spec: StencilSpec,
    grid_shape: tuple[int, ...],
    *,
    iters: int = 32,
    dtype=torch.float32,
    mode: BoundaryMode = BoundaryMode.MASK,
    bc: DirichletBC | float | None = 0.0,
    table: TunedTable | None = None,
    repeats: int = 3,
    verbose: bool = False,
    device=None,
) -> TunedTable:
    """Measure every legal schedule for one cell into ``table``."""
    if table is None:
        table = TunedTable()
    for cand in schedule_candidates(spec, grid_shape, iters, mode=mode,
                                    bc=bc, device=device):
        try:
            entry = measure_candidate(spec, grid_shape, cand, iters=iters,
                                      dtype=dtype, mode=mode, bc=bc,
                                      repeats=repeats, device=device)
        except Exception as e:  # a candidate that fails to lower is skipped
            warnings.warn(f"autotune: candidate {cand} failed: {e}",
                          stacklevel=2)
            continue
        table.add(entry)
        if verbose:
            tag = " (interp)" if entry.interpreted else ""
            print(f"# tuned {entry.family} {entry.bucket} "
                  f"{cand.backend}/f{entry.fuse}"
                  f"{f'/{cand.rim}' if cand.rim else ''}: "
                  f"{entry.us_per_iter:.1f} us/iter{tag}")
    return table


def halo_schedule_candidates(
    spec: StencilSpec,
    grid_shape: tuple[int, ...],
    mesh_tiling: tuple[int, int],
    iters: int,
) -> list[Candidate]:
    """Legal halo fuse depths for one (grid, mesh) cell: each candidate must
    divide the chunk and keep the exchanged depth within the local tile."""
    from repro_torch.core.distributed import max_halo_fuse
    n_row, n_col = mesh_tiling
    if grid_shape[0] % n_row or grid_shape[1] % n_col:
        return []
    deepest = max_halo_fuse(spec.radius, grid_shape[0] // n_row,
                            grid_shape[1] // n_col)
    return [Candidate("halo", fuse=f) for f in HALO_FUSE_CANDIDATES
            if f <= deepest and iters % f == 0]


def autotune_halo_cell(
    spec: StencilSpec,
    grid_shape: tuple[int, ...],
    mesh,
    *,
    iters: int = 32,
    dtype=torch.float32,
    bc: DirichletBC | float | None = 0.0,
    table: TunedTable | None = None,
    repeats: int = 3,
    verbose: bool = False,
    device=None,
) -> TunedTable:
    """Measure the halo fuse-depth sweep for one cell on ``mesh`` (a
    ``TileMesh`` whose tiles sit on ``device``'s type).

    The distributed analogue of :func:`autotune_cell`: entries carry the
    mesh tiling so they only ever apply to the mesh shape they were
    measured on.
    """
    from repro_torch.core.plan import _mesh_tiling
    if table is None:
        table = TunedTable()
    tiling = _mesh_tiling(mesh)
    for cand in halo_schedule_candidates(spec, grid_shape, tiling, iters):
        try:
            entry = measure_candidate(spec, grid_shape, cand, iters=iters,
                                      dtype=dtype, bc=bc, repeats=repeats,
                                      device=device, mesh=mesh)
        except Exception as e:
            warnings.warn(f"autotune: halo candidate {cand} failed: {e}",
                          stacklevel=2)
            continue
        table.add(entry)
        if verbose:
            print(f"# tuned {entry.family} {entry.bucket} halo/f{entry.fuse}"
                  f" @ mesh {tiling[0]}x{tiling[1]}: "
                  f"{entry.us_per_iter:.1f} us/iter")
    return table


# ---------------------------------------------------------------------------
# Validation (--check)
# ---------------------------------------------------------------------------

def validate_table(data: dict) -> list[str]:
    """Schema + legality errors for a raw table dict; [] means valid.

    Beyond the structural schema, every entry must still map to a legal
    ``backend_support`` cell: a backend renamed or a support rule tightened
    after the table was generated must fail the check, not silently
    misroute.
    """
    from repro_torch.core.plan import BACKENDS, backend_support
    errors: list[str] = []
    try:
        table = TunedTable.parse(data)
    except TableError as e:
        return [str(e)]
    for i, e in enumerate(table.entries):
        where = f"entry {i} ({e.backend} @ {e.family} {e.bucket})"
        if e.backend not in BACKENDS:
            errors.append(f"{where}: unknown backend {e.backend!r}")
            continue
        if e.us_per_iter <= 0:
            errors.append(f"{where}: non-positive us_per_iter")
        if e.fuse < 1:
            errors.append(f"{where}: fuse must be >= 1")
        if any(b < 1 for b in e.bucket):
            errors.append(f"{where}: malformed bucket")
            continue
        if e.backend == "halo":
            if e.mesh is None:
                errors.append(f"{where}: halo entries must record the mesh "
                              f"tiling they were measured on")
                continue
            if len(e.mesh) != 2 or any(m < 1 for m in e.mesh):
                errors.append(f"{where}: malformed mesh {e.mesh}")
                continue
        elif e.mesh is not None:
            errors.append(f"{where}: mesh is a halo-only field "
                          f"(single-device schedules transfer across meshes)")
            continue
        try:
            rep = family_representative(e.family, e.bucket)
        except TableError as err:
            errors.append(f"{where}: {err}")
            continue
        sup = backend_support(e.backend, rep, grid_shape=e.bucket,
                              mode=BoundaryMode.MASK, bc=0.0, mesh=e.mesh)
        if not sup:
            errors.append(f"{where}: no longer a legal backend_support "
                          f"cell: {sup.reason}")
    return errors


def check_table_file(path: str) -> list[str]:
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"cannot read {path}: {e}"]
    return validate_table(data)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description=f"validate a {DEFAULT_TABLE_NAME} artifact")
    ap.add_argument("--check", metavar="PATH", nargs="?", const="",
                    default="",
                    help="table to validate (default: the committed table)")
    args = ap.parse_args(argv)
    path = args.check or default_table_path()
    errors = check_table_file(path)
    if errors:
        for e in errors:
            print(f"TUNE-CHECK FAIL: {e}")
        return 1
    with open(path) as f:
        n = len(json.load(f).get("entries", []))
    print(f"tune-check OK: {path} ({n} entries, schema {SCHEMA_VERSION})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
