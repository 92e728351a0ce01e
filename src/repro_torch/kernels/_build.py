"""Build the CUDA kernels with nvcc and bind them with ctypes.

Every ``csrc/*.cu`` is compiled on its own into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), all sources at
once, the first time a kernel is launched in the process.  The libraries go
to ``build/kernels/<hash>/`` at the root of the checkout, keyed by a hash of
the sources and flags, so an edit rebuilds and an unchanged tree reuses
them.  Wrappers pass tensors as ``data_ptr()`` integers and PyTorch's
current stream; each C entry point returns ``cudaGetLastError()`` after its
launch and :func:`check` raises on anything but 0.

Nothing here runs at import: importing the package needs no CUDA toolkit.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.stencil import StencilSpec, WeightField

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches per kernel, counted by the wrappers where they launch (never on
# the plain path), so a run can show which kernels its main path went
# through.  Keys: "stencil2d", "jacobi2d_trapezoid", "jacobi2d_resident",
# "stencil3d", "dense_stencil_matmul", "split_bf16x3" (the fp32 route's
# split, two a product), "flash_attention", "flash_fwd", "flash_bwd_dq",
# "flash_bwd_dkv".
LAUNCHES: collections.Counter = collections.Counter()

# gridDim.z carries the batch of the stencil kernels (K1-K4): a larger batch
# runs as consecutive launches of at most this many instances.
MAX_GRID_Z = 65_535


def batch_slices(batch: int):
    """(first instance, instances) of each launch a stencil wrapper makes
    for ``batch`` instances."""
    return [(b0, min(MAX_GRID_Z, batch - b0))
            for b0 in range(0, batch, MAX_GRID_Z)]

# Sizes of the 2D and 3D tap tables (csrc/taps.cuh), the most taps each
# holds in the kernels' parameter space (a spec with more comes as a device
# array, ``big_taps``), and the dtype codes of its DTYPE_* enum.
MAX_TAPS = 25
MAX_TAPS_3D = 125
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class Taps(ctypes.Structure):
    """The ``Taps`` struct of csrc/taps.cuh, field for field."""

    _fields_ = [("n", ctypes.c_int),
                ("dr", ctypes.c_int * MAX_TAPS),
                ("dc", ctypes.c_int * MAX_TAPS),
                ("field", ctypes.c_int * MAX_TAPS),
                ("w", ctypes.c_float * MAX_TAPS)]


class Taps3(ctypes.Structure):
    """The ``Taps3`` struct of csrc/taps.cuh, field for field."""

    _fields_ = [("n", ctypes.c_int),
                ("dz", ctypes.c_int * MAX_TAPS_3D),
                ("dr", ctypes.c_int * MAX_TAPS_3D),
                ("dc", ctypes.c_int * MAX_TAPS_3D),
                ("field", ctypes.c_int * MAX_TAPS_3D),
                ("w", ctypes.c_float * MAX_TAPS_3D)]


_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}
_build_log: dict[str, str] = {}


def _tap_rows(spec: StencilSpec):
    """(dz, dr, dc, field, w) of each tap in canonical order: dz is 0 in
    2D, field the tap's index in the field stack or -1 for a scalar w."""
    rows, k = [], 0
    for off, w in spec.taps:
        dz = off[0] if spec.ndim == 3 else 0
        if isinstance(w, WeightField):
            rows.append((dz, *off[-2:], k, 0.0))
            k += 1
        else:
            rows.append((dz, *off[-2:], -1, float(w)))
    return rows


@functools.lru_cache(maxsize=64)
def tap_table(spec: StencilSpec) -> Taps | Taps3:
    """The spec's taps in canonical order, as the kernels read them: a
    ``Taps`` for a 2D spec, a ``Taps3`` for a 3D one (the wrappers have
    checked the rank).  Past the table's size only ``n`` is set: the taps
    come from ``big_taps``."""
    t = Taps() if spec.ndim == 2 else Taps3()
    t.n = len(spec.taps)
    if t.n > len(t.dr):
        return t
    for i, (dz, dr, dc, f, w) in enumerate(_tap_rows(spec)):
        if spec.ndim == 3:
            t.dz[i] = dz
        t.dr[i], t.dc[i], t.field[i], t.w[i] = dr, dc, f, w
    return t


@functools.lru_cache(maxsize=16)
def big_taps(spec: StencilSpec, device: torch.device) -> torch.Tensor | None:
    """The whole tap table on ``device`` as the kernels' ``Tap`` array
    (csrc/taps.cuh: int32 dz, dr, dc, field and the fp32 w, 20 bytes a
    tap) for a spec with more taps than ``tap_table`` holds; None for any
    other."""
    if len(spec.taps) <= len(tap_table(spec).dr):
        return None
    rows = _tap_rows(spec)
    table = np.array([r[:4] for r in rows], dtype=np.int32)
    w = np.array([r[4] for r in rows], dtype=np.float32).view(np.int32)
    return torch.from_numpy(np.column_stack([table, w])).to(device)


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME/bin "
                       "and /usr/local/cuda/bin): the CUDA kernels cannot "
                       "be built")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` not built yet, one nvcc each, all at
    once; returns {source stem: library path}.  Raises with nvcc's output
    when a source does not compile."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {p.stem: out_dir / f"lib{p.stem}.so"
            for p in sorted(CSRC.glob("*.cu"))}
    todo = {name: path for name, path in libs.items() if not path.exists()}
    if todo:
        nvcc = _nvcc()
        procs = {}
        for name, path in todo.items():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, path)
        failed = []
        for name, (proc, tmp, path) in procs.items():
            log, _ = proc.communicate()
            _build_log[name] = log
            (out_dir / f"{name}.log").write_text(log)
            if proc.returncode:
                failed.append(f"nvcc failed on csrc/{name}.cu:\n{log}")
            else:
                os.replace(tmp, path)  # atomic: concurrent builds agree
        if failed:
            raise RuntimeError("\n".join(failed))
    return libs


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) for one
    source, or "" if this process did not compile it."""
    return _build_log.get(name, "")


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libraries[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if rc:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
