"""K5: the dense-layer encoding's matrix product ``x @ W`` — the port of the
TPU kernel ``kernels/dense_stencil.py::dense_stencil_matmul`` (the paper's
Algorithm 1 at kernel level).

``dense_stencil_matmul`` dispatches on the device of ``x``: a CPU tensor
goes through ``dense_stencil_plain``, a CUDA tensor launches
``csrc/dense_stencil.cu`` (a tiled fp32 GEMM on the CUDA cores, no library
call) and raises if it cannot.  The plan's ``dense`` backend keeps
``torch.matmul``, as the JAX package's keeps XLA's matmul; this kernel is
reached through ``ops.dense_jacobi_kernel``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dense_stencil_ref

# gridDim.y carries the 128-row blocks of x.
MAX_ROWS = 65_535 * 128


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 2:
        raise ValueError(f"x must be (S, N), got {tuple(x.shape)}")
    N = x.shape[1]
    if tuple(w.shape) != (N, N):
        raise ValueError(f"w must be ({N},{N}), got {tuple(w.shape)}")
    if x.dtype not in _build.DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"x and w must both be float32 or both bfloat16, "
                         f"got {x.dtype} and {w.dtype}")


def dense_stencil_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K5's plain PyTorch version: fp32 product, rounded to x's type."""
    _check(x, w)
    return dense_stencil_ref(x, w)


def _launcher():
    lib = _build.library("dense_stencil")
    fn = lib.dense_stencil_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def dense_stencil_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (S, N) @ w: (N, N) -> (S, N) in x's type, fp32 accumulation."""
    if x.device.type == "cpu":
        return dense_stencil_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"dense_stencil_matmul runs on cpu or cuda, not "
                         f"{x.device}")
    _check(x, w)
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("dense_stencil_matmul needs contiguous x and w")
    S, N = x.shape
    if S > MAX_ROWS:
        raise ValueError(f"{S} rows exceed the kernel's {MAX_ROWS}")
    lib, fn = _launcher()
    out = torch.empty_like(x)
    rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), S, N,
            _build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "dense_stencil_matmul")
    _build.LAUNCHES["dense_stencil_matmul"] += 1
    return out
