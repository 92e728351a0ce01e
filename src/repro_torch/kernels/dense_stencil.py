"""K5: the dense-layer encoding's matrix product ``x @ W`` — the port of the
TPU kernel ``kernels/dense_stencil.py::dense_stencil_matmul`` (the paper's
Algorithm 1 at kernel level).

``dense_stencil_matmul`` dispatches on the device of ``x``: a CPU tensor
goes through ``dense_stencil_plain``, a CUDA tensor launches
``csrc/dense_stencil_sm90.cu`` on the tensor cores (no library call) and
raises if it cannot, a ``meta`` tensor gets its output's shape.  The route
follows the dtype: bf16 runs one bf16 product; fp32 first splits x and W
into three bf16 pieces each (``split_bf16x3``, a kernel of the same
source) and sums six piece products in fp32, as the TPU's matrix unit
builds an fp32 product from bf16 passes.
``dense_stencil_split_plain`` repeats that arithmetic in plain PyTorch.
The plan's ``dense`` backend keeps ``torch.matmul``, as the JAX package's
keeps XLA's matmul; this kernel is reached through
``ops.dense_jacobi_kernel``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dense_stencil_ref
from repro_torch.launch.hlo_cost import kernel_cost

# gridDim.y carries the 128-row blocks of x.
MAX_ROWS = 65_535 * 128
# K per stage of the fp32 route: the unit in which x0 . W0 is added to the
# fp32 sum (csrc/dense_stencil_sm90.cu, Route<3>::BK).
SPLIT_BLOCK_K = 32
# The piece products (i, j) of x_i . W_j the fp32 route sums besides
# x0 . W0, in the kernel's order.
SMALL_PRODUCTS = ((0, 1), (1, 0), (0, 2), (1, 1), (2, 0))


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 2:
        raise ValueError(f"x must be (S, N), got {tuple(x.shape)}")
    N = x.shape[1]
    if tuple(w.shape) != (N, N):
        raise ValueError(f"w must be ({N},{N}), got {tuple(w.shape)}")
    if x.dtype not in _build.DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"x and w must both be float32 or both bfloat16, "
                         f"got {x.dtype} and {w.dtype}")


def padded_cols(n: int) -> int:
    """The row stride, in elements, of the bf16 operands the kernel reads:
    n rounded up to a multiple of 8 (TMA's 16-byte stride rule)."""
    return -(-n // 8) * 8


def dense_stencil_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K5's plain PyTorch version: fp32 product, rounded to x's type."""
    _check(x, w)
    return dense_stencil_ref(x, w)


def split_bf16x3(v: torch.Tensor, cols: int | None = None) -> torch.Tensor:
    """The plain split of an fp32 (rows, n) tensor into three bf16 pieces,
    v0 = bf16(v), v1 = bf16(v - v0), v2 = bf16(v - v0 - v1) (round to
    nearest even, each difference exact in fp32), stacked as (3, rows,
    cols) and zero past n (``cols`` defaults to n).  v0 + v1 + v2 == v for
    normal values of magnitude 2^-110 and more."""
    v = v.float()
    v0 = v.bfloat16()
    r1 = v - v0.float()
    v1 = r1.bfloat16()
    v2 = (r1 - v1.float()).bfloat16()
    out = torch.stack([v0, v1, v2])
    cols = v.shape[-1] if cols is None else cols
    return F.pad(out, (0, cols - v.shape[-1]))


def dense_stencil_split_plain(x: torch.Tensor,
                              w: torch.Tensor) -> torch.Tensor:
    """The fp32 route's arithmetic in plain PyTorch: x and w split into
    three bf16 pieces each, x0 . W0 summed per ``SPLIT_BLOCK_K`` slice of K
    and each slice added to the fp32 sum, the five products of
    ``SMALL_PRODUCTS`` summed over all of K, then added once.  Each piece
    product is exact in fp32; only the order of the fp32 sums inside one
    product differs from the kernel's."""
    _check(x, w)
    xs, ws = split_bf16x3(x).float(), split_bf16x3(w).float()
    N = x.shape[1]
    big = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k0 in range(0, N, SPLIT_BLOCK_K):
        k = slice(k0, k0 + SPLIT_BLOCK_K)
        big = big + xs[0][:, k] @ ws[0][k]
    small = torch.zeros_like(big)
    for i, j in SMALL_PRODUCTS:
        small = small + xs[i] @ ws[j]
    return big + small


def _library():
    lib = _build.library("dense_stencil_sm90")
    if lib.dense_stencil_sm90_launch.argtypes is None:
        lib.dense_stencil_sm90_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.dense_stencil_sm90_launch.restype = ctypes.c_int
        lib.split_bf16x3_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.split_bf16x3_launch.restype = ctypes.c_int
    return lib


def launch_split(v: torch.Tensor, cols: int) -> torch.Tensor:
    """``split_bf16x3`` by the kernel of csrc/dense_stencil_sm90.cu: v a
    contiguous, 16-byte aligned fp32 (rows, n) CUDA tensor (its 16-byte
    loads), cols a multiple of 8 and at least n.  Counted in
    ``_build.LAUNCHES["split_bf16x3"]``."""
    if v.device.type != "cuda" or v.dtype != torch.float32 \
            or v.ndim != 2 or not v.is_contiguous():
        raise ValueError(f"launch_split takes a contiguous fp32 (rows, n) "
                         f"CUDA tensor, got {v.dtype} {tuple(v.shape)} on "
                         f"{v.device}")
    if v.data_ptr() % 16:
        raise ValueError("launch_split: v must be 16-byte aligned")
    rows, n = v.shape
    if cols % 8 or cols < n:
        raise ValueError(f"cols {cols} must be a multiple of 8, >= {n}")
    lib = _library()
    out = torch.empty((3, rows, cols), dtype=torch.bfloat16, device=v.device)
    rc = lib.split_bf16x3_launch(
        v.data_ptr(), out.data_ptr(), rows, n, cols,
        torch.cuda.current_stream(v.device).cuda_stream)
    _build.check(lib, rc, "split_bf16x3")
    _build.LAUNCHES["split_bf16x3"] += 1
    return out


def dense_stencil_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (S, N) @ w: (N, N) -> (S, N) in x's type, fp32 accumulation: the
    plain version on the CPU, the kernel on CUDA, the output's shape on
    ``meta``.  Each call charges a counting ``launch.hlo_cost.CostCounter``
    the product's 2·S·N² flops and its operands' and result's bytes (x and
    w read, the result written, once), fp32 split and bf16 alike."""
    S, N = x.shape[0], w.shape[0]
    with kernel_cost(2.0 * S * N * N, 2 * x.nbytes + w.nbytes):
        if x.device.type == "cpu":
            return dense_stencil_plain(x, w)
        if x.device.type == "meta":
            _check(x, w)
            if S > MAX_ROWS:
                raise ValueError(f"{S} rows exceed the kernel's {MAX_ROWS}")
            return torch.empty_like(x)
        if x.device.type != "cuda":
            raise ValueError(f"dense_stencil_matmul runs on cpu, cuda or "
                             f"meta, not {x.device}")
        return _launch(x, w)


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K5 on CUDA tensors: fp32 split into three bf16 pieces, or bf16."""
    _check(x, w)
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("dense_stencil_matmul needs contiguous x and w")
    # TMA (bf16) and the split's 16-byte loads (fp32) read aligned rows.
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("dense_stencil_matmul: x and w must be 16-byte "
                         "aligned")
    S, N = x.shape
    if S > MAX_ROWS:
        raise ValueError(f"{S} rows exceed the kernel's {MAX_ROWS}")
    cols = padded_cols(N)
    if x.dtype == torch.float32:
        a, b, pieces = launch_split(x, cols), launch_split(w, cols), 3
    else:
        a, b, pieces = x, w, 1
        if cols != N:
            a, b = F.pad(x, (0, cols - N)), F.pad(w, (0, cols - N))
    lib = _library()
    out = torch.empty_like(x)
    rc = lib.dense_stencil_sm90_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), S, N, cols, pieces,
        _build.DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, rc, "dense_stencil_matmul")
    _build.LAUNCHES["dense_stencil_matmul"] += 1
    return out
