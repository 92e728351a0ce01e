"""K6: GQA attention forward with an online softmax — the port of the TPU
kernel ``kernels/flash_attention.py::flash_attention``.

``flash_attention`` dispatches on the device of ``q``: a CPU tensor goes
through ``flash_attention_plain``, a CUDA tensor launches a kernel and raises
if it cannot: bf16 ``csrc/flash_attention_sm90.cu`` (the tensor cores:
``wgmma`` fed by TMA, 128 x 128 tiles), fp32 ``csrc/flash_attention.cu`` (the
CUDA cores, 64 x 64 tiles; no fp32 tensor-core format keeps fp32's bound),
each refusing the other's dtype.  The same sources carry K7
(``flash_attention_bwd.flash_fwd``, which also writes the row logsumexp);
``online_softmax_plain`` is the plain version of both.

The plain version is the TPU kernel's arithmetic in PyTorch ops, over the
TPU kernel's own (bq, bk) blocks: ``bq = min(block_q, round_up(Sq, 8))``,
``bk = min(block_k, round_up(Skv, 128))``, inputs padded to whole blocks,
blocks wholly above the causal diagonal skipped, the mask value a finite
-1e30.  So it matches JAX on every row, including rows with no valid key
(whose value depends on the blocks).  The kernels have their own tiles and
take ``block_q``/``block_k`` only to keep the signature: they compute the
same function on every row that has at least one valid key.

``kv_offset`` follows the TPU kernel's code, not its docstring: kv index j
sits at position ``j - kv_offset`` (``k_pos``, flash_attention.py:47), so
``kv_offset=128`` here is ``attention(..., kv_offset=-128)``.  Keys are
masked unless ``j - kv_offset < Skv`` and, when causal, ``j - kv_offset <=
i``.  Where JAX's zero padding makes a padded key pass that test (a
non-causal call with ``kv_offset > 0``), JAX attends to it and the kernel,
which has no padding, does not.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.tiling import round_up
from repro_torch.launch.hlo_cost import attention_cost, kernel_cost, nbytes

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)   # the kernels' template instances
MAX_GRID_YZ = 65_535            # gridDim.y/.z: heads and batch (SIMT);
                                # batch and q tiles (tensor cores)
TC_TILE_Q = 128                 # q rows a tensor-core CTA takes
# The CUDA source and entry point of each dtype.
KERNELS = {torch.bfloat16: ("flash_attention_sm90",
                            "flash_attention_sm90_launch"),
           torch.float32: ("flash_attention", "flash_attention_launch")}


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the kernel and its plain version take."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, Sq, H, hd) and k, v (B, Skv, KV, hd),"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head_dim")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    if q.dtype not in _build.DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")


def layout(q, k, v, block_q: int, block_k: int):
    """The TPU kernels' block rule (flash_attention_bwd.py ``_layout``):
    (B, heads, seq, hd) copies padded to whole (bq, bk) blocks, and the
    blocks."""
    Sq, Skv = q.shape[1], k.shape[1]
    bq = min(block_q, round_up(Sq, 8))
    bk = min(block_k, round_up(Skv, 128))
    Sqp, Skp = round_up(Sq, bq), round_up(Skv, bk)
    qt = F.pad(q.transpose(1, 2), (0, 0, 0, Sqp - Sq))
    kt = F.pad(k.transpose(1, 2), (0, 0, 0, Skp - Skv))
    vt = F.pad(v.transpose(1, 2), (0, 0, 0, Skp - Skv))
    return qt, kt, vt, bq, bk


def online_softmax_plain(q, k, v, *, causal: bool, block_q: int,
                         block_k: int, kv_offset: int):
    """K6's and K7's plain version: (out (B, Sq, H, hd) in q's type,
    lse (B, H, Sq) fp32), block by block as the TPU kernels run."""
    check_operands(q, k, v)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qt, kt, vt, bq, bk = layout(q, k, v, block_q, block_k)
    Sqp, Skp = qt.shape[2], kt.shape[2]
    # (B, KV, G, Sqp, hd): head h = kv * G + g reads kv head h // G.
    qg = qt.reshape(B, KV, G, Sqp, hd).float()
    q_pos = torch.arange(Sqp, device=q.device)
    q_last = q_pos // bq * bq + bq - 1      # last row of each row's block
    m = torch.full((B, KV, G, Sqp), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, G, Sqp, hd), device=q.device)
    for ik in range(Skp // bk):
        kb = kt[:, :, ik * bk:(ik + 1) * bk]
        vb = vt[:, :, ik * bk:(ik + 1) * bk]
        k_pos = ik * bk + torch.arange(bk, device=q.device) - kv_offset
        s = torch.einsum("bkgqd,bksd->bkgqs", qg, kb.float()) * scale
        valid = (k_pos < Skv)[None, :]
        if causal:
            valid = valid & (k_pos[None, :] <= q_pos[:, None])
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(dim=-1)
        acc_new = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bksd->bkgqd", p.to(v.dtype).float(), vb.float())
        if causal:
            # The TPU kernel skips blocks wholly above the diagonal: rows of
            # a skipped block keep their state.
            run = (ik * bk - kv_offset) <= q_last
            m = torch.where(run, m_new, m)
            l = torch.where(run, l_new, l)
            acc = torch.where(run[:, None], acc_new, acc)
        else:
            m, l, acc = m_new, l_new, acc_new
    l_safe = torch.where(l == 0, 1.0, l)
    out = (acc / l_safe[..., None]).to(q.dtype).reshape(B, H, Sqp, hd)
    lse = (m + torch.log(l_safe)).reshape(B, H, Sqp)
    return out[:, :, :Sq].transpose(1, 2), lse[:, :, :Sq]


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          block_q: int = 512, block_k: int = 512,
                          kv_offset: int = 0) -> torch.Tensor:
    """K6's plain PyTorch version."""
    return online_softmax_plain(q, k, v, causal=causal, block_q=block_q,
                                block_k=block_k, kv_offset=kv_offset)[0]


def _launcher(dtype: torch.dtype):
    source, symbol = KERNELS[dtype]
    lib = _build.library(source)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def launch(q, k, v, *, causal: bool, kv_offset: int, with_lse: bool,
           name: str):
    """Launch the kernel of q's dtype (``KERNELS``) on CUDA tensors;
    returns (out, lse or None) and counts the launch under ``name``."""
    check_operands(q, k, v)
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v lie on {q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} needs contiguous q, k, v")
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} has no kernel (built for "
                         f"{HEAD_DIMS})")
    if B > MAX_GRID_YZ or H > MAX_GRID_YZ:
        raise ValueError(f"{name}: batch {B} and heads {H} must each be at "
                         f"most {MAX_GRID_YZ}")
    if Sq == 0 or Skv == 0:
        raise ValueError(f"{name}: empty sequence (Sq={Sq}, Skv={Skv})")
    if q.dtype == torch.bfloat16:
        # TMA reads from 16-byte aligned tensors, and gridDim.z carries the
        # q tiles.
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError(f"{name}: bf16 q, k, v must be 16-byte aligned")
        if -(-Sq // TC_TILE_Q) > MAX_GRID_YZ:
            raise ValueError(f"{name}: Sq={Sq} is past "
                             f"{MAX_GRID_YZ * TC_TILE_Q} rows")
    lib, fn = _launcher(q.dtype)
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, B, Sq, Skv, H, KV, hd,
            _build.DTYPE_CODES[q.dtype], int(causal), kv_offset, hd ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, name)
    _build.LAUNCHES[name] += 1
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 512,
                    block_k: int = 512, kv_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd) -> (B, Sq, H, hd).

    kv_offset: subtracted from a kv index to give its position (the TPU
    kernel's code; see the module docstring).  block_q/block_k are the
    plain version's blocks; the kernels tile by their own sizes whatever
    they are.  On ``meta`` (the dry run) it returns the output's shape
    only.  Every path charges a counting ``launch.hlo_cost.CostCounter``
    the kernel's analytic work.
    """
    with kernel_cost(attention_cost(q, k, causal, kv_offset, 4),
                     2 * nbytes(q) + nbytes(k) + nbytes(v)):
        if q.device.type == "cpu":
            # contiguous, as the kernel writes it
            return flash_attention_plain(q, k, v, causal=causal,
                                         block_q=block_q, block_k=block_k,
                                         kv_offset=kv_offset).contiguous()
        if q.device.type == "meta":
            check_operands(q, k, v)
            return torch.empty_like(q)
        if q.device.type != "cuda":
            raise ValueError(f"flash_attention runs on cpu or cuda, not "
                             f"{q.device}")
        return launch(q, k, v, causal=causal, kv_offset=kv_offset,
                      with_lse=False, name="flash_attention")[0]


def flash_hbm_bytes(B, Sq, Skv, H, KV, hd, bytes_per_el=2) -> int:
    """The TPU kernel's analytic HBM traffic, JAX's formula: q and o once,
    k and v once for each 512-row q block, half of those skipped by the
    causal mask.  Not the CUDA kernels' traffic, whose q tiles differ."""
    q_o = 2 * B * Sq * H * hd * bytes_per_el
    passes = max(1, Sq // 512)
    kv = 2 * B * Skv * KV * hd * bytes_per_el * passes * H // KV
    return q_o + kv // 2
