"""The trainable flash attention — the port of the JAX package's
``kernels/flash_attention_bwd.py``: K7, the forward that also writes the row
logsumexp (``_flash_fwd``), K8 and K9, the backward kernels (``_flash_bwd``:
dq, and dk/dv with the GQA group folded in), and ``flash_attention_trainable``,
the op the transformer calls, joined as a ``torch.autograd.Function``.

``flash_fwd`` and ``flash_bwd`` dispatch on the device of ``q``: a CPU tensor
goes through the plain versions, a CUDA tensor launches K7
(``csrc/flash_attention_sm90.cu`` in bf16, ``csrc/flash_attention.cu`` in
fp32; see ``flash_attention.launch``) or K8 and K9 (``KERNELS``:
``csrc/flash_attention_bwd_sm90.cu`` in bf16, on the tensor cores;
``csrc/flash_attention_bwd.cu`` in fp32, on the CUDA cores) and raises if
it cannot: there is no fallback from one to the other.

The plain versions are the TPU kernels' arithmetic in PyTorch ops over the
TPU kernels' own blocks (``flash_attention.layout``: inputs padded to whole
(bq, bk) blocks, blocks wholly above the causal diagonal skipped, the mask a
finite -1e30), with JAX's casts: s = q·kᵀ with fp32 sums, then the scale;
p = exp(s - lse); dp = do·vᵀ with do and v in fp32; ds = p·(dp - delta)·
scale, rounded to k's type before ds·k (dq) and to q's type before dsᵀ·q
(dk); p not rounded before pᵀ·do (dv).  ``delta = sum(do·o)`` is a PyTorch
reduction on both paths, as JAX computes it outside its kernels
(flash_attention_bwd.py:221).  The CUDA kernels tile by their own sizes
(fp32: 64 x 64; bf16: 128-row CTAs over 64-row tiles) and compute the same
function on every row that has at least one valid key
(``flash_attention``'s module docstring says why rows with none differ).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (HEAD_DIMS, MAX_GRID_YZ,
                                                 NEG_INF, TC_TILE_Q,
                                                 check_operands, launch,
                                                 layout,
                                                 online_softmax_plain)
from repro_torch.launch.hlo_cost import attention_cost, kernel_cost, nbytes

# The CUDA source and entry points (K8, K9) of each dtype.
KERNELS = {torch.bfloat16: ("flash_attention_bwd_sm90",
                            "flash_bwd_dq_sm90_launch",
                            "flash_bwd_dkv_sm90_launch"),
           torch.float32: ("flash_attention_bwd", "flash_bwd_dq_launch",
                           "flash_bwd_dkv_launch")}


def flash_fwd_plain(q, k, v, *, causal: bool = True, block_q: int = 512,
                    block_k: int = 512, kv_offset: int = 0):
    """K7's plain PyTorch version: (out (B, Sq, H, hd), lse (B, H, Sq))."""
    return online_softmax_plain(q, k, v, causal=causal, block_q=block_q,
                                block_k=block_k, kv_offset=kv_offset)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, block_q: int = 512, block_k: int = 512,
              kv_offset: int = 0):
    """q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd) -> (out (B, Sq, H, hd) in
    q's type, lse (B, H, Sq) fp32); on ``meta`` their shapes only.  Every
    path charges a counting ``launch.hlo_cost.CostCounter`` K7's analytic
    work."""
    B, Sq, H, _ = q.shape
    with kernel_cost(attention_cost(q, k, causal, kv_offset, 4),
                     2 * nbytes(q) + nbytes(k) + nbytes(v) + 4 * B * H * Sq):
        if q.device.type == "cpu":
            # contiguous, as the kernel writes them
            out, lse = flash_fwd_plain(q, k, v, causal=causal,
                                       block_q=block_q, block_k=block_k,
                                       kv_offset=kv_offset)
            return out.contiguous(), lse.contiguous()
        if q.device.type == "meta":
            check_operands(q, k, v)
            return torch.empty_like(q), q.new_empty((B, H, Sq),
                                                    dtype=torch.float32)
        if q.device.type != "cuda":
            raise ValueError(f"flash_fwd runs on cpu or cuda, not "
                             f"{q.device}")
        return launch(q, k, v, causal=causal, kv_offset=kv_offset,
                      with_lse=True, name="flash_fwd")


# ---------------------------------------------------------------------------
# K8/K9: the backward
# ---------------------------------------------------------------------------

def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = sum(do·o) over head_dim in fp32: (B, Sq, H, hd) -> (B, H,
    Sq), contiguous."""
    return torch.einsum("bshd,bshd->bhs", do.float(), o.float()).contiguous()


def _blocks(q, k, v, do, lse, delta, block_q, block_k):
    """The TPU kernels' padded (B, heads, seq, ...) operands, q/do/lse/delta
    grouped (B, KV, G, Sqp, ...) by kv head."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qt, kt, vt, bq, bk = layout(q, k, v, block_q, block_k)
    Sqp = qt.shape[2]
    pad = Sqp - Sq
    dot = torch.nn.functional.pad(do.transpose(1, 2), (0, 0, 0, pad))
    grouped = [t.reshape(B, KV, H // KV, Sqp, *t.shape[3:]) for t in (
        qt, dot, torch.nn.functional.pad(lse, (0, pad)),
        torch.nn.functional.pad(delta, (0, pad)))]
    return (*grouped, kt, vt, bq, bk)


def _block_ds(qb, kb, vb, dob, lse_b, delta_b, q_pos, k_pos, *, causal,
              scale, Skv):
    """(p, ds) of one block, as the TPU kernels form them."""
    s = torch.einsum("bkgqd,bksd->bkgqs", qb.float(), kb.float()) * scale
    valid = (k_pos < Skv)[None, :]
    if causal:
        valid = valid & (k_pos[None, :] <= q_pos[:, None])
    s = torch.where(valid, s, NEG_INF)
    p = torch.exp(s - lse_b[..., None])
    dp = torch.einsum("bkgqd,bksd->bkgqs", dob.float(), vb.float())
    return p, p * (dp - delta_b[..., None]) * scale


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, causal: bool = True,
                       block_q: int = 512, block_k: int = 512,
                       kv_offset: int = 0) -> torch.Tensor:
    """K8's plain version (``_dq_kernel``): dq (B, Sq, H, hd) in q's type,
    summed over the kv blocks in order."""
    check_operands(q, k, v)
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    qg, dog, lse_g, delta_g, kt, vt, bq, bk = _blocks(
        q, k, v, do, lse, delta, block_q, block_k)
    Sqp = qg.shape[3]
    q_pos = torch.arange(Sqp, device=q.device)
    q_last = q_pos // bq * bq + bq - 1      # last row of each row's block
    acc = torch.zeros(qg.shape, device=q.device)
    for ik in range(kt.shape[2] // bk):
        kb = kt[:, :, ik * bk:(ik + 1) * bk]
        k_pos = ik * bk + torch.arange(bk, device=q.device) - kv_offset
        _, ds = _block_ds(qg, kb, vt[:, :, ik * bk:(ik + 1) * bk], dog,
                          lse_g, delta_g, q_pos, k_pos, causal=causal,
                          scale=hd ** -0.5, Skv=Skv)
        contrib = torch.einsum("bkgqs,bksd->bkgqd", ds.to(k.dtype).float(),
                               kb.float())
        if causal:
            # Rows of a block wholly above the diagonal get nothing from it.
            run = (ik * bk - kv_offset) <= q_last
            acc = torch.where(run[:, None], acc + contrib, acc)
        else:
            acc = acc + contrib
    dq = acc.to(q.dtype).reshape(B, H, Sqp, hd)
    return dq[:, :, :Sq].transpose(1, 2)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal: bool = True,
                        block_q: int = 512, block_k: int = 512,
                        kv_offset: int = 0):
    """K9's plain version (``_dkv_kernel``): (dk, dv), each (B, Skv, KV, hd)
    in k's and v's type, summed over the group's heads and, inside each,
    over the q blocks, in the TPU kernel's grid order."""
    check_operands(q, k, v)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg, dog, lse_g, delta_g, kt, vt, bq, bk = _blocks(
        q, k, v, do, lse, delta, block_q, block_k)
    Sqp = qg.shape[3]
    dks, dvs = [], []
    for ik in range(kt.shape[2] // bk):
        kb = kt[:, :, ik * bk:(ik + 1) * bk]
        vb = vt[:, :, ik * bk:(ik + 1) * bk]
        k_pos = ik * bk + torch.arange(bk, device=q.device) - kv_offset
        dk = torch.zeros(B, KV, bk, hd, device=q.device)
        dv = torch.zeros_like(dk)
        for g in range(G):
            for iq in range(Sqp // bq):
                if causal and (ik * bk - kv_offset) > (iq * bq + bq - 1):
                    continue
                rows = slice(iq * bq, (iq + 1) * bq)
                qb = qg[:, :, g:g + 1, rows]
                dob = dog[:, :, g:g + 1, rows]
                p, ds = _block_ds(
                    qb, kb, vb, dob, lse_g[:, :, g:g + 1, rows],
                    delta_g[:, :, g:g + 1, rows],
                    torch.arange(iq * bq, (iq + 1) * bq, device=q.device),
                    k_pos, causal=causal, scale=hd ** -0.5, Skv=Skv)
                dv = dv + torch.einsum("bkgqs,bkgqd->bksd", p, dob.float())
                dk = dk + torch.einsum("bkgqs,bkgqd->bksd",
                                       ds.to(q.dtype).float(), qb.float())
        dks.append(dk)
        dvs.append(dv)
    dk = torch.cat(dks, dim=2)[:, :, :Skv].transpose(1, 2).to(k.dtype)
    dv = torch.cat(dvs, dim=2)[:, :, :Skv].transpose(1, 2).to(v.dtype)
    return dk, dv


def flash_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                    block_q: int = 512, block_k: int = 512,
                    kv_offset: int = 0):
    """K8's and K9's plain versions: (dq, dk, dv) in the public layouts."""
    delta = flash_delta(o, do)
    kw = dict(causal=causal, block_q=block_q, block_k=block_k,
              kv_offset=kv_offset)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    return (dq, *flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw))


def _launcher(dtype: torch.dtype, dkv: bool):
    """(library, entry point) of K8 (``dkv`` False) or K9 for ``dtype``."""
    source, *symbols = KERNELS[dtype]
    lib = _build.library(source)
    fn = getattr(lib, symbols[dkv])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * (8 if dkv else 7) + [
            ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def _prepare(q, k, v, do, lse, delta, causal, kv_offset):
    """Check what K8/K9 take; returns their common launch arguments."""
    check_operands(q, k, v)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must have q's shape and type, got "
                         f"{tuple(do.shape)} {do.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, Sq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({B}, {H}, {Sq}) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    ops = (q, k, v, do, lse, delta)
    if len({t.device for t in ops}) != 1:
        raise ValueError(f"flash_bwd operands lie on "
                         f"{[str(t.device) for t in ops]}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("flash_bwd needs contiguous q, k, v, do, lse, "
                         "delta")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_bwd: head_dim {hd} has no kernel (built "
                         f"for {HEAD_DIMS})")
    if B > MAX_GRID_YZ or H > MAX_GRID_YZ:
        raise ValueError(f"flash_bwd: batch {B} and heads {H} must each be "
                         f"at most {MAX_GRID_YZ}")
    if Sq == 0 or Skv == 0:
        raise ValueError(f"flash_bwd: empty sequence (Sq={Sq}, Skv={Skv})")
    if q.dtype == torch.bfloat16:
        # TMA reads from 16-byte aligned tensors, and gridDim.z carries the
        # 128-row q tiles (K8) and k tiles (K9).
        if any(t.data_ptr() % 16 for t in (q, k, v, do)):
            raise ValueError("flash_bwd: bf16 q, k, v, do must be 16-byte "
                             "aligned")
        if -(-max(Sq, Skv) // TC_TILE_Q) > MAX_GRID_YZ:
            raise ValueError(f"flash_bwd: Sq={Sq} or Skv={Skv} is past "
                             f"{MAX_GRID_YZ * TC_TILE_Q} rows")
    inputs = tuple(t.data_ptr() for t in ops)
    shape = (B, Sq, Skv, H, KV, hd, _build.DTYPE_CODES[q.dtype], int(causal),
             kv_offset, hd ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    return inputs, shape


def launch_bwd_dq(q, k, v, do, lse, delta, *, causal: bool,
                  kv_offset: int) -> torch.Tensor:
    """Launch K8 on CUDA tensors: dq; counts under ``flash_bwd_dq``."""
    inputs, shape = _prepare(q, k, v, do, lse, delta, causal, kv_offset)
    dq = torch.empty_like(q)
    lib, fn = _launcher(q.dtype, dkv=False)
    _build.check(lib, fn(*inputs, dq.data_ptr(), *shape), "flash_bwd_dq")
    _build.LAUNCHES["flash_bwd_dq"] += 1
    return dq


def launch_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool,
                   kv_offset: int):
    """Launch K9 on CUDA tensors: (dk, dv); counts under
    ``flash_bwd_dkv``."""
    inputs, shape = _prepare(q, k, v, do, lse, delta, causal, kv_offset)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib, fn = _launcher(q.dtype, dkv=True)
    _build.check(lib, fn(*inputs, dk.data_ptr(), dv.data_ptr(), *shape),
                 "flash_bwd_dkv")
    _build.LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
              causal: bool = True, block_q: int = 512, block_k: int = 512,
              kv_offset: int = 0):
    """The gradients of flash attention: q, o, do (B, Sq, H, hd), k/v (B,
    Skv, KV, hd), lse (B, H, Sq) fp32 (``flash_fwd``'s) -> (dq, dk, dv) in
    the layouts and types of q, k, v.  block_q/block_k are the plain
    version's blocks; the kernels tile by their own sizes whatever they
    are.  On ``meta`` the gradients' shapes only.  ``delta`` is a PyTorch
    reduction on every path (JAX's too), counted as such; K8 and K9 each
    charge a counting ``launch.hlo_cost.CostCounter`` their analytic
    work."""
    dev = q.device.type
    if dev not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_bwd runs on cpu or cuda, not {q.device}")
    if o.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    delta = flash_delta(o, do)
    kw = dict(causal=causal, kv_offset=kv_offset)
    plain = dict(kw, block_q=block_q, block_k=block_k)
    reads = (2 * nbytes(q) + nbytes(k) + nbytes(v) + nbytes(lse)
             + nbytes(delta))       # q, do, k, v, lse, delta
    with kernel_cost(attention_cost(q, k, causal, kv_offset, 6),
                     reads + nbytes(q)):
        if dev == "cpu":
            dq = flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                    **plain).contiguous()
        elif dev == "meta":
            check_operands(q, k, v)
            dq = torch.empty_like(q)
        else:
            dq = launch_bwd_dq(q, k, v, do, lse, delta, **kw)
    with kernel_cost(attention_cost(q, k, causal, kv_offset, 8),
                     reads + nbytes(k) + nbytes(v)):
        if dev == "cpu":
            dk, dv = (t.contiguous() for t in flash_bwd_dkv_plain(
                q, k, v, do, lse, delta, **plain))
        elif dev == "meta":
            dk, dv = torch.empty_like(k), torch.empty_like(v)
        else:
            dk, dv = launch_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K7 forward, K8/K9 backward: the port of JAX's ``custom_vjp``
    (``_fwd_rule`` saves (q, k, v, o, lse); ``_bwd_rule`` runs the backward
    kernels on them)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k, kv_offset):
        out, lse = flash_fwd(q, k, v, causal=causal, block_q=block_q,
                             block_k=block_k, kv_offset=kv_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.options = dict(causal=causal, block_q=block_q, block_k=block_k,
                           kv_offset=kv_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout.contiguous(),
                               **ctx.options)
        return dq, dk, dv, None, None, None, None


def flash_attention_trainable(q, k, v, causal: bool = True,
                              block_q: int = 512, block_k: int = 512,
                              kv_offset: int = 0) -> torch.Tensor:
    """JAX's trainable op, with its signature: attention (B, Sq, H, hd)
    through K7, whose gradients come from K8/K9 (their plain versions on a
    CPU tensor)."""
    return FlashAttention.apply(q, k, v, causal, block_q, block_k,
                                kv_offset)
