"""Inputs shared by the flash-attention tests of the port and by
``chip_smoke.py``'s phase 16 (no JAX here)."""
import torch

# bf16 out per element: |out - plain| <= atol + rtol * |plain|.  Two bf16
# ulps (2**-7 relative each) plus 2e-3 for elements near 0, where tiles of
# other sizes round p against other running maxima.
BF16_ATOL, BF16_RTOL = 2e-3, 1.6e-2

# name -> ((B, Sq, Skv, H, KV, hd), causal, kv_offset): MHA, GQA 2:1 on a
# ragged 96, MQA, non-causal, cross lengths with kv_offset=128, every head
# dim the kernels take, a ragged cross-attention without the mask (Skv 150:
# a last kv tile of 22 keys) and a non-causal self-attention over three
# tiles at GQA 6 (300 = 2 x 128 + 44), and the full-size shapes of
# ``CARD_ONLY``.
FLASH_CASES = {
    "mha": ((1, 128, 128, 2, 2, 32), True, 0),
    "gqa_ragged_96": ((2, 96, 96, 4, 2, 16), True, 0),
    "mqa": ((1, 256, 256, 8, 1, 32), True, 0),
    "non_causal": ((1, 64, 64, 2, 2, 16), False, 0),
    "cross_kv_offset_128": ((1, 32, 160, 2, 2, 16), True, 128),
    **{f"hd{hd}": ((2, 200, 200, 4, 2, hd), True, 0)
       for hd in (16, 32, 64, 128)},
    "cross_ragged_non_causal": ((2, 40, 150, 6, 6, 64), False, 0),
    "non_causal_gqa6": ((1, 300, 300, 12, 2, 64), False, 0),
    # The serve and training shape (qwen3-0.6b); qwen2-vl-2b's (GQA 6: 12
    # query heads on 2); whisper-tiny's encoder (1500 frames, non-causal)
    # and cross-attention (224 decoder tokens on 1500 frames).
    "serve_shape": ((4, 2048, 2048, 16, 8, 128), True, 0),
    "vlm_shape": ((4, 2048, 2048, 12, 2, 128), True, 0),
    "whisper_encoder": ((16, 1500, 1500, 6, 6, 64), False, 0),
    "whisper_cross": ((16, 224, 1500, 6, 6, 64), False, 0),
    # The last dense archs': glm4-9b (GQA 16: 32 query heads on 2),
    # phi3-medium-14b (GQA 4: 40 on 10) and nemotron-4-15b (GQA 6: 48 on
    # 8), all at head_dim 128.
    "glm4_shape": ((4, 2048, 2048, 32, 2, 128), True, 0),
    "phi3_shape": ((4, 2048, 2048, 40, 10, 128), True, 0),
    "nemotron_shape": ((4, 2048, 2048, 48, 8, 128), True, 0),
}
# The dense archs' shapes by arch (chip_smoke.py phases 12, 15, 16, 19, 33
# and 34).
DENSE_CASES = {"glm4-9b": "glm4_shape", "phi3-medium-14b": "phi3_shape",
               "nemotron-4-15b": "nemotron_shape"}
# Run on the card only: the CPU tests, which hold the plain versions to
# JAX's Pallas kernels interpreted, leave them out.
CARD_ONLY = frozenset({"serve_shape", "vlm_shape", "whisper_encoder",
                       "whisper_cross", *DENSE_CASES.values()})
# The full-size cases whose bf16 dq and dk bounds allow one flipped
# rounding of ds (``ds_flip_atol``), as the moe shapes' do: sums of 1500 to
# 2048 terms a row and, at qwen2-vl's GQA 6, six heads' terms in each dk
# element; and the dense archs' GQA 16, 4 and 6, whose dk sums 16, 4 and 6
# heads' terms: on the H100, chip_smoke.py phase 16's glm4 inputs read one
# dk element of 2 M at 1.1 times the bound, 0.0027 from the plain value,
# one bf16 ulp (2^-7) of its largest round(ds) q term (0.357), where the
# plain value agrees with float64 of the same rounded ds to 1.7e-5
# (tests/_torch_flash_bwd_noise.py).
FLIP_CASES = frozenset({"vlm_shape", "whisper_encoder", "whisper_cross",
                        *DENSE_CASES.values()})


def p_rounding_case(device="cpu"):
    """bf16 q (1, 64, 2, 16), k and v (1, 1024, 1, 16), for a non-causal call,
    on which rounding p to v's type matters: key 0 scores 0 and keys 1-1023
    score 2.125 * -1 / 4, so each of their p is exp(-0.53125) = 0.58787,
    which bf16 rounds down by 0.33%; v is 8 on those keys and -4800 on key
    0, which nearly cancels their sum.  The output is -0.0078 everywhere,
    and an attention that skips the rounding gives +0.0185."""
    q = torch.zeros(1, 64, 2, 16, device=device)
    q[..., 0] = 2.125
    k = torch.zeros(1, 1024, 1, 16, device=device)
    k[:, 1:, :, 0] = -1.0
    v = torch.full((1, 1024, 1, 16), 8.0, device=device)
    v[:, 0] = -4800.0
    return tuple(t.to(torch.bfloat16) for t in (q, k, v))


def ds_rounding_case(device="cpu"):
    """bf16 q, do (1, 64, 2, 16) and k, v (1, 1024, 1, 16), for a non-causal
    call, on which rounding ds to k's type before ds . k matters (K8): key 0
    scores 0 and keys 1-1023 score 1.5 * -1 / 4; v is 49152 on key 0 and 0
    elsewhere in column 0, which do reads alone, so ds_0 = 17.5 and the 1023
    other ds are equal and negative, and the row of ds sums to 0 (a softmax
    gradient).  Column 1 of k is 1 on every key, so dq[..., 1] is that sum:
    -0.108 after the 1024 roundings to bf16, about -0.048 (what delta's own
    rounding leaves) without them, 16 times the bf16 bound apart."""
    q = torch.zeros(1, 64, 2, 16, device=device)
    q[..., 0] = 1.5
    k = torch.zeros(1, 1024, 1, 16, device=device)
    k[:, 1:, :, 0] = -1.0
    k[..., 1] = 1.0
    v = torch.zeros(1, 1024, 1, 16, device=device)
    v[:, 0, :, 0] = 49152.0
    do = torch.zeros(1, 64, 2, 16, device=device)
    do[..., 0] = 1.0
    return tuple(t.to(torch.bfloat16) for t in (q, k, v, do))


def dv_p_rounding_case(device="cpu"):
    """bf16 q, do (1, 1024, 2, 16) and k, v (1, 64, 1, 16), for a non-causal
    call, on which rounding p to do's type before pᵀ·do matters (K9's dv;
    JAX keeps p in fp32 there, flash_attention_bwd.py:196): key 0 scores
    9.25 / 4 against queries 1-1023, whose 63 other keys score 0, so their
    p on key 0 is exp(2.3125) / (exp(2.3125) + 63) = 0.13816, which bf16
    rounds down by 0.34%; query 0 scores 0 on every key (p = 1/64 exactly).
    do is 8 on queries 1-1023 and -72192 on query 0 in column 0, which
    nearly cancels their sum: dv[0, 0] is about 5.45, and a dv that rounds
    p once gives -2.20, 86 times the bf16 bound away.  v is 0, so o, delta, ds, dq
    and dk are 0."""
    q = torch.zeros(1, 1024, 2, 16, device=device)
    q[:, 1:, :, 0] = 9.25
    k = torch.zeros(1, 64, 1, 16, device=device)
    k[:, 0, :, 0] = 1.0
    v = torch.zeros(1, 64, 1, 16, device=device)
    do = torch.zeros(1, 1024, 2, 16, device=device)
    do[:, 1:, :, 0] = 8.0
    do[:, 0, :, 0] = -72192.0
    return tuple(t.to(torch.bfloat16) for t in (q, k, v, do))


def ds_flip_atol(q, k, v, do, lse, delta, causal=True):
    """(dq's, dk's) allowance for one flipped rounding of ds (kv_offset 0).

    K8 and K9 round each ds to bf16 (JAX's rule) from fp32 values whose
    last bits differ from the plain versions' (the tensor cores sum s and dp
    in another order), so where an fp32 ds lies at a rounding boundary the
    two round it apart, and the sum moves by up to a bf16 ulp (2^-7 of it)
    of that term, ds * k in dq and ds * q in dk, however small the sum.  At
    a GQA group of 8 a dk element sums 8 heads' terms, and at qwen3-moe's
    shape (4 x 2048, 32 heads on 4) one element in 4 M reads 1.5 times the
    bf16 bound for that reason (the float64 evaluation of the same formula
    puts the plain version at 0.31 of it and the kernel one flip of its
    largest term away, tests/_torch_flash_bwd_noise.py).  The allowance is
    2^-7 * max |ds| * max |k| (dq) and * max |q| (dk)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    scale = hd ** -0.5
    mask = torch.ones(S, k.shape[1], dtype=torch.bool, device=q.device)
    if causal:
        mask = mask.tril()
    ds_max = 0.0
    for b in range(B):
        for hq in range(H):
            h = hq // G
            s = q[b, :, hq].float() @ k[b, :, h].float().T * scale
            p = torch.where(mask, torch.exp(s - lse[b, hq][:, None]), 0.0)
            dp = do[b, :, hq].float() @ v[b, :, h].float().T
            ds = p * (dp - delta[b, hq][:, None]) * scale
            ds_max = max(ds_max, float(ds.abs().max()))
    ulp = 2.0 ** -7
    return (ulp * ds_max * float(k.float().abs().max()),
            ulp * ds_max * float(q.float().abs().max()))
