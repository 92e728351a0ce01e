"""Inputs shared by the flash-attention tests of the port (no JAX here)."""
import torch

# bf16 out per element: |out - plain| <= atol + rtol * |plain|.  Two bf16
# ulps (2**-7 relative each) plus 2e-3 for elements near 0, where tiles of
# other sizes round p against other running maxima.
BF16_ATOL, BF16_RTOL = 2e-3, 1.6e-2


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
