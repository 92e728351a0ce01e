"""Print a digest of the bf16 flash kernels' outputs (K7 out and lse, K8 dq,
K9 dk and dv) on the cases of tests/_torch_flash_cases.py, from inputs made
from a seed, as one JSON object {case: sha256}.  Run it from two checkouts
on one card to show that a change leaves the kernels bit-equal:

    PYTHONPATH=<checkout>/src python3 <checkout>/tests/_torch_kernel_digest.py
"""
import hashlib
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_flash_cases import FLASH_CASES  # noqa: E402

from repro_torch.kernels import flash_bwd, flash_fwd  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(18)
    out = {}
    for label, (shape, causal, kv_offset) in FLASH_CASES.items():
        B, Sq, Skv, H, KV, hd = shape
        q, k, v, do = (torch.randn(s, generator=g, device=dev)
                       .to(torch.bfloat16)
                       for s in ((B, Sq, H, hd), (B, Skv, KV, hd),
                                 (B, Skv, KV, hd), (B, Sq, H, hd)))
        kw = dict(causal=causal, kv_offset=kv_offset)
        o, lse = flash_fwd(q, k, v, **kw)
        grads = flash_bwd(q, k, v, o, lse, do, **kw)
        h = hashlib.sha256()
        for t in (o, lse, *grads):
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        out[label] = h.hexdigest()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
