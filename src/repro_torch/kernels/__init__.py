"""Hand-written CUDA kernels (Hopper, sm_90a): the stencil hot path (K1-K5)
and the LM substrate's attention forward (K6/K7) and backward (K8/K9).

Layout per kernel: ``<name>.py`` holds the wrapper and its plain PyTorch
version, ``csrc/<name>.cu`` the kernel, ``ops.py`` the iteration loop,
``ref.py`` the naive oracles and ``_build.py`` the nvcc build and ctypes
binding.  A wrapper runs its plain version on a CPU tensor and launches the
kernel on a CUDA tensor; ``_build.LAUNCHES`` counts the launches.
"""
from repro_torch.kernels.dense_stencil import (dense_stencil_matmul,
                                               dense_stencil_plain,
                                               dense_stencil_split_plain,
                                               split_bf16x3)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_attention_bwd import (
    flash_attention_trainable, flash_bwd, flash_bwd_plain, flash_fwd,
    flash_fwd_plain)
from repro_torch.kernels.jacobi_fused import (jacobi2d_fused_plain,
                                              jacobi2d_fused_step)
from repro_torch.kernels.ops import dense_jacobi_kernel, jacobi2d, jacobi3d
from repro_torch.kernels.stencil2d import stencil2d, stencil2d_plain
from repro_torch.kernels.stencil3d import stencil3d, stencil3d_plain

__all__ = [
    "dense_jacobi_kernel",
    "dense_stencil_matmul",
    "dense_stencil_plain",
    "dense_stencil_split_plain",
    "flash_attention",
    "flash_attention_plain",
    "flash_attention_trainable",
    "flash_bwd",
    "flash_bwd_plain",
    "flash_fwd",
    "flash_fwd_plain",
    "jacobi2d",
    "jacobi2d_fused_plain",
    "jacobi2d_fused_step",
    "jacobi3d",
    "split_bf16x3",
    "stencil2d",
    "stencil2d_plain",
    "stencil3d",
    "stencil3d_plain",
]
