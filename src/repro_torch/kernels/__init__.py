"""Hand-written CUDA kernels for the stencil hot path (Hopper, sm_90a).

Layout per kernel: ``<name>.py`` holds the wrapper and its plain PyTorch
version, ``csrc/<name>.cu`` the kernel, ``ops.py`` the iteration loop,
``ref.py`` the naive oracles and ``_build.py`` the nvcc build and ctypes
binding.  A wrapper runs its plain version on a CPU tensor and launches the
kernel on a CUDA tensor; ``_build.LAUNCHES`` counts the launches.
"""
from repro_torch.kernels.jacobi_fused import (jacobi2d_fused_plain,
                                              jacobi2d_fused_step)
from repro_torch.kernels.ops import jacobi2d
from repro_torch.kernels.stencil2d import stencil2d, stencil2d_plain

__all__ = [
    "jacobi2d",
    "jacobi2d_fused_plain",
    "jacobi2d_fused_step",
    "stencil2d",
    "stencil2d_plain",
]
