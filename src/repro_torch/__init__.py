"""PyTorch/CUDA port of the stencil DSL (``src/repro`` is the JAX/Pallas
reference).  It imports ``torch`` and numpy only; the kernels on its path
are CUDA C++ for Hopper (``csrc/``), built with nvcc at first launch."""
