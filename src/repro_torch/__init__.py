"""PyTorch/CUDA port of the stencil DSL and of the LM substrate's serving
path (``src/repro`` is the JAX/Pallas reference).  It imports ``torch`` and
numpy only; the kernels on its paths are CUDA C++ for Hopper (``csrc/``),
built with nvcc at first launch."""
