"""base_tpu_torch: the PyTorch/CUDA port of base_tpu for NVIDIA Hopper.

Mirrors base_tpu's layout (ops, grids, model, sim, inference, utils).  Plain
tensor code is PyTorch; the four Pallas kernels of the single-population
density are hand-written CUDA C++ under csrc/, built with nvcc for sm_90a at
the first CUDA call (ops.build).  The package imports torch and nothing of
jax or base_tpu: it keeps its own copies of what it needs from base_tpu's
JAX-free modules (`constants`, `grids.filters`).
"""

__version__ = "0.1.0"
