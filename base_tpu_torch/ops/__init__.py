"""Tensor primitives and the hand-written CUDA kernels of the density.

float32 at full precision on the card: TF32 rounding of the interpolated
magnitudes (about three decimal digits) is comparable to the photometric
sigmas and once froze the HMC chains (base_tpu/ops/interp.py
interp1d_dense), so both TF32 switches are turned off here, before any op
of the port runs.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
