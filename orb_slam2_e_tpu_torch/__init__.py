"""ORB-SLAM2-E on PyTorch and CUDA: the synchronous main path of the
monocular, stereo and RGB-D sensors, with loop closing, localization-only
mode, rigid and FEM-regularized non-rigid relocalization, and map save/load.

A second package beside `orb_slam2_e_tpu` (the JAX reference) with the same
`ops/`, `models/`, `utils/` layout and the same function names wherever a
counterpart exists. It imports torch and numpy only.

The one hand-written kernel, the fused FAST score + 3x3 NMS +
7x7 Gaussian blur (`ops/kernels.py`, source `csrc/fast_nms_blur.cu`), is
CUDA C++ for sm_90a, built at first use. The deformable mode's host geometry
(`ops/geometry.py`, source `csrc/geometry.cpp`) is C++ built by g++ at first
use. Everything else is torch ops.

Tensors never pick a device on their own: `SlamSystem` and every state
constructor take an explicit `device`.
"""

import torch as _torch

# Geometry and BA need true float32 matmuls, as the reference pins
# `jax_default_matmul_precision = "highest"` (orb_slam2_e_tpu/__init__.py).
# TF32 would keep ~3 decimal digits in rotation products and Schur sums.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
