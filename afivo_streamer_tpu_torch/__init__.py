"""PyTorch/CUDA port of the streamer-discharge framework.

A drift-diffusion-reaction plasma fluid coupled to Poisson's equation on a
quadtree of fixed-size boxes, solved with FAS multigrid, written in
PyTorch for one NVIDIA Hopper card. Host-side NumPy builds the tree
topology and the index plans; the device holds the per-cell state and
runs the batched work on it. The multigrid smoother is five kernels
written by hand in CUDA C++ (ops/smoother.py; csrc/smoother.cu for 2D,
csrc/smoother_3d.cu for 3D).

This package ports two slices of ``afivo_streamer_tpu``: the 2D
(cylindrical or Cartesian) and the 3D (Cartesian) streamer on a mesh that
is refined uniformly at setup and then held fixed. Every state tensor is
float64 by default.
"""

import torch

__version__ = "0.1.0"

#: dtype of the simulation state
DEFAULT_DTYPE = torch.float64
