"""PyTorch/CUDA port of the streamer-discharge framework.

A drift-diffusion-reaction plasma fluid coupled to Poisson's equation on a
binary tree, quadtree or octree of fixed-size boxes, solved with FAS
multigrid, written in PyTorch for one NVIDIA Hopper card. Host-side NumPy
builds the tree topology and the index plans; the device holds the
per-cell state and runs the batched work on it. The multigrid smoother is
six kernels written by hand in CUDA C++ (ops/smoother.py; csrc/smoother.cu
for 2D, csrc/smoother_3d.cu for 3D); in one dimension it is tensor
operations.

This package ports these paths of ``afivo_streamer_tpu``: the planar 1D,
the 2D (cylindrical or Cartesian) and the 3D (Cartesian) streamer with
live refinement and Helmholtz photoionization, dielectrics, electrodes,
gas dynamics, the fluid model's variants (the electron energy equation,
the source factor and the plasma region), every user hook with the
programs in programs/, the analysis routines, and the writers that are on
by default: the regression and text logs, the grid files and the
chemistry files. The state is float64, or float32 under
``-compiled%enabled=T -compiled%dtype=float32`` (parallel/compiled.py).
"""

__version__ = "0.1.0"
