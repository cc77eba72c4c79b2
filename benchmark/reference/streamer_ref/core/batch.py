"""Device-side SoA storage for the box batch.

The analog of the reference's per-box allocatable arrays
(``afivo/src/m_af_types.f90:286-322``): all cell-centered data lives in one
tensor ``cc[n_var, cap, (nc+2)^ndim]`` (one ghost layer included, spatial
dims flattened) and face-centered data in
``fc[n_fc, ndim, cap, (nc+1)^ndim]``. Box ids are stable across refinement
epochs, so rows persist.
"""

from __future__ import annotations

import torch

from .tree import Tree


def capacity(n_level1: int) -> int:
    """Initial box rows of the state: a multiple of 64 for the level-1
    boxes (the simulation grows it with the mesh)."""
    return max(64, ((n_level1 + 63) // 64) * 64)


class BoxBatch:
    def __init__(self, tree: Tree, n_var: int, n_fc: int, cap: int,
                 dtype: torch.dtype, device: torch.device):
        self.S = (tree.nc + 2) ** tree.ndim
        self.Sf = (tree.nc + 1) ** tree.ndim
        self.cc = torch.zeros((n_var, cap, self.S), dtype=dtype, device=device)
        self.fc = torch.zeros((n_fc, tree.ndim, cap, self.Sf), dtype=dtype,
                              device=device)
