"""Per-level tables of a fixed mesh: box ids, leaves, parents and the
geometry factors of the leaves (the analog of ``tree%lvls(lvl)``,
``m_af_types.f90:326-393``), plus the cached plans built from them.

The mesh of the slice does not change after setup, so every table and
plan is built once on the host and copied to the device once.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import spatial as sp
from .ghostcell import GcLevelPlan
from .prolong_restrict import ProlongRestrictPlan
from .tree import Tree


class LevelTables:
    """Ids, leaves and parents of one level with their positions in the
    level's id list; cell volumes and cylindrical radial flux factors of
    the leaves (af_cyl_volume_cc / af_cyl_flux_factors)."""

    def __init__(self, tree: Tree, lvl: int, device):
        ndim, nc = tree.ndim, tree.nc
        self.lvl = lvl
        self.ids = np.asarray(tree.lvl_ids[lvl - 1], np.int32)
        self.leaves = np.asarray(tree.lvl_leaves[lvl - 1], np.int32)
        self.parents = np.asarray(tree.lvl_parents[lvl - 1], np.int32)
        pos = {int(b): i for i, b in enumerate(self.ids)}
        self.leaves_pos = np.array([pos[int(b)] for b in self.leaves],
                                   np.int32)
        self.parents_pos = np.array([pos[int(b)] for b in self.parents],
                                    np.int32)
        dr = tree.lvl_dr(lvl)
        n = len(self.leaves)
        if tree.coord == "cyl":
            r0 = tree.box_r_min(self.leaves)[:, 0]
            i = np.arange(1, nc + 1)
            r_cc = r0[:, None] + (i[None, :] - 0.5) * dr[0]  # [n, nc]
            vol = 2.0 * np.pi * r_cc * np.prod(dr)
            self.vol = np.repeat(vol[:, :, None], nc ** (ndim - 1),
                                 axis=2).reshape(n, nc ** ndim)
            # 2 pi r per cell: the weight of the tree sums
            self.two_pi_r = np.repeat(2.0 * np.pi * r_cc[:, :, None],
                                      nc ** (ndim - 1),
                                      axis=2).reshape(n, nc ** ndim)
            self.rfac_lo = (r_cc - 0.5 * dr[0]) / r_cc
            self.rfac_hi = (r_cc + 0.5 * dr[0]) / r_cc
        else:
            self.vol = np.full((n, nc ** ndim), float(np.prod(dr)))
            self.rfac_lo = None
            self.rfac_hi = None
        self.d = sp.device_copy(self, device)


class MeshPlans:
    """Lazily built, cached per-level tables and plans of a fixed mesh.

    Refuses to serve a tree whose topology changed after construction
    (live refinement is not part of this package)."""

    def __init__(self, tree: Tree, device):
        self.tree = tree
        self.device = torch.device(device)
        self.epoch = tree.epoch
        self._cache: Dict = {}

    def check_fixed(self) -> None:
        """Raise if the tree changed after these plans were built."""
        if self.tree.epoch != self.epoch:
            raise NotImplementedError(
                "physics/refine.py: the mesh changed after setup (live "
                "refinement)")

    def _get(self, key, make):
        self.check_fixed()
        if key not in self._cache:
            self._cache[key] = make()
        return self._cache[key]

    @property
    def n_levels(self) -> int:
        return self.tree.highest_lvl

    def tb(self, lvl: int) -> LevelTables:
        return self._get(("tb", lvl),
                         lambda: LevelTables(self.tree, lvl, self.device))

    def gc(self, lvl: int) -> GcLevelPlan:
        return self._get(("gc", lvl),
                         lambda: GcLevelPlan(self.tree, lvl, self.device))

    def pr(self, lvl: int):
        """Restriction plan of the children at ``lvl`` (None at level 1)."""
        if lvl == 1:
            return None
        return self._get(("pr", lvl), lambda: ProlongRestrictPlan(
            self.tree, self.tree.lvl_ids[lvl - 1], self.device))

    def pr_all(self):
        return [self.pr(l) for l in range(1, self.n_levels + 1)]

    def all_ids(self) -> torch.Tensor:
        """Ids of every box, level by level."""
        return self._get("all_ids", lambda: torch.as_tensor(
            np.concatenate([self.tb(l).ids
                            for l in range(1, self.n_levels + 1)]),
            dtype=torch.int64, device=self.device))

    def cached(self, key, make):
        """Cache any other mesh-derived object under ``key``."""
        return self._get(key, make)
