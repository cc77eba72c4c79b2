"""Per-level tables of a mesh: box ids, leaves, parents and the geometry
factors of the leaves (the analog of ``tree%lvls(lvl)``,
``m_af_types.f90:326-393``), plus the cached plans built from them.

The tables and plans are built on the host and copied to the device. They
follow a changing tree: each cached object names the levels it derives
from, and after a refinement epoch only the objects of levels whose boxes
changed are rebuilt (a level's fingerprint covers its boxes, their
neighbors, children and parents, and the parents' neighbors).
"""

from __future__ import annotations

import hashlib
import time
from typing import Dict, Iterable, Optional

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


def level_fingerprint(tree: Tree, lvl: int) -> bytes:
    """Digest of everything a level's tables and plans read from the tree:
    its boxes (ids, positions, neighbors, leaf status, parents) and its
    parents' neighbors (the coarse side of refinement boundaries)."""
    ids = np.asarray(tree.lvl_ids[lvl - 1], np.int64)
    par = tree.parent[ids]
    h = hashlib.blake2b(digest_size=16)
    for a in (ids, tree.ix[ids], tree.neighbors[ids],
              tree.children[ids, 0] >= 0, par,
              tree.neighbors[par] if lvl > 1 else par):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.digest()


class MeshPlans:
    """Lazily built, cached per-level tables and plans of a tree.

    An object cached under a key depends on a set of levels (all levels by
    default); it is rebuilt when the fingerprint of one of them changed
    since it was built. ``epoch`` follows the tree's topology version;
    ``build_seconds`` counts the host time spent building objects."""

    def __init__(self, tree: Tree, device):
        self.tree = tree
        self.device = torch.device(device)
        self.epoch = -1
        self._fp: Dict[int, bytes] = {}
        self._cache: Dict = {}
        self.build_seconds = 0.0
        self._depth = 0

    def _sync(self) -> None:
        """Refresh the level fingerprints after a topology change and drop
        the objects whose levels changed."""
        if self.tree.epoch == self.epoch:
            return
        self._fp = {l: level_fingerprint(self.tree, l)
                    for l in range(1, self.tree.highest_lvl + 1)}
        self.epoch = self.tree.epoch
        self._cache = {k: v for k, v in self._cache.items()
                       if v[0] == self.fingerprint(v[1])}

    def fingerprint(self, lvls: Iterable[int]) -> tuple:
        return tuple(self._fp.get(l) for l in lvls)

    def cached(self, key, make, lvls: Optional[Iterable[int]] = None):
        """The object under ``key``, built by ``make()`` if it is missing or
        one of ``lvls`` (default: all levels) changed."""
        self._sync()
        lvls = tuple(range(1, self.n_levels + 1) if lvls is None else lvls)
        fp = self.fingerprint(lvls)
        hit = self._cache.get(key)
        if hit is None or hit[0] != fp:
            t0 = time.perf_counter()
            self._depth += 1
            try:
                hit = (fp, lvls, make())
            finally:
                self._depth -= 1
            self._cache[key] = hit
            if self._depth == 0:  # nested builds are inside this one
                self.build_seconds += time.perf_counter() - t0
        return hit[2]

    @property
    def n_levels(self) -> int:
        return self.tree.highest_lvl

    def tb(self, lvl: int) -> LevelTables:
        return self.cached(("tb", lvl),
                           lambda: LevelTables(self.tree, lvl, self.device),
                           (lvl,))

    def gc(self, lvl: int) -> GcLevelPlan:
        return self.cached(("gc", lvl),
                           lambda: GcLevelPlan(self.tree, lvl, self.device),
                           (lvl,))

    def pr(self, lvl: int):
        """Restriction plan of the children at ``lvl`` (None at level 1)."""
        if lvl == 1:
            return None
        return self.cached(("pr", lvl), lambda: ProlongRestrictPlan(
            self.tree, self.tree.lvl_ids[lvl - 1], self.device), (lvl,))

    def pr_all(self):
        return [self.pr(l) for l in range(1, self.n_levels + 1)]

    def all_ids(self) -> torch.Tensor:
        """Ids of every box, level by level."""
        return self.cached("all_ids", lambda: torch.as_tensor(
            np.concatenate([self.tb(l).ids
                            for l in range(1, self.n_levels + 1)]),
            dtype=torch.int64, device=self.device))
