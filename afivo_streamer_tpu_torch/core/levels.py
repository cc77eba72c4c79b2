"""Per-level tables of a mesh: box ids, leaves, parents and the geometry
factors of the leaves (the analog of ``tree%lvls(lvl)``,
``m_af_types.f90:326-393``), plus the cached plans built from them.

The tables and plans are built on the host and copied to the device. They
follow a changing tree: each cached object names the levels it derives
from, and after a refinement epoch only the objects of levels whose boxes
changed are rebuilt (a level's fingerprint covers its boxes, their
neighbors, children and parents, and the parents' neighbors).

In a sharded run (parallel/halo.py) a rank's MeshPlans is built over its
``LocalTree``: the tables cover the rank's own boxes and address its local
rows, a level's fingerprint also covers the partition, the restriction
plans cover the children of the rank's own parents, and the ghost-cell,
restriction and prolongation plans exchange the halo rows they read
(``halo``). The numerical code reaches the exchanges and collectives
through this class alone (``halo``, ``halo_blocks``, ``reduce``,
``extremum``, ``map_boxes``, ``whole_level``), each the identity or the
plain answer when unsharded. ``full`` is the MeshPlans of the whole tree
(the level-1 solve, the writers on rank 0, where a reduction's leaf
lies); an unsharded MeshPlans is its own ``full``.
"""

from __future__ import annotations

import hashlib
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..trace import Tracer
from . import spatial as sp
from .ghostcell import GcLevelPlan
from .prolong_restrict import ProlongRestrictPlan
from .tree import Tree


class LevelTables:
    """Ids, leaves and parents of one level with their positions in the
    level's id list; cell volumes and cylindrical radial flux factors of
    the leaves (af_cyl_volume_cc / af_cyl_flux_factors)."""

    def __init__(self, tree: Tree, lvl: int, device, dtype=torch.float64):
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
        self.d = sp.device_copy(self, device, dtype)


def level_fingerprint(tree: Tree, lvl: int) -> bytes:
    """Digest of everything a level's tables and plans read from the tree:
    its boxes (ids, positions, neighbors, leaf status, parents) and its
    parents' neighbors (the coarse side of refinement boundaries)."""
    ids = np.asarray(tree.lvl_ids[lvl - 1], np.int64)
    par = tree.parent[ids]
    h = hashlib.blake2b(digest_size=16)
    if tree.layout is not None:
        # a sharded run's rows: every local row and its box
        h.update(np.ascontiguousarray(tree.layout.glob).tobytes())
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
    ``build_seconds`` counts the host time spent building objects, each
    outermost build also a span ``plans.build`` of ``tracer`` (the
    simulation's, which the objects built on this MeshPlans time their
    work with; a tracer of its own by default)."""

    def __init__(self, tree: Tree, device, full: "MeshPlans" = None,
                 dtype=torch.float64, tracer: Optional[Tracer] = None):
        self.tree = tree
        self.tracer = Tracer() if tracer is None else tracer
        self.device = torch.device(device)
        #: dtype of the state and of the plans' float tables
        self.dtype = dtype
        #: the MeshPlans of the whole tree (self when unsharded)
        self.full = self if full is None else full
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

    def set_dtype(self, dtype) -> None:
        """Build the float tables in ``dtype`` from now on: every cached
        object is dropped, and the next use rebuilds it."""
        if dtype != self.dtype:
            self.dtype = dtype
            self._cache = {}

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
            if self._depth:  # nested builds are inside the outermost one
                hit = self._build(fp, lvls, make)
            else:
                t0 = time.perf_counter()
                with self.tracer.span("plans.build"):
                    hit = self._build(fp, lvls, make)
                self.build_seconds += time.perf_counter() - t0
            self._cache[key] = hit
        return hit[2]

    def _build(self, fp, lvls, make):
        self._depth += 1
        try:
            return (fp, lvls, make())
        finally:
            self._depth -= 1

    @property
    def n_levels(self) -> int:
        return self.tree.highest_lvl

    # ------------------------------------------------ the sharded run
    # Each of these is the identity, or the plain answer, when unsharded.
    @property
    def layout(self):
        """The partition of a sharded run (parallel/halo.Layout), None
        when unsharded."""
        return self.tree.layout

    @property
    def n_own(self) -> int:
        """State rows of the rank's own boxes, which come first (every row
        when unsharded)."""
        return (self.tree.highest_id if self.layout is None
                else self.layout.n_own)

    def parents_held(self, lvl: int):
        """The parents of level ``lvl`` among the state's rows (a sharded
        run's own and halo rows)."""
        return (self.tree.lvl_parents[lvl - 1] if self.layout is None
                else self.layout.lvl_parents_held[lvl - 1])

    def level_rows(self, lvl: int) -> np.ndarray:
        """The state rows of a level's multigrid arrays: the level's boxes,
        or the rank's own boxes of the level then its halo."""
        return (np.asarray(self.tb(lvl).ids, np.int64) if self.layout is None
                else self.layout.lvl_rows[lvl - 1])

    def halo(self, x, levels, ivs=None, fc: bool = False):
        """Refresh the halo rows of ``levels`` of ``x`` (cc, or fc with
        ``fc``) from their owners (parallel/halo.Layout.exchange)."""
        if self.layout is not None:
            self.layout.exchange(x, levels, ivs, fc)
        return x

    def halo_blocks(self, X, lvl: int):
        """A level's multigrid array (rows ``level_rows``) with its halo
        rows from their owners."""
        return X if self.layout is None else self.layout.exchange_blocks(
            X, lvl)

    def reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``t`` reduced over the ranks (op "max", "min" or "sum"). A max
        or a min is exact in any order; a sum adds the ranks' partial
        sums."""
        return t if self.layout is None else self.layout.shards.all_reduce(
            t, op)

    def extremum(self, found, largest: bool):
        """The rank's best leaf ``[value, level, row among the level's
        leaves, index]`` (or []) reduced over the ranks, with the row as
        the position in the tree's leaf list; None without one."""
        if self.layout is None:
            return found or None
        return self.layout.extremum(found, largest)

    def map_boxes(self, ids, fn) -> np.ndarray:
        """``fn(rows, sel)`` -> NumPy values per box on the tree's boxes
        ``ids`` (their state rows and a selector of them in ``ids``); in a
        sharded run on the rank's own boxes among them, gathered on every
        rank in the order of ``ids``."""
        if self.layout is None:
            return fn(np.asarray(ids, np.int64), slice(None))
        return self.layout.map_boxes(ids, fn)

    def whole_level(self, lvl: int, fn, *arrays):
        """``fn(*arrays)`` on a level's multigrid arrays; in a sharded run
        on the whole level gathered on every rank, of whose result the
        rank keeps its rows."""
        if self.layout is None:
            return fn(*arrays)
        return self.layout.whole_level(lvl, fn, *arrays)

    def _hooked(self, plan):
        plan.halo = self.halo if self.layout is not None else None
        return plan

    def tb(self, lvl: int) -> LevelTables:
        return self.cached(("tb", lvl),
                           lambda: LevelTables(self.tree, lvl, self.device,
                                                     self.dtype),
                           (lvl,))

    def gc(self, lvl: int) -> GcLevelPlan:
        return self.cached(("gc", lvl), lambda: self._hooked(
            GcLevelPlan(self.tree, lvl, self.device, self.dtype)), (lvl,))

    def pr(self, lvl: int):
        """Restriction plan of the children at ``lvl`` (None at level 1);
        sharded: the children of the rank's own parents."""
        if lvl == 1:
            return None
        if self.layout is None:
            children = self.tree.lvl_ids[lvl - 1]
        else:
            children = self.tree.children[
                np.asarray(self.tree.lvl_parents[lvl - 2], np.int64)].ravel()
        return self.cached(("pr", lvl), lambda: self._hooked(
            ProlongRestrictPlan(self.tree, children, self.device, lvl,
                                self.dtype)),
            (lvl,))

    def prolong_plan(self, lvl: int, ids) -> ProlongRestrictPlan:
        """Prolongation plan into the boxes ``ids`` at ``lvl`` (box ids
        of the tree; sharded: the rank's own among them, in local
        rows)."""
        ids = np.asarray(ids, np.int64)
        if self.layout is not None:
            ids = self.layout.own_rows(ids)[1]
        return self._hooked(ProlongRestrictPlan(self.tree, ids, self.device,
                                                lvl, self.dtype))

    def prolong_into(self, lvl: int) -> ProlongRestrictPlan:
        """Prolongation plan into every box of level ``lvl`` (``pr(lvl)``
        when unsharded; sharded: into the rank's own boxes of the level,
        whose parents the plan reads through the halo, where ``pr`` holds
        the children of the rank's own parents)."""
        if self.layout is None:
            return self.pr(lvl)
        return self.cached(("prolong_into", lvl), lambda: self.prolong_plan(
            lvl, self.tree.global_tree.lvl_ids[lvl - 1]), (lvl - 1, lvl))

    def pr_all(self):
        return [self.pr(l) for l in range(1, self.n_levels + 1)]

    def all_ids(self) -> torch.Tensor:
        """Ids of every box, level by level."""
        return self.cached("all_ids", lambda: torch.as_tensor(
            np.concatenate([self.tb(l).ids
                            for l in range(1, self.n_levels + 1)]),
            dtype=torch.int64, device=self.device))
