"""Tree-wide reductions over leaf boxes (volume-weighted sums, maxima).

Re-implements the reference's ``afivo/src/m_af_utils.f90`` reductions
(af_tree_sum_cc ``:966-1026`` incl. the cylindrical 2*pi*r weighting,
af_tree_max_cc, af_tree_min_cc, af_tree_max_fc and af_tree_min_fc with
location). Each reduction is one batched op per level on the device; only
the final scalar (and where it is) comes back to the host.

In a sharded run (parallel/halo.py) every rank reduces its own leaves and
the ranks' results are combined: the per-level sums are added up over the
ranks before the level sum (so a sum differs from the unsharded one by
rounding), an extremum is exact, and its location breaks ties as the
unsharded scan does, by (level, position in the tree's leaf list, cell).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

import torch

from ..trace import to_list, to_numpy
from .levels import MeshPlans
from .rowops import cc_get_interior, fc_get_faces


def tree_sum_cc(cc, mesh: MeshPlans, iv: int, power: int = 1) -> float:
    """Volume-integrated sum of cc(iv)**power over the leaves: one sum per
    level on the device, added up on the host in level order."""
    tree = mesh.tree
    nc, ndim = tree.nc, tree.ndim
    sums = []
    for lvl in range(1, tree.highest_lvl + 1):
        tb = mesh.tb(lvl)
        if len(tb.leaves) == 0:  # every rank of a sharded run sums it
            sums.append(cc.new_zeros(()))
            continue
        vals = cc_get_interior(cc, iv, tb.d.leaves, nc, ndim)
        if power != 1:
            vals = vals ** power
        if tree.coord == "cyl":
            vals = vals * tb.d.two_pi_r.to(vals.dtype)
        sums.append(vals.sum())
    total = 0.0
    per_lvl = mesh.tracer.host_read(mesh.reduce(torch.stack(sums), "sum"),
                                    "tree_sum_cc", to_list)
    for lvl, s in enumerate(per_lvl, start=1):
        total += float(np.prod(tree.lvl_dr(lvl))) * s
    return total


def leaf_extremum(mesh: MeshPlans, values, largest: bool = True,
                  site: str = "leaf_extremum"):
    """The largest (or smallest) of ``values(lvl, tb)`` -> [n, m] over the
    levels with leaves, and where it is: (value, level, row, flat index in
    the row), or None without leaves. Each level reduces on the device and
    one small tensor comes to the host. Ties go to the first level, then
    the first row and index, as a scan of the levels with np.argmax (or
    np.argmin) finds them. In a sharded run the row is the leaf's position
    in the tree's leaf list of its level (``leaf_box``). The reads to the
    host are the tracer's ``sync.extremum_index`` (one per level) and
    ``sync.<site>``."""
    lvls, best, where = [], [], []
    for lvl in range(1, mesh.tree.highest_lvl + 1):
        tb = mesh.tb(lvl)
        if len(tb.leaves) == 0:
            continue
        vals = values(lvl, tb)
        if vals is None or vals.numel() == 0:
            continue
        flat = vals.reshape(-1)
        k = flat.argmax() if largest else flat.argmin()
        lvls.append((lvl, vals.shape[1]))
        # a 0-d tensor as an index is read by the host (sync.extremum_index)
        best.append(flat[mesh.tracer.host_read(k, "extremum_index", int)]
                    .to(torch.float64))
        where.append(k.to(torch.float64))
    found = []
    if lvls:
        host = mesh.tracer.host_read(torch.stack(best + where), site,
                                     to_numpy)
        vals = host[:len(lvls)]
        j = int(np.argmax(vals) if largest else np.argmin(vals))
        lvl, m = lvls[j]
        row, k = divmod(int(host[len(lvls) + j]), m)
        found = [float(vals[j]), lvl, row, k]
    found = mesh.extremum(found, largest)
    return None if not found else tuple(found)


def leaf_box(mesh: MeshPlans, lvl: int, row: int) -> int:
    """The box id (in the whole tree) of the leaf at ``row`` of a level's
    leaves as leaf_extremum reports it."""
    return int(mesh.full.tree.lvl_leaves[lvl - 1][row])


def tree_max_cc(cc, mesh: MeshPlans, iv: int) -> Tuple[float, np.ndarray]:
    """Maximum of cc(iv) over leaf interiors and its cell coordinates
    (af_tree_max_cc with af_reduction_loc)."""
    tree = mesh.tree
    nc, ndim = tree.nc, tree.ndim
    found = leaf_extremum(mesh, lambda lvl, tb: cc_get_interior(
        cc, iv, tb.d.leaves, nc, ndim))
    if found is None:
        return -np.inf, np.zeros(ndim)
    best, lvl, row, k = found
    cell = np.unravel_index(k, (nc,) * ndim)
    r0 = mesh.full.tree.box_r_min(np.asarray([leaf_box(mesh, lvl, row)]))[0]
    return best, r0 + (np.asarray(cell) + 0.5) * tree.lvl_dr(lvl)


def tree_min_cc(cc, mesh: MeshPlans, iv: int) -> float:
    """Minimum of cc(iv) over leaf interiors (af_tree_min_cc)."""
    tree = mesh.tree
    found = leaf_extremum(mesh, lambda lvl, tb: cc_get_interior(
        cc, iv, tb.d.leaves, tree.nc, tree.ndim), largest=False)
    return np.inf if found is None else found[0]


def tree_max_fc(fc, mesh: MeshPlans, dim: int, iv: int
                ) -> Tuple[float, np.ndarray]:
    """Maximum of a face-centered variable along one dimension over the
    leaves, with the face coordinates (af_tree_max_fc)."""
    tree = mesh.tree
    nc, ndim = tree.nc, tree.ndim
    found = leaf_extremum(mesh, lambda lvl, tb: fc_get_faces(
        fc, iv, dim, tb.d.leaves, nc, ndim).reshape(len(tb.leaves), -1))
    if found is None:
        return -np.inf, np.zeros(ndim)
    best, lvl, row, k = found
    fshape = tuple(nc + 1 if j == dim else nc for j in range(ndim))
    face = np.asarray(np.unravel_index(k, fshape), np.float64)
    off = np.full(ndim, 0.5)
    off[dim] = 0.0
    r0 = mesh.full.tree.box_r_min(np.asarray([leaf_box(mesh, lvl, row)]))[0]
    return best, r0 + (face + off) * tree.lvl_dr(lvl)


def tree_min_fc(fc, mesh: MeshPlans, dim: int, iv: int) -> float:
    """Minimum of a face-centered variable along one dimension
    (af_tree_min_fc)."""
    tree = mesh.tree
    found = leaf_extremum(mesh, lambda lvl, tb: fc_get_faces(
        fc, iv, dim, tb.d.leaves, tree.nc, tree.ndim).reshape(
            len(tb.leaves), -1), largest=False)
    return np.inf if found is None else found[0]


def tree_maxabs_cc(cc, mesh: MeshPlans, iv: int) -> float:
    """max |cc(iv)| over leaf interiors (af_tree_maxabs_cc loops leaves)."""
    tree = mesh.tree
    found = leaf_extremum(mesh, lambda lvl, tb: cc_get_interior(
        cc, iv, tb.d.leaves, tree.nc, tree.ndim).abs(), site="tree_maxabs_cc")
    return 0.0 if found is None else found[0]


def n_leaf_cells(tree) -> int:
    """Leaf cells of the tree (of the rank's own leaves for a LocalTree)."""
    return sum(len(l) for l in tree.lvl_leaves) * tree.nc ** tree.ndim
