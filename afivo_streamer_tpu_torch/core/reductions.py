"""Tree-wide reductions over leaf boxes (volume-weighted sums, maxima).

Re-implements the reference's ``afivo/src/m_af_utils.f90`` reductions
(af_tree_sum_cc ``:966-1026`` incl. the cylindrical 2*pi*r weighting,
af_tree_max_cc with location). Each reduction is one batched op per level
on the device; only the final scalar comes back to the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .levels import MeshPlans
from .rowops import cc_get_interior


def tree_sum_cc(cc, mesh: MeshPlans, iv: int, power: int = 1) -> float:
    """Volume-integrated sum of cc(iv)**power over the leaves."""
    tree = mesh.tree
    nc, ndim = tree.nc, tree.ndim
    total = 0.0
    for lvl in range(1, tree.highest_lvl + 1):
        tb = mesh.tb(lvl)
        if len(tb.leaves) == 0:
            continue
        vals = cc_get_interior(cc, iv, tb.d.leaves, nc, ndim)
        if power != 1:
            vals = vals ** power
        if tree.coord == "cyl":
            w = tb.d.two_pi_r.to(vals.dtype)
            total += float(np.prod(tree.lvl_dr(lvl))) * float(
                (vals * w).sum())
        else:
            total += float(np.prod(tree.lvl_dr(lvl))) * float(vals.sum())
    return total


def tree_max_cc(cc, mesh: MeshPlans, iv: int) -> Tuple[float, np.ndarray]:
    """Maximum of cc(iv) over leaf interiors and its cell coordinates
    (af_tree_max_cc with af_reduction_loc)."""
    tree = mesh.tree
    nc, ndim = tree.nc, tree.ndim
    best = -np.inf
    best_r = np.zeros(ndim)
    for lvl in range(1, tree.highest_lvl + 1):
        tb = mesh.tb(lvl)
        if len(tb.leaves) == 0:
            continue
        vals = cc_get_interior(cc, iv, tb.d.leaves, nc, ndim)
        k = int(vals.argmax())
        m = float(vals.reshape(-1)[k])
        if m > best:
            best = m
            b_i, c_i = divmod(k, nc ** ndim)
            cell = np.unravel_index(c_i, (nc,) * ndim)
            r0 = tree.box_r_min(np.asarray([int(tb.leaves[b_i])]))[0]
            best_r = r0 + (np.asarray(cell) + 0.5) * tree.lvl_dr(lvl)
    return best, best_r


def tree_maxabs_cc(cc, mesh: MeshPlans, iv: int) -> float:
    """max |cc(iv)| over leaf interiors (af_tree_maxabs_cc loops leaves)."""
    tree = mesh.tree
    best = 0.0
    for lvl in range(1, tree.highest_lvl + 1):
        tb = mesh.tb(lvl)
        if len(tb.leaves) == 0:
            continue
        vals = cc_get_interior(cc, iv, tb.d.leaves, tree.nc, tree.ndim)
        best = max(best, float(vals.abs().max()))
    return best


def n_leaf_cells(tree) -> int:
    return sum(len(l) for l in tree.lvl_leaves) * tree.nc ** tree.ndim
