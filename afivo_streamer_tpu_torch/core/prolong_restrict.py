"""Restriction and the prolongation tables between parent/child boxes.

Re-designs the reference's ``afivo/src/m_af_restrict.f90`` and the linear
prolongation stencil of ``m_af_prolong.f90`` (af_prolong_linear
``:531-679``): (parent, child) pairs are grouped by the child's parity (its
position inside the parent), so each group is one batched gather +
arithmetic + scatter with static spatial index tables.

Restriction is 2^ndim-cell averaging, optionally cylindrical-volume-weighted
(af_restrict_box, ``m_af_restrict.f90:62-136``).
"""

from __future__ import annotations

import itertools
from typing import Dict, Tuple

import numpy as np

from . import spatial as sp
from .tree import Tree


class ParityTables:
    """Static index tables for one child parity."""

    def __init__(self, ndim: int, nc: int, parity: Tuple[int, ...], device):
        self.parity = tuple(parity)
        hnc = nc // 2
        i = np.arange(1, nc + 1)  # fine interior (1-based)
        mesh = np.meshgrid(*([i] * ndim), indexing="ij")
        fine_nd = np.stack([m.ravel() for m in mesh], axis=-1)  # [C, ndim]
        c1_nd = np.stack(
            [parity[d] * hnc + (fine_nd[:, d] + 1) // 2 for d in range(ndim)],
            axis=-1)
        sign_nd = np.stack([np.where(fine_nd[:, d] % 2 == 1, -1, 1)
                            for d in range(ndim)], axis=-1)
        # all corner combinations for linear (248) prolongation
        self.corners = []  # list of (weight, sidx) over subsets of dims
        for subset in itertools.product([0, 1], repeat=ndim):
            v = c1_nd.copy()
            w = 1.0
            for d in range(ndim):
                if subset[d]:
                    v[:, d] += sign_nd[:, d]
                    w *= 0.25
                else:
                    w *= 0.75
            self.corners.append((w, sp.cc_flat_nd(ndim, nc, v)))
        # restriction: parent target cells and child sources
        ic = np.arange(1, hnc + 1)
        meshc = np.meshgrid(*([ic] * ndim), indexing="ij")
        coarse_nd = np.stack([m.ravel() for m in meshc], axis=-1)  # [Cc, ndim]
        self.restrict_tgt = sp.cc_flat_nd(ndim, nc,
                                          coarse_nd + np.asarray(parity) * hnc)
        self.restrict_src = []
        for bits in itertools.product([0, 1], repeat=ndim):
            src = 2 * coarse_nd - 1 + np.asarray(bits)
            self.restrict_src.append(sp.cc_flat_nd(ndim, nc, src))
        self.coarse_nd = coarse_nd  # local 1..hnc (before parity shift)
        self.d = sp.device_copy(self, device)
        self.d.corners = [(w, sp.device_copy({"s": s}, device).s)
                          for w, s in self.corners]


_tables_cache: Dict = {}


def parity_tables(ndim: int, nc: int, parity, device) -> ParityTables:
    key = (ndim, nc, tuple(parity), str(device))
    if key not in _tables_cache:
        _tables_cache[key] = ParityTables(ndim, nc, tuple(parity), device)
    return _tables_cache[key]


class ProlongRestrictPlan:
    """Pairs (parent, child) grouped by parity, for all children of a
    level: groups of (tables, parent_ids, child_ids, cyl_w)."""

    def __init__(self, tree: Tree, child_ids, device):
        ndim, nc = tree.ndim, tree.nc
        self.ndim, self.nc = ndim, nc
        self.coord = tree.coord
        self.groups = []
        child_ids = np.asarray(child_ids, dtype=np.int64)
        parities = tree.ix[child_ids] % 2
        for parity in itertools.product([0, 1], repeat=ndim):
            mask = np.all(parities == np.asarray(parity), axis=1)
            ch = child_ids[mask]
            if len(ch) == 0:
                continue
            par = tree.parent[ch]
            tb = parity_tables(ndim, nc, parity, device)
            cyl_w = None
            if tree.coord == "cyl":
                # cylindrical child weights for restriction
                # (af_cyl_child_weights, m_af_types.f90:1186-1197): per parent
                # target cell, w_inner/w_outer = 1 -/+ dr/(4 r_c)
                hnc = nc // 2
                r0 = tree.box_r_min(par)[:, 0]  # parent r_min
                drp = (tree.dr_base[0] /
                       2.0 ** (tree.lvl[par].astype(np.float64) - 1))
                i_c = (tb.coarse_nd[:, 0] + parity[0] * hnc)  # 1-based
                r_c = r0[:, None] + (i_c[None, :] - 0.5) * drp[:, None]
                tmp = 0.25 * drp[:, None] / r_c
                cyl_w = np.stack([1.0 - tmp, 1.0 + tmp], axis=-1)  # [n,Cc,2]
            g = sp.device_copy({"par": par, "ch": ch, "cyl_w": cyl_w}, device)
            self.groups.append((tb, par.astype(np.int32), ch.astype(np.int32),
                                cyl_w, g))


def restrict(cc, plan: ProlongRestrictPlan, ivs, use_geometry: bool = True):
    """Restrict child interiors into parents (af_restrict_box), in place."""
    ndim = plan.ndim
    for tb, _par, _ch, cyl_w, g in plan.groups:
        for iv in ivs:
            iv = int(iv)
            srcs = [cc[iv, g.ch[:, None], s[None, :]]
                    for s in tb.d.restrict_src]
            acc = 0.0
            if plan.coord == "cyl" and use_geometry:
                # source order: bits over dims; the dim-0 (r) bit selects
                # the inner (0) or outer (1) fine column
                w = g.cyl_w.to(cc.dtype)
                for bits, s in zip(itertools.product([0, 1], repeat=ndim),
                                   srcs):
                    acc = acc + w[:, :, bits[0]] * s
            else:
                for s in srcs:
                    acc = acc + s
            cc[iv, g.par[:, None], tb.d.restrict_tgt[None, :]] = \
                acc / (2 ** ndim)
    return cc


def restrict_tree(cc, plans, ivs, use_geometry: bool = True):
    """Restrict all levels downward (af_restrict_tree); ``plans[l-1]`` is
    the plan of the children at level l (None at level 1)."""
    for lvl in range(len(plans), 1, -1):
        cc = restrict(cc, plans[lvl - 1], ivs, use_geometry)
    return cc
