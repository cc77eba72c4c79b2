"""Prolongation and restriction between parent/child boxes.

Re-designs the reference's ``afivo/src/m_af_prolong.f90`` and
``m_af_restrict.f90``: all (parent, child) pairs of a set of children are
one batched gather + arithmetic + scatter, each child's cells in its parent
picked by its parity (its position inside the parent).

Prolongation methods (selected per variable, as in af_set_cc_methods):

* ``zeroth``      — af_prolong_zeroth (copy of the containing coarse cell)
* ``sparse``      — af_prolong_sparse (2/3/4-point)
* ``linear``      — af_prolong_linear (bi/tri-linear 4/8-point, ``:531-679``)
* ``limit``       — af_prolong_limit (limited slopes, ``:311-420``)
* ``linear_cons`` — af_prolong_linear_cons (conservative unlimited slopes,
  ``:424-529``; includes the cylindrical volume correction)

Restriction is 2^ndim-cell averaging, optionally cylindrical-volume-weighted
(af_restrict_box, ``m_af_restrict.f90:62-136``).
"""

from __future__ import annotations

import itertools
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import spatial as sp
from .tree import Tree
from ..ops.limiters import LIMITER_MC, LIMITER_GMINMOD43, limiter_apply


def default_prolong_limiter(ndim: int) -> int:
    """Default limiter for prolongation (af_set_cc_methods,
    ``m_af_core.f90:399-408``): MC for ndim < 3, gminmod43 in 3D."""
    return LIMITER_MC if ndim < 3 else LIMITER_GMINMOD43


def _coarse_cells(ndim: int, nc: int) -> np.ndarray:
    """The cells 1..nc/2 of a parent's quadrant/octant: [Cc, ndim]."""
    ic = np.arange(1, nc // 2 + 1)
    mesh = np.meshgrid(*([ic] * ndim), indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=-1)


class ParityTables:
    """The prolongation stencils for the fine cells of a child of one
    parity: the containing coarse cell ``near``, its neighbors ``lo``/``hi``
    and the one toward the fine cell ``far`` along each dim, the fine
    cell's side ``sign`` [C, ndim] and the linear stencil ``corners``."""

    def __init__(self, ndim: int, nc: int, parity: Tuple[int, ...]):
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
        self.fine_sidx = sp.cc_flat_nd(ndim, nc, fine_nd)
        self.c1_nd = c1_nd
        self.near = sp.cc_flat_nd(ndim, nc, c1_nd)
        self.sign = sign_nd.astype(np.float64)
        self.lo, self.hi, self.far = [], [], []
        for d in range(ndim):
            for lst, off in ((self.lo, -1), (self.hi, 1),
                             (self.far, sign_nd[:, d])):
                v = c1_nd.copy()
                v[:, d] += off
                lst.append(sp.cc_flat_nd(ndim, nc, v))
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


_tables_cache: Dict = {}


def parity_tables(ndim: int, nc: int, parity) -> ParityTables:
    key = (ndim, nc, tuple(parity))
    if key not in _tables_cache:
        _tables_cache[key] = ParityTables(ndim, nc, tuple(parity))
    return _tables_cache[key]


class ProlongRestrictPlan:
    """The (parent, child) pairs of a set of children: the children ``ch``,
    their parents ``par``, each child's coarse target cells in its parent
    ``tgt`` [m, Cc] (flat, by the child's parity), the fine source cells of
    every coarse cell ``src`` (one table per child bit combination) and the
    cylindrical restriction weights ``cyl_w`` [m, Cc, 2]. ``lvl`` is the
    children's level; ``halo`` (set by core/levels.MeshPlans in a sharded
    run) refreshes the halo rows that a transfer reads."""

    halo = None

    def __init__(self, tree: Tree, child_ids, device, lvl: int = 0,
                 dtype=torch.float64):
        ndim, nc = tree.ndim, tree.nc
        self.ndim, self.nc, self.lvl = ndim, nc, lvl
        self.coord = tree.coord
        hnc = nc // 2
        self.ch = np.asarray(child_ids, dtype=np.int64)
        self.par = tree.parent[self.ch].astype(np.int64)
        coarse_nd = _coarse_cells(ndim, nc)
        # fine cells of each coarse cell: child bits over dims
        self.src = [sp.cc_flat_nd(ndim, nc, 2 * coarse_nd - 1 + np.asarray(b))
                    for b in itertools.product([0, 1], repeat=ndim)]
        tgt_nd = coarse_nd[None] + (tree.ix[self.ch] % 2)[:, None, :] * hnc
        self.tgt = sp.cc_flat_nd(ndim, nc, tgt_nd)
        self.cyl_w = None
        if tree.coord == "cyl":
            # cylindrical child weights for restriction
            # (af_cyl_child_weights, m_af_types.f90:1186-1197): per parent
            # target cell, w_inner/w_outer = 1 -/+ dr/(4 r_c)
            r0 = tree.box_r_min(self.par)[:, 0]  # parent r_min
            drp = (tree.dr_base[0] /
                   2.0 ** (tree.lvl[self.par].astype(np.float64) - 1))
            r_c = r0[:, None] + (tgt_nd[..., 0] - 0.5) * drp[:, None]
            tmp = 0.25 * drp[:, None] / r_c
            self.cyl_w = np.stack([1.0 - tmp, 1.0 + tmp], axis=-1)
        self.d = sp.device_copy(self, device, dtype)
        # host inputs of the prolongation tables (not copied above)
        self.device, self.dtype = device, dtype
        self._prolong = None
        self._parity = tree.ix[self.ch] % 2
        self._r0_par = tree.box_r_min(self.par)[:, 0]
        self._dr_par = (tree.dr_base[0]
                        / 2.0 ** (tree.lvl[self.par].astype(np.float64) - 1))

    def prolong_tables(self) -> SimpleNamespace:
        """Per-child prolongation tables on the device (built at first
        use): ``near`` [m, C], ``lo``/``hi``/``far`` per dim, ``sign``
        [m, C, ndim], ``corners`` (weight, [m, C]) and, in cylindrical
        coordinates, the conservative correction ``cyl_corr`` [m, C]."""
        if self._prolong is not None:
            return self._prolong
        ndim, nc = self.ndim, self.nc
        parities = list(itertools.product([0, 1], repeat=ndim))
        tabs = [parity_tables(ndim, nc, q) for q in parities]
        code = sum(self._parity[:, k] << (ndim - 1 - k) for k in range(ndim))

        def per_child(get):
            return np.stack([get(t) for t in tabs])[code]
        t = {"near": per_child(lambda t: t.near),
             "sign": per_child(lambda t: t.sign),
             "fine": tabs[0].fine_sidx,
             "lo": [per_child(lambda t, d=d: t.lo[d]) for d in range(ndim)],
             "hi": [per_child(lambda t, d=d: t.hi[d]) for d in range(ndim)],
             "far": [per_child(lambda t, d=d: t.far[d])
                     for d in range(ndim)]}
        if self.coord == "cyl":
            # -0.25 dr_p / r at each fine cell's containing coarse cell
            # (af_prolong_linear_cons, m_af_prolong.f90:472-476)
            r0 = self._r0_par[:, None]
            c1 = per_child(lambda t: t.c1_nd[:, 0])
            drp = self._dr_par[:, None]
            t["cyl_corr"] = -0.25 * drp / (r0 + (c1 - 0.5) * drp)
        out = sp.device_copy(t, self.device, self.dtype)
        out.corners = [(w, torch.as_tensor(per_child(
            lambda t, k=k: t.corners[k][1]), dtype=torch.int64,
            device=self.device)) for k, (w, _s) in enumerate(tabs[0].corners)]
        self._prolong = out
        return out


def restrict(cc, plan: ProlongRestrictPlan, ivs, use_geometry: bool = True):
    """Restrict child interiors into parents (af_restrict_box), in place."""
    if plan.halo is not None:
        plan.halo(cc, (plan.lvl,), ivs)
    ndim, d = plan.ndim, plan.d
    for iv in ivs:
        iv = int(iv)
        srcs = [cc[iv, d.ch[:, None], s[None, :]] for s in d.src]
        acc = 0.0
        if plan.coord == "cyl" and use_geometry:
            # source order: bits over dims; the dim-0 (r) bit selects the
            # inner (0) or outer (1) fine column
            w = d.cyl_w.to(cc.dtype)
            for bits, s in zip(itertools.product([0, 1], repeat=ndim), srcs):
                acc = acc + w[:, :, bits[0]] * s
        else:
            for s in srcs:
                acc = acc + s
        cc[iv, d.par[:, None], d.tgt] = acc / (2 ** ndim)
    return cc


def restrict_tree(cc, plans, ivs, use_geometry: bool = True):
    """Restrict all levels downward (af_restrict_tree); ``plans[l-1]`` is
    the plan of the children at level l (None at level 1)."""
    for lvl in range(len(plans), 1, -1):
        cc = restrict(cc, plans[lvl - 1], ivs, use_geometry)
    return cc


def prolong(cc, plan: ProlongRestrictPlan, ivs, method: str,
            limiter: Optional[int] = None, add: bool = False):
    """Prolong the parents' data (variables ivs) into the children's
    interiors (af_prolong_* over the plan's children), in place; with
    ``add`` the prolonged values are added to the children's own (the
    Monte-Carlo photons' deposit, physics/photoi_mc.py)."""
    ndim = plan.ndim
    if limiter is None:
        limiter = default_prolong_limiter(ndim)
    if plan.halo is not None:
        plan.halo(cc, (plan.lvl - 1,), ivs)
    t = plan.prolong_tables()
    par = plan.d.par[:, None]
    for iv in ivs:
        iv = int(iv)

        def g(sidx):
            return cc[iv, par, sidx]
        if method == "zeroth":
            fine = g(t.near)
        elif method == "sparse":
            w0, wd = {1: (0.75, 0.25), 2: (0.5, 0.25), 3: (0.25, 0.25)}[ndim]
            fine = w0 * g(t.near)
            for d in range(ndim):
                fine = fine + wd * g(t.far[d])
        elif method == "linear":
            fine = 0.0
            for w, sidx in t.corners:
                fine = fine + float(w) * g(sidx)
        elif method in ("limit", "linear_cons"):
            f0 = g(t.near)
            fine = f0
            sgn = t.sign.to(cc.dtype)
            for d in range(ndim):
                lo, hi = g(t.lo[d]), g(t.hi[d])
                if method == "limit":
                    fd = 0.25 * limiter_apply(f0 - lo, hi - f0, limiter)
                else:
                    fd = 0.125 * (hi - lo)
                if method == "linear_cons" and plan.coord == "cyl" and d == 0:
                    fine = fine + t.cyl_corr.to(cc.dtype) * fd
                fine = fine + sgn[:, :, d] * fd
        else:
            raise ValueError(f"unknown prolongation method {method}")
        if add:
            fine = cc[iv, plan.d.ch[:, None], t.fine[None, :]] + fine
        cc[iv, plan.d.ch[:, None], t.fine[None, :]] = fine
    return cc
