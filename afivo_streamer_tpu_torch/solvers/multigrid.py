"""Geometric multigrid (FAS-FMG / FAS V-cycle) over the box batch.

Re-designs the reference's ``afivo/src/m_af_multigrid.f90``: downward
red-black GSRB smoothing with a ghost exchange after every half sweep
(gsrb_boxes ``:648-687``), FAS coarse-grid construction (update_coarse
``:691-738``), a coarse-grid solve at level 1 and upward corrections
(correct_children ``:624-646``). The cycles run on per-level block arrays
(solvers/mg_blocks.py) whose smoothing and ghost fills are the kernels of
ops/smoother.py.

The red-black update colors cells by (i+j[+k]) parity matching stencil_gsrb_357
(``m_af_stencil.f90:820-980``), including the cylindrical gradient
correction via radial flux factors (af_cyl_flux_factors,
``m_af_types.f90:1199-1212``). The level-1 solve replaces the reference's
HYPRE bridge with an assembled direct solve (solvers/coarse.py).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable

import numpy as np
import torch

from ..core import ghostcell as gc
from ..core.levels import MeshPlans
from ..core.rowops import fc_get_faces, fc_set_faces
from ..ops.smoother import SmootherTables
from . import mg_blocks as mgb
from .coarse import make_coarse_solver
from .lsf import lsf_stencil_coefficients


def parity_mask(ndim: int, nc: int, redblack: int) -> np.ndarray:
    """Cells updated in a half sweep: (i+j[+k]) % 2 == redblack % 2 with
    1-based indices (stencil_gsrb_357)."""
    mesh = np.meshgrid(*[np.arange(1, nc + 1)] * ndim, indexing="ij")
    return (sum(mesh) % 2) == (redblack % 2)


class LevelOp:
    """Operator coefficients for one level: center + 2 ndim neighbor
    coefficients, each broadcastable against [n] + [nc]^ndim blocks (host
    NumPy float64).

    Normal box: the constant 5/7-point Laplacian - helmholtz_lambda
    (mg_box_lpl_stencil, ``m_af_multigrid.f90:1227-1245``); cylindrical
    coordinates scale the radial couplings by the flux factors.

    With the permittivity ``eps`` of the level's blocks ([n, (nc+2)^ndim],
    ghost layer included): the variable-permittivity operator
    (mg_box_lpld_stencil, ``m_af_multigrid.f90:1476-1560``) with the
    harmonic-mean couplings 2 eps0 eps_nb / (eps0 + eps_nb), and ``veps``
    flags the boxes where eps varies anywhere in the block.

    With a level set (``lsf_data``, solvers/lsf.LsfData): on the boxes that
    hold the electrode boundary the generalized-distance stencil
    (mg_box_lsf_stencil) replaces the rows above, after eps as in the JAX
    package; ``f`` is the factor of the eliminated boundary couplings and
    ``bc_coeff`` the per-cell multiplier of the boundary potential, so the
    operator with a boundary at potential phi_b is
    L(phi) - f bc_coeff phi_b. On those boxes c_sum is not -lambda."""

    def __init__(self, tree, lvl: int, lam: float, eps=None, lsf_data=None,
                 ids=None):
        nc, ndim = tree.nc, tree.ndim
        dr = tree.lvl_dr(lvl)
        inv_dr2 = 1.0 / dr**2
        ids = tree.lvl_ids[lvl - 1] if ids is None else ids
        c_nb = [float(inv_dr2[d // 2]) for d in range(2 * ndim)]
        c0 = -2.0 * float(np.sum(inv_dr2)) - lam
        if tree.coord == "cyl":
            # radial flux factors per box (dim 0 is r)
            r0 = tree.box_r_min(ids)[:, 0]
            i = np.arange(1, nc + 1)
            r_cc = r0[:, None] + (i[None, :] - 0.5) * dr[0]  # [n, nc]
            rfac1 = (r_cc - 0.5 * dr[0]) / r_cc
            rfac2 = (r_cc + 0.5 * dr[0]) / r_cc
            c_lo = (rfac1 * c_nb[0]).reshape(len(r0), nc, 1)
            c_hi = (rfac2 * c_nb[1]).reshape(len(r0), nc, 1)
            c0 = c0 - (c_lo - c_nb[0]) - (c_hi - c_nb[1])
            c_nb[0] = c_lo
            c_nb[1] = c_hi
        self.veps = None
        if eps is not None:
            n = len(ids)
            E = np.asarray(eps).reshape((n,) + (nc + 2,) * ndim)
            e0 = E[(slice(None),) + (slice(1, nc + 1),) * ndim]
            c_nb = []
            for d in range(2 * ndim):
                delta = -1 if d % 2 == 0 else 1
                sl = [slice(1, nc + 1)] * ndim
                sl[d // 2] = slice(1 + delta, nc + 1 + delta)
                enb = E[(slice(None),) + tuple(sl)]
                c_nb.append(inv_dr2[d // 2] * 2.0 * e0 * enb / (e0 + enb))
            if tree.coord == "cyl":
                r0 = tree.box_r_min(ids)[:, 0]
                i = np.arange(1, nc + 1)
                r_cc = r0[:, None] + (i[None, :] - 0.5) * dr[0]
                c_nb[0] = c_nb[0] * ((r_cc - 0.5 * dr[0]) / r_cc)[:, :, None]
                c_nb[1] = c_nb[1] * ((r_cc + 0.5 * dr[0]) / r_cc)[:, :, None]
            c0 = -sum(c_nb) - lam
            eps = np.asarray(eps)
            self.veps = (eps.max(axis=1) - eps.min(axis=1)) > 1e-8
        self.f = self.bc_coeff = None
        if lsf_data is not None:
            data = lsf_data.level_data(lvl)
            if data["has_bnd"].any():
                c0l, c_nbl, fl = lsf_stencil_coefficients(tree, lvl, data,
                                                          0.0)
                bshape = (len(ids),) + (nc,) * ndim
                sel = data["has_bnd"].reshape((len(ids),) + (1,) * ndim)
                c0 = np.where(sel, c0l.reshape(bshape), c0 + np.zeros(bshape))
                c_nb = [np.where(sel, c_nbl[d].reshape(bshape),
                                 c_nb[d] + np.zeros(bshape))
                        for d in range(2 * ndim)]
                self.f = np.where(sel, fl.reshape(bshape), 0.0)
                self.bc_coeff = data["bc_coeff"].reshape(bshape)
        # difference-form sum coefficient s = c0 + sum(c_nb), in float64:
        # the operator is applied as L(phi) = sum_d c_d (phi_d - phi_0)
        # + s phi_0, which avoids the |phi|/dx^2-scale cancellation of the
        # naive sum; s = -helmholtz_lambda exactly except on the boxes of
        # a level set's boundary
        self.c_sum = c0 + sum(c_nb)
        self.c_nb = c_nb
        self.c0 = c0


class Multigrid:
    """FAS multigrid solver bound to a (mesh, variable set, BC spec).

    ``eps_data(lvl)``, when set, gives the permittivity blocks of a level
    (host float64 [n, (nc+2)^ndim]) for the variable-permittivity operator;
    ``lsf_data`` (solvers/lsf.LsfData), when set, the level set of an
    electrode, whose boundary potential a solve reads from
    ``params["lsf_phi_b"]``.
    The per-level operator, smoother and transfer tables are cached with
    the mesh's plans and rebuilt for the levels a refinement epoch
    changed.

    In a sharded run (parallel/halo.py) a level's arrays hold the rank's
    rows of the level (``rows``: its own boxes, then its halo), the tables
    cover its own boxes (a halo row's neighbor rows name itself), the
    cycles exchange the halo rows between their steps
    (solvers/mg_blocks.py), the level-1 solve runs on the whole level
    gathered on every rank, and the leaf residual is the maximum over the
    ranks, so that every rank takes the same stop decisions."""

    def __init__(self, mesh: MeshPlans, i_phi: int, i_rhs: int,
                 sides_bc: Callable, helmholtz_lambda: float = 0.0,
                 n_cycle_down: int = 2, n_cycle_up: int = 2):
        self.mesh = mesh
        self.tree = mesh.tree
        self.i_phi, self.i_rhs = i_phi, i_rhs
        self.sides_bc = sides_bc
        self.lam = helmholtz_lambda
        self.n_cycle_down = n_cycle_down
        self.n_cycle_up = n_cycle_up
        self.eps_data = None
        #: in a sharded run with eps_data, the permittivity blocks of the
        #: whole of level 1 in the tree's order, gathered on every rank
        self.eps_level1 = None
        self.lsf_data = None

    def rows(self, lvl: int) -> np.ndarray:
        """The state rows of a level's arrays: the level's boxes, or in a
        sharded run the rank's own boxes of the level then its halo."""
        return self.mesh.level_rows(lvl)

    def level_ids(self, lvl: int) -> torch.Tensor:
        """``rows(lvl)`` on the device."""
        return self._get(("rows", lvl), lambda: torch.as_tensor(
            self.rows(lvl), dtype=torch.int64, device=self.mesh.device),
            (lvl,))

    def _get(self, key, make, lvls=None):
        return self.mesh.cached(("mg", self.i_phi) + key, make, lvls)

    # ----------------------------------------------------------- tables
    @property
    def n_levels(self) -> int:
        return self.tree.highest_lvl

    def op(self, lvl: int) -> LevelOp:
        return self._get(("op", lvl), lambda: LevelOp(
            self.tree, lvl, self.lam,
            None if self.eps_data is None else self.eps_data(lvl),
            self.lsf_data, ids=self.rows(lvl)), (lvl,))

    def rb_extrap(self, lvl: int):
        """{direction: bool per refinement-boundary entry} of the entries
        whose box has variable eps, which take the extrapolating ghost
        (JAX Multigrid._veps_mask, mg_auto_rb -> mg_sides_rb_extrap); only
        directions with such an entry; None without eps."""
        op = self.op(lvl)
        if op.veps is None:
            return None
        pos = np.full(int(self.tree.highest_id) + 1, -1, np.int64)
        pos[self.rows(lvl)] = np.arange(len(op.veps))
        out = {}
        for d, p in enumerate(self.mesh.gc(lvl).dirs):
            m = op.veps[pos[p.rb_ids]] if len(p.rb_ids) else None
            if m is not None and m.any():
                out[d] = m
        return out

    def smoother(self, lvl: int) -> SmootherTables:
        return self._get(("sm", lvl), lambda: SmootherTables(
            self.tree, lvl, self.mesh.gc(lvl),
            SimpleNamespace(ids=self.rows(lvl)),
            self.sides_bc, self.i_phi, self.mesh.device,
            self.rb_extrap(lvl)), (lvl,))

    def blocks(self, lvl: int) -> mgb.LevelBlockPlan:
        return self._get(("blk", lvl),
                         lambda: mgb.LevelBlockPlan(self.mesh, lvl),
                         (lvl - 1, lvl))

    def cs(self, lvl: int, dtype) -> torch.Tensor:
        return self.smoother(lvl).cs(self.op(lvl), dtype)

    def corr(self, lvl: int, dtype):
        """f * bc_coeff of a level's boxes [n] + [nc]^ndim, or None on a
        level without a level-set boundary."""
        return self.smoother(lvl).corr(self.op(lvl), dtype)

    def parity_masks(self, n_half: int) -> list:
        """float32 [nc]^ndim masks of half sweeps 1..n_half."""
        def make():
            return [torch.as_tensor(parity_mask(self.tree.ndim,
                                                self.tree.nc, k),
                                    dtype=torch.float32,
                                    device=self.mesh.device)
                    for k in range(1, n_half + 1)]
        return self._get(("masks", n_half), make, ())

    def coarse_solver(self):
        """The level-1 solver (solvers/coarse.make_coarse_solver). The
        level-1 boxes, their permittivity and their level set never change
        after setup: built once, at the first solve. With either, the solve
        must use the per-cell level-1 operator."""
        per_cell = self.eps_data is not None or self.lsf_data is not None

        def make():
            # the tracer's span plans.coarse, inside plans.build
            with self.mesh.tracer.span("plans.coarse"):
                return make_coarse_solver(
                    self.mesh.full.tree, self.sides_bc, self.lam,
                    self.mesh.device,
                    level1_op=self.level1_op() if per_cell else None,
                    dtype=self.mesh.dtype, tracer=self.mesh.tracer)
        return self._get(("coarse",), make, ())

    def level1_op(self) -> LevelOp:
        """The per-cell operator of the whole of level 1 in the tree's
        order, which the dense coarse solve takes: ``op(1)``, or in a
        sharded run the operator of the whole tree's level 1 on every rank
        (the permittivity from ``eps_level1``, the level set's twin on the
        whole tree)."""
        if self.mesh.layout is None:
            return self.op(1)
        return LevelOp(
            self.mesh.full.tree, 1, self.lam,
            None if self.eps_data is None else self.eps_level1(),
            None if self.lsf_data is None else self.lsf_data.whole())

    # --------------------------------------------------------- cycles
    def fill_ghosts_phi(self, cc, params):
        for lvl in range(1, self.n_levels + 1):
            emask = {d: m for d, m in enumerate(self.smoother(lvl).rb_extrap)
                     if m is not None}
            gc.fill_ghosts_lvl(cc, self.mesh.gc(lvl), [self.i_phi], gc.RB_MG,
                               self.sides_bc, params, rb_extrap_mask=emask)
        return cc

    def vcycle(self, cc, params):
        """One FAS V-cycle on cc; returns (cc, max leaf residual)."""
        P, R = mgb.gather_levels(self, cc)
        P, R = mgb.fas_vcycle_blocks(self, P, R, params)
        res = mgb.max_leaf_residual_blocks(self, P, R, params)
        return mgb.scatter_levels(self, cc, P, R), res

    # ---------------------------------------------------- field utilities
    def _all_ids_inv_dr(self):
        """Ids of all boxes and their per-box 1/dr [N, ndim]."""
        def make():
            t = self.tree
            inv_dr = np.concatenate([
                np.repeat(1.0 / np.asarray(t.lvl_dr(l), np.float64)[None, :],
                          len(t.lvl_ids[l - 1]), axis=0)
                for l in range(1, self.n_levels + 1)])
            return (self.mesh.all_ids(),
                    torch.as_tensor(inv_dr, dtype=self.mesh.dtype,
                                    device=self.mesh.device))
        return self._get(("ids_inv_dr",), make)

    def compute_phi_gradient(self, cc, fc, i_fc: int, fac: float):
        """fc = fac * grad(phi) on all boxes (mg_compute_phi_gradient /
        mg_box_lpl_gradient, ``m_af_multigrid.f90:1837-1974``)."""
        nc, ndim = self.tree.nc, self.tree.ndim
        ids, inv_dr = self._all_ids_inv_dr()
        B = cc[self.i_phi, ids].reshape((len(ids),) + (nc + 2,) * ndim)
        inv_dr = inv_dr.to(cc.dtype)
        bshape = (slice(None),) + (None,) * ndim
        for d in range(ndim):
            lo = [slice(0, nc + 1) if k == d else slice(1, nc + 1)
                  for k in range(ndim)]
            hi = [slice(1, nc + 2) if k == d else slice(1, nc + 1)
                  for k in range(ndim)]
            g = (float(fac) * inv_dr[:, d][bshape]
                 * (B[(slice(None),) + tuple(hi)]
                    - B[(slice(None),) + tuple(lo)]))
            fc_set_faces(fc, i_fc, d, ids, g, nc, ndim)
        return fc

    def compute_field_norm(self, cc, fc, i_fc: int, i_norm: int):
        """Cell-centered norm of a face field (mg_box_field_norm,
        ``m_af_multigrid.f90:1995-2025``): average of the two faces."""
        nc, ndim = self.tree.nc, self.tree.ndim
        ids, _ = self._all_ids_inv_dr()
        acc = 0.0
        for d in range(ndim):
            F = fc_get_faces(fc, i_fc, d, ids, nc, ndim)
            lo = tuple(slice(0, nc) if k == d else slice(None)
                       for k in range(ndim))
            hi = tuple(slice(1, nc + 1) if k == d else slice(None)
                       for k in range(ndim))
            acc = acc + (F[(slice(None),) + lo] + F[(slice(None),) + hi]) ** 2
        B = cc[i_norm, ids].reshape((len(ids),) + (nc + 2,) * ndim)
        B[(slice(None),) + (slice(1, nc + 1),) * ndim] = 0.5 * torch.sqrt(acc)
        cc[i_norm, ids] = B.flatten(1)
        return cc
