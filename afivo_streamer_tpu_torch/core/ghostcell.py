"""Ghost-cell filling as batched gather/compute/scatter over the box batch.

Re-designs the reference's ``afivo/src/m_af_ghostcell.f90`` (2D): each
(level, direction, case) group of box faces is one batched gather +
arithmetic + scatter, with the index tables ("plans") built on the host
once per mesh and copied to the device.

Cases per face (af_gc_box, ``m_af_ghostcell.f90:66-123``):

* same-level neighbor: copy the neighbor's interior layer;
* refinement boundary: interpolate between the coarse neighbor of the parent
  and the fine interior (af_gc_interp ``:394-498``, af_gc_interp_lim
  ``:503-612``, or mg_sides_rb ``m_af_multigrid.f90:294-461``);
* physical boundary: bc_to_gc with Dirichlet / Neumann / continuous /
  Dirichlet-copy coefficients (``:173-279``).

Corner ghost cells are filled in a second phase (af_gc_box_corner
``:125-170``), copying from diagonal neighbors or extrapolating linearly.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from . import spatial as sp
from .rowops import as_value
from .tree import Tree, NO_BOX, neighb_dim, neighb_low

# Boundary condition types (m_af_types.f90)
BC_DIRICHLET = 1
BC_NEUMANN = 2
BC_CONTINUOUS = 3
BC_DIRICHLET_COPY = 4

# Refinement-boundary methods
RB_INTERP = "interp"          # af_gc_interp
RB_INTERP_LIM = "interp_lim"  # af_gc_interp_lim
RB_MG = "mg_sides_rb"         # mg_sides_rb (preserves diffusive fluxes)


class _DirPlan:
    """Index tables for one (level, direction) pair."""

    def __init__(self):
        self.copy_ids = np.zeros(0, np.int32)
        self.copy_nb = np.zeros(0, np.int32)
        self.bc_ids = np.zeros(0, np.int32)
        self.bc_coords = None  # [n_bc, F, ndim]
        self.rb_ids = np.zeros(0, np.int32)
        self.rb_coarse = np.zeros(0, np.int32)
        self.rb_parent = np.zeros(0, np.int32)
        self.rb_c1 = None   # [n_rb, F] coarse-neighbor cell per ghost cell
        self.rb_c2 = None   # [n_rb, F]
        self.rb_tmp = None  # [n_rb, nc/2+2] coarse strip for mg_sides_rb


class GcLevelPlan:
    """All index tables to fill one ghost layer on one level (2D)."""

    def __init__(self, tree: Tree, lvl: int, device):
        ndim, nc = tree.ndim, tree.nc
        if ndim != 2:
            raise NotImplementedError("core/ghostcell.py: ndim != 2")
        self.ndim, self.nc, self.lvl = ndim, nc, lvl
        self.dr = tree.lvl_dr(lvl)
        ids = tree.lvl_ids[lvl - 1]
        self.dirs: List[_DirPlan] = []
        hnc = nc // 2

        for d in range(2 * ndim):
            dim, low = neighb_dim(d), neighb_low(d)
            td = 1 - dim
            p = _DirPlan()
            g_idx = 0 if low else nc + 1          # ghost layer index
            f1_idx = 1 if low else nc             # first interior
            f2_idx = 2 if low else nc - 1         # second interior
            nbi_idx = nc if low else 1            # neighbor interior layer
            cge_idx = nc if low else 1            # coarse nb layer (ix_c)

            def layer(i):
                return sp.cc_flat(ndim, nc, *sp.face_transverse_axes(
                    ndim, nc, dim, i))
            p.ghost_sidx, p.f1_sidx = layer(g_idx), layer(f1_idx)
            p.f2_sidx, p.nbint_sidx = layer(f2_idx), layer(nbi_idx)

            copy_ids, copy_nb, bc_ids, rb_ids = [], [], [], []
            for bid in ids:
                nb = int(tree.neighbors[bid, d])
                if nb >= 0:
                    copy_ids.append(int(bid))
                    copy_nb.append(nb)
                elif nb == NO_BOX:
                    rb_ids.append(int(bid))
                else:
                    bc_ids.append(int(bid))
            p.copy_ids = np.asarray(copy_ids, np.int32)
            p.copy_nb = np.asarray(copy_nb, np.int32)
            p.bc_ids = np.asarray(bc_ids, np.int32)
            p.rb_ids = np.asarray(rb_ids, np.int32)

            # face coordinates for BC evaluation (af_get_face_coords)
            if len(bc_ids):
                coords = []
                for bid in bc_ids:
                    r0 = tree.box_r_min(np.asarray([bid]))[0]
                    axes = []
                    for k in range(ndim):
                        if k == dim:
                            face_x = r0[k] if low else r0[k] + nc * self.dr[k]
                            axes.append(np.array([face_x]))
                        else:
                            axes.append(r0[k] + (np.arange(nc) + 0.5)
                                        * self.dr[k])
                    mesh = np.meshgrid(*axes, indexing="ij")
                    coords.append(np.stack([m.ravel() for m in mesh], -1))
                p.bc_coords = np.asarray(coords)  # [n_bc, F, ndim]

            # refinement-boundary gather tables
            if len(rb_ids):
                n_rb = len(rb_ids)
                p.rb_parent = tree.parent[p.rb_ids].astype(np.int32)
                p.rb_coarse = tree.neighbors[p.rb_parent, d].astype(np.int32)
                c1 = np.zeros((n_rb, nc), np.int32)
                c2 = np.zeros((n_rb, nc), np.int32)
                tmp = np.zeros((n_rb, hnc + 2), np.int32)
                j = np.arange(1, nc + 1)

                def at(normal, trans):
                    v = np.zeros((len(trans), 2), np.int64)
                    v[:, dim] = normal
                    v[:, td] = trans
                    return sp.cc_flat_nd(2, nc, v)
                for n_i, bid in enumerate(p.rb_ids):
                    off = tree.child_offset(int(bid))  # [ndim], 0 or nc/2
                    j_c1 = off[td] + (j + 1) // 2
                    j_c2 = j_c1 + 1 - 2 * (j & 1)
                    c1[n_i] = at(cge_idx, j_c1)
                    c2[n_i] = at(cge_idx, j_c2)
                    # mg strip: coarse cells off+0 .. off+hnc+1 (incl. the
                    # coarse box's own side ghosts)
                    tmp[n_i] = at(cge_idx, off[td] + np.arange(0, hnc + 2))
                p.rb_c1, p.rb_c2, p.rb_tmp = c1, c2, tmp
            p.d = sp.device_copy(p, device)
            self.dirs.append(p)

        # ------------------------------------------------ corner plans
        self.corner_plans = []
        for pos, di in sp.corner_list(ndim, nc):
            copy_ids, copy_nb, ext_ids = [], [], []
            for bid in ids:
                # di is inward; the diagonal neighbor offset is -di
                nb = tree.neighbor_mat(int(bid), -di)
                if nb >= 0:
                    copy_ids.append(int(bid))
                    copy_nb.append(int(nb))
                else:
                    ext_ids.append(int(bid))
            # ghost position maps to the neighbor interior: 0 -> nc, nc+1 -> 1
            nb_pos = np.where(pos == 0, nc, np.where(pos == nc + 1, 1, pos))
            a = pos.copy()
            a[0] += di[0]
            b = pos.copy()
            b[1] += di[1]
            plan = {
                "pos": int(sp.cc_flat_nd(ndim, nc, pos)),
                "nb_pos": int(sp.cc_flat_nd(ndim, nc, nb_pos)),
                "ext_a": int(sp.cc_flat_nd(2, nc, a)),
                "ext_b": int(sp.cc_flat_nd(2, nc, b)),
                "ext_c": int(sp.cc_flat_nd(2, nc, pos + di)),
                "copy_ids": np.asarray(copy_ids, np.int32),
                "copy_nb": np.asarray(copy_nb, np.int32),
                "ext_ids": np.asarray(ext_ids, np.int32),
            }
            plan["d"] = sp.device_copy(plan, device)
            self.corner_plans.append(plan)


def bc_to_ghost(bc_type: int, bc_val, inner1, inner2, dr_dim: float,
                high: bool):
    """bc_to_gc coefficients (``m_af_ghostcell.f90:176-213``)."""
    if bc_type == BC_DIRICHLET:
        return 2.0 * bc_val - inner1
    if bc_type == BC_NEUMANN:
        sign = 1.0 if high else -1.0
        return inner1 + sign * dr_dim * bc_val
    if bc_type == BC_CONTINUOUS:
        return 2.0 * inner1 - inner2
    if bc_type == BC_DIRICHLET_COPY:
        return bc_val + 0.0 * inner1
    raise ValueError("unknown bc type")


def _gat(cc, iv: int, ids, sidx):
    """cc[iv] at (ids, sidx): sidx [F] (shared) or [n, F] per entry."""
    if sidx.dim() == 1:
        return cc[iv, ids[:, None], sidx[None, :]]
    return cc[iv, ids[:, None], sidx]


def _scat(cc, iv: int, ids, sidx, vals):
    if sidx.dim() == 1:
        cc[iv, ids[:, None], sidx[None, :]] = vals
    else:
        cc[iv, ids[:, None], sidx] = vals


def mg_rb_interp(tmp, nc: int):
    """Interpolate the coarse strip next to a fine box to positions straight
    next to the fine cells (mg_sides_rb, ``m_af_multigrid.f90:361-388``).
    tmp: [n, nc/2+2]; returns [n, nc]."""
    hnc = nc // 2
    center = tmp[:, 1:hnc + 1]
    grad = 0.125 * (tmp[:, 2:hnc + 2] - tmp[:, 0:hnc])
    return torch.stack([center - grad, center + grad], dim=-1).reshape(
        tmp.shape[0], nc)


def fill_ghosts_lvl(cc, plan: GcLevelPlan, ivs, rb_method: str, bc_fn,
                    params=None, corners: bool = True):
    """Fill one ghost layer for variables ivs on one level (in place).

    bc_fn(iv, d, coords, params) -> (bc_type, values); values broadcastable
    to [n_bc, F]."""
    params = params or {}
    for d, p in enumerate(plan.dirs):
        dim, low = neighb_dim(d), neighb_low(d)
        t = p.d
        for iv in ivs:
            iv = int(iv)
            if len(p.copy_ids):
                _scat(cc, iv, t.copy_ids, t.ghost_sidx,
                      _gat(cc, iv, t.copy_nb, t.nbint_sidx))
            if len(p.bc_ids):
                in1 = _gat(cc, iv, t.bc_ids, t.f1_sidx)
                in2 = _gat(cc, iv, t.bc_ids, t.f2_sidx)
                bc_type, bc_val = bc_fn(iv, d, p.bc_coords, params)
                _scat(cc, iv, t.bc_ids, t.ghost_sidx,
                      bc_to_ghost(bc_type, as_value(bc_val, cc), in1, in2,
                                  float(plan.dr[dim]), not low))
            if len(p.rb_ids):
                fine1 = _gat(cc, iv, t.rb_ids, t.f1_sidx)
                if rb_method in (RB_INTERP, RB_INTERP_LIM):
                    c1 = _gat(cc, iv, t.rb_coarse, t.rb_c1)
                    c2 = _gat(cc, iv, t.rb_coarse, t.rb_c2)
                    ghost = 0.5 * c1 + c2 / 6.0 + fine1 / 3.0
                    if rb_method == RB_INTERP_LIM:
                        ghost = torch.minimum(ghost, 2.0 * c1)
                elif rb_method == RB_MG:
                    fine2 = _gat(cc, iv, t.rb_ids, t.f2_sidx)
                    gc = mg_rb_interp(_gat(cc, iv, t.rb_coarse, t.rb_tmp),
                                      plan.nc)
                    ghost = 0.5 * gc + 0.75 * fine1 - 0.25 * fine2
                else:
                    raise NotImplementedError(
                        f"core/ghostcell.py: rb method {rb_method}")
                _scat(cc, iv, t.rb_ids, t.ghost_sidx, ghost)
    if corners:
        fill_corners_lvl(cc, plan, ivs)
    return cc


def fill_corners_lvl(cc, plan: GcLevelPlan, ivs):
    """Corner ghost cells (af_gc_box_corner, ``m_af_ghostcell.f90:125-170``):
    copy from the diagonal neighbor when present, else the linear
    extrapolation a + b - c."""
    for pl in plan.corner_plans:
        t = pl["d"]
        for iv in ivs:
            iv = int(iv)
            if len(pl["copy_ids"]):
                cc[iv, t.copy_ids, pl["pos"]] = cc[iv, t.copy_nb, pl["nb_pos"]]
            if len(pl["ext_ids"]):
                e = t.ext_ids
                cc[iv, e, pl["pos"]] = (cc[iv, e, pl["ext_a"]]
                                        + cc[iv, e, pl["ext_b"]]
                                        - cc[iv, e, pl["ext_c"]])
    return cc
