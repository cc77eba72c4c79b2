"""Ghost-cell filling as batched gather/compute/scatter over the box batch.

Re-designs the reference's ``afivo/src/m_af_ghostcell.f90`` (1D to 3D):
each (level, direction, case) group of box faces is one batched gather +
arithmetic + scatter, with the index tables ("plans") built on the host
once per mesh and copied to the device.

Cases per face (af_gc_box, ``m_af_ghostcell.f90:66-123``):

* same-level neighbor: copy the neighbor's interior layer;
* refinement boundary: interpolate between the coarse neighbor of the parent
  and the fine interior (af_gc_interp ``:394-498``, af_gc_interp_lim
  ``:503-612``, or mg_sides_rb ``m_af_multigrid.f90:294-461``), copy the
  parent cell (af_gc_prolong_copy), or, for boxes with variable
  permittivity, extrapolate (mg_sides_rb_extrap
  ``m_af_multigrid.f90:468-621``);
* physical boundary: bc_to_gc with Dirichlet / Neumann / continuous /
  Dirichlet-copy coefficients (``:173-279``).

Edge (3D) and corner ghost cells are filled in a second phase
(af_gc_box_corner ``:125-170``), copying from diagonal neighbors or
extrapolating linearly. In 1D a face is one cell: every per-face table has
one column, the coarse strip is the one coarse cell, and there are no
corners.
"""

from __future__ import annotations

import itertools
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
RB_PROLONG_COPY = "prolong_copy"  # af_gc_prolong_copy


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
        # coarse-neighbor cell per ghost cell [n_rb, F]: the nearest (c1),
        # then the next one across each transverse dim (c2; c3 in 3D)
        self.rb_c = []
        self.rb_tmp = None  # [n_rb, (nc/2+2)^(ndim-1)] mg_sides_rb strip
        self.rb_pcopy = None  # [n_rb, F] parent cells holding the ghosts


class GcLevelPlan:
    """All index tables to fill one ghost layer on one level. ``halo``
    (set by core/levels.MeshPlans in a sharded run) refreshes the halo
    rows of the level and of the level below before a fill."""

    halo = None

    def __init__(self, tree: Tree, lvl: int, device, dtype=torch.float64):
        ndim, nc = tree.ndim, tree.nc
        self.ndim, self.nc, self.lvl = ndim, nc, lvl
        self.dr = tree.lvl_dr(lvl)
        ids = tree.lvl_ids[lvl - 1]
        self.dirs: List[_DirPlan] = []
        hnc = nc // 2
        # fine transverse cells 1..nc of a face, one column per transverse
        # dim, in their natural (C) order
        def transverse(rng):
            if ndim == 1:  # one face cell, no transverse coordinate
                return np.zeros((1, 0), np.int64)
            return np.stack([m.ravel() for m in np.meshgrid(
                *[rng] * (ndim - 1), indexing="ij")], -1)
        jt = transverse(np.arange(1, nc + 1))
        # coarse strip cells 0..hnc+1 (incl. the coarse box's side ghosts)
        st = transverse(np.arange(0, hnc + 2))

        for d in range(2 * ndim):
            dim, low = neighb_dim(d), neighb_low(d)
            tdims = [k for k in range(ndim) if k != dim]
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
                p.rb_parent = tree.parent[p.rb_ids].astype(np.int32)
                p.rb_coarse = tree.neighbors[p.rb_parent, d].astype(np.int32)

                def at(trans, normal=cge_idx):
                    v = np.zeros((len(trans), ndim), np.int64)
                    v[:, dim] = normal
                    v[:, tdims] = trans
                    return sp.cc_flat_nd(ndim, nc, v)
                rb_c = [[] for _ in range(ndim)]
                tmp, pcopy = [], []
                for bid in p.rb_ids:
                    off_all = tree.child_offset(int(bid))  # 0 or nc/2
                    off = off_all[tdims]
                    j_c1 = off + (jt + 1) // 2
                    j_c2 = j_c1 + 1 - 2 * (jt & 1)
                    rb_c[0].append(at(j_c1))
                    for t in range(ndim - 1):
                        j = j_c1.copy()
                        j[:, t] = j_c2[:, t]
                        rb_c[1 + t].append(at(j))
                    tmp.append(at(off + st))
                    # the parent cell containing each ghost cell
                    pcopy.append(at(j_c1, off_all[dim] + (g_idx + 1) // 2))
                p.rb_c = [np.asarray(c, np.int32) for c in rb_c]
                p.rb_tmp = np.asarray(tmp, np.int32)
                p.rb_pcopy = np.asarray(pcopy, np.int32)
            p.d = sp.device_copy(p, device, dtype)
            self.dirs.append(p)

        # ------------------------------------------- edge and corner groups
        # 3D edges, then corners: copy from the diagonal neighbor where it
        # exists, else extrapolate (af_gc_box_corner)
        self.corner_groups = []
        if ndim == 3:
            for dim_e in range(3):
                odims = [k for k in range(3) if k != dim_e]
                for bits in itertools.product([0, 1], repeat=2):
                    pos = np.full((nc, 3), 0, np.int64)
                    pos[:, dim_e] = np.arange(1, nc + 1)
                    di = np.zeros(3, np.int64)
                    for b, k in zip(bits, odims):
                        pos[:, k] = nc + 1 if b else 0
                        di[k] = -1 if b else 1
                    ea, eb = pos.copy(), pos.copy()
                    ea[:, odims[0]] += di[odims[0]]
                    eb[:, odims[1]] += di[odims[1]]
                    self.corner_groups.append(self._group(
                        tree, ids, pos, -di, [ea, eb, pos + di]))
        for pos, di in (sp.corner_list(ndim, nc) if ndim > 1 else []):
            pos = pos[None, :]
            if ndim == 2:
                a, b = pos.copy(), pos.copy()
                a[:, 0] += di[0]
                b[:, 1] += di[1]
                ext = [a, b, pos + di]
            else:
                # a + b + c - 2 d: the three edge-adjacent face cells and
                # the diagonal interior cell
                ext = []
                for k in range(3):
                    e = pos + di
                    e[:, k] = pos[:, k]
                    ext.append(e)
                ext.append(pos + di)
            self.corner_groups.append(self._group(tree, ids, pos, -di, ext))
        self.corner_flat = corner_tables(self, np.arange(tree.highest_id),
                                         (nc + 2) ** ndim, device)

    def _group(self, tree, ids, pos, nb_off, ext):
        """Edge or corner group: ghost cells ``pos`` [F, ndim] of every box,
        the same-level neighbor at offset ``nb_off`` and the extrapolation
        cells ``ext`` (a, b, c[, d])."""
        nc, ndim = self.nc, self.ndim
        copy_ids, copy_nb, ext_ids = [], [], []
        for bid in ids:
            nb = tree.neighbor_mat(int(bid), nb_off)
            if nb >= 0:
                copy_ids.append(int(bid))
                copy_nb.append(int(nb))
            else:
                ext_ids.append(int(bid))
        # a ghost position maps to the neighbor's interior: 0 -> nc,
        # nc+1 -> 1
        nb_pos = np.where(pos == 0, nc, np.where(pos == nc + 1, 1, pos))
        plan = {"pos": sp.cc_flat_nd(ndim, nc, pos),
                "nb_pos": sp.cc_flat_nd(ndim, nc, nb_pos),
                "ext": [sp.cc_flat_nd(ndim, nc, e) for e in ext],
                "copy_ids": np.asarray(copy_ids, np.int64),
                "copy_nb": np.asarray(copy_nb, np.int64),
                "ext_ids": np.asarray(ext_ids, np.int64)}
        return plan


def corner_tables(plan: GcLevelPlan, rows, S: int, device):
    """The edge and corner groups of ``plan`` as flat indices into rows of
    S cells, box b at row ``rows[b]``: the copies (target, source), the
    three-term extrapolations a + b - c (edges, 2D corners) and the
    four-term ones a + b + c - 2 d (3D corners), as (target, [sources]).
    No group reads a cell that another group writes, so all of a level's
    groups are filled at once."""
    copy_t, copy_s = [], []
    ext = {3: ([], [[] for _ in range(3)]), 4: ([], [[] for _ in range(4)])}
    for pl in plan.corner_groups:
        if len(pl["copy_ids"]):
            copy_t.append(rows[pl["copy_ids"]][:, None] * S + pl["pos"])
            copy_s.append(rows[pl["copy_nb"]][:, None] * S + pl["nb_pos"])
        if len(pl["ext_ids"]):
            r = rows[pl["ext_ids"]][:, None] * S
            tgt, srcs = ext[len(pl["ext"])]
            tgt.append(r + pl["pos"])
            for lst, e in zip(srcs, pl["ext"]):
                lst.append(r + e)

    def flat(parts):
        return torch.as_tensor(
            np.concatenate([a.ravel() for a in parts]) if parts
            else np.zeros(0, np.int64), dtype=torch.int64, device=device)
    return {"copy": (flat(copy_t), flat(copy_s)),
            "ext": [(flat(tgt), [flat(x) for x in srcs])
                    for tgt, srcs in ext.values() if tgt]}


def corner_fill_flat(flat, tables):
    """Fill the edge and corner ghosts of a flat view of rows (in place)
    from ``corner_tables``: the copies, then the extrapolations."""
    tgt, src = tables["copy"]
    if len(tgt):
        flat[tgt] = flat[src]
    for tgt, srcs in tables["ext"]:
        e = [flat[x] for x in srcs]
        flat[tgt] = (e[0] + e[1] - e[2] if len(e) == 3
                     else e[0] + e[1] + e[2] - 2.0 * e[3])
    return flat


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


def mg_rb_interp(tmp, ndim: int, nc: int):
    """Interpolate the coarse strip next to a fine box to positions straight
    next to the fine cells (mg_sides_rb, ``m_af_multigrid.f90:361-388``).
    tmp: [n, (nc/2+2)^(ndim-1)] (the one coarse cell in 1D); returns
    [n, nc^(ndim-1)]."""
    hnc = nc // 2
    n = tmp.shape[0]
    if ndim == 1:
        return tmp
    if ndim == 2:
        center = tmp[:, 1:hnc + 1]
        grad = 0.125 * (tmp[:, 2:hnc + 2] - tmp[:, 0:hnc])
        return torch.stack([center - grad, center + grad], dim=-1).reshape(
            n, nc)
    t = tmp.reshape(n, hnc + 2, hnc + 2)
    c = t[:, 1:hnc + 1, 1:hnc + 1]
    g1 = 0.125 * (t[:, 2:hnc + 2, 1:hnc + 1] - t[:, 0:hnc, 1:hnc + 1])
    g2 = 0.125 * (t[:, 1:hnc + 1, 2:hnc + 2] - t[:, 1:hnc + 1, 0:hnc])
    # fine (2i-1, 2j-1), (2i-1, 2j), (2i, 2j-1), (2i, 2j)
    gc = torch.stack([torch.stack([c - g1 - g2, c - g1 + g2], dim=-1),
                      torch.stack([c + g1 - g2, c + g1 + g2], dim=-1)],
                     dim=-2)  # [n, hnc, hnc, 2 (i), 2 (j)]
    return gc.permute(0, 1, 3, 2, 4).reshape(n, nc * nc)


def pair_swap(a):
    """Exchange the transverse cell pairs (j, j^1) of [n, nc] face rows."""
    n, nc = a.shape
    return a.reshape(n, nc // 2, 2).flip(-1).reshape(n, nc)


def rb_extrap_ghost(cc, iv: int, t, ndim: int):
    """Extrapolating refinement-boundary ghosts of boxes with variable
    permittivity (mg_sides_rb_extrap, ``m_af_multigrid.f90:468-621``): half
    the parent copy plus a bilinear extrapolation from the fine side, with
    the transverse pair swap in 2D; 1D and 3D take the one-dimensional
    form."""
    pcopy = _gat(cc, iv, t.rb_parent, t.rb_pcopy)
    f1 = _gat(cc, iv, t.rb_ids, t.f1_sidx)
    f2 = _gat(cc, iv, t.rb_ids, t.f2_sidx)
    if ndim == 2:
        return (0.5 * pcopy + 1.125 * f1
                - 0.375 * (f2 + pair_swap(f1)) + 0.125 * pair_swap(f2))
    return 0.5 * pcopy + 0.75 * f1 - 0.25 * f2


def fill_ghosts_lvl(cc, plan: GcLevelPlan, ivs, rb_method: str, bc_fn,
                    params=None, corners: bool = True, rb_extrap_mask=None):
    """Fill one ghost layer for variables ivs on one level (in place).

    bc_fn(iv, d, coords, params) -> (bc_type, values); values broadcastable
    to [n_bc, F]. ``rb_extrap_mask`` ({direction: bool tensor per
    refinement-boundary entry}) selects the entries that take the
    extrapolating ghost instead of ``rb_method``."""
    params = params or {}
    if plan.halo is not None:
        plan.halo(cc, (plan.lvl - 1, plan.lvl), ivs)
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
                    c1, *cn = (_gat(cc, iv, t.rb_coarse, c) for c in t.rb_c)
                    if plan.ndim == 1:
                        ghost = (2.0 * c1 + fine1) / 3.0
                    elif plan.ndim == 2:
                        ghost = 0.5 * c1 + cn[0] / 6.0 + fine1 / 3.0
                    else:
                        ghost = (c1 + fine1) / 3.0 + (cn[0] + cn[1]) / 6.0
                    if rb_method == RB_INTERP_LIM:
                        ghost = torch.minimum(ghost, 2.0 * c1)
                elif rb_method == RB_MG:
                    fine2 = _gat(cc, iv, t.rb_ids, t.f2_sidx)
                    gc = mg_rb_interp(_gat(cc, iv, t.rb_coarse, t.rb_tmp),
                                      plan.ndim, plan.nc)
                    ghost = 0.5 * gc + 0.75 * fine1 - 0.25 * fine2
                elif rb_method == RB_PROLONG_COPY:
                    ghost = _gat(cc, iv, t.rb_parent, t.rb_pcopy)
                else:
                    raise ValueError(f"unknown rb method {rb_method}")
                emask = (None if rb_extrap_mask is None
                         else rb_extrap_mask.get(d))
                if emask is not None:
                    ghost = torch.where(emask[:, None],
                                        rb_extrap_ghost(cc, iv, t, plan.ndim),
                                        ghost)
                _scat(cc, iv, t.rb_ids, t.ghost_sidx, ghost)
    if corners:
        fill_corners_lvl(cc, plan, ivs)
    return cc


def fill_corners_lvl(cc, plan: GcLevelPlan, ivs):
    """Edge (3D) and corner ghost cells (af_gc_box_corner,
    ``m_af_ghostcell.f90:125-170``): copy from the diagonal neighbor when
    present, else the linear extrapolation a + b - c (an edge or a 2D
    corner) or a + b + c - 2 d (a 3D corner)."""
    for iv in ivs:
        corner_fill_flat(cc[int(iv)].view(-1), plan.corner_flat)
    return cc
