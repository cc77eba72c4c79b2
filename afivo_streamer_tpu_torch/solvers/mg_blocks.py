"""FAS multigrid on per-level block arrays (2D).

The solve state lives in small per-level block arrays

* ``P[l]``: phi blocks ``[n_l, nc+2, nc+2]`` (with ghost layer),
* ``R[l]``: rhs interiors ``[n_l, nc, nc]``,

gathered from ``cc`` once per solve and scattered back once. Every ghost
exchange goes through the smoother's fill kernel and every smoothing half
sweep through its sweep kernels (ops/smoother.py). The cycle structure and
numerics are the reference's FAS V-cycle (``afivo/src/m_af_multigrid.f90``:
mg_fas_vcycle :185-264, update_coarse :691-738, correct_children
:624-646) and FAS full multigrid (mg_fas_fmg :137-180, set_coarse_phi_rhs
:741-777), including the corner ghost fills of ``af_gc_box_corner``
(``m_af_ghostcell.f90:125-170``) as direct block-index updates.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core import ghostcell as gc
from ..core import prolong_restrict as pr
from ..core import spatial as sp
from ..core.rowops import as_value
from ..ops import smoother as ks


class LevelBlockPlan:
    """Block-row index tables of one level for the block cycle: the
    rb-ghost coarse-strip rows in the coarse level's block array, the
    corner-fill row tables, the parity-grouped (parent-row, child-row)
    transfer tables with the cylindrical restriction weights, and the
    parent mask of the coarse level for the FAS rhs update."""

    def __init__(self, mesh, lvl: int):
        tree, device = mesh.tree, mesh.device
        self.lvl, self.nc = lvl, tree.nc
        tb_l = mesh.tb(lvl)
        self.n = len(tb_l.ids)
        pos_l = _posmap(tree, tb_l.ids)
        plan = mesh.gc(lvl)

        # rb coarse-strip rows per direction
        self.rb_cpos = [None] * 4
        self.rb_tmp = [None] * 4
        self.n_c = 0
        if lvl > 1:
            tb_c = mesh.tb(lvl - 1)
            self.n_c = len(tb_c.ids)
            pos_c = _posmap(tree, tb_c.ids)
            for d, p in enumerate(plan.dirs):
                if len(p.rb_ids):
                    self.rb_cpos[d] = torch.as_tensor(
                        pos_c[p.rb_coarse], dtype=torch.int64, device=device)
                    self.rb_tmp[d] = p.d.rb_tmp

        # corner-fill tables
        self.c_rows, self.c_nb, self.c_ext = [], [], []
        for pl in plan.corner_plans:
            for name, lst in (("copy_ids", self.c_rows),
                              ("copy_nb", self.c_nb),
                              ("ext_ids", self.c_ext)):
                lst.append(torch.as_tensor(pos_l[pl[name]],
                                           dtype=torch.int64, device=device))

        # parity-grouped transfer tables (children at lvl, parents at lvl-1)
        self.groups = []
        self.parent_mask = None
        if lvl > 1:
            for tb, par, ch, cyl_w, _g in mesh.pr(lvl).groups:
                self.groups.append((
                    tb.parity,
                    torch.as_tensor(pos_c[par], dtype=torch.int64,
                                    device=device),
                    torch.as_tensor(pos_l[ch], dtype=torch.int64,
                                    device=device),
                    None if cyl_w is None else torch.as_tensor(
                        cyl_w, dtype=torch.float64, device=device)))
            m = np.zeros(self.n_c, bool)
            m[pos_c[tb_c.parents]] = True
            self.parent_mask = torch.as_tensor(m, dtype=torch.bool,
                                               device=device)


def _posmap(tree, ids) -> np.ndarray:
    """Box id -> row in the level's block array."""
    pos = np.full(int(tree.highest_id) + 1, -1, np.int64)
    pos[np.asarray(ids, np.int64)] = np.arange(len(ids))
    return pos


# ---------------------------------------------------------------------------
# block-array primitives
# ---------------------------------------------------------------------------
def apply_cs(P, cs, nc: int):
    """Difference-form stencil apply on [n, C, C] blocks (see
    multigrid.LevelOp): L(phi) = c_sum phi0 + sum_d c_d (phi_d - phi_0)."""
    B0 = P[:, 1:nc + 1, 1:nc + 1]
    return (cs[:, 5] * B0
            + cs[:, 1] * (P[:, 0:nc, 1:nc + 1] - B0)
            + cs[:, 2] * (P[:, 2:nc + 2, 1:nc + 1] - B0)
            + cs[:, 3] * (P[:, 1:nc + 1, 0:nc] - B0)
            + cs[:, 4] * (P[:, 1:nc + 1, 2:nc + 2] - B0))


def corner_fill_blocks(P, bp: LevelBlockPlan, nc: int):
    """Corner ghost cells on [n, C, C] blocks (af_gc_box_corner): copy from
    the diagonal neighbor when present, else the linear extrapolation
    a + b - c. Updates P in place and returns it."""
    for gi, (pos, di) in enumerate(sp.corner_list(2, nc)):
        i0, j0 = int(pos[0]), int(pos[1])
        d0, d1 = int(di[0]), int(di[1])
        rows, nbr, erows = bp.c_rows[gi], bp.c_nb[gi], bp.c_ext[gi]
        if len(rows):
            ni = nc if i0 == 0 else 1
            nj = nc if j0 == 0 else 1
            P[rows, i0, j0] = P[nbr, ni, nj]
        if len(erows):
            P[erows, i0, j0] = (P[erows, i0 + d0, j0] + P[erows, i0, j0 + d1]
                                - P[erows, i0 + d0, j0 + d1])
    return P


def restrict_to_parent(P_f, res_f, Pc, bp: LevelBlockPlan, nc: int):
    """FAS down-transfer (update_coarse, ``m_af_multigrid.f90:691-738``):
    restrict the smoothed fine phi into the parent interiors of ``Pc``
    (plain 2^d average) and the fine residual (cylindrical-volume-weighted,
    af_cyl_child_weights). Returns (Pc_updated, res_c) with res_c the
    restricted residual [n_c, nc, nc] (zero outside parents). Sums run in
    the order of core/prolong_restrict.restrict."""
    hnc = nc // 2
    Pc = Pc.clone()
    res_c = torch.zeros((bp.n_c, nc, nc), dtype=P_f.dtype, device=P_f.device)
    phi_f = P_f[:, 1:nc + 1, 1:nc + 1]
    for (q0, q1), par, ch, cylw in bp.groups:
        # fine interiors as (box, i_r, a, i_z, b): coarse cell (i_r, i_z),
        # child bits (a, b) along (r, z)
        I = phi_f[ch].reshape(-1, hnc, 2, hnc, 2)
        vals = (I[:, :, 0, :, 0] + I[:, :, 0, :, 1] + I[:, :, 1, :, 0]
                + I[:, :, 1, :, 1]) / 4.0
        rsl = slice(1 + q0 * hnc, 1 + (q0 + 1) * hnc)
        zsl = slice(1 + q1 * hnc, 1 + (q1 + 1) * hnc)
        Pc[par, rsl, zsl] = vals
        Ir = res_f[ch].reshape(-1, hnc, 2, hnc, 2)
        if cylw is not None:
            w = cylw.to(P_f.dtype).reshape(-1, hnc, hnc, 2)
            rvals = (w[..., 0] * Ir[:, :, 0, :, 0] + w[..., 0] * Ir[:, :, 0, :, 1]
                     + w[..., 1] * Ir[:, :, 1, :, 0]
                     + w[..., 1] * Ir[:, :, 1, :, 1]) / 4.0
        else:
            rvals = (Ir[:, :, 0, :, 0] + Ir[:, :, 0, :, 1] + Ir[:, :, 1, :, 0]
                     + Ir[:, :, 1, :, 1]) / 4.0
        res_c[par, q0 * hnc:(q0 + 1) * hnc, q1 * hnc:(q1 + 1) * hnc] = rvals
    return Pc, res_c


def prolong_add_correction(P_f, corr_c, bp: LevelBlockPlan, nc: int):
    """phi += prolong(phi_c - phi_old_c) (correct_children,
    ``m_af_multigrid.f90:624-646``) with the linear 4-point prolongation
    (af_prolong_linear); corr_c is the full coarse block array incl.
    ghosts."""
    C = nc + 2
    corr_flat = corr_c.reshape(-1, C * C)
    P_f = P_f.clone()
    for parity, par, ch, _w in bp.groups:
        tb = pr.parity_tables(2, nc, parity, P_f.device)
        src = corr_flat[par]
        fine = 0.0
        for w, sidx in tb.d.corners:
            fine = fine + float(w) * src[:, sidx]
        P_f[ch, 1:nc + 1, 1:nc + 1] += fine.reshape(-1, nc, nc)
    return P_f


# ---------------------------------------------------------------------------
# the cycles
# ---------------------------------------------------------------------------
def gather_levels(mg, cc):
    """(P, R) per level from cc: the only full-state reads of a solve."""
    nc = mg.tree.nc
    C = nc + 2
    P, R = [], []
    for l in range(1, mg.n_levels + 1):
        ids = mg.mesh.tb(l).d.ids
        P.append(cc[mg.i_phi, ids].reshape(len(ids), C, C))
        R.append(cc[mg.i_rhs, ids].reshape(len(ids), C, C)[
            :, 1:nc + 1, 1:nc + 1].contiguous())
    return P, R


def scatter_levels(mg, cc, P, R):
    """Write the per-level phi blocks and the rhs interiors (the FAS rhs of
    the parents) back: the only full-state writes of a solve."""
    nc = mg.tree.nc
    C = nc + 2
    for l in range(1, mg.n_levels + 1):
        ids = mg.mesh.tb(l).d.ids
        cc[mg.i_phi, ids] = P[l - 1].reshape(len(ids), -1)
        Rb = cc[mg.i_rhs, ids].reshape(len(ids), C, C)
        Rb[:, 1:nc + 1, 1:nc + 1] = R[l - 1]
        cc[mg.i_rhs, ids] = Rb.reshape(len(ids), -1)
    return cc


def build_A_blocks(mg, lvl: int, Pc, params, dtype):
    """Ghost constants A [n, 4, nc] of one level: physical boundary values
    folded with the runtime voltage; mg_sides_rb coarse strips
    interpolated from the coarse block array ``Pc``
    (``m_af_multigrid.f90:361-388``)."""
    sm = mg.smoother(lvl)
    bp = mg.blocks(lvl)
    plan = mg.mesh.gc(lvl)
    nc, n = sm.nc, sm.n
    C = nc + 2
    device = sm.device
    bc_by_d = {d: gamma for d, _t, gamma in sm.bc_recipe}
    cols = []
    for d in range(4):
        Ad = torch.zeros((n, nc), dtype=dtype, device=device)
        gamma = bc_by_d.get(d, 0.0)
        if gamma != 0.0:
            p = plan.dirs[d]
            _, val = mg.sides_bc(mg.i_phi, d, p.bc_coords, params)
            nbc = len(sm.bc_pos[d])
            val = gamma * (as_value(val, Ad)
                           + torch.zeros((nbc, nc), dtype=dtype,
                                         device=device))
            Ad.index_add_(0, sm.bc_pos[d], val)
        if d in sm.rb_dirs and Pc is not None:
            strips = Pc.reshape(-1, C * C)[bp.rb_cpos[d][:, None],
                                           bp.rb_tmp[d]]
            Ad.index_add_(0, sm.rb_pos[d], 0.5 * gc.mg_rb_interp(strips, nc))
        cols.append(Ad)
    return torch.stack(cols, dim=1).contiguous()


def smooth_blocks(mg, lvl: int, P_l, R_l, A_l, cs_l, n_cycle: int,
                  up_cycle: bool):
    """gsrb_boxes on a level's block array (``m_af_multigrid.f90:648-687``):
    the (sweep, fill) x 2 n_cycle sequence as sweep; [fill+sweep] ...;
    fill, i.e. K2, K1 for every interior pair, then K3. Corner ghosts are
    stored after the final upward half sweep."""
    sm = mg.smoother(lvl)
    masks = mg.parity_masks(2 * n_cycle)
    W = sm.W(P_l.dtype)
    P_l = ks.sweep_2d(P_l, R_l, masks[0], sm.g, cs_l)
    for mask in masks[1:]:
        P_l = ks.fill_sweep_2d(P_l, R_l, mask, A_l, sm.g, W, cs_l)
    P_l = ks.fill_2d(P_l, A_l, sm.g, W)
    if up_cycle:
        P_l = corner_fill_blocks(P_l, mg.blocks(lvl), sm.nc)
    return P_l


def fill_blocks(mg, lvl: int, P_l, A_l):
    """Side ghosts (K3) and corners of one level's blocks (af_gc_tree on
    one level)."""
    sm = mg.smoother(lvl)
    P_l = ks.fill_2d(P_l, A_l, sm.g, sm.W(P_l.dtype))
    return corner_fill_blocks(P_l, mg.blocks(lvl), sm.nc)


def _A(mg, lvl, P, params, dtype):
    return build_A_blocks(mg, lvl, P[lvl - 2] if lvl > 1 else None, params,
                          dtype)


def _restrict_level(mg, l, P, R, params):
    """Restrict level l's phi and residual into level l-1 and set the FAS
    rhs of its parents: rhs_c = L(phi_c) + restrict(residual)."""
    nc = mg.tree.nc
    li = l - 1
    dtype = P[0].dtype
    res = R[li] - apply_cs(P[li], mg.cs(l, dtype), nc)
    Pc, res_c = restrict_to_parent(P[li], res, P[li - 1], mg.blocks(l), nc)
    Pc = fill_blocks(mg, l - 1, Pc, _A(mg, l - 1, P, params, dtype))
    Lp = apply_cs(Pc, mg.cs(l - 1, dtype), nc)
    pm = mg.blocks(l).parent_mask[:, None, None]
    R[li - 1] = torch.where(pm, Lp + res_c, R[li - 1])
    P[li - 1] = Pc


def fas_vcycle_blocks(mg, P, R, params, top: Optional[int] = None):
    """One FAS V-cycle up to level ``top`` (mg_fas_vcycle,
    ``m_af_multigrid.f90:185-264``) on the block lists P, R (updated in
    place and returned)."""
    L = top or mg.n_levels
    dtype = P[0].dtype
    tmp: List = [None] * L
    for l in range(L, 1, -1):
        li = l - 1
        P[li] = smooth_blocks(mg, l, P[li], R[li], _A(mg, l, P, params, dtype),
                              mg.cs(l, dtype), mg.n_cycle_down, False)
        _restrict_level(mg, l, P, R, params)
        tmp[li - 1] = P[li - 1]
    # coarse level
    P[0] = mg.coarse_solver().solve_blocks(P[0], R[0], mg.i_phi, params)
    P[0] = fill_blocks(mg, 1, P[0], _A(mg, 1, P, params, dtype))
    # upward
    for l in range(2, L + 1):
        li = l - 1
        P[li] = prolong_add_correction(P[li], P[li - 1] - tmp[li - 1],
                                       mg.blocks(l), mg.tree.nc)
        A_l = _A(mg, l, P, params, dtype)
        P[li] = fill_blocks(mg, l, P[li], A_l)
        P[li] = smooth_blocks(mg, l, P[li], R[li], A_l, mg.cs(l, dtype),
                              mg.n_cycle_up, True)
    return P, R


def fas_fmg_blocks(mg, P, R, params):
    """One FAS full-multigrid cycle with the current phi as the guess
    (mg_fas_fmg with have_guess, ``m_af_multigrid.f90:137-180`` and
    set_coarse_phi_rhs ``:741-777``)."""
    L = mg.n_levels
    dtype = P[0].dtype
    for l in range(L, 1, -1):
        if l == L:
            P[l - 1] = fill_blocks(mg, l, P[l - 1],
                                   _A(mg, l, P, params, dtype))
        _restrict_level(mg, l, P, R, params)
    old: List = [None] * L
    old[0] = P[0]
    P, R = fas_vcycle_blocks(mg, P, R, params, top=1)
    for l in range(2, L + 1):
        li = l - 1
        old[li] = P[li]
        P[li] = prolong_add_correction(P[li], P[li - 1] - old[li - 1],
                                       mg.blocks(l), mg.tree.nc)
        P[li] = fill_blocks(mg, l, P[li], _A(mg, l, P, params, dtype))
        P, R = fas_vcycle_blocks(mg, P, R, params, top=l)
    return P, R


def max_leaf_residual_blocks(mg, P, R):
    """Max |rhs - L(phi)| over the leaves (af_tree_maxabs_cc of the
    residual) as a 0-d tensor."""
    dtype = P[0].dtype
    m = torch.zeros((), dtype=dtype, device=P[0].device)
    for l in range(1, mg.n_levels + 1):
        tb = mg.mesh.tb(l)
        if len(tb.leaves) == 0:
            continue
        res = R[l - 1] - apply_cs(P[l - 1], mg.cs(l, dtype), mg.tree.nc)
        m = torch.maximum(m, res[tb.d.leaves_pos].abs().max())
    return m
