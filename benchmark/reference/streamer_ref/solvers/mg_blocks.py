"""FAS multigrid on per-level block arrays (1D, 2D and 3D).

The solve state lives in small per-level block arrays

* ``P[l]``: phi blocks ``[n_l] + [nc+2]^ndim`` (with ghost layer),
* ``R[l]``: rhs interiors ``[n_l] + [nc]^ndim``,

gathered from ``cc`` once per solve and scattered back once. Every ghost
exchange goes through the smoother's fill kernel and every smoothing half
sweep through its sweep kernels (ops/smoother.py). The cycle structure and
numerics are the reference's FAS V-cycle (``afivo/src/m_af_multigrid.f90``:
mg_fas_vcycle :185-264, update_coarse :691-738, correct_children
:624-646) and FAS full multigrid (mg_fas_fmg :137-180, set_coarse_phi_rhs
:741-777), including the edge and corner ghost fills of
``af_gc_box_corner`` (``m_af_ghostcell.f90:125-170``) as direct
block-index updates.

In a sharded run (parallel/halo.py) a level's arrays hold the rank's own
boxes and its halo (``Multigrid.rows``). The halo rows are refreshed from
their owners before every fill, before a restriction reads the children's
residuals, after the coarse level of a restriction is filled and after
each level of the upward pass; the level-1 solve runs on the whole level.
"""

from __future__ import annotations

import itertools
from typing import List, Optional

import numpy as np
import torch

from ..core import ghostcell as gc
from ..core import prolong_restrict as pr
from ..core.rowops import as_value
from ..ops import smoother as ks


class LevelBlockPlan:
    """Block-row index tables of one level for the block cycle: the
    rb-ghost coarse-strip rows in the coarse level's block array (and the
    parent rows and cells that the extrapolating rb ghosts copy), the
    edge- and corner-fill tables, the transfer tables between the level's
    blocks and their parents' (children in the order [parent, parity],
    with the cylindrical restriction weights) and the parent mask of the
    coarse level for the FAS rhs update.

    The block arrays hold the state rows ``mesh.level_rows(lvl)``. In a
    sharded run the tables cover the rank's own boxes: the restriction
    into its own parents, whose children may be halo rows, and the
    prolongation into its own children, whose parents may be halo rows."""

    def __init__(self, mesh, lvl: int):
        tree, device = mesh.tree, mesh.device
        nc, ndim = tree.nc, tree.ndim
        self.lvl, self.nc, self.ndim = lvl, nc, ndim
        rows = mesh.level_rows
        rows_l = rows(lvl)
        self.n = len(rows_l)
        pos_l = _posmap(tree, rows_l)
        plan = mesh.gc(lvl)
        S = (nc + 2) ** ndim

        def dev(a, dtype=torch.int64):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        # rb coarse-strip rows per direction
        self.rb_cpos = [None] * (2 * ndim)
        self.rb_tmp = [None] * (2 * ndim)
        self.rb_ppos = [None] * (2 * ndim)
        self.rb_pcopy = [None] * (2 * ndim)
        self.n_c = 0
        if lvl > 1:
            tb_c = mesh.tb(lvl - 1)
            rows_c = rows(lvl - 1)
            self.n_c = len(rows_c)
            pos_c = _posmap(tree, rows_c)
            for d, p in enumerate(plan.dirs):
                if len(p.rb_ids):
                    self.rb_cpos[d] = dev(pos_c[p.rb_coarse])
                    self.rb_tmp[d] = p.d.rb_tmp
                    self.rb_ppos[d] = dev(pos_c[p.rb_parent])
                    self.rb_pcopy[d] = p.d.rb_pcopy

        # all edge and corner groups as flat indices into the block array
        self.corners = gc.corner_tables(plan, pos_l, S, device)

        # transfer tables (children at lvl, parents at lvl-1): the child of
        # every parent for each parity in product order and the coarse
        # cells each child restricts into; the linear prolongation stencil
        # of all parities at once, applied to the parents of the level's
        # (own) boxes, and the row of each box's parity among its results
        self.parent_mask = None
        if lvl > 1:
            parents = np.asarray(tb_c.parents, np.int64)
            parities = list(itertools.product([0, 1], repeat=ndim))
            cidx = [sum(b << k for k, b in enumerate(q)) for q in parities]
            children = tree.children[parents][:, cidx].ravel()
            prp = mesh.pr(lvl)
            order = _posmap(tree, prp.ch)[children]
            par_c = np.repeat(pos_c[parents], len(parities))[:, None]
            tgt = prp.tgt[order]
            t_int = np.ravel_multi_index(
                [a - 1 for a in np.unravel_index(tgt, (nc + 2,) * ndim)],
                (nc,) * ndim)
            self.ch = dev(pos_l[children])
            self.r_tgt = dev(par_c * S + tgt)
            self.r_int = dev(par_c * nc ** ndim + t_int)
            tabs = [pr.parity_tables(ndim, nc, q) for q in parities]
            self.p_corners = [
                (w, dev(np.concatenate([t.corners[k][1] for t in tabs])))
                for k, (w, _s) in enumerate(tabs[0].corners)]
            self.cyl_w = (None if prp.cyl_w is None
                          else dev(prp.cyl_w[order], mesh.dtype))
            m = np.zeros(self.n_c, bool)
            m[pos_c[parents]] = True
            self.parent_mask = dev(m, torch.bool)
            own = np.asarray(mesh.tb(lvl).ids, np.int64)
            par_own, which = np.unique(tree.parent[own], return_inverse=True)
            code = sum((tree.ix[own][:, k] % 2) << (ndim - 1 - k)
                       for k in range(ndim))
            sel = which * len(parities) + code
            order = np.argsort(sel)
            self.pro_ch = dev(pos_l[own[order]])
            self.pro_par = dev(pos_c[par_own])
            # None where the boxes are every child of their parents (an
            # unsharded level, or no family split between ranks): then
            # they take every prolongated row, in order
            self.pro_sel = (None if len(own) == len(par_own) * len(parities)
                            else dev(sel[order]))


def _posmap(tree, ids) -> np.ndarray:
    """Box id -> row in the level's block array."""
    pos = np.full(int(tree.highest_id) + 1, -1, np.int64)
    pos[np.asarray(ids, np.int64)] = np.arange(len(ids))
    return pos


# ---------------------------------------------------------------------------
# block-array primitives
# ---------------------------------------------------------------------------
def _interior(nc: int, ndim: int):
    return (slice(None),) + (slice(1, nc + 1),) * ndim


def _shift(P, k: int, delta: int, nc: int, ndim: int):
    """Neighbor values of the interior of blocks P along dim k."""
    sl = [slice(1, nc + 1)] * ndim
    sl[k] = slice(1 + delta, nc + 1 + delta)
    return P[(slice(None),) + tuple(sl)]


def apply_cs(P, cs, nc: int):
    """Difference-form stencil apply on [n] + [C]^ndim blocks (see
    multigrid.LevelOp): L(phi) = c_sum phi0 + sum_d c_d (phi_d - phi_0)."""
    ndim = P.dim() - 1
    B0 = P[_interior(nc, ndim)]
    out = cs[:, 1 + 2 * ndim] * B0
    for d in range(2 * ndim):
        out = out + cs[:, 1 + d] * (
            _shift(P, d // 2, -1 if d % 2 == 0 else 1, nc, ndim) - B0)
    return out


def corner_fill_blocks(P, bp: LevelBlockPlan, nc: int):
    """Edge (3D) and corner ghost cells on [n] + [C]^ndim blocks
    (af_gc_box_corner): copy from the diagonal neighbor when present, else
    the linear extrapolation a + b - c (an edge or a 2D corner) or
    a + b + c - 2 d (a 3D corner). Updates P in place and returns it."""
    gc.corner_fill_flat(P.view(-1), bp.corners)
    return P


def restrict_to_parent(P_f, res_f, Pc, bp: LevelBlockPlan, nc: int):
    """FAS down-transfer (update_coarse, ``m_af_multigrid.f90:691-738``):
    restrict the smoothed fine phi into the parent interiors of ``Pc``
    (plain 2^ndim average) and the fine residual (cylindrical-volume-
    weighted, af_cyl_child_weights). Returns (Pc_updated, res_c) with res_c
    the restricted residual [n_c] + [nc]^ndim (zero outside parents). Sums
    run in the order of core/prolong_restrict.restrict (child bits over
    dims)."""
    hnc, ndim = nc // 2, bp.ndim
    m = len(bp.ch)

    def child_mean(X, w=None):
        # [m] + [nc]^ndim -> [m, hnc^ndim, 2^ndim], fine cells of each
        # coarse cell last, in child-bit order
        perm = ([0] + [1 + 2 * k for k in range(ndim)]
                + [2 + 2 * k for k in range(ndim)])
        I = X.reshape((m,) + (hnc, 2) * ndim).permute(perm).reshape(
            m, hnc ** ndim, 2 ** ndim)
        acc = 0.0
        for k, bits in enumerate(itertools.product([0, 1], repeat=ndim)):
            acc = acc + (I[..., k] if w is None
                         else w[..., bits[0]] * I[..., k])
        return acc / 2 ** ndim

    Pc = Pc.clone()
    Pc.view(-1)[bp.r_tgt] = child_mean(P_f[bp.ch][_interior(nc, ndim)])
    res_c = torch.zeros((bp.n_c,) + (nc,) * ndim, dtype=P_f.dtype,
                        device=P_f.device)
    w = None if bp.cyl_w is None else bp.cyl_w.to(P_f.dtype)
    res_c.view(-1)[bp.r_int] = child_mean(res_f[bp.ch], w)
    return Pc, res_c


def prolong_add_correction(P_f, corr_c, bp: LevelBlockPlan, nc: int):
    """phi += prolong(phi_c - phi_old_c) (correct_children,
    ``m_af_multigrid.f90:624-646``) with the linear 2^ndim-point
    prolongation (af_prolong_linear); corr_c is the full coarse block
    array incl. ghosts. Every parity of each parent of the level's (own)
    boxes is prolongated, and each box takes its own."""
    ndim = bp.ndim
    src = corr_c.flatten(1)[bp.pro_par]
    fine = 0.0
    for w, sidx in bp.p_corners:
        fine = fine + float(w) * src[:, sidx]
    fine = fine.reshape((-1,) + (nc,) * ndim)
    if bp.pro_sel is not None:
        fine = fine[bp.pro_sel]
    P_f = P_f.clone()
    P_f[(bp.pro_ch,) + _interior(nc, ndim)[1:]] += fine
    return P_f


# ---------------------------------------------------------------------------
# the cycles
# ---------------------------------------------------------------------------
def _exchange(mg, lvl: int, X):
    """A level's array with its halo rows from their owners (a sharded
    run; X itself otherwise)."""
    return mg.mesh.halo_blocks(X, lvl)


def gather_levels(mg, cc):
    """(P, R) per level from cc: the only full-state reads of a solve (in a
    sharded run after the halo rows of phi and rhs are refreshed)."""
    nc, ndim = mg.tree.nc, mg.tree.ndim
    block = (nc + 2,) * ndim
    mg.mesh.halo(cc, range(1, mg.n_levels + 1), [mg.i_phi, mg.i_rhs])
    P, R = [], []
    for l in range(1, mg.n_levels + 1):
        ids = mg.level_ids(l)
        P.append(cc[mg.i_phi, ids].reshape((len(ids),) + block))
        R.append(cc[mg.i_rhs, ids].reshape((len(ids),) + block)[
            _interior(nc, ndim)].contiguous())
    return P, R


def scatter_levels(mg, cc, P, R):
    """Write the per-level phi blocks and the rhs interiors (the FAS rhs of
    the parents) back: the only full-state writes of a solve."""
    nc, ndim = mg.tree.nc, mg.tree.ndim
    block = (nc + 2,) * ndim
    for l in range(1, mg.n_levels + 1):
        ids = mg.level_ids(l)
        cc[mg.i_phi, ids] = P[l - 1].flatten(1)
        Rb = cc[mg.i_rhs, ids].reshape((len(ids),) + block)
        Rb[_interior(nc, ndim)] = R[l - 1]
        cc[mg.i_rhs, ids] = Rb.flatten(1)
    return cc


def build_A_blocks(mg, lvl: int, Pc, params, dtype):
    """Ghost constants A [n, 2 ndim] + [nc]^(ndim-1) of one level:
    physical boundary values folded with the runtime voltage;
    mg_sides_rb coarse strips interpolated from the coarse block array
    ``Pc`` (``m_af_multigrid.f90:361-388``), or, for the extrapolating
    entries of boxes with variable eps, half the parent copy gathered from
    ``Pc`` (pallas_smoother.py PallasSmoother2D.build_consts :162-174)."""
    sm = mg.smoother(lvl)
    bp = mg.blocks(lvl)
    plan = mg.mesh.gc(lvl)
    nc, n, ndim = sm.nc, sm.n, sm.ndim
    F = nc ** (ndim - 1)
    device = sm.device
    bc_by_d = {d: gamma for d, _t, gamma in sm.bc_recipe}
    cols = []
    for d in range(2 * ndim):
        Ad = torch.zeros((n, F), dtype=dtype, device=device)
        gamma = bc_by_d.get(d, 0.0)
        if gamma != 0.0:
            p = plan.dirs[d]
            _, val = mg.sides_bc(mg.i_phi, d, p.bc_coords, params)
            nbc = len(sm.bc_pos[d])
            val = gamma * (as_value(val, Ad)
                           + torch.zeros((nbc, F), dtype=dtype,
                                         device=device))
            Ad.index_add_(0, sm.bc_pos[d], val)
        if d in sm.rb_dirs and Pc is not None:
            flat = Pc.flatten(1)
            contrib = 0.5 * gc.mg_rb_interp(
                flat[bp.rb_cpos[d][:, None], bp.rb_tmp[d]], ndim, nc)
            if sm.rb_extrap[d] is not None:
                pc = flat[bp.rb_ppos[d][:, None], bp.rb_pcopy[d]]
                contrib = torch.where(sm.rb_extrap[d][:, None], 0.5 * pc,
                                      contrib)
            Ad.index_add_(0, sm.rb_pos[d], contrib)
        cols.append(Ad)
    return torch.stack(cols, dim=1).reshape(
        (n, 2 * ndim) + (nc,) * (ndim - 1)).contiguous()


def rhs_with_boundary(mg, lvl: int, R_l, params):
    """The rhs of one level with the level-set boundary term:
    R + f bc_coeff phi_b on a level that holds an electrode boundary
    (stencil_gsrb_357 and the residual take the boundary potential
    ``params["lsf_phi_b"]`` into the rhs; pallas_smoother.py
    build_consts), else R itself."""
    corr = mg.corr(lvl, R_l.dtype)
    phi_b = float((params or {}).get("lsf_phi_b", 0.0))
    if corr is None or phi_b == 0.0:
        return R_l
    return R_l + corr * phi_b


def smooth_blocks(mg, lvl: int, P_l, R_l, A_l, cs_l, n_cycle: int,
                  up_cycle: bool):
    """gsrb_boxes on a level's block array (``m_af_multigrid.f90:648-687``):
    2 n_cycle (sweep, fill) half sweeps. In 2D that is sweep;
    [fill+sweep] ...; fill, i.e. K2, K1 for every interior pair, then K3;
    on a 2D level with extrapolating (parity-swap) ghosts K2 then K3-swap
    for every half sweep, as K1 has no swap terms; in 3D K4 then K5 for
    every half sweep; in 1D the tensor operations sweep_1d then fill_1d.
    Edge and corner ghosts are stored after the final upward half sweep."""
    sm = mg.smoother(lvl)
    masks = mg.parity_masks(2 * n_cycle)
    W = sm.W(P_l.dtype)
    # a sharded run refreshes the halo rows before every fill, which reads
    # the neighbors' interiors (K1, K3, K3-swap, K5)
    if sm.has_swap:
        for mask in masks:
            P_l = ks.sweep_2d(P_l, R_l, mask, sm.g, cs_l)
            P_l = ks.fill_2d_swap(_exchange(mg, lvl, P_l), A_l, sm.g, W)
    elif sm.ndim == 2:
        P_l = ks.sweep_2d(P_l, R_l, masks[0], sm.g, cs_l)
        for mask in masks[1:]:
            P_l = ks.fill_sweep_2d(_exchange(mg, lvl, P_l), R_l, mask, A_l,
                                   sm.g, W, cs_l)
        P_l = ks.fill_2d(_exchange(mg, lvl, P_l), A_l, sm.g, W)
    else:
        sweep, fill = ((ks.sweep_1d, ks.fill_1d) if sm.ndim == 1
                       else (ks.sweep_3d, ks.fill_3d))
        for mask in masks:
            P_l = sweep(P_l, R_l, mask, sm.g, cs_l)
            P_l = fill(_exchange(mg, lvl, P_l), A_l, sm.g, W)
    if up_cycle:
        P_l = corner_fill_blocks(P_l, mg.blocks(lvl), sm.nc)
    return P_l


def fill_blocks(mg, lvl: int, P_l, A_l):
    """Side ghosts (K3, or K3-swap on a level with extrapolating ghosts, in
    2D; K5 in 3D; fill_1d in 1D), then edges and corners, of one level's
    blocks (af_gc_tree on one level)."""
    sm = mg.smoother(lvl)
    fill = (ks.fill_2d_swap if sm.has_swap
            else {1: ks.fill_1d, 2: ks.fill_2d, 3: ks.fill_3d}[sm.ndim])
    P_l = fill(_exchange(mg, lvl, P_l), A_l, sm.g, sm.W(P_l.dtype))
    return corner_fill_blocks(P_l, mg.blocks(lvl), sm.nc)


def _A(mg, lvl, P, params, dtype):
    return build_A_blocks(mg, lvl, P[lvl - 2] if lvl > 1 else None, params,
                          dtype)


def _restrict_level(mg, l, P, R, params):
    """Restrict level l's phi and residual into level l-1 and set the FAS
    rhs of its parents: rhs_c = L(phi_c) + restrict(residual), with each
    level's operator carrying its own level-set boundary term."""
    nc = mg.tree.nc
    li = l - 1
    dtype = P[0].dtype
    res = rhs_with_boundary(mg, l, R[li], params) - apply_cs(
        P[li], mg.cs(l, dtype), nc)
    # sharded: the halo children's residuals from their owners (their
    # interiors are fresh since the last fill's exchange)
    res = _exchange(mg, l, res)
    Pc, res_c = restrict_to_parent(P[li], res, P[li - 1], mg.blocks(l), nc)
    Pc = fill_blocks(mg, l - 1, Pc, _A(mg, l - 1, P, params, dtype))
    # sharded: the halo rows with their owners' ghosts, for the coarse
    # strips and the correction of the upward pass
    Pc = _exchange(mg, l - 1, Pc)
    Lp = apply_cs(Pc, mg.cs(l - 1, dtype), nc)
    corr_c = mg.corr(l - 1, dtype)
    if corr_c is not None:
        Lp = Lp - corr_c * float(params.get("lsf_phi_b", 0.0))
    pm = mg.blocks(l).parent_mask.reshape((-1,) + (1,) * mg.tree.ndim)
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
        P[li] = smooth_blocks(mg, l, P[li],
                              rhs_with_boundary(mg, l, R[li], params),
                              _A(mg, l, P, params, dtype), mg.cs(l, dtype),
                              mg.n_cycle_down, False)
        _restrict_level(mg, l, P, R, params)
        tmp[li - 1] = P[li - 1]
    # coarse level
    P[0] = coarse_solve(mg, P[0], R[0], params)
    P[0] = _exchange(mg, 1, fill_blocks(mg, 1, P[0],
                                        _A(mg, 1, P, params, dtype)))
    # upward; sharded, each level ends with its halo rows refreshed, as the
    # next level's correction and coarse strips read them
    for l in range(2, L + 1):
        li = l - 1
        P[li] = prolong_add_correction(P[li], P[li - 1] - tmp[li - 1],
                                       mg.blocks(l), mg.tree.nc)
        A_l = _A(mg, l, P, params, dtype)
        P[li] = fill_blocks(mg, l, P[li], A_l)
        P[li] = _exchange(mg, l, smooth_blocks(
            mg, l, P[li], rhs_with_boundary(mg, l, R[li], params), A_l,
            mg.cs(l, dtype), mg.n_cycle_up, True))
    return P, R


def coarse_solve(mg, P1, R1, params):
    """The level-1 solve (solvers/coarse.py); in a sharded run on the whole
    level gathered on every rank, of which each keeps its rows."""
    return mg.mesh.whole_level(
        1, lambda P, R: mg.coarse_solver().solve_blocks(P, R, mg.i_phi,
                                                         params), P1, R1)


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


def max_leaf_residual_blocks(mg, P, R, params=None):
    """Max |rhs - L(phi)| over the leaves (af_tree_maxabs_cc of the
    residual) as a 0-d tensor; ``params`` carries the level-set boundary
    potential of a solve with an electrode."""
    dtype = P[0].dtype
    m = torch.zeros((), dtype=dtype, device=P[0].device)
    for l in range(1, mg.n_levels + 1):
        tb = mg.mesh.tb(l)
        if len(tb.leaves) == 0:
            continue
        res = rhs_with_boundary(mg, l, R[l - 1], params) - apply_cs(
            P[l - 1], mg.cs(l, dtype), mg.tree.nc)
        m = torch.maximum(m, res[tb.d.leaves_pos].abs().max())
    # sharded: the rank's own leaves, the maximum over the ranks (exact)
    return mg.mesh.reduce(m, "max")
