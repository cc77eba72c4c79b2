"""Streamer analysis routines.

Port of the JAX package's ``physics/analysis.py`` (the reference's
``src/m_analysis.f90``): local-maxima search (analysis_get_maxima
``:23-78``), the z-extent of the region where a variable exceeds a
threshold (analysis_zmin_zmax_threshold ``:81-149``), the maximum of a
variable restricted to boxes overlapping a region (analysis_max_var_region
``:153-198``), the maximum of a product of variables
(analysis_max_var_product ``:200-212``), and the axisymmetric
cross-section integrals (analysis_get_cross ``:218-281``), plus the point
interpolation they need (``afivo/src/m_af_interp.f90`` af_interp1 /
af_interp1_fc).

The state stays on its device: the searches are masked reductions over
each level's leaf blocks, and only their results come to the host. The
interpolations gather the few cells they weigh and combine them on the
host in the JAX package's order.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import constants as uc
from ..core import spatial as sp
from ..core.levels import MeshPlans
from ..core.reductions import leaf_extremum
from ..core.rowops import cc_get_interior, cc_rows, interior
from ..core.tree import Tree
from .transport_data import TD_MOBILITY


def get_id_at(tree: Tree, r: np.ndarray) -> int:
    """Leaf box id containing position r, or -1 outside the domain
    (af_get_id_at: the deepest existing box containing r is a leaf)."""
    nc = tree.nc
    r = np.asarray(r, np.float64)
    if np.any(r < tree.r_base) or \
            np.any(r >= tree.r_base + tree.domain_len):
        return -1
    for lvl in range(tree.highest_lvl, 0, -1):
        dr = tree.lvl_dr(lvl)
        bix = tuple(int(x) for x in ((r - tree.r_base) // (nc * dr)))
        bid = tree._ix_maps[lvl - 1].get(bix) if \
            lvl - 1 < len(tree._ix_maps) else None
        if bid is not None:
            return int(bid)
    return -1


def _corners(tree: Tree, points):
    """The multilinear stencil of each point: its box, the flat index and
    weight of its 2^ndim surrounding cell centres (one ghost layer used
    within half a cell of the box edge); None for a point outside."""
    ndim, nc = tree.ndim, tree.nc
    out = []
    for r in points:
        b = get_id_at(tree, r)
        if b < 0:
            out.append(None)
            continue
        dr = tree.lvl_dr(int(tree.lvl[b]))
        r0 = tree.box_r_min(np.asarray([b]))[0]
        ix = np.rint((np.asarray(r) - r0) / dr).astype(np.int64)  # 0..nc
        r_lo = r0 + (ix - 0.5) * dr
        dvec = (np.asarray(r) - r_lo) / dr
        ovec = 1.0 - dvec
        cells = []
        for corner in range(2 ** ndim):
            off = [(corner >> k) & 1 for k in range(ndim)]
            w = float(np.prod([dvec[k] if off[k] else ovec[k]
                               for k in range(ndim)]))
            cells.append((w, int(sp.cc_flat_nd(ndim, nc, ix + off))))
        out.append((b, cells))
    return out


def _interp_points(cc, tree: Tree, points, ivs: Sequence[int]):
    """af_interp1 at many points with one gather on the device: [n_points,
    len(ivs)] values and a flag per point."""
    stencils = _corners(tree, points)
    ok = np.array([s is not None for s in stencils])
    vals = np.zeros((len(stencils), len(ivs)))
    if not ok.any():
        return vals, ok
    boxes, flats = [], []
    for s in stencils:
        if s is not None:
            boxes += [s[0]] * len(s[1])
            flats += [f for _w, f in s[1]]
    dev = cc.device
    got = cc[torch.as_tensor(list(ivs), device=dev)[:, None],
             torch.as_tensor(boxes, device=dev)[None, :],
             torch.as_tensor(flats, device=dev)[None, :]]
    got = got.to(torch.float64).cpu().numpy()
    j = 0
    for p, s in enumerate(stencils):
        if s is None:
            continue
        for w, _f in s[1]:
            for i in range(len(ivs)):
                vals[p, i] += w * float(got[i, j])
            j += 1
    return vals, ok


def interp1(cc, tree: Tree, r, ivs: Sequence[int]
            ) -> Tuple[np.ndarray, bool]:
    """Multilinear interpolation of cc variables at point r (af_interp1).
    Uses one ghost layer when r is within half a cell of the box edge."""
    vals, ok = _interp_points(cc, tree, [np.asarray(r, np.float64)], ivs)
    return vals[0], bool(ok[0])


def _fc_points(fc, tree: Tree, points, ifc: int):
    """af_interp1_fc at many points with one gather: [n_points, ndim]."""
    ndim, nc = tree.ndim, tree.nc
    vals = np.zeros((len(points), ndim))
    ok = np.zeros(len(points), bool)
    rows, fracs = [], []
    for p, r in enumerate(points):
        b = get_id_at(tree, r)
        if b < 0:
            continue
        ok[p] = True
        dr = tree.lvl_dr(int(tree.lvl[b]))
        r0 = tree.box_r_min(np.asarray([b]))[0]
        ix_frac = (np.asarray(r) - r0) / dr  # 0..nc in face index space
        ix = np.clip(np.floor(ix_frac).astype(np.int64), 0, nc - 1)
        frac = ix_frac - ix
        for d in range(ndim):
            hi = ix.copy()
            hi[d] += 1
            flo, fhi = (int(sp.fc_flat(ndim, nc, *[np.array([int(a[k])])
                                                   for k in range(ndim)])[0])
                        for a in (ix, hi))
            rows.append((p, d, b, flo, fhi))
            fracs.append(frac[d])
    if rows:
        dev = fc.device
        tab = torch.as_tensor([[d, b, lo, hi] for _p, d, b, lo, hi in rows],
                              device=dev)
        lo = fc[ifc, tab[:, 0], tab[:, 1], tab[:, 2]]
        hi = fc[ifc, tab[:, 0], tab[:, 1], tab[:, 3]]
        got = torch.stack([lo, hi]).to(torch.float64).cpu().numpy()
        for j, ((p, d, *_), fr) in enumerate(zip(rows, fracs)):
            vals[p, d] = ((1 - fr) * float(got[0, j])
                          + fr * float(got[1, j]))
    return vals, ok


def interp1_fc(fc, tree: Tree, r, ifc: int) -> Tuple[np.ndarray, bool]:
    """Per-dimension linear interpolation of a face-centered field at r
    (af_interp1_fc)."""
    vals, ok = _fc_points(fc, tree, [np.asarray(r, np.float64)], ifc)
    return vals[0], bool(ok[0])


def _leaf_blocks(cc, mesh: MeshPlans, iv: int, lvl: int):
    """Whole blocks [n] + [nc+2]^ndim of a level's leaves."""
    t = mesh.tree
    return cc_rows(cc, iv, mesh.tb(lvl).d.leaves, t.nc, t.ndim)


def get_maxima(cc, mesh: MeshPlans, iv: int, threshold: float, n_max: int
               ) -> Tuple[np.ndarray, int]:
    """Local maxima of cc(iv) above a threshold: strictly larger than at
    least one face neighbor and not smaller than any
    (analysis_get_maxima). Returns (coord_val [n, ndim+1], n_found), in
    level order, then by box and cell."""
    t = mesh.tree
    nc, ndim = t.nc, t.ndim
    hits = []
    for lvl in range(1, t.highest_lvl + 1):
        tb = mesh.tb(lvl)
        if len(tb.leaves) == 0:
            continue
        B = _leaf_blocks(cc, mesh, iv, lvl)
        val = B[interior(nc, ndim)]
        ge_all = torch.ones_like(val, dtype=torch.bool)
        gt_any = torch.zeros_like(val, dtype=torch.bool)
        for d in range(ndim):
            for delta in (-1, 1):
                slc = [slice(1, nc + 1)] * ndim
                slc[d] = slice(1 + delta, nc + 1 + delta)
                nbv = B[(slice(None),) + tuple(slc)]
                ge_all &= val >= nbv
                gt_any |= val > nbv
        hit = (val > threshold) & ge_all & gt_any
        idx = torch.nonzero(hit)  # [k, 1 + ndim], row-major order
        hits.append((lvl, tb, torch.cat(
            [idx.to(val.dtype), val[hit][:, None]], 1)))
    if not hits:
        return np.zeros((0, ndim + 1)), 0
    host = torch.cat([h for _l, _tb, h in hits]).to(
        torch.float64).cpu().numpy()
    out, start = [], 0
    for lvl, tb, h in hits:
        k = h.shape[0]
        part = host[start:start + k]
        start += k
        if k == 0:
            continue
        boxes = part[:, 0].astype(np.int64)
        cell = part[:, 1:1 + ndim]
        r0 = t.box_r_min(np.asarray(tb.leaves)[boxes])
        out.append(np.concatenate(
            [r0 + (cell + 0.5) * t.lvl_dr(lvl), part[:, -1:]], 1))
    coord_val = (np.concatenate(out) if out
                 else np.zeros((0, ndim + 1)))
    return coord_val[:n_max].reshape(-1, ndim + 1), len(coord_val)


def zmin_zmax_threshold(cc, mesh: MeshPlans, iv: int, threshold: float,
                        limits: Sequence[float]) -> np.ndarray:
    """Min/max z coordinate where cc(iv) exceeds a threshold
    (analysis_zmin_zmax_threshold). As in the reference's box_minmax_z,
    *both* entries use the first above-threshold plane of each box
    (``m_analysis.f90:130-136``)."""
    t = mesh.tree
    nc, ndim = t.nc, t.ndim
    vec = np.array([limits[0], limits[1]], np.float64)
    lo, hi = [], []
    for lvl in range(1, t.highest_lvl + 1):
        tb = mesh.tb(lvl)
        if len(tb.leaves) == 0:
            continue
        val = _leaf_blocks(cc, mesh, iv, lvl)[interior(nc, ndim)]
        # max over the non-z dims -> [n, nc] planes along the last dim
        planes = (val.amax(dim=tuple(range(1, ndim))) if ndim > 1
                  else val)
        above = planes > threshold
        has = above.any(dim=1)
        first = above.to(torch.uint8).argmax(dim=1)  # first above plane
        z0 = mesh.cached(("leaf_z0", lvl), lambda: torch.as_tensor(
            t.box_r_min(np.asarray(tb.leaves))[:, ndim - 1],
            device=mesh.device), (lvl,))
        z_first = z0 + (first.to(torch.float64) + 0.5) * float(
            t.lvl_dr(lvl)[ndim - 1])
        lo.append(torch.where(has, z_first, 1e100).min())
        hi.append(torch.where(has, z_first, -1e100).max())
    acc = np.array([1e100, -1e100])
    if lo:
        host = torch.stack(lo + hi).cpu().numpy()
        for k in range(len(lo)):
            acc[0] = min(acc[0], float(host[k]))
            acc[1] = max(acc[1], float(host[len(lo) + k]))
    return np.array([min(vec[0], acc[0]) if acc[0] < 1e99 else vec[0],
                     max(vec[1], acc[1]) if acc[1] > -1e99 else vec[1]])


def _max_with_location(mesh: MeshPlans, values, select=None
                       ) -> Tuple[float, Optional[np.ndarray]]:
    """The largest of ``values(lvl, tb, sel)`` over the levels and its cell
    coordinates, where ``select(lvl, tb)`` picks the leaves (positions in
    ``tb.leaves``) of a level; (-1e100, None) where none is picked."""
    t = mesh.tree
    nc, ndim = t.nc, t.ndim
    picked = {}

    def vals_of(lvl, tb):
        sel = (np.arange(len(tb.leaves)) if select is None
               else select(lvl, tb))
        picked[lvl] = sel
        if len(sel) == 0:
            return None
        return values(lvl, tb, sel)

    found = leaf_extremum(mesh, vals_of)
    if found is None or found[0] <= -1e100:
        return -1e100, None
    best, lvl, row, k = found
    cell = np.asarray(np.unravel_index(k, (nc,) * ndim))
    b = int(mesh.tb(lvl).leaves[picked[lvl][row]])
    rb = t.box_r_min(np.asarray([b]))[0]
    return best, rb + (cell + 0.5) * t.lvl_dr(lvl)


def max_var_region(cc, mesh: MeshPlans, iv: int, r0, r1
                   ) -> Tuple[float, Optional[np.ndarray]]:
    """Max of cc(iv) over leaf boxes that (at least partially) overlap
    [r0, r1]; like the reference, the max is over the *whole* box
    (analysis_max_var_region). Returns (max, coords or None)."""
    t = mesh.tree
    nc, ndim = t.nc, t.ndim

    def select(lvl, tb):
        bmin = t.box_r_min(np.asarray(tb.leaves))
        bmax = bmin + nc * t.lvl_dr(lvl)
        inside = ~(np.any(bmin > np.asarray(r1), axis=1)
                   | np.any(bmax < np.asarray(r0), axis=1))
        return np.nonzero(inside)[0]

    def values(lvl, tb, sel):
        rows = torch.as_tensor(np.asarray(tb.leaves)[sel], dtype=torch.int64,
                               device=cc.device)
        return cc_get_interior(cc, iv, rows, nc, ndim)

    return _max_with_location(mesh, values, select)


def max_var_product(cc, mesh: MeshPlans, ivs: Sequence[int]
                    ) -> Tuple[float, Optional[np.ndarray]]:
    """Max of the product of variables over the leaves
    (analysis_max_var_product)."""
    t = mesh.tree

    def values(lvl, tb, sel):
        vals = None
        for iv in ivs:
            v = cc_get_interior(cc, iv, tb.d.leaves, t.nc, t.ndim)
            vals = v if vals is None else vals * v
        return vals

    return _max_with_location(mesh, values)


def get_cross(sim, rmax: float, z: float) -> Tuple[float, float, float]:
    """Axisymmetric cross-section integrals at height z up to radius rmax
    (analysis_get_cross): integrated electron density, charge density and
    conduction current density."""
    t = sim.tree
    if t.coord != "cyl":
        raise ValueError("analysis_get_cross: need cylindrical coordinates")
    if not sim.gas.constant_density:
        raise ValueError("analysis_get_cross: need constant gas density")
    N_inv = 1.0 / sim.gas.number_density
    dr = float(t.lvl_dr(t.highest_lvl).min())
    m = int(rmax / dr) + 1
    radii = [i * rmax / (m + 1) for i in range(1, m + 1)]
    points = [np.array([r, z]) for r in radii]
    vals, ok = _interp_points(sim.cc, t, points,
                              [sim.i_electron, sim.i_electric_fld,
                               sim.field.i_rhs])
    if not ok.all():
        raise RuntimeError("unsuccessful interp1")
    fvec, ok = _fc_points(sim.fc, t, points, sim.field.fc_E)
    if not ok.all():
        raise RuntimeError("unsuccessful interp1_fc")
    mus = sim.td.tbl.host_col(
        TD_MOBILITY, vals[:, 1] * uc.SI_to_Townsend * N_inv)
    elec_dens = charge_dens = current_dens = 0.0
    for i, r in enumerate(radii):
        ne, _fld, rhs = vals[i]
        Ez = fvec[i, 1]
        mu = float(mus[i]) * N_inv
        elec_dens += ne * 2 * np.pi * r * dr
        charge_dens += rhs * uc.eps0 * 2 * np.pi * r * dr / uc.elec_charge
        current_dens += Ez * mu * ne * 2 * np.pi * r * dr * uc.elem_charge
    return elec_dens, charge_dens, current_dens
