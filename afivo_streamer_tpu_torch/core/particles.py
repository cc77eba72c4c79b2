"""Particle <-> grid transfer over the boxes of a mesh.

Port of the JAX package's ``core/particles.py`` (the reference's
``afivo/src/m_af_particles.f90``: af_particles_to_grid ``:39-182``,
particles_to_grid_0 ``:184-235``, particles_to_grid_1 ``:239-320``,
tree_add_from_ghostcells ``:322-``; and af_interp1 of ``m_af_interp.f90``
for grid to particle): a level-by-level descent to the containing leaf,
deposits of zeroth or bi/tri-linear order with the ghost-layer spill
folded back onto the same-level neighbor, and a linear gather back.

The boxes and cells of the particles are found on the host, where the
tree is; the deposit (``index_put_`` with accumulation) and the gather run
on the device of the state ``cc``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import spatial as sp
from .tree import NO_BOX, Tree


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float64).cpu().numpy()
    return np.asarray(a, np.float64)


def locate(tree: Tree, r, max_lvl: Optional[int] = None) -> np.ndarray:
    """The containing leaf box id of each particle (af_get_id), by a
    level-by-level descent through ``tree.children``; -1 outside the
    domain. ``max_lvl`` stops the descent early."""
    r = _host(r).reshape(-1, tree.ndim)
    n = len(r)
    ids = np.full(n, -1, np.int64)
    inside = np.all((r >= tree.r_base)
                    & (r < tree.r_base + tree.domain_len), axis=1)
    if not inside.any():
        return ids
    nc = tree.nc
    dr1 = tree.lvl_dr(1)
    cgs = np.asarray(tree.coarse_grid_size) // nc
    bix = ((r - tree.r_base) // (nc * dr1)).astype(np.int64)
    bix = np.clip(bix, 0, cgs - 1)
    lvl1 = {tuple(int(x) for x in tree.ix[int(b)]): int(b)
            for b in tree.lvl_ids[0]}
    for k in np.nonzero(inside)[0]:
        ids[k] = lvl1.get(tuple(int(x) for x in bix[k]), -1)
    lvl_cap = tree.highest_lvl if max_lvl is None else int(max_lvl)
    active = ids >= 0
    lvl = 1
    while active.any() and lvl < lvl_cap:
        sel = np.nonzero(active)[0]
        cur = ids[sel]
        sel = sel[tree.children[cur, 0] != NO_BOX]
        if len(sel) == 0:
            break
        cur = ids[sel]
        mid = tree.box_r_min(cur) + 0.5 * nc * tree.lvl_dr(lvl)
        oct_ix = ((r[sel] >= mid) << np.arange(tree.ndim)).sum(axis=1)
        ids[sel] = tree.children[cur, oct_ix]
        mask = np.zeros(len(ids), bool)
        mask[sel] = True
        active = active & mask
        lvl += 1
    return ids


def _deposit(cc, iv: int, bid, flat, w) -> None:
    dev = cc.device
    cc[iv].index_put_(
        (torch.as_tensor(np.asarray(bid, np.int64), device=dev),
         torch.as_tensor(np.asarray(flat, np.int64), device=dev)),
        torch.as_tensor(w, dtype=cc.dtype, device=dev), accumulate=True)


def particles_to_grid(cc, tree: Tree, iv: int, r, w, order: int = 0,
                      density: bool = True, max_lvl: Optional[int] = None):
    """Deposit weighted particles into cc[iv] (af_particles_to_grid), in
    place. Order 0 adds to the containing cell; order 1 spreads over the
    2^ndim surrounding cell centres, and what lands in a ghost layer goes
    to the same-level neighbor (tree_add_from_ghostcells), or to the edge
    cell at a physical boundary. With ``density`` the weights are divided
    by the cell volume (cylindrical volumes in cylindrical coordinates)."""
    ndim, nc = tree.ndim, tree.nc
    r = _host(r).reshape(-1, ndim)
    w = np.broadcast_to(_host(w), (len(r),))
    ids = locate(tree, r, max_lvl=max_lvl)
    ok = ids >= 0
    if not ok.any():
        return cc
    ids, r, w = ids[ok], r[ok], w[ok]
    lvls = tree.lvl[ids]
    r0 = tree.box_r_min(ids)
    drs = np.stack([tree.lvl_dr(int(l)) for l in lvls])

    if order == 0:
        cell = np.clip(((r - r0) / drs).astype(np.int64), 0, nc - 1)
        if density:
            w = w / _cell_volume(tree, ids, cell, drs)
        _deposit(cc, iv, ids, sp.cc_flat_nd(ndim, nc, cell + 1), w)
        return cc

    if order != 1:
        raise ValueError("order must be 0 or 1")
    if tree.coord == "cyl" and density:
        raise ValueError("cyl + density needs order 0 (reference "
                         "particles_to_grid_1 has the same restriction)")
    tmp = (r - r0) / drs + 0.5
    ix = np.floor(tmp).astype(np.int64)          # 1-based lower cell
    wu = tmp - ix
    wl = 1.0 - wu
    if density:
        w = w / np.prod(drs, axis=1)
    for corner in range(2 ** ndim):
        off = np.array([(corner >> d) & 1 for d in range(ndim)])
        cw = w.copy()
        for d in range(ndim):
            cw = cw * (wu[:, d] if off[d] else wl[:, d])
        bid = ids.copy()
        cellpos = ix + off  # 1-based, ghost layer included
        for d in range(ndim):
            for hi, side in ((False, 2 * d), (True, 2 * d + 1)):
                out = cellpos[:, d] > nc if hi else cellpos[:, d] < 1
                if not out.any():
                    continue
                nb = tree.neighbors[bid[out], side]
                take = nb >= 0
                sub = np.nonzero(out)[0]
                bid[sub[take]] = nb[take]
                cellpos[sub[take], d] += -nc if hi else nc
                cellpos[sub[~take], d] = nc if hi else 1
        _deposit(cc, iv, bid, sp.cc_flat_nd(ndim, nc, cellpos), cw)
    return cc


def grid_to_particles(cc, tree: Tree, iv: int, r) -> torch.Tensor:
    """Bi/tri-linear interpolation of cc[iv] at the particle positions
    (af_interp1), with the ghost layer; 0 outside the domain. One gather
    on the device of ``cc``; the values are returned there."""
    ndim, nc = tree.ndim, tree.nc
    r = _host(r).reshape(-1, ndim)
    ids = locate(tree, r)
    out = torch.zeros(len(r), dtype=cc.dtype, device=cc.device)
    sel = np.nonzero(ids >= 0)[0]
    if len(sel) == 0:
        return out
    bid = ids[sel]
    r0 = tree.box_r_min(bid)
    drs = np.stack([tree.lvl_dr(int(l)) for l in tree.lvl[bid]])
    tmp = (r[sel] - r0) / drs + 0.5
    ix = np.floor(tmp).astype(np.int64)
    wu = tmp - ix
    wl = 1.0 - wu
    dev = cc.device
    bid_t = torch.as_tensor(bid, device=dev)
    acc = torch.zeros(len(sel), dtype=cc.dtype, device=dev)
    for corner in range(2 ** ndim):
        off = np.array([(corner >> d) & 1 for d in range(ndim)])
        cw = np.ones(len(sel))
        for d in range(ndim):
            cw = cw * (wu[:, d] if off[d] else wl[:, d])
        flat = sp.cc_flat_nd(ndim, nc, np.clip(ix + off, 0, nc + 1))
        acc = acc + torch.as_tensor(cw, dtype=cc.dtype, device=dev) * cc[
            iv, bid_t, torch.as_tensor(flat.astype(np.int64), device=dev)]
    out[torch.as_tensor(sel, device=dev)] = acc
    return out


def _cell_volume(tree: Tree, ids, cell, drs) -> np.ndarray:
    """Cell volumes for density deposits (af_cyl_volume_cc in
    cylindrical coordinates)."""
    if tree.coord == "cyl":
        r0 = tree.box_r_min(ids)[:, 0]
        r_cc = r0 + (cell[:, 0] + 0.5) * drs[:, 0]
        return 2.0 * np.pi * r_cc * np.prod(drs, axis=1)
    return np.prod(drs, axis=1)
