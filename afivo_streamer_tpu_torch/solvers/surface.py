"""Surface grids on dielectric boundaries.

Re-implements the reference's ``afivo/src/m_af_surface.f90``: surfaces live
on box faces where the permittivity jumps (surface_initialize ``:89-172``),
store per-face densities (photon flux, surface charge and its time-state
copies), deposit surface charge into the Poisson rhs split between the gas
and dielectric side (surface_charge_to_rhs ``:514-566``), correct the
face-centered field from sigma (surface_correct_field_fc ``:629-727``),
follow refinement by prolongation/restriction of the surface data
(``:327-467``), and provide refinement links so the mesh never jumps across
a surface (surface_get_refinement_links ``:472-491``).

The topology (which box pairs form a surface, their parents and offsets)
is kept on the host and changes only at refinement epochs. The surface
state lives in cc variables stored at the gas-side box row (its first
nc^(ndim-1) entries), so the state copies and restores of the time step
carry it like any other variable; ``SurfaceTables`` holds the per-direction
index and weight tables of the active surfaces on the device.

In a sharded run (parallel/halo.py) the topology stays replicated in box
ids, and the state lives in the rows of the rank that owns the gas-side
box. A rank works the gas side of the surfaces whose gas-side box it owns
and the dielectric side of those whose dielectric-side box it owns; the
latter reads the surface charge from the gas-side row, which the halo
exchange brings (the two boxes are same-level neighbors). A relayout moves
the state rows with the box rows; the refinement update gathers the state
of every surface before the relayout and writes back each rank's share
after it. The writers see the whole tree (Simulation.full_view), where the
tables address box ids again.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import spatial as sp
from ..core.tree import Tree, neighb_dim, neighb_low


def dir_statics(ndim: int, nc: int, d: int) -> dict:
    """Flat-index tables of one surface direction: the gas/dielectric cell
    layers next to the surface, the shared face on both boxes, and the
    ghost layers toward the surface."""
    dim, low = neighb_dim(d), neighb_low(d)

    def cc_layer(i):
        return sp.cc_flat(ndim, nc, *[
            np.array([i]) if k == dim else np.arange(1, nc + 1)
            for k in range(ndim)])

    def fc_layer(i):
        return sp.fc_flat(ndim, nc, *[
            np.array([i]) if k == dim else np.arange(0, nc)
            for k in range(ndim)])
    return dict(dim=dim, low=low,
                gas=cc_layer(1 if low else nc), die=cc_layer(nc if low else 1),
                g_ghost=cc_layer(0 if low else nc + 1),
                i_ghost=cc_layer(nc + 1 if low else 0),
                fo=fc_layer(0 if low else nc), fi=fc_layer(nc if low else 0))


@dataclass
class Surface:
    in_use: bool
    id_in: int      #: box inside the dielectric
    id_out: int     #: box outside (gas side); its cc row holds the state
    direction: int  #: neighbor direction of the *outside* box toward inside
    eps: float
    ix_parent: int = -1
    offset_parent: Optional[np.ndarray] = None


class SurfaceTables:
    """Per-direction device tables of the active surfaces: gas-side rows
    ``rows_out``, dielectric-side rows ``rows_in``, 1/dr normal to the
    surface ``inv_dr`` and the permittivity ``eps`` (float64), the state's
    entries ``fidx`` in a row, and the flat-index tables of
    ``dir_statics``. ``dirs`` holds the surfaces whose gas side this rank
    works, ``dirs_in`` those whose dielectric side it works: both all of
    them unless ``layout`` (a sharded run's parallel/halo.Layout) is set,
    and then its own gas-side, or dielectric-side, boxes, in its rows."""

    def __init__(self, surfaces: "Surfaces", device, layout=None):
        t = surfaces.tree
        self.dirs, self.dirs_in = [], []
        for d in range(2 * t.ndim):
            ss = [s for s in surfaces.active() if s.direction == d]
            if not ss:
                continue
            out = np.array([s.id_out for s in ss], np.int64)
            inn = np.array([s.id_in for s in ss], np.int64)
            if layout is None:
                tab = self._table(t, ss, d, out, inn, device)
                self.dirs.append(tab)
                self.dirs_in.append(tab)
                continue
            rank, cap = layout.rank, layout.cap
            for side, ids in ((self.dirs, out), (self.dirs_in, inn)):
                mine = layout.shards.owner(ids, cap) == rank
                if mine.any():
                    sel = np.nonzero(mine)[0]
                    side.append(self._table(
                        t, [ss[k] for k in sel], d, layout.row_of[out[sel]],
                        layout.row_of[inn[sel]], device))

    @staticmethod
    def _table(t, ss, d, rows_out, rows_in, device):
        dim = neighb_dim(d)
        st = dir_statics(t.ndim, t.nc, d)
        arrays = dict(
            rows_out=np.asarray(rows_out, np.int64),
            rows_in=np.asarray(rows_in, np.int64),
            inv_dr=np.array([1.0 / t.lvl_dr(int(t.lvl[s.id_out]))[dim]
                             for s in ss]),
            eps=np.array([s.eps for s in ss]),
            fidx=np.arange(t.nc ** (t.ndim - 1)),
            **{k: v for k, v in st.items() if isinstance(v, np.ndarray)})
        tab = sp.device_copy(arrays, device)
        tab.d, tab.dim, tab.low = d, dim, st["low"]
        return tab


class Surfaces:
    """The surfaces of the mesh and their state rows in cc:
    ``i_photon`` (photon flux) and ``i_sigma`` + k (surface charge, time
    state k)."""

    def __init__(self, tree: Tree, eps, i_photon: int, i_sigma: int,
                 n_sigma: int, mesh_fn=None):
        """eps: host array [n_boxes, m] of the permittivity by box id,
        its (nc+2)^ndim cells or their median (surface_initialize: a box
        pair forms a surface where the median eps jumps from <= 1 on the
        gas side). ``mesh_fn`` gives the MeshPlans of the state (a sharded
        run's rows, or the whole tree's in Simulation.full_view); None for
        a state in box ids."""
        self.tree = tree
        self.mesh_fn = mesh_fn or (lambda: None)
        self.i_photon, self.i_sigma, self.n_sigma = i_photon, i_sigma, n_sigma
        self.surfaces: List[Surface] = []
        self.box_out_to_ix: Dict[int, int] = {}
        self.box_in_to_ix: Dict[int, int] = {}
        self.face_cells = tree.nc ** (tree.ndim - 1)
        self._tables = None
        med = np.median(np.asarray(eps), axis=1)
        for lvl in range(1, tree.highest_lvl + 1):
            for b in tree.lvl_ids[lvl - 1]:
                b = int(b)
                for d in range(2 * tree.ndim):
                    nb = int(tree.neighbors[b, d])
                    if nb >= 0 and med[b] <= 1.0 + 1e-8 < med[nb]:
                        self._add_surface(b, nb, d, float(med[nb]))

    @property
    def state_vars(self) -> List[int]:
        """The cc variables of the surface state."""
        return [self.i_photon] + [self.i_sigma + k
                                  for k in range(self.n_sigma)]

    def _add_surface(self, id_out: int, id_in: int, direction: int,
                     eps: float, parent_ix: int = -1, offset=None) -> int:
        if id_out in self.box_out_to_ix:
            return self.box_out_to_ix[id_out]
        self.surfaces.append(Surface(True, id_in, id_out, direction, eps,
                                     ix_parent=parent_ix,
                                     offset_parent=offset))
        ix = len(self.surfaces) - 1
        self.box_out_to_ix[id_out] = ix
        self.box_in_to_ix[id_in] = ix
        self._tables = None
        return ix

    def active(self) -> List[Surface]:
        return [s for s in self.surfaces if s.in_use]

    def _layout(self):
        mesh = self.mesh_fn()
        return None if mesh is None else mesh.layout

    def tables(self, device) -> SurfaceTables:
        layout = self._layout()
        if self._tables is None or self._tables[0] is not layout:
            self._tables = (layout, SurfaceTables(self, device, layout))
        return self._tables[1]

    def own_rows(self, ids):
        """(mask, rows): which of the gas-side boxes ``ids`` hold their
        state in this rank's rows (all of them unless sharded), and those
        rows."""
        ids = np.asarray(ids, np.int64)
        layout = self._layout()
        if layout is None:
            return np.ones(len(ids), bool), ids
        return layout.own_rows(ids)

    def _sigma_halo(self, cc):
        """In a sharded run, the surface charge of the halo rows from
        their owners: the dielectric side reads it at the gas-side row."""
        mesh = self.mesh_fn()
        if mesh is not None and mesh.layout is not None:
            mesh.halo(cc, range(1, mesh.n_levels + 1), [self.i_sigma])

    def refinement_links(self) -> np.ndarray:
        """Box pairs that must have equal refinement
        (surface_get_refinement_links)."""
        out = [(s.id_in, s.id_out) for s in self.active()]
        return np.asarray(out, np.int64).reshape(-1, 2)

    # ---------------------------------------------------------- operations
    def _rows(self, cc, iv: int, rows):
        return cc[iv, rows, :self.face_cells]

    def charge_to_rhs(self, cc, i_rhs: int, fac: float):
        """Deposit the base-state sigma into the rhs, split between the gas
        and the dielectric side (surface_charge_to_rhs)."""
        self._sigma_halo(cc)
        tabs = self.tables(cc.device)
        # a box is on the gas side or the dielectric side of its surfaces,
        # never both, so the two loops add to different cells
        for t in tabs.dirs:
            sig = self._rows(cc, self.i_sigma, t.rows_out)
            frac_gas = 1.0 / (1.0 + t.eps.to(cc.dtype))
            idr = t.inv_dr.to(cc.dtype)
            cc[i_rhs].index_put_(
                (t.rows_out[:, None], t.gas[None, :]),
                (frac_gas * fac * idr)[:, None] * sig, accumulate=True)
        for t in tabs.dirs_in:
            sig = self._rows(cc, self.i_sigma, t.rows_out)
            frac_gas = 1.0 / (1.0 + t.eps.to(cc.dtype))
            idr = t.inv_dr.to(cc.dtype)
            cc[i_rhs].index_put_(
                (t.rows_in[:, None], t.die[None, :]),
                ((1.0 - frac_gas) * fac * idr)[:, None] * sig,
                accumulate=True)
        return cc

    def correct_field_fc(self, cc, fc, i_fld: int, i_phi: int, fac: float):
        """One-sided field at the surface faces including the sigma jump
        (surface_correct_field_fc)."""
        self._sigma_halo(cc)
        tabs = self.tables(cc.device)
        for t in tabs.dirs:  # the gas side's face
            eps = t.eps.to(cc.dtype)[:, None]
            idr = t.inv_dr.to(cc.dtype)[:, None]
            fac_fld0 = 2.0 * eps / (1.0 + eps)
            fac_charge = fac / (1.0 + eps)
            sig = self._rows(cc, self.i_sigma, t.rows_out)
            ro = t.rows_out[:, None]
            phi_g = cc[i_phi, ro, t.gas]
            phi_gg = cc[i_phi, ro, t.g_ghost]
            if t.low:
                out_val = fac_fld0 * idr * (phi_gg - phi_g) + fac_charge * sig
            else:
                out_val = fac_fld0 * idr * (phi_g - phi_gg) - fac_charge * sig
            fc[i_fld, t.dim, ro, t.fo] = out_val
        for t in tabs.dirs_in:  # the dielectric side's face
            eps = t.eps.to(cc.dtype)[:, None]
            idr = t.inv_dr.to(cc.dtype)[:, None]
            fac_fld1 = 2.0 / (1.0 + eps)
            fac_charge = fac / (1.0 + eps)
            sig = self._rows(cc, self.i_sigma, t.rows_out)
            ri = t.rows_in[:, None]
            phi_i = cc[i_phi, ri, t.die]
            phi_ig = cc[i_phi, ri, t.i_ghost]
            if t.low:
                in_val = fac_fld1 * idr * (phi_i - phi_ig) - fac_charge * sig
            else:
                in_val = fac_fld1 * idr * (phi_ig - phi_i) + fac_charge * sig
            fc[i_fld, t.dim, ri, t.fi] = in_val
        return fc

    def get_integral(self, cc, k: int = 0) -> float:
        """Integral of the surface charge of time state k
        (surface_get_integral, ``m_af_surface.f90:293-324``): in
        cylindrical coordinates each surface element is weighted with
        2 pi r of its face center."""
        t = self.tree
        nc = t.nc
        ss = self.active()
        if not ss:
            return 0.0
        rows = torch.as_tensor([s.id_out for s in ss], device=cc.device)
        vals = self._rows(cc, self.i_sigma + k, rows).cpu().numpy()
        total = 0.0
        for s, v in zip(ss, vals):
            dim, low = neighb_dim(s.direction), neighb_low(s.direction)
            dr = t.lvl_dr(int(t.lvl[s.id_out]))
            tdims = [k for k in range(t.ndim) if k != dim]
            area = float(np.prod([dr[k] for k in tdims])) if tdims else 1.0
            if t.coord == "cyl":
                r0 = t.box_r_min(np.asarray([s.id_out]))[0]
                if dim == 1:  # z-normal surface: elements at varying r
                    r_face = r0[0] + (np.arange(1, nc + 1) - 0.5) * dr[0]
                else:         # r-normal surface: constant radius R
                    r_face = np.full(nc, r0[0] + (0.0 if low
                                                  else nc * dr[0]))
                total += float(np.sum(2 * np.pi * r_face * area * v))
            else:
                total += area * float(np.sum(v))
        return total

    # --------------------------------------------------- refinement update
    def gather_state(self, cc):
        """In a sharded run, before the relayout of a refinement epoch:
        the state of every surface's gas-side box in the layout that is
        about to go, on every rank, as (box ids, [n, n_var, face cells]);
        None when unsharded."""
        mesh = self.mesh_fn()
        if mesh is None or mesh.layout is None:
            return None
        layout = mesh.layout
        held = np.concatenate(layout.own)
        ids = np.asarray(sorted({s.id_out for s in self.surfaces}), np.int64)
        ids = ids[np.isin(ids, held)]
        ivs = torch.as_tensor(self.state_vars, device=cc.device)
        F = self.face_cells
        vals = mesh.map_boxes(ids, lambda rows, _sel: cc[
            ivs[:, None], torch.as_tensor(rows, device=cc.device)[None, :],
            :F].transpose(0, 1).cpu().numpy())
        return ids, vals

    def update_after_refinement(self, cc, ref_info, gathered=None):
        """surface_update_after_refinement (``m_af_surface.f90:327-363``):
        restrict the surfaces of removed boxes into their parent surfaces,
        prolong parent surfaces onto the new children next to the
        dielectric, and move the state rows with them. Run before the
        new boxes' rows are written. In 1D a surface is one cell, whose
        value is copied both ways (the JAX package moves no 1D surface
        data, so there its charge is lost at derefinement). In a sharded
        run ``gathered`` is ``gather_state`` of the old layout: the update
        runs on those rows in box ids, and each rank keeps its rows of the
        new layout."""
        if gathered is None:
            return self._update(cc, ref_info)
        ids, vals = gathered
        n_var = max(self.state_vars) + 1
        X = cc.new_zeros((n_var, int(self.tree.highest_id) + 1,
                          self.face_cells))
        ivs = torch.as_tensor(self.state_vars, device=cc.device)
        X[ivs[:, None], torch.as_tensor(ids, device=cc.device)[None, :]] = \
            torch.as_tensor(vals, dtype=cc.dtype,
                            device=cc.device).transpose(0, 1)
        X = self._update(X, ref_info)
        layout = self.mesh_fn().layout
        out = np.asarray(sorted({s.id_out for s in self.surfaces}), np.int64)
        out = out[out < len(layout.row_of)]
        rows = layout.row_of[out]
        out, rows = out[rows >= 0], rows[rows >= 0]
        cc[ivs[:, None], torch.as_tensor(rows, device=cc.device)[None, :],
           :self.face_cells] = X[ivs[:, None], torch.as_tensor(
               out, device=cc.device)[None, :]]
        return cc

    def _update(self, cc, ref_info):
        t = self.tree
        nc, ndim = t.nc, t.ndim
        hnc = nc // 2
        ivs = torch.as_tensor(self.state_vars, device=cc.device)
        F = self.face_cells
        fidx = torch.arange(F, device=cc.device)

        def rows(bid):
            return cc[ivs, bid, :F]  # [n_var, F]

        def restrict(vals):
            if ndim == 1:
                return vals
            if ndim == 2:
                return 0.5 * (vals[:, 0::2] + vals[:, 1::2])
            v = vals.reshape(-1, nc, nc)
            return 0.25 * (v[:, 0::2, 0::2] + v[:, 1::2, 0::2]
                           + v[:, 0::2, 1::2] + v[:, 1::2, 1::2])

        # removed boxes: restrict child surfaces back to the parent surface
        for rid in ref_info.removed:
            ix = self.box_out_to_ix.get(int(rid))
            if ix is None or not self.surfaces[ix].in_use:
                continue
            s = self.surfaces[ix]
            if s.ix_parent < 0:
                raise RuntimeError("Too much derefinement on surface")
            par = self.surfaces[s.ix_parent]
            dix = s.offset_parent
            avg = restrict(rows(s.id_out))
            if ndim == 1:
                cc[ivs[:, None], par.id_out, fidx] = avg
            elif ndim == 2:
                cc[ivs[:, None], par.id_out, fidx[dix[0]:dix[0] + hnc]] = avg
            else:
                blk = rows(par.id_out).reshape(-1, nc, nc)
                blk[:, dix[0]:dix[0] + hnc, dix[1]:dix[1] + hnc] = avg
                cc[ivs[:, None], par.id_out, fidx] = blk.reshape(-1, F)
            par.in_use = True
            self.box_out_to_ix.pop(s.id_out, None)
            self.box_in_to_ix.pop(s.id_in, None)
            s.in_use = False

        # new boxes: prolong parent surfaces onto the children
        handled = set()
        for cid in ref_info.added:
            p_id = int(t.parent[int(cid)])
            p_ix = self.box_out_to_ix.get(p_id)
            if p_ix is None or not self.surfaces[p_ix].in_use or \
                    p_ix in handled:
                continue
            handled.add(p_ix)
            par = self.surfaces[p_ix]
            d = par.direction
            dim, low = neighb_dim(d), neighb_low(d)
            tdims = [k for k in range(ndim) if k != dim]
            pvals = rows(p_id)
            for c in t.children[p_id]:
                c = int(c)
                cdix = t.ix[c] % 2
                if cdix[dim] != (0 if low else 1):
                    continue
                id_in = int(t.neighbors[c, d])
                if id_in < 0:
                    raise RuntimeError("surface prolongation: missing child")
                dix = np.array([hnc * cdix[k] for k in tdims], np.int64)
                self._add_surface(c, id_in, d, par.eps, p_ix, dix)
                if ndim == 1:
                    child = pvals
                elif ndim == 2:
                    v = pvals[:, dix[0]:dix[0] + hnc]
                    child = torch.stack([v, v], dim=-1).reshape(-1, F)
                else:
                    v = pvals.reshape(-1, nc, nc)[
                        :, dix[0]:dix[0] + hnc, dix[1]:dix[1] + hnc]
                    child = v.repeat_interleave(2, 1).repeat_interleave(
                        2, 2).reshape(-1, F)
                cc[ivs[:, None], c, fidx] = child
            self.box_out_to_ix.pop(par.id_out, None)
            self.box_in_to_ix.pop(par.id_in, None)
            par.in_use = False
        self._tables = None
        return cc
