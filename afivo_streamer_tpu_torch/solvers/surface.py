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
    ``dir_statics``."""

    def __init__(self, surfaces: "Surfaces", device):
        t = surfaces.tree
        self.dirs = []
        for d in range(2 * t.ndim):
            ss = [s for s in surfaces.active() if s.direction == d]
            if not ss:
                continue
            dim = neighb_dim(d)
            st = dir_statics(t.ndim, t.nc, d)
            arrays = dict(
                rows_out=np.array([s.id_out for s in ss], np.int64),
                rows_in=np.array([s.id_in for s in ss], np.int64),
                inv_dr=np.array([1.0 / t.lvl_dr(int(t.lvl[s.id_out]))[dim]
                                 for s in ss]),
                eps=np.array([s.eps for s in ss]),
                fidx=np.arange(t.nc ** (t.ndim - 1)),
                **{k: v for k, v in st.items() if isinstance(v, np.ndarray)})
            tab = sp.device_copy(arrays, device)
            tab.d, tab.dim, tab.low = d, dim, st["low"]
            self.dirs.append(tab)


class Surfaces:
    """The surfaces of the mesh and their state rows in cc:
    ``i_photon`` (photon flux) and ``i_sigma`` + k (surface charge, time
    state k)."""

    def __init__(self, tree: Tree, eps, i_photon: int, i_sigma: int,
                 n_sigma: int):
        """eps: host array [n_boxes, (nc+2)^ndim] of the permittivity by box
        id (surface_initialize: a box pair forms a surface where the median
        eps jumps from <= 1 on the gas side)."""
        self.tree = tree
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

    def tables(self, device) -> SurfaceTables:
        if self._tables is None:
            self._tables = SurfaceTables(self, device)
        return self._tables

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
        for t in self.tables(cc.device).dirs:
            sig = self._rows(cc, self.i_sigma, t.rows_out)
            frac_gas = 1.0 / (1.0 + t.eps.to(cc.dtype))
            idr = t.inv_dr.to(cc.dtype)
            cc[i_rhs].index_put_(
                (t.rows_out[:, None], t.gas[None, :]),
                (frac_gas * fac * idr)[:, None] * sig, accumulate=True)
            cc[i_rhs].index_put_(
                (t.rows_in[:, None], t.die[None, :]),
                ((1.0 - frac_gas) * fac * idr)[:, None] * sig,
                accumulate=True)
        return cc

    def correct_field_fc(self, cc, fc, i_fld: int, i_phi: int, fac: float):
        """One-sided field at the surface faces including the sigma jump
        (surface_correct_field_fc)."""
        for t in self.tables(cc.device).dirs:
            eps = t.eps.to(cc.dtype)[:, None]
            idr = t.inv_dr.to(cc.dtype)[:, None]
            fac_fld0 = 2.0 * eps / (1.0 + eps)
            fac_fld1 = 2.0 / (1.0 + eps)
            fac_charge = fac / (1.0 + eps)
            sig = self._rows(cc, self.i_sigma, t.rows_out)
            ro, ri = t.rows_out[:, None], t.rows_in[:, None]
            phi_g = cc[i_phi, ro, t.gas]
            phi_gg = cc[i_phi, ro, t.g_ghost]
            phi_i = cc[i_phi, ri, t.die]
            phi_ig = cc[i_phi, ri, t.i_ghost]
            if t.low:
                out_val = fac_fld0 * idr * (phi_gg - phi_g) + fac_charge * sig
                in_val = fac_fld1 * idr * (phi_i - phi_ig) - fac_charge * sig
            else:
                out_val = fac_fld0 * idr * (phi_g - phi_gg) - fac_charge * sig
                in_val = fac_fld1 * idr * (phi_ig - phi_i) + fac_charge * sig
            fc[i_fld, t.dim, ro, t.fo] = out_val
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
    def update_after_refinement(self, cc, ref_info):
        """surface_update_after_refinement (``m_af_surface.f90:327-363``):
        restrict the surfaces of removed boxes into their parent surfaces,
        prolong parent surfaces onto the new children next to the
        dielectric, and move the state rows with them. Run before the
        new boxes' rows are written. In 1D a surface is one cell, whose
        value is copied both ways (the JAX package moves no 1D surface
        data, so there its charge is lost at derefinement)."""
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
