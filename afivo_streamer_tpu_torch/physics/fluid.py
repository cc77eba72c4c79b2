"""Drift-diffusion-reaction fluid model: the hot path (1D, 2D and 3D).

Re-designs the reference's ``src/m_fluid.f90`` (forward_euler ``:21-99``,
flux_upwind ``:102-209``, add_source_terms ``:298-466``) plus the flux
engine of ``afivo/src/m_af_flux_schemes.f90`` (flux_upwind_tree/box
``:666-848``, reconstruct_upwind_1d ``:282-303``, flux_update_densities
``:320-436``), the 2-ghost assembly ``m_af_ghostcell.f90:672-856``
(af_gc2_box + gc2_prolong_rb) and fine-to-coarse flux matching
``m_af_core.f90:1257-1404`` (af_consistent_fluxes).

Instead of per-box line loops, every level pass operates on an extended
tensor ``E[n_leaves, n_species, (nc+4)^ndim]`` with two ghost layers; the
Koren-limited upwind reconstruction, transport-coefficient lookups, flux
evaluation, CFL/dielectric-relaxation time step terms, chemistry source
terms and the conservative update are batched tensor ops per level. The
time-step limits stay on the device as 0-d tensors until the driver reads
them once per step.

With the electron energy equation (``model%type = ee53``) the energy
density is the second electron-like flux variable: mobility and diffusion
come from the mean energy at the faces, the rates from the mean energy of
the cells after the flux update, and the energy gains the Joule heating
and loses the tabulated loss.

With a varying gas density (gas dynamics, or a user gas density) the
variable ``M`` holds the gas number density on every cell: the transport
coefficients take its face average, the reduced field and the source
factor its cell value, and the gas components enter the chemistry as the
first species, at their fractions of ``M``.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, Dict, List

import numpy as np
import torch

from .. import constants as uc
from ..core import ghostcell as gc
from ..core import prolong_restrict as pr
from ..core import rowops as ro
from ..core import spatial as sp
from ..core.tree import Tree, NO_BOX, neighb_dim, neighb_low
from ..ops.limiters import limiter_apply, LIMITER_KOREN
from .chemistry import IONIZATION_REACTION
from .transport_data import (TD_MOBILITY, TD_DIFFUSION, TD_EE_MOBILITY,
                             TD_EE_DIFFUSION, TD_EE_LOSS)

#: energy fluxes are 5/3 times the electron flux (m_fluid.f90:122)
FIVE_THIRD = 5.0 / 3.0


# --------------------------------------------------------------------------
# 2-ghost extended-array plan (af_gc2_box)
# --------------------------------------------------------------------------
class Gc2LevelPlan:
    """Index tables to assemble [n_leaves, nv, (nc+4)^ndim] extended arrays
    for the leaves of one level. Reference coordinates -1..nc+2 map to
    extended indices 0..nc+3 (shift +1)."""

    def __init__(self, tree: Tree, lvl: int, device, dtype=torch.float64):
        ndim, nc = tree.ndim, tree.nc
        self.ndim, self.nc, self.lvl = ndim, nc, lvl
        hnc = nc // 2
        leaves = tree.lvl_leaves[lvl - 1]
        self.leaves = np.asarray(leaves, np.int32)
        leaf_pos = {int(b): i for i, b in enumerate(leaves)}
        self.dr = tree.lvl_dr(lvl)

        # center copy: cc (nc+2)^d -> ext at 1..nc+2 per dim
        self.center_ext = sp.ext_flat(ndim, nc, *[np.arange(1, nc + 3)] * ndim)

        self.dirs = []
        for d in range(2 * ndim):
            dim, low = neighb_dim(d), neighb_low(d)
            info: Dict = {"dim": dim, "low": low}

            def axes_ext(face_vals):
                return [face_vals if k == dim else np.arange(2, nc + 2)
                        for k in range(ndim)]

            def cc_layer(vals):
                return sp.cc_flat(ndim, nc, *[
                    vals if k == dim else np.arange(1, nc + 1)
                    for k in range(ndim)])

            # extended-array target slabs (transverse: interior ref 1..nc)
            l12 = np.array([0, 1]) if low else np.array([nc + 2, nc + 3])
            info["slab_ext"] = sp.ext_flat(ndim, nc, *axes_ext(l12))
            # neighbor source cells: low: nc-1..nc ; high: 1..2
            info["nb_cc"] = cc_layer(np.array([nc - 1, nc]) if low
                                     else np.array([1, 2]))
            # first/second interior layers (for BC)
            info["f1_cc"] = cc_layer(np.array([1 if low else nc]))
            info["f2_cc"] = cc_layer(np.array([2 if low else nc - 1]))
            info["l1_ext"] = sp.ext_flat(ndim, nc, *axes_ext(
                np.array([1] if low else [nc + 2])))
            info["l2_ext"] = sp.ext_flat(ndim, nc, *axes_ext(
                np.array([0] if low else [nc + 3])))
            # ghost layer of the 1-ghost cc array (for write-back)
            info["gc_cc"] = cc_layer(np.array([0 if low else nc + 1]))

            copy_ids, copy_nb, bc_ids, rb_ids = [], [], [], []
            for b in leaves:
                nb = int(tree.neighbors[b, d])
                if nb >= 0:
                    copy_ids.append(int(b))
                    copy_nb.append(nb)
                elif nb == NO_BOX:
                    rb_ids.append(int(b))
                else:
                    bc_ids.append(int(b))
            info["copy_pos"] = np.array([leaf_pos[b] for b in copy_ids],
                                        np.int32)
            info["copy_nb"] = np.asarray(copy_nb, np.int32)
            info["bc_pos"] = np.array([leaf_pos[b] for b in bc_ids],
                                      np.int32)
            info["bc_ids"] = np.asarray(bc_ids, np.int32)
            # face coordinates for BC values
            if bc_ids:
                coords = []
                for bid in bc_ids:
                    r0 = tree.box_r_min(np.asarray([bid]))[0]
                    axes = []
                    for k in range(ndim):
                        if k == dim:
                            axes.append(np.array(
                                [r0[k] if low else r0[k] + nc * self.dr[k]]))
                        else:
                            axes.append(r0[k] + (np.arange(nc) + 0.5)
                                        * self.dr[k])
                    mesh = np.meshgrid(*axes, indexing="ij")
                    coords.append(np.stack([m.ravel() for m in mesh], -1))
                info["bc_coords"] = np.asarray(coords)

            # refinement boundaries: gc2_prolong_rb gather tables
            info["rb_pos"] = np.array([leaf_pos[b] for b in rb_ids],
                                      np.int32)
            if rb_ids:
                parents = tree.parent[np.asarray(rb_ids)]
                info["rb_coarse"] = tree.neighbors[parents, d].astype(np.int32)
                cface = nc if low else 1
                n_rb = len(rb_ids)
                T = hnc ** (ndim - 1)
                cc0 = np.zeros((n_rb, T), np.int32)
                lo_t = [np.zeros((n_rb, T), np.int32) for _ in range(ndim)]
                hi_t = [np.zeros((n_rb, T), np.int32) for _ in range(ndim)]
                for n_i, b in enumerate(rb_ids):
                    off = tree.child_offset(int(b))
                    axes = [np.array([cface]) if k == dim
                            else off[k] + np.arange(1, hnc + 1)
                            for k in range(ndim)]
                    mesh = np.meshgrid(*axes, indexing="ij")
                    v = np.stack([m.ravel() for m in mesh], -1)
                    cc0[n_i] = sp.cc_flat_nd(ndim, nc, v)
                    for k in range(ndim):
                        vl = v.copy()
                        vl[:, k] -= 1
                        vh = v.copy()
                        vh[:, k] += 1
                        lo_t[k][n_i] = sp.cc_flat_nd(ndim, nc, vl)
                        hi_t[k][n_i] = sp.cc_flat_nd(ndim, nc, vh)
                info["rb_c0"] = cc0
                info["rb_lo"] = lo_t
                info["rb_hi"] = hi_t
                # fine targets in the extended array per sign combination
                # (s_face, s_transverse...), each in {-1, +1}, transverse
                # dims in their natural order
                tdims = [k for k in range(ndim) if k != dim]
                targets = {}
                for signs in itertools.product([-1, 1], repeat=ndim):
                    if low:
                        fpos = 0 if signs[0] < 0 else 1
                    else:
                        fpos = nc + 2 if signs[0] < 0 else nc + 3
                    tcells = 2 + 2 * np.arange(hnc)  # ext coord of fine lo
                    axes = [np.array([fpos]) if k == dim
                            else tcells + (1 if signs[1 + tdims.index(k)] > 0
                                           else 0)
                            for k in range(ndim)]
                    mesh = np.meshgrid(*axes, indexing="ij")
                    v = np.stack([m.ravel() for m in mesh], -1)
                    targets[signs] = np.ravel_multi_index(
                        [v[:, k] for k in range(ndim)],
                        [nc + 4] * ndim).astype(np.int32)
                info["rb_targets"] = {
                    s: sp.device_copy({"t": t}, device, dtype).t
                    for s, t in targets.items()}
                # sign tuple position k -> actual dim
                info["rb_sign_dims"] = [dim] + tdims
            info["d"] = sp.device_copy(info, device, dtype)
            self.dirs.append(info)
        self.d = sp.device_copy(self, device, dtype)


def gc2_extend(cc, plan: Gc2LevelPlan, ivs, bc_fn, params,
               prolong_limiter: int):
    """Assemble the 2-ghost extended array for the level's leaves and write
    the first ghost layer back into cc (af_gc2_box semantics).

    Returns (E, cc): E has shape [n_leaves, n_iv, (nc+4)^ndim]."""
    nc = plan.nc
    leaves = plan.d.leaves
    n = len(plan.leaves)
    E = torch.zeros((n, len(ivs), (nc + 4) ** plan.ndim), dtype=cc.dtype,
                    device=cc.device)
    for i, iv in enumerate(ivs):
        E[:, i, plan.d.center_ext] = cc[iv, leaves]
    for info in plan.dirs:
        dim, low, t = info["dim"], info["low"], info["d"]
        for i, iv in enumerate(ivs):
            # same-level neighbors
            if len(info["copy_pos"]):
                E[t.copy_pos[:, None], i, t.slab_ext[None, :]] = \
                    cc[iv, t.copy_nb[:, None], t.nb_cc[None, :]]
            # physical boundaries (bc_to_gc2, m_af_ghostcell.f90:283-378)
            if len(info["bc_pos"]):
                x1 = cc[iv, t.bc_ids[:, None], t.f1_cc[None, :]]
                x2 = cc[iv, t.bc_ids[:, None], t.f2_cc[None, :]]
                bc_type, b = bc_fn(int(iv), 2 * dim + (0 if low else 1),
                                   info.get("bc_coords"), params)
                b = ro.as_value(b, x1)
                if bc_type == gc.BC_DIRICHLET:
                    c0, c1, c2 = 2.0, -1.0, 2.0
                elif bc_type == gc.BC_NEUMANN:
                    sgn = -1.0 if low else 1.0
                    c0 = sgn * float(plan.dr[dim])
                    c1, c2 = 1.0, 3.0 * c0
                elif bc_type == gc.BC_DIRICHLET_COPY:
                    c0, c1, c2 = 1.0, 0.0, 1.0
                else:
                    raise ValueError("unsupported bc for gc2")
                E[t.bc_pos[:, None], i, t.l1_ext[None, :]] = c0 * b + c1 * x1
                E[t.bc_pos[:, None], i, t.l2_ext[None, :]] = c2 * b + c1 * x2
            # refinement boundaries (gc2_prolong_rb, :753-856)
            if len(info["rb_pos"]):
                coarse = t.rb_coarse[:, None]
                c0v = cc[iv, coarse, t.rb_c0]
                fvals = []
                for k in range(plan.ndim):
                    lo = cc[iv, coarse, t.rb_lo[k]]
                    hi = cc[iv, coarse, t.rb_hi[k]]
                    fvals.append(0.25 * limiter_apply(c0v - lo, hi - c0v,
                                                      prolong_limiter))
                sdims = info["rb_sign_dims"]
                for signs, tg in info["rb_targets"].items():
                    vals = c0v
                    for k_pos, s in enumerate(signs):
                        vals = vals + s * fvals[sdims[k_pos]]
                    E[t.rb_pos[:, None], i, tg[None, :]] = vals
    # write the first ghost layer back into cc (af_gc2_box :739-744)
    for info in plan.dirs:
        t = info["d"]
        for i, iv in enumerate(ivs):
            cc[iv, leaves[:, None], t.gc_cc[None, :]] = E[:, i, t.l1_ext]
    return E, cc


# --------------------------------------------------------------------------
# fine-to-coarse flux matching plan (af_consistent_fluxes)
# --------------------------------------------------------------------------
class ConsistentGroup:
    """One (level, direction) flux-matching group: coarse faces ``tgt`` of
    boxes ``nbs`` take the weighted mean of fine faces ``src`` of their
    neighbors' children ``chs``."""

    def __init__(self, d, dim, nbs, chs, tgt, src, w, device,
                 dtype=torch.float64):
        self.d, self.dim = d, dim
        t = sp.device_copy({"nbs": nbs, "chs": chs, "tgt": tgt}, device)
        self.nbs, self.chs, self.tgt = t.nbs, t.chs, t.tgt
        self.src = [sp.device_copy({"a": a}, device).a for a in src]
        self.w = [sp.device_copy({"a": a}, device, dtype).a for a in w]


def build_consistent_plan(tree: Tree, device, parents=None,
                          n_own: int = None,
                          dtype=torch.float64) -> List[ConsistentGroup]:
    """The flux-matching groups of a mesh (af_consistent_fluxes,
    ``m_af_core.f90:1257-1404``): per (coarse level, direction), the
    coarse faces next to a fine box and the 2^(ndim-1) fine faces over
    each of them. ``parents`` (per level; default the tree's) are the
    fine boxes' parents and ``n_own`` (default all) the rows whose coarse
    faces are matched: in a sharded run the parents among the rank's rows
    and its own boxes (core/levels.MeshPlans)."""
    t = tree
    nc, ndim = t.nc, t.ndim
    hnc = nc // 2
    parents = t.lvl_parents if parents is None else parents
    n_own = t.highest_id if n_own is None else n_own
    by_key: Dict = {}
    for lvl in range(1, t.highest_lvl):
        for p_id in parents[lvl - 1]:
            for d in range(2 * ndim):
                nb = int(t.neighbors[p_id, d])
                if nb < 0 or nb >= n_own or t.has_children(nb):
                    continue
                dim, low = neighb_dim(d), neighb_low(d)
                # children of p_id adjacent to direction d
                for c in t.children[int(p_id)]:
                    if (t.ix[c] % 2)[dim] != (0 if low else 1):
                        continue
                    by_key.setdefault((lvl, d), []).append((nb, int(c)))
    plan = []
    # a child's share of a coarse face: transverse cells in natural order
    # (in 1D the one face, with no transverse coordinate)
    tcells = (np.zeros((1, 0), np.int64) if ndim == 1 else np.stack(
        [m.ravel() for m in np.meshgrid(*[np.arange(hnc)] * (ndim - 1),
                                        indexing="ij")], -1))
    for (lvl, d), pairs in sorted(by_key.items()):
        dim, low = neighb_dim(d), neighb_low(d)
        tdims = [k for k in range(ndim) if k != dim]
        # the coarse neighbor's face next to the fine box; the fine
        # children's face next to the coarse neighbor
        tgt_face = nc if low else 0
        src_face = 0 if low else nc
        nbs = np.array([p[0] for p in pairs], np.int32)
        chs = np.array([p[1] for p in pairs], np.int32)
        n_src = 2 ** (ndim - 1)
        tgt_idx = np.zeros((len(pairs), len(tcells)), np.int32)
        src_idx = [np.zeros_like(tgt_idx) for _ in range(n_src)]
        weights = [np.ones(tgt_idx.shape) for _ in range(n_src)]

        def face(normal, trans):
            v = np.zeros((len(trans), ndim), np.int64)
            v[:, dim] = normal
            v[:, tdims] = trans
            return np.ravel_multi_index([v[:, k] for k in range(ndim)],
                                        [nc + 1] * ndim)
        for pi, (nb, c) in enumerate(pairs):
            off = (t.ix[c] % 2)[tdims] * hnc
            tgt_idx[pi] = face(tgt_face, off + tcells)
            for si, bits in enumerate(itertools.product(
                    [0, 1], repeat=ndim - 1)):
                src_idx[si][pi] = face(src_face, 2 * tcells + np.asarray(bits))
                # cylindrical weights for z-fluxes: the radial fine position
                if t.coord == "cyl" and dim == 1:
                    r0 = t.box_r_min(np.asarray([nb]))[0][0]
                    drc = t.lvl_dr(lvl)[0]
                    r_c = r0 + (off[0] + tcells[:, 0] + 1 - 0.5) * drc
                    tmp = 0.25 * drc / r_c
                    weights[si][pi] = ((1.0 - tmp) if bits[0] == 0
                                       else (1.0 + tmp))
        plan.append(ConsistentGroup(d, dim, nbs, chs, tgt_idx, src_idx,
                                    weights, device, dtype))
    return plan


def gc2_plan(mesh, lvl: int) -> Gc2LevelPlan:
    """The 2-ghost plan of a level, cached with the mesh."""
    return mesh.cached(("gc2", lvl), lambda: Gc2LevelPlan(
        mesh.tree, lvl, mesh.device, mesh.dtype), (lvl,))


def consistent_plan(mesh) -> List[ConsistentGroup]:
    """The flux-matching groups of the mesh, cached with it."""
    return mesh.cached("consistent", lambda: build_consistent_plan(
        mesh.tree, mesh.device,
        [mesh.parents_held(l) for l in range(1, mesh.n_levels + 1)],
        mesh.n_own, mesh.dtype))


def consistent_fluxes(fc, groups: List[ConsistentGroup], flux_fc: List[int]):
    """Replace coarse fluxes at refinement boundaries by the average of
    the fine fluxes (in place)."""
    for g in groups:
        for f_iv in flux_fc:
            acc = 0.0
            for src, w in zip(g.src, g.w):
                acc = acc + w.to(fc.dtype) * fc[f_iv, g.dim, g.chs[:, None],
                                                src]
            fc[f_iv, g.dim, g.nbs[:, None], g.tgt] = acc / len(g.src)
    return fc


# --------------------------------------------------------------------------
# Flux computation, consistent fluxes, conservative update with sources
# --------------------------------------------------------------------------
def _lo_hi(F, d: int, nc: int):
    """The low and high faces of every cell along dim d of face values
    F [n] + [nc+1 if k == d else nc]."""
    ndim = F.dim() - 1

    def sl(a, b):
        return F[(slice(None),) + tuple(slice(a, b) if k == d
                                        else slice(None)
                                        for k in range(ndim))]
    return sl(0, nc), sl(1, nc + 1)


@dataclass
class FluidIndices:
    """Variable indices wired by the simulation setup."""
    i_electron: int
    i_electric_fld: int  # cc field norm
    fc_E: int            # fc electric field
    flux_species: List[int]      # cc base indices of species with fluxes
    flux_fc: List[int]           # fc indices of their fluxes
    flux_charge_sign: np.ndarray
    all_densities: List[int]     # cc base indices of all evolving densities
    species_cc: List[int]        # cc index per chemistry species
    i_photo: int = -1            # photoionization source, -1 when off
    photoi_species_cc: int = -1  # the species it ionizes
    i_electron_energy: int = -1  # flux variable 2 of the ee53 model
    i_srcfac: int = -1           # output variable for the source factor
    i_gas_dens: int = -1         # the gas number density M when it varies


class FluidModel:
    """Batched forward-Euler step of the plasma fluid model."""

    def __init__(self, mesh, idx: FluidIndices, chemistry, transport, gas,
                 bc_species: Callable, dt_cfg, settings,
                 prolong_limiter: int, limiter: int = LIMITER_KOREN):
        if not gas.constant_density and idx.i_gas_dens < 0:
            raise ValueError("a varying gas density needs the variable M")
        self.mesh = mesh
        self.tree = mesh.tree
        self.idx = idx
        self.chem = chemistry
        self.td = transport
        self.gas = gas
        self.bc_species = bc_species
        self.dt_cfg = dt_cfg
        self.st = settings
        self.prolong_limiter = prolong_limiter
        self.limiter = limiter
        self.field_compute = None  # wired by the simulation (m_field)
        #: callable(lvl) -> bool mask [n_leaves, nc^ndim] of the cells the
        #: update may change (set_box_mask), or None
        self.mask_provider = None
        self.dielectric = None  # physics/dielectric.Dielectric when used
        self._ioniz_cols = [n for n, r in enumerate(chemistry.reactions)
                            if r.reaction_type == IONIZATION_REACTION]

    # -------------------------------------------------------- flux kernel
    def compute_fluxes(self, cc, fc, s_deriv: int, params):
        """flux_upwind_tree: per-level 2-ghost assembly + Koren upwind flux
        + CFL/DRT terms + fine-to-coarse flux matching.

        Returns (cc, fc, dt_cfl, dt_drt) with the dt terms as 0-d
        tensors."""
        t = self.tree
        nc, ndim = t.nc, t.ndim
        idx = self.idx
        sp_ivs = [iv + s_deriv for iv in idx.flux_species]
        n_sp = len(sp_ivs)
        has_ee = idx.i_electron_energy >= 0
        n_elec = 2 if has_ee else 1  # flux_num_electron_vars
        cfl_factor = FIVE_THIRD if has_ee else 1.0
        sign = idx.flux_charge_sign
        dev = dict(dtype=cc.dtype, device=cc.device)

        # ghost-cell validity near refinement boundaries
        cc = pr.restrict_tree(cc, self.mesh.pr_all(), sp_ivs,
                              use_geometry=True)

        inv_max_cfl = torch.zeros((), **dev)
        max_sigma = torch.full((), uc.tiny(cc.dtype), **dev)
        N_inv = self.gas.inverse_number_density
        sign_t = self.mesh.cached(
            ("flux_sign", cc.dtype),
            lambda: torch.as_tensor(sign, **dev).reshape(
                (1, n_sp) + (1,) * ndim), ())

        for lvl in range(1, t.highest_lvl + 1):
            plan = gc2_plan(self.mesh, lvl)
            # the neighbors and the coarse boxes the 2-ghost fill reads
            self.mesh.halo(cc, (lvl - 1, lvl), sp_ivs)
            n = len(plan.leaves)
            if n == 0:
                continue
            leaves = plan.d.leaves
            E, cc = gc2_extend(cc, plan, sp_ivs, self.bc_species, params,
                               self.prolong_limiter)
            Eb = E.reshape((n, n_sp) + (nc + 4,) * ndim)
            # cell-centered field norm with 1 ghost
            Bfld = ro.cc_rows(cc, idx.i_electric_fld, leaves, nc, ndim)
            Bgas = (None if self.gas.constant_density else
                    ro.cc_rows(cc, idx.i_gas_dens, leaves, nc, ndim))
            cfl_sum = torch.zeros((n,) + (nc,) * ndim, **dev)

            for d in range(ndim):
                def sl_faces(arr, start, width, ghost):
                    # [start, start+width) along d, transverse interior of
                    # a `ghost`-ghost array
                    return arr[(Ellipsis,) + tuple(
                        slice(start, start + width) if k == d
                        else slice(ghost, ghost + nc) for k in range(ndim))]

                cL2 = sl_faces(Eb, 0, nc + 1, 2)
                cL = sl_faces(Eb, 1, nc + 1, 2)
                cR = sl_faces(Eb, 2, nc + 1, 2)
                cR2 = sl_faces(Eb, 3, nc + 1, 2)

                # upwind reconstruction (reconstruct_upwind_1d)
                u_pos = cL + 0.5 * limiter_apply(cR - cL, cL - cL2,
                                                 self.limiter)
                u_neg = cR - 0.5 * limiter_apply(cR - cL, cR2 - cR,
                                                 self.limiter)

                E_fc = ro.fc_get_faces(fc, idx.fc_E, d, leaves, nc, ndim)
                u_f = torch.where(sign_t * E_fc[:, None] > 0, u_pos, u_neg)

                # the inverse gas density at the faces: with a varying
                # density 2 / (N_lo + N_hi) (flux_upwind, m_fluid.f90:
                # 147-153), guarded where the sum is not positive
                if Bgas is not None:
                    Ng_sum = (sl_faces(Bgas, 0, nc + 1, 1)
                              + sl_faces(Bgas, 1, nc + 1, 1))
                    N_inv_f = 2.0 / torch.where(Ng_sum > 0.0, Ng_sum, 1.0)
                else:
                    N_inv_f = N_inv
                if has_ee:
                    # mobility and diffusion from the mean energy at the
                    # faces (flux_upwind, m_fluid.f90:159-168)
                    mean_en_f = u_f[:, 1] / torch.clamp(u_f[:, 0], min=1.0)
                    mu, dc = self.td.ee_tbl.get_cols(
                        (TD_EE_MOBILITY, TD_EE_DIFFUSION), mean_en_f)
                else:
                    # field strength at faces -> mobility/diffusion lookup
                    fld_face = (0.5 * (sl_faces(Bfld, 0, nc + 1, 1)
                                       + sl_faces(Bfld, 1, nc + 1, 1))
                                * uc.SI_to_Townsend * N_inv_f)
                    mu, dc = self.td.tbl.get_cols(
                        (TD_MOBILITY, TD_DIFFUSION), fld_face)
                mu = mu * N_inv_f
                dc = dc * N_inv_f

                inv_dx = 1.0 / float(plan.dr[d])
                v_e = -mu * E_fc
                flux_e = (v_e * u_f[:, 0]
                          - dc * inv_dx * (cR[:, 0] - cL[:, 0]))
                fluxes = [flux_e]
                sigma = mu * u_f[:, 0]
                if has_ee:
                    # energy flux = 5/3 of the electron-like flux of the
                    # energy density (m_fluid.f90:188-192)
                    fluxes.append(FIVE_THIRD * (
                        v_e * u_f[:, 1]
                        - dc * inv_dx * (cR[:, 1] - cL[:, 1])))
                for m in range(n_elec, n_sp):
                    mu_i = (float(self.td.ion_mobilities[m - n_elec])
                            * N_inv_f)
                    v_i = float(sign[m]) * mu_i * E_fc
                    fluxes.append(v_i * u_f[:, m])
                    sigma = sigma + mu_i * u_f[:, m]
                max_sigma = torch.maximum(max_sigma, sigma.max())

                # CFL sum per cell (flux_upwind, m_fluid.f90:195-197); the
                # 5/3 factor applies to the advective term only
                v_lo, v_hi = _lo_hi(v_e, d, nc)
                dc_lo, dc_hi = _lo_hi(dc, d, nc)
                cfl_sum = cfl_sum + (
                    cfl_factor
                    * torch.maximum(v_lo.abs(), v_hi.abs()) * inv_dx
                    + 2.0 * torch.maximum(dc_lo, dc_hi) * inv_dx ** 2)

                # no fluxes out of dielectric boxes (flux_upwind,
                # m_fluid.f90:139-144)
                if self.dielectric is not None:
                    first = sp.cc_flat(ndim, nc, *([np.array([1])] * ndim))
                    diel = (cc[self.dielectric.i_eps, leaves, int(first[0])]
                            > 1.0).reshape((n,) + (1,) * ndim)
                    fluxes = [torch.where(diel, 0.0, f) for f in fluxes]
                for m, f_iv in enumerate(idx.flux_fc):
                    ro.fc_set_faces(fc, f_iv, d, leaves, fluxes[m], nc,
                                    ndim)
            inv_max_cfl = torch.maximum(inv_max_cfl, cfl_sum.max())

        # the fine fluxes next to the rank's coarse faces
        self.mesh.halo(fc, range(2, t.highest_lvl + 1), idx.flux_fc,
                       fc=True)
        fc = consistent_fluxes(fc, consistent_plan(self.mesh), idx.flux_fc)
        dt_cfl = 1.0 / torch.clamp(inv_max_cfl, min=uc.tiny(cc.dtype))
        dt_drt = uc.eps0 / (uc.elem_charge * max_sigma)
        return cc, fc, dt_cfl, dt_drt

    # ------------------------------------------------------------ update
    def update_densities(self, cc, fc, dt: float, s_deriv: int,
                         s_prev: List[int], w_prev: List[float], s_out: int,
                         last_step: bool):
        """flux_update_densities + add_source_terms. Returns
        (cc, dt_chem, diag)."""
        t = self.tree
        idx = self.idx
        nc, ndim = t.nc, t.ndim
        dev = dict(dtype=cc.dtype, device=cc.device)
        dt_chem = torch.full((), uc.huge(cc.dtype), **dev)
        dt_other = torch.full((), uc.huge(cc.dtype), **dev)
        has_ee = idx.i_electron_energy >= 0
        total_rates = torch.zeros(self.chem.n_reactions, **dev)
        total_JdotE = torch.zeros((), **dev)
        ngas = self.chem.n_gas_species

        for lvl in range(1, t.highest_lvl + 1):
            tb = self.mesh.tb(lvl)
            if len(tb.leaves) == 0:
                continue
            leaves = tb.d.leaves
            n = len(tb.leaves)
            dr = t.lvl_dr(lvl)
            # cells the update may change (set_box_mask,
            # m_fluid.f90:469-515); the weighted sum below ignores it
            mask = (None if self.mask_provider is None
                    else self.mask_provider(lvl))

            # weighted sum of previous states for ALL densities, written
            # unconditionally (flux_update_densities,
            # m_af_flux_schemes.f90:370-380)
            for iv in idx.all_densities:
                acc = 0.0
                for s, w in zip(s_prev, w_prev):
                    acc = acc + w * ro.cc_get_interior(cc, iv + s, leaves,
                                                       nc, ndim)
                ro.cc_set_interior(cc, iv + s_out, leaves, acc, nc, ndim)

            # flux divergence, applied before the source terms, so that
            # the energy model's sources see the post-flux s_out states
            for m, iv in enumerate(idx.flux_species):
                f_iv = idx.flux_fc[m]
                div = 0.0
                for d in range(ndim):
                    F = ro.fc_get_faces(fc, f_iv, d, leaves, nc, ndim)
                    F_lo, F_hi = _lo_hi(F, d, nc)
                    if t.coord == "cyl" and d == 0:
                        F_lo = F_lo * tb.d.rfac_lo.to(cc.dtype)[:, :, None]
                        F_hi = F_hi * tb.d.rfac_hi.to(cc.dtype)[:, :, None]
                    div = div + (F_lo - F_hi) / float(dr[d])
                upd = dt * div.reshape(n, -1)
                if mask is not None:
                    upd = torch.where(mask, upd, 0.0)
                ro.cc_add_interior(cc, iv + s_out, leaves, upd, nc, ndim)

            # chemistry source terms (add_source_terms); with a varying
            # gas density the gas components are the first species
            # (m_chemistry.f90:265-266), at their fractions of M
            fld = ro.cc_get_interior(cc, idx.i_electric_fld, leaves, nc, ndim)
            if self.gas.constant_density:
                fields_td = (fld * uc.SI_to_Townsend
                             * self.gas.inverse_number_density)
                cols = []
            else:
                Ncell = ro.cc_get_interior(cc, idx.i_gas_dens, leaves, nc,
                                           ndim)
                fields_td = (fld * uc.SI_to_Townsend
                             / torch.where(Ncell > 0.0, Ncell, 1.0))
                cols = [float(self.gas.fractions[k]) * Ncell
                        for k in range(ngas)]
            dens = torch.stack(cols + [
                ro.cc_get_interior(cc, s_cc + s_deriv, leaves, nc, ndim)
                for s_cc in idx.species_cc], dim=-1)
            dens = torch.clamp(dens, min=0.0)
            nsp = ngas + len(idx.species_cc)
            mean_energies = None
            if has_ee:
                # mean energy from the post-flux s_out states
                # (add_source_terms, m_fluid.f90:358-364)
                ne_out = ro.cc_get_interior(cc, idx.i_electron + s_out,
                                            leaves, nc, ndim)
                en_out = ro.cc_get_interior(
                    cc, idx.i_electron_energy + s_out, leaves, nc, ndim)
                mean_energies = en_out / torch.clamp(ne_out, min=1.0)
            rates = self.chem.get_rates(
                fields_td.reshape(-1),
                energy_eV=(mean_energies.reshape(-1) if has_ee else None))
            if self.st.source_factor != "none":
                rates = self._apply_source_factor(cc, fc, rates, dens,
                                                  leaves, lvl)
            full, derivs = self.chem.get_derivatives(dens.reshape(-1, nsp),
                                                     rates)
            C = nc ** ndim
            derivs = derivs.reshape(n, C, -1)
            full = full.reshape(n, C, -1)

            # chemistry time step restriction (add_source_terms :404-414)
            dflat = dens.reshape(-1, nsp)
            dr_flat = derivs.reshape(dflat.shape)
            if self.dt_cfg.chemistry_nmin > 0:
                tmp = ((dflat + self.dt_cfg.chemistry_nmin)
                       / torch.clamp(dr_flat.abs(), min=uc.tiny(cc.dtype)))
                dt_chem = torch.minimum(dt_chem, tmp.min())
            elif self.dt_cfg.chemistry_limit_loss:
                tmp = (torch.clamp(dflat, min=uc.tiny(cc.dtype))
                       / torch.clamp(-dr_flat, min=uc.tiny(cc.dtype)))
                dt_chem = torch.minimum(dt_chem, tmp.min())

            if last_step:
                vol = tb.d.vol.to(cc.dtype)
                total_rates = total_rates + (full * vol[:, :, None]).sum(
                    dim=(0, 1))
                total_JdotE = total_JdotE + self._sum_JdotE(fc, leaves, vol)

            # photoionization source
            if idx.i_photo >= 0:
                photo = ro.cc_get_interior(cc, idx.i_photo, leaves, nc, ndim)
                derivs[:, :, ngas + idx.species_cc.index(
                    idx.i_electron)] += photo
                derivs[:, :, ngas + idx.species_cc.index(
                    idx.photoi_species_cc)] += photo

            if has_ee:
                # electron energy source: the Joule gain from the electron
                # flux minus the tabulated loss (add_source_terms,
                # m_fluid.f90:442-447), applied before the species' sources
                gain = 0.0
                for d in range(ndim):
                    prod = (ro.fc_get_faces(fc, idx.flux_fc[0], d, leaves,
                                            nc, ndim)
                            * ro.fc_get_faces(fc, idx.fc_E, d, leaves, nc,
                                              ndim))
                    lo, hi = _lo_hi(prod, d, nc)
                    gain = gain + 0.5 * (lo + hi).reshape(n, -1)
                gain = -gain
                loss_rate = self.td.ee_tbl.get_col(TD_EE_LOSS, mean_energies)
                upd_en = dt * (gain - loss_rate * ne_out)
                if mask is not None:
                    upd_en = torch.where(mask, upd_en, 0.0)
                ro.cc_add_interior(cc, idx.i_electron_energy + s_out, leaves,
                                   upd_en, nc, ndim)
                # energy-loss time step restriction (m_fluid.f90:163-166)
                # from the level's largest mean energy; a zero mean energy
                # has zero loss and restricts nothing
                tmp = mean_energies.max()
                restr = torch.where(
                    tmp > 0.0,
                    tmp / torch.clamp(
                        self.td.ee_tbl.get_col(TD_EE_LOSS, tmp),
                        min=uc.tiny(cc.dtype)),
                    uc.huge(cc.dtype))
                dt_other = torch.minimum(dt_other, restr)

            # apply source terms (plasma species only; the gas species are
            # not stored in the tree)
            for spi, s_cc in enumerate(idx.species_cc):
                upd = dt * derivs[:, :, ngas + spi]
                if mask is not None:
                    upd = torch.where(mask, upd, 0.0)
                ro.cc_add_interior(cc, s_cc + s_out, leaves, upd, nc, ndim)

        diag = {"rates": total_rates, "JdotE": total_JdotE,
                "dt_other": dt_other}
        return cc, dt_chem, diag

    def _apply_source_factor(self, cc, fc, rates, dens, leaves, lvl: int):
        """Scale the ionization rates with |flux| / (n_e mu E) to counter
        unphysical ionization driven by diffusion (compute_source_factor,
        ``m_fluid.f90:525-583`` and add_source_terms ``:368-398``).
        Returns the scaled rates; writes the factor to ``i_srcfac``."""
        idx = self.idx
        nc, ndim = self.tree.nc, self.tree.ndim
        n = len(leaves)
        small_flux = 1.0e-9
        ne = dens[:, :, self.chem.n_gas_species
                  + idx.species_cc.index(idx.i_electron)]

        # cell-centered norm of the electron flux
        acc = 0.0
        for d in range(ndim):
            lo, hi = _lo_hi(ro.fc_get_faces(fc, idx.flux_fc[0], d, leaves,
                                            nc, ndim), d, nc)
            acc = acc + (lo + hi).reshape(n, -1) ** 2
        flux_norm = 0.5 * torch.sqrt(acc)

        fld = ro.cc_get_interior(cc, idx.i_electric_fld, leaves, nc, ndim)
        if self.gas.constant_density:
            N_inv = self.gas.inverse_number_density
        else:
            Ng = ro.cc_get_interior(cc, idx.i_gas_dens, leaves, nc, ndim)
            N_inv = 1.0 / torch.where(Ng > 0.0, Ng, 1.0)
        mob = self.td.tbl.get_col(TD_MOBILITY,
                                  fld * uc.SI_to_Townsend * N_inv) * N_inv
        factor = (flux_norm + small_flux) / (small_flux + ne * mob * fld)
        factor = torch.clamp(factor, 0.0, 1.0)
        if self.st.source_min_electrons_per_cell > 0:
            dr = self.tree.lvl_dr(lvl)
            factor = torch.where(
                ne * float(dr.min()) ** 3
                < self.st.source_min_electrons_per_cell, 0.0, factor)
        if idx.i_srcfac >= 0:
            ro.cc_set_interior(cc, idx.i_srcfac, leaves, factor, nc, ndim)
        rates[:, self._ioniz_cols] *= factor.reshape(-1)[:, None]
        return rates

    def _sum_JdotE(self, fc, leaves, vol):
        """Volume-integrated J.E * elec_charge over one level's leaves."""
        idx = self.idx
        nc, ndim = self.tree.nc, self.tree.ndim
        n = len(leaves)
        acc = 0.0
        for d in range(ndim):
            prod = (ro.fc_get_faces(fc, idx.flux_fc[0], d, leaves, nc, ndim)
                    * ro.fc_get_faces(fc, idx.fc_E, d, leaves, nc, ndim))
            lo, hi = _lo_hi(prod, d, nc)
            half = 0.5 * (lo + hi)
            acc = acc + (half.reshape(n, -1) * vol).sum()
        return acc * uc.elec_charge

    # ----------------------------------------------------- forward Euler
    def forward_euler(self, cc, fc, dt: float, dt_lim_state, time: float,
                      s_deriv: int, s_prev: List[int], w_prev: List[float],
                      s_out: int, i_step: int, n_steps: int, params):
        """One explicit sub-step (forward_euler, ``m_fluid.f90:21-99``),
        its flux and its sources timed as the tracer's spans ``flux`` and
        ``source`` (wc_time_flux / wc_time_source, ``m_fluid.f90:57-75``).

        Returns (cc, fc, dt_lim, diag) with dt_lim a 0-d tensor."""
        tr = self.mesh.tracer
        if i_step > 1 and self.field_compute is not None:
            cc, fc = self.field_compute(cc, fc, s_deriv, time, True, params)
        with tr.span("flux"):
            cc, fc, dt_cfl, dt_drt = self.compute_fluxes(cc, fc, s_deriv,
                                                         params)
        with tr.span("source"):
            cc, dt_chem, diag = self.update_densities(
                cc, fc, dt, s_deriv, s_prev, w_prev, s_out,
                i_step == n_steps)
        if self.dielectric is not None:
            # surface charge from the fluxes, secondary and photon emission
            # (forward_euler, m_fluid.f90:77-94)
            cc = self.dielectric.update_surface_charge(cc, fc, dt, s_prev,
                                                       w_prev, s_out)
            cc = self.dielectric.photon_emission(cc, fc, dt, s_out)
        # NOTE: the reference *assigns* dt_lim in each substep
        # (m_fluid.f90:96-98), so af_advance returns the limit of the LAST
        # substep, not the minimum over substeps.
        dt_other = diag.pop("dt_other")
        # the limits over every rank's leaves of a sharded run (exact: a
        # min in any order) and the sums of the rates and of J.E (partial
        # sums)
        dt_cfl, dt_drt, dt_chem, dt_other = self.mesh.reduce(torch.stack(
            [dt_cfl, dt_drt, dt_chem, dt_other]), "min").unbind()
        sums = self.mesh.reduce(torch.cat([diag["rates"],
                                           diag["JdotE"].reshape(1)]), "sum")
        diag["rates"], diag["JdotE"] = sums[:-1], sums[-1]
        dt_cfl = dt_cfl * self.dt_cfg.cfl_number
        dt_lim = torch.clamp(torch.minimum(torch.minimum(dt_cfl, dt_drt),
                                           torch.minimum(dt_chem, dt_other)),
                             max=self.dt_cfg.dt_max)
        # the four dt restrictions in the reference's order (m_dt.f90:13-25:
        # cfl, drt, rates, other); only the energy model sets "other"
        diag["dt_limits"] = torch.stack([dt_cfl, dt_drt, dt_chem, dt_other])
        return cc, fc, dt_lim, diag
