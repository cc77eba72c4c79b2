"""Dielectric surface physics: charge from fluxes, secondary and photon
electron emission.

Re-implements the reference's ``src/m_dielectric.f90``: the surface-charge
update from the charged-species fluxes onto the surface with ion secondary
electron emission (dielectric_update_surface_charge ``:94-182``) and
photon-flux-driven electron emission where the field points into the
surface (dielectric_photon_emission ``:184-237``), and the interception of
Monte-Carlo photons by the surfaces (dielectric_photon_absorption
``:243-336``), on the surface state rows of solvers/surface.py. The
photons' segments are tested against the surfaces on the host, where the
photons are made (physics/photoi_mc.py); the fluxes they leave are added
to the photon row on the state's device.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import constants as uc
from ..core.tree import neighb_dim, neighb_low


class Dielectric:
    def __init__(self, cfg, surfaces, idx, i_eps: int, flux_species_charge,
                 flux_pos_ion: List[int]):
        """i_eps: cc variable of the permittivity; flux_species_charge:
        charge of each flux species (in the order of idx.flux_fc);
        flux_pos_ion: fc indices of positive-ion fluxes."""
        self.surf = surfaces
        self.idx = idx
        self.i_eps = i_eps
        self.flux_species_charge = np.asarray(flux_species_charge,
                                              np.float64)
        self.flux_pos_ion = list(flux_pos_ion)
        self.photon_step_length = cfg.add_get(
            "dielectric%photon_step_length", 1.0e-3,
            "Maximum travel distance for testing boundary intersection")
        self.gamma_se_ph_he = cfg.add_get(
            "dielectric%gamma_se_ph_highenergy", 0.1,
            "Secondary electron emission coefficient for high energy "
            "photons")
        self.gamma_se_ph_le = cfg.add_get(
            "dielectric%gamma_se_ph_lowenergy", 0.1,
            "Secondary electron emission coefficient for low energy "
            "photons")
        self.gamma_se_ion = cfg.add_get(
            "dielectric%gamma_se_ion", 0.1,
            "Secondary electron emission coefficient for positive ion "
            "impact")
        self.photons_no_absorption = cfg.add_get(
            "dielectric%photons_no_absorption", False,
            "Assume photons are not absorbed for photoemission computation")

    def update_surface_charge(self, cc, fc, dt: float, s_prev: List[int],
                              w_prev: List[float], s_out: int):
        """sigma(s_out) = sum_k w_k sigma(s_k) +- dt sum(q flux) at the
        surface face; ion-impact secondary emission adds electrons in the
        first gas cell and charge to the surface."""
        sf, idx = self.surf, self.idx
        for t in sf.tables(cc.device).dirs:
            ro = t.rows_out[:, None]
            idr = t.inv_dr.to(cc.dtype)[:, None]
            sign = -1.0 if t.low else 1.0
            sd_new = 0.0
            for s, w in zip(s_prev, w_prev):
                sd_new = sd_new + float(w) * cc[sf.i_sigma + s, ro, t.fidx]
            flux_sum = 0.0
            for m, f_iv in enumerate(idx.flux_fc):
                q = float(self.flux_species_charge[m])
                if q == 0.0:
                    continue
                flux_sum = flux_sum + q * fc[f_iv, t.dim, ro, t.fo]
            sd_new = sd_new + (sign * dt) * flux_sum
            if self.flux_pos_ion and self.gamma_se_ion > 0:
                ion_flux = 0.0
                for f_iv in self.flux_pos_ion:
                    ion_flux = ion_flux + fc[f_iv, t.dim, ro, t.fo]
                se_flux = (sign * self.gamma_se_ion) * ion_flux
                cc[idx.i_electron + s_out].index_put_(
                    (ro, t.gas[None, :]), dt * idr * se_flux,
                    accumulate=True)
                sd_new = sd_new + dt * se_flux
            cc[sf.i_sigma + s_out, ro, t.fidx] = sd_new
        return cc

    def photon_emission(self, cc, fc, dt: float, s_out: int):
        """Where the face field points into the surface, emit electrons in
        the first gas cell in proportion to the stored photon flux, and
        charge the surface accordingly."""
        sf, idx = self.surf, self.idx
        for t in sf.tables(cc.device).dirs:
            ro, fidx = t.rows_out[:, None], t.fidx
            idr = t.inv_dr.to(cc.dtype)[:, None]
            E_face = fc[idx.fc_E, t.dim, ro, t.fo]
            into = (E_face < 0.0) if t.low else (E_face > 0.0)
            pf = cc[sf.i_photon, ro, fidx]
            zero = pf.new_zeros(())
            cc[idx.i_electron + s_out].index_put_(
                (ro, t.gas[None, :]), torch.where(into, pf * dt * idr, zero),
                accumulate=True)
            cc[sf.i_sigma + s_out, ro, fidx] = (
                cc[sf.i_sigma + s_out, ro, fidx]
                + torch.where(into, pf * (dt * uc.elem_charge), zero))
        return cc


    # ------------------------------------------------ Monte-Carlo photons
    def reset_photons(self, cc):
        """Zero the photon flux of every active surface."""
        sf = self.surf
        for t in sf.tables(cc.device).dirs:
            cc[sf.i_photon, t.rows_out[:, None], t.fidx] = 0.0
        return cc

    def _deposit_photons(self, acc, xyz_src, xyz_abs, weight: float,
                         frac_gamma: float, skip=None) -> np.ndarray:
        """Add frac_gamma * weight / area to ``acc`` (per active surface,
        its face cells) where a photon's segment crosses the surface's
        plane within its extent, each photon at the first such surface in
        the surfaces' order; returns the mask of the photons that hit."""
        tree = self.surf.tree
        nc, ndim = tree.nc, tree.ndim
        hit_any = np.zeros(len(xyz_src), dtype=bool)
        for k, s in enumerate(self.surf.active()):
            dim, low = neighb_dim(s.direction), neighb_low(s.direction)
            dr = tree.lvl_dr(int(tree.lvl[s.id_out]))
            r0 = tree.box_r_min(np.asarray([s.id_out]))[0]
            plane = r0[dim] if low else r0[dim] + nc * dr[dim]
            tdims = [j for j in range(ndim) if j != dim]
            a = xyz_src[:, dim]
            b = xyz_abs[:, dim]
            crosses = ((a - plane) * (b - plane) < 0) & ~hit_any
            if skip is not None:
                crosses &= ~skip
            if not crosses.any():
                continue
            frac = (plane - a[crosses]) / (b[crosses] - a[crosses])
            hit = xyz_src[crosses] + frac[:, None] * (
                xyz_abs[crosses] - xyz_src[crosses])
            ok = np.ones(len(hit), dtype=bool)
            cell = np.zeros((len(hit),), np.int64)
            for j in tdims:
                rel = (hit[:, j] - r0[j]) / dr[j]
                ok &= (rel >= 0) & (rel < nc)
                cell = cell * nc + np.clip(rel.astype(np.int64), 0, nc - 1)
            sel = np.nonzero(crosses)[0][ok]
            area = np.prod([dr[j] for j in tdims]) if tdims else 1.0
            np.add.at(acc[k], cell[ok], frac_gamma * weight / area)
            hit_any[sel] = True
        return hit_any

    def photon_absorption(self, cc, xyz_src, xyz_abs, weight: float):
        """Intercept the Monte-Carlo photons that cross a surface
        (dielectric_photon_absorption, ``m_dielectric.f90:243-336``): a
        photon absorbed within its path deposits the high- and low-energy
        photoemission fractions and is removed; with
        dielectric%photons_no_absorption the paths of the others are
        extended across the domain and deposit the low-energy fraction (a
        segment-plane intersection with the axis-aligned surface faces, as
        in the JAX package). Returns the state and the mask of the absorbed
        photons."""
        if self.gamma_se_ph_he <= 0 and self.gamma_se_ph_le <= 0:
            return cc, np.zeros(len(xyz_src), dtype=bool)
        tree = self.surf.tree
        active = self.surf.active()
        acc = np.zeros((len(active), self.surf.face_cells))
        absorbed = self._deposit_photons(
            acc, xyz_src, xyz_abs, weight,
            self.gamma_se_ph_he + self.gamma_se_ph_le)
        if self.photons_no_absorption and len(xyz_src):
            dvec = xyz_abs - xyz_src
            norm = np.maximum(np.linalg.norm(dvec, axis=1, keepdims=True),
                              1e-300)
            L = float(np.linalg.norm(tree.domain_len))
            far = xyz_abs + dvec / norm * L
            self._deposit_photons(acc, xyz_abs, far, weight,
                                  self.gamma_se_ph_le, skip=absorbed)
        if active and acc.any():
            # every rank computes every surface's share (the photons are
            # the same on every rank of a sharded run) and keeps its own
            sf = self.surf
            mine, rows = sf.own_rows([s.id_out for s in active])
            rows = torch.as_tensor(rows, device=cc.device)
            cc[sf.i_photon, rows, :sf.face_cells] += torch.as_tensor(
                acc[mine], dtype=cc.dtype, device=cc.device)
        return cc, absorbed
