"""Dielectric surface physics: charge from fluxes, secondary and photon
electron emission.

Re-implements the reference's ``src/m_dielectric.f90``: the surface-charge
update from the charged-species fluxes onto the surface with ion secondary
electron emission (dielectric_update_surface_charge ``:94-182``) and
photon-flux-driven electron emission where the field points into the
surface (dielectric_photon_emission ``:184-237``), on the surface state
rows of solvers/surface.py. The interception of Monte-Carlo photons
(dielectric_photon_absorption) comes with the Monte-Carlo photoionization.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import constants as uc


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
        # the photon settings (dielectric%gamma_se_ph_*, %photon_step_length,
        # %photons_no_absorption) serve photon absorption, which comes with
        # the Monte-Carlo photoionization
        self.gamma_se_ion = cfg.add_get(
            "dielectric%gamma_se_ion", 0.1,
            "Secondary electron emission coefficient for positive ion "
            "impact")

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

