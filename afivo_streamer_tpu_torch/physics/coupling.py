"""Plasma-to-gas coupling: Joule heating, the EHD force and the gas density.

Port of the JAX package's ``physics/coupling.py``, which re-implements the
reference's ``src/m_coupling.f90``: J.E heating split into a fast channel
and a slow (vibrational) one that relaxes into the gas over the V-T time
(add_heating_box ``:28-83``), the electrohydrodynamic body force q E on the
gas momentum, and the gas number density M = rho / molecular weight
(``:86-103``).
"""

from __future__ import annotations

import numpy as np

from .. import constants as uc
from ..core import rowops as ro
from .fluid import _lo_hi


class Coupling:
    def __init__(self, mesh, gas, gasdyn, idx, registry, charged_species_cc,
                 charged_sign):
        self.mesh = mesh
        self.tree = mesh.tree
        self.gas = gas
        self.gd = gasdyn
        self.idx = idx  # FluidIndices
        self.charged_cc = list(charged_species_cc)
        self.charged_sign = np.asarray(charged_sign, np.float64)
        self.i_vib = -1
        if gas.fraction_slow_heating > 0:
            self.i_vib = registry.add_cc("vibrational_energy")

    def add_fluid_source(self, cc, fc, dt: float):
        """coupling_add_fluid_source / add_heating_box: the heating from
        the electron flux and the face field of the last field solve, and
        the EHD force from the space charge."""
        t = self.tree
        nc, ndim = t.nc, t.ndim
        idx, gd, gas = self.idx, self.gd, self.gas
        i_e_var = gd.gas_vars[gd.i_e]
        for lvl in range(1, t.highest_lvl + 1):
            tb = self.mesh.tb(lvl)
            n = len(tb.leaves)
            if n == 0:
                continue
            leaves = tb.d.leaves
            # J.E per cell from the face products (fc_inner_product) and
            # the cell-centred E (face averages)
            JdotE = 0.0
            E_vec = []
            for d in range(ndim):
                Fe = ro.fc_get_faces(fc, idx.flux_fc[0], d, leaves, nc, ndim)
                Ef = ro.fc_get_faces(fc, idx.fc_E, d, leaves, nc, ndim)
                p_lo, p_hi = _lo_hi(Fe * Ef, d, nc)
                JdotE = JdotE + 0.5 * (p_lo + p_hi)
                e_lo, e_hi = _lo_hi(Ef, d, nc)
                E_vec.append(0.5 * (e_lo + e_hi))
            tmp = (JdotE * uc.elec_charge * dt).reshape(n, -1)

            e_old = ro.cc_get_interior(cc, i_e_var, leaves, nc, ndim)
            if gas.fraction_slow_heating > 0:
                eff_fast = gas.heating_efficiency * (
                    1 - gas.fraction_slow_heating)
                eff_slow = gas.heating_efficiency * gas.fraction_slow_heating
                vib = ro.cc_get_interior(cc, self.i_vib, leaves, nc, ndim)
                release = vib / gas.vt_time * dt
                ro.cc_set_interior(cc, self.i_vib, leaves,
                                   vib + eff_slow * tmp - release, nc, ndim)
                e_new = e_old + eff_fast * tmp + release
            else:
                e_new = e_old + gas.heating_efficiency * tmp
            ro.cc_set_interior(cc, i_e_var, leaves, e_new, nc, ndim)

            # EHD body force q E on the momentum
            charge = 0.0
            for s_cc, q in zip(self.charged_cc, self.charged_sign):
                charge = charge + q * ro.cc_get_interior(cc, s_cc, leaves, nc,
                                                         ndim)
            charge = uc.elem_charge * charge
            for d in range(ndim):
                upd = gas.EHD_factor * charge * E_vec[d].reshape(n, -1) * dt
                ro.cc_add_interior(cc, gd.gas_vars[gd.i_mom[d]], leaves, upd,
                                   nc, ndim)
        return cc

    def update_gas_density(self, cc, gc_fill):
        """M = rho / molecular_weight on the leaves, then ``gc_fill(cc,
        [M])`` fills its ghost cells."""
        t = self.tree
        nc, ndim = t.nc, t.ndim
        inv_w = 1.0 / self.gas.molecular_weight
        i_rho = self.gd.gas_vars[self.gd.i_rho]
        for lvl in range(1, t.highest_lvl + 1):
            tb = self.mesh.tb(lvl)
            if len(tb.leaves) == 0:
                continue
            rho = ro.cc_get_interior(cc, i_rho, tb.d.leaves, nc, ndim)
            ro.cc_set_interior(cc, self.gd.i_gas_dens, tb.d.leaves,
                               rho * inv_w, nc, ndim)
        return gc_fill(cc, [self.gd.i_gas_dens])
