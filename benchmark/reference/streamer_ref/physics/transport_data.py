"""Electron (and ion) transport coefficients from tabulated input data.

Re-implements the reference's ``src/m_transport_data.f90``: mobility,
diffusion, ionization (alpha) and attachment (eta) coefficients versus the
reduced field E/N from named text blocks, in the old style (quantities
versus E in V/m at standard density, ``:87-129``) and in the new style
(scaled quantities versus Td with a mean-energy block, ``:130-166``), as
columns of one regular lookup table; the tables of the electron energy
equation versus the mean energy (``:168-193``); and the mobile-ion data
(``:195-218``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .. import constants as uc
from ..utils.lookup_table import LookupTable
from ..utils.table_data import TableDataSettings, table_from_file, table_set_column

# Column indices in the transport table (td_*, m_transport_data.f90:12-22)
TD_MOBILITY = 0
TD_DIFFUSION = 1
TD_ALPHA = 2
TD_ETA = 3
TD_ENERGY_EV = 4

# Columns of the electron-energy table
TD_EE_MOBILITY = 0
TD_EE_DIFFUSION = 1
TD_EE_LOSS = 2
TD_EE_FIELD = 3


class TransportData:
    def __init__(self, cfg, gas, table_settings: TableDataSettings,
                 has_energy_equation: bool = False):
        self.gas = gas
        td_file = cfg.add_get("input_data%file", "UNDEFINED",
                              "Input file with transport (and reaction) data")
        if td_file == "UNDEFINED":
            raise ValueError("input_data%file undefined")
        self.file = td_file
        self.old_style = cfg.add_get(
            "input_data%old_style", False,
            "Use old style transport data (alpha, eta, mu, D vs V/m)")
        ts = table_settings
        self.max_eV = 20.0
        self.ee_tbl: Optional[LookupTable] = None

        if self.old_style:
            if not gas.constant_density:
                raise ValueError(
                    "old style transport with varying gas density")
            if has_energy_equation:
                raise ValueError("old style transport with energy equation")
            self.has_energy_eV = False
            x, y = table_from_file(td_file, "efield[V/m]_vs_mu[m2/Vs]")
            x = x * uc.SI_to_Townsend / gas.number_density
            y = y * gas.number_density
            max_td = x[-1] if ts.max_townsend < 0 else ts.max_townsend
            self.tbl = LookupTable(ts.min_townsend, max_td, ts.table_size, 5,
                                   ts.xspacing)
            table_set_column(self.tbl, TD_MOBILITY, x, y, ts)
            for name, col in (("efield[V/m]_vs_dif[m2/s]", TD_DIFFUSION),
                              ("efield[V/m]_vs_alpha[1/m]", TD_ALPHA),
                              ("efield[V/m]_vs_eta[1/m]", TD_ETA)):
                x, y = table_from_file(td_file, name)
                x = x * uc.SI_to_Townsend / gas.number_density
                y = y * gas.number_density if col == TD_DIFFUSION \
                    else y / gas.number_density
                table_set_column(self.tbl, col, x, y, ts)
        else:
            self.has_energy_eV = True
            x, y = table_from_file(td_file, "Mobility *N (1/m/V/s)")
            max_td = x[-1] if ts.max_townsend < 0 else ts.max_townsend
            self.tbl = LookupTable(ts.min_townsend, max_td, ts.table_size, 5,
                                   ts.xspacing)
            table_set_column(self.tbl, TD_MOBILITY, x, y, ts)
            for name, col in (
                    ("Diffusion coefficient *N (1/m/s)", TD_DIFFUSION),
                    ("Townsend ioniz. coef. alpha/N (m2)", TD_ALPHA),
                    ("Townsend attach. coef. eta/N (m2)", TD_ETA),
                    ("Mean energy (eV)", TD_ENERGY_EV)):
                x, y = table_from_file(td_file, name)
                table_set_column(self.tbl, col, x, y, ts)
            # the last value of the mean-energy block
            self.max_eV = float(y[-1])

        if has_energy_equation:
            # columns versus the mean energy; the loss, the diffusion and
            # the field start from a prepended zero at zero energy
            _, energy_eV = table_from_file(td_file, "Mean energy (eV)")
            energy_0 = np.concatenate([[0.0], energy_eV])
            self.ee_tbl = LookupTable(0.0, energy_eV[-1], ts.table_size, 4,
                                      ts.xspacing)
            x, y = table_from_file(td_file, "Mobility *N (1/m/V/s)")
            table_set_column(self.ee_tbl, TD_EE_MOBILITY, energy_eV, y, ts)
            # energy loss = mu E^2 versus the energy
            loss = y * x**2 * uc.Townsend_to_SI**2 * gas.number_density
            table_set_column(self.ee_tbl, TD_EE_LOSS, energy_0,
                             np.concatenate([[0.0], loss]), ts)
            x, y = table_from_file(td_file,
                                   "Diffusion coefficient *N (1/m/s)")
            table_set_column(self.ee_tbl, TD_EE_DIFFUSION, energy_0,
                             np.concatenate([[0.0], y]), ts)
            table_set_column(self.ee_tbl, TD_EE_FIELD, energy_0,
                             np.concatenate([[0.0], x]), ts)

        # mobile ions (m_transport_data.f90:195-215)
        self.mobile_ion_names: List[str] = cfg.add_get(
            "input_data%mobile_ions", [],
            "List of ions that are considered mobile", dynamic=True)
        mob = cfg.add_get("input_data%ion_mobilities", [],
                          "List of ion mobilities (m^2/Vs) at 1 bar, 300 K",
                          dynamic=True)
        mob = np.asarray([float(m) for m in mob])
        if np.any(mob < 0):
            raise ValueError("ion mobilities should be positive")
        # scale with gas number density at 300 K and 1 bar
        self.ion_mobilities = mob * (1e5 / (uc.boltzmann_const * 300.0))
        self.ion_se_yield = cfg.add_get(
            "input_data%ion_se_yield", 0.0,
            "Secondary electron emission yield for positive ions")
