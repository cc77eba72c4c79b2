"""Electron (and ion) transport coefficients from tabulated input data.

Re-implements the old-style path of the reference's
``src/m_transport_data.f90`` (``:87-129``): mobility, diffusion,
ionization (alpha) and attachment (eta) coefficients versus the field in
V/m at standard density, converted to reduced-field (Td) columns of one
regular lookup table; plus the mobile-ion data (``:195-218``).
"""

from __future__ import annotations

from typing import List

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
        if not self.old_style:
            raise NotImplementedError(
                "physics/transport_data.py: new-style transport tables")
        if not gas.constant_density:
            raise ValueError("old style transport with varying gas density")
        if has_energy_equation:
            raise ValueError("old style transport with energy equation")
        ts = table_settings
        self.max_eV = 20.0
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
