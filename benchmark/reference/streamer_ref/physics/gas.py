"""Gas composition and (constant-density) state.

Covers the configuration side of the reference's ``src/m_gas.f90``
(gas_initialize ``:102-176``): components/fractions, pressure, temperature,
the derived number density N = 1e5 p / (kB T), and the Townsend conversion.
Dynamic gas (coupled Euler equations, ``gas%dynamics``) is handled by
physics/gas_dynamics.py.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .. import constants as uc


class Gas:
    def __init__(self, cfg=None):
        self.dynamics = False
        self.constant_density = True
        self.pressure = 1.0  # bar
        self.temperature = 300.0  # K
        self.components: List[str] = ["N2", "O2"]
        self.fractions = np.array([0.8, 0.2])
        self.molecular_weight = 28.8 * uc.atomic_mass
        self.heating_efficiency = 1.0
        self.fraction_slow_heating = 0.0
        self.vt_time = 20e-6
        self.euler_gamma = 1.4
        if cfg is not None:
            self.dynamics = cfg.add_get("gas%dynamics", False,
                                        "Whether the gas dynamics are simulated")
            self.components = cfg.add_get(
                "gas%components", list(self.components),
                "Gas component names", dynamic=True)
            fr = cfg.add_get("gas%fractions", [0.8, 0.2],
                             "Gas component fractions", dynamic=True)
            self.fractions = np.asarray(fr, dtype=np.float64)
            self.pressure = cfg.add_get("gas%pressure", 1.0,
                                        "The gas pressure (bar)")
            self.temperature = cfg.add_get("gas%temperature", 300.0,
                                           "The gas temperature (Kelvin)")
            mw = cfg.add_get("gas%molecular_weight", 28.8,
                             "Gas mean molecular weight (amu), for gas dynamics")
            self.molecular_weight = mw * uc.atomic_mass
            self.heating_efficiency = cfg.add_get(
                "gas%heating_efficiency", 1.0,
                "Joule heating efficiency (between 0.0 and 1.0)")
            self.fraction_slow_heating = cfg.add_get(
                "gas%fraction_slow_heating", 0.0,
                "Fraction of gas heating via V-T relaxation")
            self.vt_time = cfg.add_get(
                "gas%vt_relaxation_time", 20e-6,
                "Vibration-Translation relaxation time")
            self.EHD_factor = cfg.add_get(
                "gas%EHD_factor", 1.0,
                "Factor for the EHD force term (should be 1 by default)")
            if self.dynamics:
                self.constant_density = False
        if len(self.components) != len(self.fractions):
            raise ValueError("gas%components and gas%fractions size mismatch")
        if abs(float(np.sum(self.fractions)) - 1.0) > 1e-4:
            raise ValueError("gas fractions do not sum to 1")
        # the last component is 'M', the total density
        # (gas_initialize, m_gas.f90:183-190)
        self.components = list(self.components) + ["M"]
        self.fractions = np.concatenate([self.fractions, [1.0]])
        # N = 1e5 * p / (kB T)  (gas_initialize, m_gas.f90:174-176)
        self.number_density = 1e5 * self.pressure / (
            uc.boltzmann_const * self.temperature)
        self.inverse_number_density = 1.0 / self.number_density
        self.densities = self.fractions * self.number_density

    def index(self, name: str) -> int:
        """Index of a gas component, -1 if not present (gas_index)."""
        try:
            return self.components.index(name)
        except ValueError:
            return -1
