"""Physical and numerical constants.

Mirrors the reference's ``src/m_units_constants.f90:1-28`` (exact same values,
so that rate/field conversions reproduce the regression data bit-for-bit
within float64 rounding).
"""

import math

pi = math.pi

eps0 = 8.8541878176e-12  #: permittivity of vacuum (SI)
elem_charge = 1.6022e-19  #: elementary charge (C)
elec_charge = -1.6022e-19  #: electron charge (C)
elec_volt = 1.6022e-19  #: eV in joules
elec_mass = 9.10938189e-31  #: electron mass (kg)
atomic_mass = 1.66053886e-27  #: atomic mass unit (kg)
N2_mass = 28.0 * atomic_mass
O2_mass = 32.0 * atomic_mass
lightspeed = 299792458.0
boltzmann_const = 1.3806503e-23
bohr_radius = 5.29e-11
torr_to_bar = 133.322368 * 1.0e-5
elec_q_over_eps0 = elec_charge / eps0
elec_q_over_m = elec_charge / elec_mass

# Conversion V/m <-> Townsend (reference src/m_gas.f90:38-42)
SI_to_Townsend = 1e21
Townsend_to_SI = 1e-21

#: Marker for undefined values (reference src/m_types.f90)
undefined_real = -1e100
huge_real = 1e100


def tiny(dtype) -> float:
    """The reference's 1e-100 guard in ``dtype`` (a torch dtype): 1e-30 in
    float32, whose exponent range holds neither 1e-100 nor 1e100, as on the
    JAX package's traced path (fluid.py:54-62)."""
    return 1e-100 if dtype.itemsize == 8 else 1e-30


def huge(dtype) -> float:
    """The reference's 1e100 "no limit" sentinel in ``dtype``: 1e30 in
    float32."""
    return huge_real if dtype.itemsize == 8 else 1e30
