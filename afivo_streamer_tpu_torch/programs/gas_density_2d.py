"""User code for the gas_density_2d program.

Port of the JAX package's ``programs/gas_density_2d/user.py`` (the
reference's ``programs/gas_density_2d/m_user.f90``): composable axial (z)
and radial (r) gas number density profiles for an axisymmetric channel,
given to the simulation as its ``gas_density`` hook. The simulation calls
the hook with the cell centres of boxes, ghost layer included, as NumPy
coordinates [..., ndim], and stores the result in the variable ``M``.

Use with ``-user%module=afivo_streamer_tpu_torch/programs/gas_density_2d.py``.
"""

import numpy as np


def user_initialize(cfg, sim):
    profile_z = cfg.add_get(
        "density_profile_z", "homogeneous",
        "Name of the gas number density profile in the z direction")
    profile_r = cfg.add_get(
        "density_profile_r", "homogeneous",
        "Name of the gas number density profile in the r direction")
    z_ratio = cfg.add_get("z_density_ratio", 0.0,
                          "Density ratio in the z direction")
    r_reduction = cfg.add_get(
        "r_reduction", 0.5, "Reduction of the gas number density on the axis")
    r_width = cfg.add_get("r_width", 0.1,
                          "Width of the profile in the r direction")
    if profile_z not in ("homogeneous", "linear_z"):
        raise ValueError("Unknown density_profile_z specified")
    if profile_r not in ("homogeneous", "gaussian", "step"):
        raise ValueError("Unknown density_profile_r specified")

    def gas_density(s, coords):
        # user_initialize runs before the domain is set up (module order,
        # streamer.f90:439-455), so read the geometry at hook time
        N = s.gas.number_density
        rel = (coords - s.st.domain_origin) / s.st.domain_len
        r_rel, z_rel = rel[..., 0], rel[..., 1]
        if profile_z == "linear_z":
            dens = N * (1 + (z_ratio - 1) * z_rel) / max(1.0, abs(z_ratio))
        else:
            dens = N * np.ones_like(z_rel)
        if profile_r == "gaussian":
            dens = dens * (1 - r_reduction * np.exp(-(r_rel / r_width) ** 2))
        elif profile_r == "step":
            dens = np.where(r_rel < r_width, r_reduction * dens, dens)
        return dens
    sim.user.gas_density = gas_density
