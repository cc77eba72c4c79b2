"""User code for the gas_gradient_2d program.

Port of the JAX package's ``programs/gas_gradient_2d/user.py`` (the
reference's ``programs/gas_gradient_2d/m_user.f90``): the gas number
density differs on two sides of a line or a sphere, with a linear shock
profile of configurable width. The simulation calls the ``gas_density``
hook with the cell centres of boxes, ghost layer included, as NumPy
coordinates [..., ndim], and stores the result in the variable ``M``.

Use with
``-user%module=afivo_streamer_tpu_torch/programs/gas_gradient_2d.py``.
"""

import numpy as np


def user_initialize(cfg, sim):
    gradient_type = cfg.add_get("gradient_type", "line",
                                "What type of gas gradient to use "
                                "(line, sphere)")
    ndim = sim.ndim
    density_ratio = cfg.add_get("density_ratio", 0.8, "Density ratio (<= 1)")
    shock_width = cfg.add_get("shock_width", 0.01,
                              "Shock width (relative to domain size)")
    line_coeff = np.asarray(cfg.add_get(
        "line_coeff", [0.0] * (ndim + 1),
        "Coefficients a, b, c of a line a + bx + cy = 0"))
    sphere_center = np.asarray(cfg.add_get(
        "sphere_center", [0.5] * ndim,
        "Center (relative to domain) of sphere"))
    sphere_radius = cfg.add_get("sphere_radius", 0.1,
                                "Radius (relative to domain) of sphere")
    inside = cfg.add_get("density_ratio_inside_sphere", False,
                         "Whether density ratio is inside sphere")

    def gas_density_line(s, coords):
        N = s.gas.number_density
        r_rel = (coords - s.st.domain_origin) / s.st.domain_len
        q = ((line_coeff[0] + np.sum(line_coeff[1:] * r_rel, axis=-1))
             / np.linalg.norm(line_coeff[1:]))
        tmp = np.clip((q + shock_width) / (2 * shock_width), 0.0, 1.0)
        return N * (1 + (density_ratio - 1) * tmp)

    def gas_density_sphere(s, coords):
        N = s.gas.number_density
        r_rel = (coords - s.st.domain_origin) / s.st.domain_len
        q = np.linalg.norm(r_rel - sphere_center, axis=-1)
        if inside:
            tmp = np.clip((sphere_radius + shock_width - q)
                          / (2 * shock_width), 0.0, 1.0)
        else:
            tmp = np.clip((q - sphere_radius + shock_width)
                          / (2 * shock_width), 0.0, 1.0)
        return N * (1 + (density_ratio - 1) * tmp)

    if gradient_type == "line":
        sim.user.gas_density = gas_density_line
    elif gradient_type == "sphere":
        sim.user.gas_density = gas_density_sphere
    else:
        raise ValueError("Unknown gradient_type")
