"""User code for the dielectric_2d program.

Port of the JAX package's ``programs/dielectric_2d/user.py`` (the
reference's ``programs/dielectric_2d/m_user.f90``): sets the permittivity
pattern (a dielectric slab at the top/bottom/left of the domain) and zeroes
the electron and first positive-ion densities inside the dielectric, on
every cell of the boxes including the ghost layer, on the state's device.

Use with ``-user%module=afivo_streamer_tpu_torch/programs/dielectric_2d.py``.
"""

import numpy as np
import torch


def user_initialize(cfg, sim):
    dielectric_type = cfg.add_get("dielectric_type", "top",
                                  "What kind of dielectric to use")
    dielectric_eps = cfg.add_get("dielectric_eps", 2.0,
                                 "The dielectric permittivity")

    def set_ics(s, ids):
        # user_initialize runs before the domain is set up (module order,
        # streamer.f90:439-455), so read the geometry at hook time
        L = s.st.domain_len
        coords = s.tree.boxes_cell_coords(ids)
        if dielectric_type == "top":
            inside = coords[..., 1] > 0.75 * L[1]
        elif dielectric_type == "bottom":
            inside = coords[..., 1] < 0.25 * L[1]
        elif dielectric_type == "left":
            inside = coords[..., 0] < 0.25 * L[0]
        else:
            raise ValueError(f"unknown dielectric_type {dielectric_type}")
        inside = torch.as_tensor(inside.reshape(len(ids), -1),
                                 device=s.cc.device)
        rows = torch.as_tensor(np.asarray(ids, np.int64), device=s.cc.device)
        s.cc[s.i_eps, rows] = torch.where(inside, dielectric_eps, 1.0).to(
            s.cc.dtype)
        for iv in (s.i_electron, s.i_1pos_ion):
            s.cc[iv, rows] = torch.where(inside, 0.0, s.cc[iv, rows])

    sim.user.initial_conditions = set_ics
