"""User code for the stability_3d program.

Port of the JAX package's ``programs/stability_3d/user.py`` (the
reference's ``programs/stability_3d/m_user.f90``): the applied field decays
exponentially with the distance the (downward) streamer has propagated
past a given z-coordinate, detected as the lowest z where the electron
density exceeds 1e18 /m3 (analysis.zmin_zmax_threshold, a masked reduction
over the leaves on the device).

Use with ``-user%module=afivo_streamer_tpu_torch/programs/stability_3d.py``.
"""

import numpy as np

from afivo_streamer_tpu_torch.physics import analysis


def user_initialize(cfg, sim):
    p = {
        "initial_field": cfg.add_get(
            "my%initial_field", -2e6, "Initial field before any decay (V/m)"),
        "min_field": cfg.add_get("my%min_field", -5e5, "Minimal field (V/m)"),
        "decay_distance": cfg.add_get(
            "my%decay_distance", 10e-3, "Decay distance (m)"),
        "decay_start_time": cfg.add_get(
            "my%decay_start_time", 10.0e-9, "Decay start time (s)"),
        "decay_start_z": cfg.add_get(
            "my%decay_start_z", 28e-3,
            "Decay starts from this z-coordinate"),
    }
    detection_density = 1e18

    def my_field_amplitude(s, time):
        zminmax = analysis.zmin_zmax_threshold(
            s.cc, s.mesh, s.i_electron, detection_density,
            [1e100, -1e100])
        zmin = zminmax[0]
        dist = max(p["decay_start_z"] - zmin, 0.0)
        return (p["min_field"] + (p["initial_field"] - p["min_field"])
                * np.exp(-dist / p["decay_distance"]))

    sim.user.field_amplitude = my_field_amplitude
