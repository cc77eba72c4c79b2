"""User code for the comparison_air_2d program (the setup of the six-code
streamer benchmark).

Port of the JAX package's ``programs/comparison_air_2d/user.py`` (the
reference's ``programs/comparison_air_2d/m_user.f90``): the boundary
potential in the last dimension is read from position-dependent tables for
the upper and lower electrodes and scaled by the current voltage; the
other sides get zero-Neumann conditions. The tables are the synthetic
``data/applied_voltage_upper.txt`` and ``data/applied_voltage_lower.txt``
(``data/make_voltage_tables.py`` writes them).

The hook is called for every boundary ghost fill and multigrid cycle. Each
set of face coordinates (one per level and side) has its profile
interpolated once and kept on the state's device; a call scales it by the
voltage there, so no boundary value crosses to the device per cycle.

Use with
``-user%module=afivo_streamer_tpu_torch/programs/comparison_air_2d.py``.
"""

from pathlib import Path

import numpy as np
import torch

from afivo_streamer_tpu_torch.core import ghostcell as gc
from afivo_streamer_tpu_torch.utils.table_data import table_from_file

DATA = Path(__file__).resolve().parent.parent / "data"
#: profiles kept at most (one per level and side of a mesh)
MAX_PROFILES = 256


def user_initialize(cfg, sim):
    xu, yu = table_from_file(str(DATA / "applied_voltage_upper.txt"),
                             "location[m]_vs_potential[V]")
    xl, yl = table_from_file(str(DATA / "applied_voltage_lower.txt"),
                             "location[m]_vs_potential[V]")
    profiles = {}

    def profile(d, coords):
        key = (d, coords.shape, coords.tobytes())
        prof = profiles.get(key)
        if prof is None:
            x, y = (xl, yl) if d % 2 == 0 else (xu, yu)
            prof = torch.as_tensor(np.interp(coords[..., 0], x, y),
                                   dtype=sim.dtype, device=sim.device)
            if len(profiles) >= MAX_PROFILES:
                profiles.clear()
            profiles[key] = prof
        return prof

    def potential_bc(iv, d, coords, params):
        ndim = coords.shape[-1]
        if d // 2 == ndim - 1:
            return gc.BC_DIRICHLET, (params.get("voltage", 0.0)
                                     * profile(d, coords))
        return gc.BC_NEUMANN, 0.0

    sim.user.potential_bc = potential_bc
