"""User code of the sprite programs, 2d_sprite.py (axisymmetric) and
3d_sprite.py (3D).

Port of the JAX package's ``programs/2d_sprite/user.py`` and
``programs/3d_sprite/user.py``, which are the same (the reference's
``programs/2d_sprite/m_user.f90``): an air density that falls with
altitude (scale height 7.2 km, the ``gas_density`` hook) and a Wait-Spies
ambient electron and ion profile added to the configured seeds (the
``initial_conditions`` hook, on all boxes of a call at once, ghost layer
included, on the state's device). The domain's origin sits at the altitude
of the run (``domain_origin``), so z is the height above the ground.
"""

import numpy as np
import torch

from afivo_streamer_tpu_torch.utils.geometry import density_line

E_DECAY_HEIGHT = 2.86e3
SCALE_HEIGHT = 7.2e3
N_E0 = 1e4


def user_initialize(cfg, sim):
    def gas_density(s, coords):
        # 2.5e25 * exp(-z / scale_height) (m_user.f90:33-40)
        return 2.5e25 * np.exp(-coords[..., -1] / SCALE_HEIGHT)

    def init_cond(s, ids):
        ic = s.init_cond
        ids = np.asarray(ids, np.int64)
        rr = s.tree.boxes_cell_coords(ids)  # incl. ghost layer
        n_e = N_E0 * np.exp((rr[..., -1] - 60e3) / E_DECAY_HEIGHT)
        ne = n_e.copy()
        ni = n_e.copy()
        for n in range(ic.n_cond):
            dens = density_line(
                rr, ic.seed_r0[n], ic.seed_r1[n], ic.seed_density[n],
                ic.seed_density2[n], ic.seed_width[n], ic.seed_falloff[n])
            if ic.seed_charge_type[n] <= 0:
                ne = ne + dens
            if ic.seed_charge_type[n] >= 0:
                ni = ni + dens
        rows = torch.as_tensor(ids, device=s.cc.device)
        for iv, vals in ((s.i_electron, ne), (s.i_1pos_ion, ni)):
            s.cc[iv, rows] = torch.as_tensor(
                vals.reshape(len(ids), -1), dtype=s.cc.dtype,
                device=s.cc.device)

    sim.user.gas_density = gas_density
    sim.user.initial_conditions = init_cond
