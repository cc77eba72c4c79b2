"""User code: a pre-heated channel on the axis for gas-dynamics runs.

An ``initial_conditions`` hook that raises the gas energy density ``gas_e``
(and so the pressure and the temperature at the same density) in a
Gaussian channel around the axis of a cylindrical domain:
``E = E0 (1 + channel_heating exp(-(r / channel_radius)^2))``, on every
cell of the boxes, ghost layer included. The gas then expands out of the
channel while the streamer runs. It needs ``gas%dynamics = t``.

Use with ``-user%module=afivo_streamer_tpu_torch/programs/heated_channel.py``.
"""

import numpy as np
import torch


def channel_energy(sim, coords, heating: float, radius: float):
    """The gas energy density at points ``coords`` [..., ndim]."""
    gas = sim.gas
    e0 = gas.pressure * 1e5 / (gas.euler_gamma - 1.0)
    r = coords[..., 0] - sim.st.domain_origin[0]
    return e0 * (1.0 + heating * np.exp(-(r / radius) ** 2))


def cell_coords(tree, ids) -> np.ndarray:
    """Cell centres of boxes ``ids``, ghost layer included:
    [n, (nc+2)^ndim, ndim]."""
    ids = np.asarray(ids, np.int64)
    axes = np.meshgrid(*[np.arange(-1, tree.nc + 1) + 0.5] * tree.ndim,
                       indexing="ij")
    off = np.stack([a.ravel() for a in axes], -1)
    return (tree.box_r_min(ids)[:, None, :]
            + off[None, :, :] * tree.box_dr(ids)[:, None, :])


def user_initialize(cfg, sim):
    heating = cfg.add_get("channel_heating", 2.0,
                          "Relative rise of the gas energy on the axis")
    radius = cfg.add_get("channel_radius", 5e-4,
                         "Radius (m) of the heated channel")

    def set_ics(s, ids):
        iv = s.gasdyn.gas_vars[s.gasdyn.i_e]
        e = channel_energy(s, cell_coords(s.tree, ids), heating, radius)
        s.cc[iv, torch.as_tensor(np.asarray(ids, np.int64),
                                 device=s.cc.device)] = torch.as_tensor(
            e, dtype=s.cc.dtype, device=s.cc.device)

    sim.user.initial_conditions = set_ics
