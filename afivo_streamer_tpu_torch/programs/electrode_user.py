"""User code for an electrode of the user's own shape
(``field_electrode_type = user``): an elliptic blade hanging from the top
plate of a 2D domain, held at a fixed potential.

``user_initialize`` sets the two hooks the field solver takes for such an
electrode: ``sim.user.lsf`` (the level-set function on points [n, ndim],
negative inside the electrode) and ``sim.user.lsf_bc`` (the potential on
its surface in V; the solve then scales it by 1, not by the applied
voltage). Both are NumPy functions of coordinates only, so the JAX package
takes this module unchanged.

Use with ``-use_electrode=t -field_electrode_type=user
-field_rod_radius=4e-4
-user%module=afivo_streamer_tpu_torch/programs/electrode_user.py``
(``field_rod_radius`` is the electrode's length scale for the boundary
search).
"""

import numpy as np

#: semi-axes of the blade (m) and the potential on its surface (V)
SEMI_AXES = np.array([4e-4, 2.4e-3])
POTENTIAL = 2.5e4


def user_initialize(cfg, sim):
    def lsf(r):
        # the blade's centre: mid-domain in x, on the top plate (the
        # domain's settings exist once the field solver asks)
        st = sim.st
        centre = st.domain_origin + np.array([0.5, 1.0]) * st.domain_len
        scaled = (np.asarray(r) - centre) / SEMI_AXES
        return (np.linalg.norm(scaled, axis=-1) - 1.0) * SEMI_AXES.min()

    def lsf_bc(r):
        return np.full(np.shape(r)[:-1], POTENTIAL)

    sim.user.lsf = lsf
    sim.user.lsf_bc = lsf_bc
