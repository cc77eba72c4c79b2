"""User code for the velocity_control_2d program.

Port of the JAX package's ``programs/velocity_control_2d/user.py`` (the
reference's ``programs/velocity_control_2d/m_user.f90``): a feedback
controller on the applied field that steers the streamer velocity (from
the motion of the field maximum, smoothed over a 5-entry ring buffer)
toward a goal velocity. The ``generic`` hook reads the position of max(E)
every step (one reduction on the device); the ``field_amplitude`` hook
keeps the controller's state and is called at every voltage update, so
the number and order of its calls are part of the result. Before 1 ns it
returns ``field_amplitude`` of the configuration.

Use with
``-user%module=afivo_streamer_tpu_torch/programs/velocity_control_2d.py``.
"""

import numpy as np

from afivo_streamer_tpu_torch.core import reductions as red

BUFFER_SIZE = 5
GOAL_VELOCITY = 3.0e5
DFIELDT = -2e14


def user_initialize(cfg, sim):
    state = {"vring": np.zeros(BUFFER_SIZE), "buffer_index": 0,
             "first": True, "prev_time": 0.0, "x_prev": None,
             "prev_field": None, "prev_amp_time": 0.0}

    def my_velocity(s, time):
        _, pos = red.tree_max_cc(s.cc, s.mesh, s.i_electric_fld)
        if state["first"]:
            state["x_prev"] = pos
            state["prev_time"] = time
            state["first"] = False
            state["buffer_index"] = 1
            return
        min_dr = float(s.tree.lvl_dr(s.tree.highest_lvl).min())
        n_cells = abs(pos[-1] - state["x_prev"][-1]) / min_dr
        if n_cells > 7.5:
            v = abs(pos[-1] - state["x_prev"][-1]) / (time
                                                      - state["prev_time"])
            state["x_prev"] = pos
            state["prev_time"] = time
            state["buffer_index"] = state["buffer_index"] % BUFFER_SIZE + 1
            state["vring"][state["buffer_index"] - 1] = v

    def my_field_amplitude(s, time):
        v = state["vring"].sum() / BUFFER_SIZE
        if time < 1e-9 or state["prev_field"] is None:
            amp = s.field.field_amplitude
            state["prev_field"] = amp
            state["prev_amp_time"] = time
            return amp
        diff = ((GOAL_VELOCITY - v) / GOAL_VELOCITY * DFIELDT
                * (time - state["prev_amp_time"]))
        amp = state["prev_field"] + diff
        state["prev_amp_time"] = time
        state["prev_field"] = amp
        return amp

    sim.user.generic = my_velocity
    sim.user.field_amplitude = my_field_amplitude
