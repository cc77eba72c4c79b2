"""User code for the animation_2d program.

Port of the JAX package's ``programs/animation_2d/user.py`` (the
reference's ``programs/animation_2d/m_user.f90``): a template that sets no
hook, so the simulation runs with its default routines on any
configuration.

Use with ``-user%module=afivo_streamer_tpu_torch/programs/animation_2d.py``.
"""


def user_initialize(cfg, sim):
    pass
