"""User code for the 2d_sprite program: the sprite's altitude density and
Wait-Spies ambient profile of programs/sprite.py, the port of the JAX
package's ``programs/2d_sprite/user.py``.

Use with ``-user%module=afivo_streamer_tpu_torch/programs/2d_sprite.py``.
"""

from afivo_streamer_tpu_torch.programs.sprite import user_initialize

__all__ = ["user_initialize"]
