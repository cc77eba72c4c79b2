"""The check that a run loaded neither JAX nor the JAX package.

Module names are compared by their top-level name (the part before the
first dot) as a whole word: the port, ``afivo_streamer_tpu_torch``, begins
with the JAX package's name, ``afivo_streamer_tpu``, and is no match.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "afivo_streamer_tpu"})


def forbidden(names: Iterable[str]) -> List[str]:
    """The names among ``names`` whose top-level name is forbidden."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def loaded_forbidden() -> List[str]:
    """The forbidden modules that ``sys.modules`` holds now."""
    return forbidden(list(sys.modules))
