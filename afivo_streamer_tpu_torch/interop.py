"""State exchange with NumPy arrays in the JAX package's layout.

``state_from_numpy`` loads a state (``cc``/``fc`` arrays, the tree
topology arrays, the step counter and the times) into a port
``Simulation`` built from the same configuration; ``state_to_numpy`` gives
the port's state back in the same form. Both packages can so be started
from one state and compared step by step.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

#: the tree topology arrays, over box ids 0..highest_id-1
TREE_ARRAYS = ("lvl", "ix", "parent", "children", "neighbors", "in_use")


def tree_arrays(tree) -> Dict[str, np.ndarray]:
    """Topology arrays of a tree (either package's Tree)."""
    n = tree.highest_id
    return {name: np.array(getattr(tree, name)[:n]) for name in TREE_ARRAYS}


def state_from_numpy(sim, cc: np.ndarray, fc: np.ndarray,
                     tree: Optional[Dict[str, np.ndarray]] = None,
                     it: int = 0, global_time: float = 0.0,
                     global_dt: Optional[float] = None) -> None:
    """Load a NumPy state into ``sim`` (in place).

    ``cc``/``fc`` hold at least the rows of the boxes of ``sim``'s mesh;
    ``tree``, when given, must describe that same mesh, since this package
    does not change its mesh after setup."""
    if tree is not None:
        own = tree_arrays(sim.tree)
        for name in TREE_ARRAYS:
            if not np.array_equal(np.asarray(tree[name]), own[name]):
                raise ValueError(f"tree array {name!r} differs from the "
                                 "simulation's mesh")
    n = sim.tree.highest_id
    if cc.shape[0] != sim.cc.shape[0] or cc.shape[2] != sim.cc.shape[2]:
        raise ValueError(f"cc shape {cc.shape} does not match "
                         f"{tuple(sim.cc.shape)}")
    if fc.shape[:2] != tuple(sim.fc.shape[:2]) or fc.shape[3] != sim.fc.shape[3]:
        raise ValueError(f"fc shape {fc.shape} does not match "
                         f"{tuple(sim.fc.shape)}")
    sim.cc.zero_()
    sim.fc.zero_()
    sim.cc[:, :n] = torch.as_tensor(np.asarray(cc)[:, :n], dtype=sim.dtype,
                                    device=sim.device)
    sim.fc[:, :, :n] = torch.as_tensor(np.asarray(fc)[:, :, :n],
                                       dtype=sim.dtype, device=sim.device)
    sim.it = int(it)
    sim.global_time = float(global_time)
    if global_dt is not None:
        sim.global_dt = float(global_dt)


def state_to_numpy(sim) -> Dict:
    """The port's state as NumPy arrays in the JAX package's layout."""
    return {"cc": sim.cc.cpu().numpy(), "fc": sim.fc.cpu().numpy(),
            "tree": tree_arrays(sim.tree), "it": sim.it,
            "global_time": sim.global_time, "global_dt": sim.global_dt}
