"""State exchange with NumPy arrays in the JAX package's layout.

``state_from_numpy`` loads a state (``cc``/``fc`` arrays, the tree
topology, the step counter and the times (that of the last
photoionization update among them), and with dielectrics the
surfaces and their per-surface data arrays) into a port ``Simulation``
built from the same configuration; ``state_to_numpy`` gives the port's
state back in the same form and ``surface_data`` the surface state in the
per-surface layout. Both packages can so be started from one state and
compared step by step. The arrays carry whatever variables the
configuration registers, in the order both packages register them: under
the electron energy equation ``e_energy`` with its time-state copies and
the face variable ``flux_energy``, with ``fixes%write_source_factor`` the
``srcfac`` variable, with an electrode the ``lsf`` variable (the level set
on every cell; everything else of an electrode follows from the
configuration); a 1D mesh has ``ix`` [n, 1] and two neighbor columns.
The output state (the output counter, the streamer velocity and the
position of max(E), the accumulated rates, J.E and currents) goes with
the state.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .solvers.surface import Surface

#: the tree topology arrays, over box ids 0..highest_id-1
TREE_ARRAYS = ("lvl", "ix", "parent", "children", "neighbors", "in_use")


def tree_arrays(tree) -> Dict[str, np.ndarray]:
    """Topology arrays of a tree (either package's Tree), with the ids
    freed for reuse in their order."""
    n = tree.highest_id
    out = {name: np.array(getattr(tree, name)[:n]) for name in TREE_ARRAYS}
    out["removed_ids"] = np.asarray(tree.removed_ids, np.int64)
    return out


def load_tree(tree, arrays: Dict[str, np.ndarray]) -> None:
    """Make ``tree`` (the port's Tree) the mesh described by ``arrays``."""
    n = len(arrays["lvl"])
    if n > tree.cap:
        tree._grow(max(n, 2 * tree.cap))
    for name in TREE_ARRAYS:
        getattr(tree, name)[:n] = arrays[name]
    tree.highest_id = n
    tree.removed_ids = [int(b) for b in arrays.get("removed_ids", [])]
    tree._ix_maps = [dict() for _ in range(int(arrays["lvl"][
        arrays["in_use"]].max()))]
    for bid in np.nonzero(arrays["in_use"])[0]:
        tree._ix_maps[int(tree.lvl[bid]) - 1][
            tuple(int(x) for x in tree.ix[bid])] = int(bid)
    tree._rebuild_levels()


#: the output state of a simulation, which the text log and the chemistry
#: files read: the output counter, the streamer velocity and the position
#: of max(E) at the last log line, and the accumulated reaction rates,
#: J.E and the currents
OUTPUT_STATE = ("out_cnt", "velocity", "prev_emax_pos", "global_rates",
                "global_JdotE", "global_JdotE_current",
                "global_displ_current")


def output_state(sim) -> Dict:
    """The output state of ``sim`` (either package's Simulation)."""
    return {k: (np.array(v) if isinstance(v, np.ndarray) else v)
            for k, v in ((k, getattr(sim, k)) for k in OUTPUT_STATE)}


def state_from_numpy(sim, cc: np.ndarray, fc: np.ndarray,
                     tree: Optional[Dict[str, np.ndarray]] = None,
                     it: int = 0, global_time: float = 0.0,
                     global_dt: Optional[float] = None,
                     surfaces=None, photoi_prev_time: float = 0.0,
                     output: Optional[Dict] = None) -> None:
    """Load a NumPy state into ``sim`` (in place).

    ``cc``/``fc`` hold at least the rows of the boxes of the mesh;
    ``tree``, when given and different, replaces ``sim``'s mesh.
    ``surfaces`` (the JAX package's Surfaces: a ``surfaces`` list whose
    entries carry ``sd`` [photon flux, sigma states...] arrays) replaces
    ``sim``'s surfaces, and the data of the active ones goes into their
    state rows. ``photoi_prev_time`` is the time of the last
    photoionization update (the JAX Simulation's ``_photoi_prev_time``);
    ``output`` the output state (``output_state``), so that a run resumed
    from it writes the same log lines and chemistry files."""
    if tree is not None:
        own = tree_arrays(sim.tree)
        if any(not np.array_equal(np.asarray(tree[k]), own[k])
               for k in TREE_ARRAYS):
            load_tree(sim.tree, tree)
            sim._sync_capacity()
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
    if surfaces is not None:
        sf = sim.surfaces
        sf.surfaces = [Surface(bool(s.in_use), int(s.id_in), int(s.id_out),
                               int(s.direction), float(s.eps),
                               int(s.ix_parent), s.offset_parent)
                       for s in surfaces.surfaces]
        sf.box_out_to_ix = dict(surfaces.box_out_to_ix)
        sf.box_in_to_ix = dict(surfaces.box_in_to_ix)
        sf._tables = None
        ivs = sf.state_vars
        for s in surfaces.surfaces:
            if s.in_use:
                sim.cc[ivs, s.id_out, :sf.face_cells] = torch.as_tensor(
                    s.sd, dtype=sim.dtype, device=sim.device)
    sim.it = int(it)
    sim.global_time = float(global_time)
    if global_dt is not None:
        sim.global_dt = float(global_dt)
    sim._photoi_prev_time = float(photoi_prev_time)
    for k, v in (output or {}).items():
        if k not in OUTPUT_STATE:
            raise ValueError(f"unknown output state {k!r}")
        setattr(sim, k, np.array(v) if isinstance(v, np.ndarray) else v)


def surface_data(sim) -> Dict[int, np.ndarray]:
    """The state of the active surfaces as {gas-side box id: [photon flux,
    sigma states...] x face cells} (the JAX package's ``sd`` layout)."""
    sf = sim.surfaces
    if sf is None:
        return {}
    cc = sim.cc.cpu().numpy()
    return {s.id_out: cc[sf.state_vars, s.id_out, :sf.face_cells]
            for s in sf.active()}


def state_to_numpy(sim) -> Dict:
    """The port's state as NumPy arrays in the JAX package's layout."""
    return {"cc": sim.cc.cpu().numpy(), "fc": sim.fc.cpu().numpy(),
            "tree": tree_arrays(sim.tree), "it": sim.it,
            "global_time": sim.global_time, "global_dt": sim.global_dt,
            "photoi_prev_time": sim._photoi_prev_time,
            "surfaces": surface_data(sim), "output": output_state(sim)}
