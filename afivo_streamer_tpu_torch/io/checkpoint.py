"""Full-state checkpoint and restart.

Port of the JAX package's ``io/checkpoint.py``, the analog of the
reference's binary "datfile" (af_write_tree / af_read_tree,
``afivo/src/m_af_output.f90:41-374``; the driver's payload,
``streamer.f90:521-557``): the tree's geometry and topology, every cell-
and face-centered variable and a versioned payload (iteration, times, dt,
the accumulated rates), in a compressed ``.npz`` with the JAX package's
keys, so that each package reads the other's files. A restart restores the
topology and the state onto the simulation's device; the per-level tables
and plans the port keeps (core/levels.MeshPlans and everything cached
there: ghost, prolongation and multigrid plans, the level-1 solvers, the
level-set data) are rebuilt from the restored tree at first use. The
checks are the JAX package's (``streamer.f90:129-140``). A sharded run
writes the state that rank 0 gathers (driver.Simulation.full_view) and
reads the rows of its new layout, so that its checkpoints restart
unsharded and the other way round.
"""

from __future__ import annotations

import numpy as np
import torch

DATFILE_VERSION = 1


def write_checkpoint(fname: str, sim) -> None:
    """Write the state of ``sim`` to ``fname`` (a name ending in
    ``.npz``, which np.savez would otherwise append)."""
    t = sim.tree
    n = t.highest_id
    payload = dict(
        version=DATFILE_VERSION,
        it=sim.it,
        out_cnt=sim.out_cnt,
        global_time=sim.global_time,
        global_dt=sim.global_dt,
        photoi_prev_time=sim._photoi_prev_time,
        global_rates=sim.global_rates,
        global_JdotE=sim.global_JdotE,
    )
    np.savez_compressed(
        fname,
        ndim=t.ndim, nc=t.nc, coord=t.coord,
        domain_len=t.domain_len, r_base=t.r_base,
        coarse_grid_size=t.coarse_grid_size, periodic=t.periodic,
        highest_id=n,
        lvl=t.lvl[:n], ix=t.ix[:n], parent=t.parent[:n],
        children=t.children[:n], neighbors=t.neighbors[:n],
        in_use=t.in_use[:n],
        removed_ids=np.asarray(t.removed_ids, np.int64),
        cc=sim.cc[:, :n].cpu().numpy(),
        fc=sim.fc[:, :, :n].cpu().numpy(),
        cc_names=np.asarray(sim.registry.cc_names),
        **{f"payload_{k}": v for k, v in payload.items()},
    )


def read_checkpoint(fname: str, sim) -> None:
    """Restore the tree and the state of ``fname`` into ``sim``, whose tree
    must have the same geometry and whose registry the same variables."""
    d = np.load(fname, allow_pickle=False)
    if int(d["payload_version"]) != DATFILE_VERSION:
        raise ValueError("Different datfile version")
    t = sim.tree
    if int(d["nc"]) != t.nc:
        raise ValueError("restart: incompatible box size")
    if len(d["cc_names"]) != len(sim.registry.cc_names):
        raise ValueError("restart: incompatible variable list")
    if int(d["ndim"]) != t.ndim:
        raise ValueError("restart: incompatible ndim")
    if str(d["coord"]) != t.coord:
        raise ValueError("restart: incompatible coordinate system")
    for key, live in (("domain_len", t.domain_len), ("r_base", t.r_base)):
        if not np.allclose(np.asarray(d[key], np.float64),
                           np.asarray(live, np.float64), rtol=1e-12):
            raise ValueError(f"restart: incompatible {key}")
    if not np.array_equal(np.asarray(d["coarse_grid_size"]),
                          np.asarray(t.coarse_grid_size)):
        raise ValueError("restart: incompatible coarse_grid_size")
    if not np.array_equal(np.asarray(d["periodic"], bool),
                          np.asarray(t.periodic, bool)):
        raise ValueError("restart: incompatible periodicity")
    n = int(d["highest_id"])
    if n > t.cap:
        t._grow(n + 64)
    t.highest_id = n
    for key in ("lvl", "ix", "parent", "children", "neighbors", "in_use"):
        getattr(t, key)[:n] = d[key]
    t.removed_ids = [int(x) for x in d["removed_ids"]]
    t._ix_maps = []
    for b in np.nonzero(t.in_use[:n])[0]:
        lvl = int(t.lvl[b])
        while len(t._ix_maps) < lvl:
            t._ix_maps.append(dict())
        t._ix_maps[lvl - 1][tuple(int(x) for x in t.ix[b])] = int(b)
    # a new topology version: every table and plan cached per level is
    # rebuilt at its next use
    t._rebuild_levels()

    sim._sync_capacity()
    dev, dtype = sim.cc.device, sim.cc.dtype
    if sim.layout is None:
        sim.cc[:, :n] = torch.as_tensor(d["cc"], dtype=dtype, device=dev)
        sim.fc[:, :, :n] = torch.as_tensor(d["fc"], dtype=dtype, device=dev)
    else:
        # a sharded run keeps the rows of its own boxes and their halo
        rows = sim.layout.glob
        sim.cc[:] = torch.as_tensor(d["cc"][:, rows], dtype=dtype,
                                    device=dev)
        sim.fc[:] = torch.as_tensor(d["fc"][:, :, rows], dtype=dtype,
                                    device=dev)
    sim.it = int(d["payload_it"])
    sim.out_cnt = int(d["payload_out_cnt"]) if "payload_out_cnt" in d \
        else 0
    sim.global_time = float(d["payload_global_time"])
    sim.global_dt = float(d["payload_global_dt"])
    sim._photoi_prev_time = float(d["payload_photoi_prev_time"])
    sim.global_rates = np.asarray(d["payload_global_rates"])
    sim.global_JdotE = float(d["payload_global_JdotE"])
