"""Initial conditions: background density and seeds.

Re-implements the reference's ``src/m_init_cond.f90`` (init_cond_initialize
``:39-144``, init_cond_set_box ``:217-291``): background electron/ion
density, line seeds with configurable endpoints, widths and fall-off
profiles, optional per-species seeds; evaluated vectorized over whole box
batches (including one ghost layer, as the reference does with
``KJI_DO(0,nc+1)``). ``stochastic_density`` adds the stochastic background
(init_cond_stochastic_density ``:146-198``) when user code calls it."""

from __future__ import annotations

import numpy as np
import torch

from ..core import ghostcell as gc
from ..core import prolong_restrict as pr
from ..core import spatial as sp
from ..utils import geometry


class InitCond:
    def __init__(self, cfg, settings, registry, i_electron: int,
                 i_1pos_ion: int):
        ndim = settings.ndim
        self.i_electron = i_electron
        self.i_1pos_ion = i_1pos_ion
        self.background_density = cfg.add_get(
            "background_density", 0.0,
            "The background ion and electron density (1/m3)")
        self.stochastic_density = cfg.add_get(
            "stochastic_density", 0.0, "Stochastic background density (1/m3)")
        dens = cfg.add_get("seed_density", [],
                           "Initial density of the seed (1/m3)", dynamic=True)
        self.n_cond = len(dens)
        self.seed_density = np.asarray([float(x) for x in dens])
        r0 = cfg.add_get("seed_rel_r0", [],
                         "The relative start position of the initial seed",
                         dynamic=True)
        r1 = cfg.add_get("seed_rel_r1", [],
                         "The relative end position of the initial seed",
                         dynamic=True)
        ct = cfg.add_get("seed_charge_type", [],
                         "Type of seed: neutral (0), ions (1) or electrons "
                         "(-1)", dynamic=True)
        w = cfg.add_get("seed_width", [], "Seed width (m)", dynamic=True)
        fo = cfg.add_get("seed_falloff", [],
                         "Fall-off type for seed (sigmoid, gaussian, "
                         "smoothstep, step, laser)", dynamic=True)
        if len(r0) != ndim * self.n_cond or len(r1) != ndim * self.n_cond:
            raise ValueError("seed_rel_r0/r1 has incompatible size")
        rel0 = np.asarray([float(x) for x in r0]).reshape(ndim, self.n_cond,
                                                          order="F")
        rel1 = np.asarray([float(x) for x in r1]).reshape(ndim, self.n_cond,
                                                          order="F")
        self.seed_r0 = (rel0.T * settings.domain_len + settings.domain_origin)
        self.seed_r1 = (rel1.T * settings.domain_len + settings.domain_origin)
        self.seed_charge_type = [int(x) for x in ct]
        self.seed_width = np.asarray([float(x) for x in w])
        self.seed_falloff = list(fo)
        d2 = cfg.add_get("seed_density2", list(self.seed_density),
                         "Initial density of the seed at other endpoint "
                         "(1/m3)", dynamic=True)
        self.seed_density2 = np.asarray([float(x) for x in d2])
        # custom species lists (m_init_cond.f90:67-71, 120-139): names are
        # resolved to cc indices by the driver after registration
        self.seed1_species_names = [
            s for s in cfg.add_get(
                "seed1_species", [""],
                "Names of custom species for the first seed", dynamic=True)
            if s]
        self.background_species_names = [
            s for s in cfg.add_get(
                "background_species", [""],
                "Names of custom species for the background density",
                dynamic=True) if s]
        self.seed1_species: list = []      # cc indices, wired by the driver
        self.background_species: list = []

    def set_box_values(self, tree, ids) -> dict:
        """Evaluate initial conditions for the given boxes.

        Returns {cc_index: array [n_ids, (nc+2)^ndim]} of values to SET
        (background) and seeds to ADD are already combined."""
        nc, ndim = tree.nc, tree.ndim
        C = (nc + 2) ** ndim
        # background density: custom species list or electrons + first
        # positive ions (init_cond_set_box, m_init_cond.f90:229-235)
        if self.background_species:
            bg_ivs = list(self.background_species)
        else:
            bg_ivs = [self.i_electron, self.i_1pos_ion]
        vals = {iv: np.zeros((len(ids), C)) for iv in
                set(bg_ivs + [self.i_electron, self.i_1pos_ion]
                    + list(self.seed1_species))}
        for n_i, b in enumerate(ids):
            coords = tree.cell_coords(int(b)).reshape(-1, ndim)
            acc = {iv: np.zeros(coords.shape[0]) for iv in vals}
            for iv in bg_ivs:
                acc[iv] += self.background_density
            for s in range(self.n_cond):
                dens = geometry.density_line(
                    coords, self.seed_r0[s], self.seed_r1[s],
                    self.seed_density[s], self.seed_density2[s],
                    self.seed_width[s], self.seed_falloff[s])
                if s == 0 and self.seed1_species:
                    # the first seed can set custom species
                    # (m_init_cond.f90:265-268)
                    for iv in self.seed1_species:
                        acc[iv] += dens
                    continue
                t = self.seed_charge_type[s]
                if t == -1:
                    acc[self.i_electron] += dens
                elif t == 0:
                    acc[self.i_electron] += dens
                    acc[self.i_1pos_ion] += dens
                elif t == 1:
                    acc[self.i_1pos_ion] += dens
                else:
                    raise ValueError("Invalid seed_charge_type")
            for iv in vals:
                vals[iv][n_i] = acc[iv]
        return vals

    def apply(self, cc, tree, ids):
        """Set the initial values of boxes ``ids`` (host evaluation, one
        copy to the device per variable)."""
        vals = self.set_box_values(tree, ids)
        rows = torch.as_tensor(np.asarray(ids), dtype=torch.int64,
                               device=cc.device)
        for iv, v in vals.items():
            cc[iv, rows] = torch.as_tensor(v, dtype=cc.dtype, device=cc.device)
        return cc


def stochastic_density(sim, rng_seed: int = 0):
    """Add a stochastic background density to the electrons and the first
    positive ion (init_cond_stochastic_density, ``m_init_cond.f90:146-198``;
    the JAX package's ``physics/init_cond.stochastic_density``): uniform
    noise in [0, stochastic_density) drawn from
    ``np.random.default_rng(rng_seed)`` on the first level that has leaves,
    in the level's box order, and prolonged linearly and additively to the
    finer levels; the rhs row keeps the noise. Like the JAX package, a
    utility for user code: nothing calls it. It runs on the state's device;
    in a sharded run every rank draws the whole array and writes its own
    rows, which gives the unsharded state."""
    ic = sim.init_cond
    if ic.stochastic_density <= 0.0:
        return
    # the whole tree, also inside a user hook's view of a sharded run
    t = getattr(sim.tree, "global_tree", sim.tree)
    mesh, layout, cc = sim.mesh, sim.layout, sim.cc
    nc, ndim, i_rhs = t.nc, t.ndim, sim.i_rhs
    rng = np.random.default_rng(rng_seed)
    interior = torch.as_tensor(sp.interior_flat(ndim, nc), dtype=torch.int64,
                               device=cc.device)[None, :]

    def own_rows(lvl):
        ids = np.asarray(t.lvl_ids[lvl - 1], np.int64)
        sel, rows = ((slice(None), ids) if layout is None
                     else layout.own_rows(ids))
        return sel, torch.as_tensor(rows, dtype=torch.int64,
                                    device=cc.device)[:, None]

    # the highest fully refined level: the first with leaves
    my_lvl = next(lvl for lvl in range(1, t.highest_lvl + 1)
                  if len(t.lvl_leaves[lvl - 1]) > 0)
    cc[i_rhs] = 0.0
    sel, rows = own_rows(my_lvl)
    noise = rng.random((len(t.lvl_ids[my_lvl - 1]), nc ** ndim)
                       ) * ic.stochastic_density
    cc[i_rhs, rows, interior] = torch.as_tensor(noise[sel], dtype=cc.dtype,
                                                device=cc.device)

    def neumann(iv, d, c, p):
        return gc.BC_NEUMANN, 0.0
    for lvl in range(my_lvl, t.highest_lvl):
        cc = gc.fill_ghosts_lvl(cc, mesh.gc(lvl), [i_rhs], gc.RB_INTERP,
                                neumann, {})
        cc = pr.prolong(cc, mesh.prolong_into(lvl + 1), [i_rhs], "linear",
                        add=True)

    for lvl in range(my_lvl, t.highest_lvl + 1):
        rows = own_rows(lvl)[1]
        noise = cc[i_rhs, rows, interior]
        for iv in (sim.i_electron, sim.i_1pos_ion):
            cc[iv, rows, interior] += noise
    # restrict and refill the ghosts of the two species
    ivs = [sim.i_electron, sim.i_1pos_ion]
    cc = pr.restrict_tree(cc, mesh.pr_all(), ivs)
    sim.cc = sim._gc_simple(cc, ivs)
