"""Simulation output: the regression log, the text log, the grid files, the
chemistry files and the status line.

Re-implements these writers of the reference's ``src/m_output.f90``, as the
JAX package's ``io/output.py`` has them:

* the regression-test log with per-species volume-averaged sum(n),
  sum(n^2), max(n) at every output time (output_regression_log
  ``:783-837``);
* the text log of the streamer's observables (output_log ``:496-670``),
  with the user's extra columns (``log_variables``);
* the per-box grid file of the leaves, a compressed ``.npz`` that takes the
  place of the Silo output (``silo_write``, every ``silo%per_outputs``
  outputs);
* the chemistry files: at setup the species, the reactions, the
  stoichiometric matrix and, at constant gas density, the swarm summary
  (output_initial_summary ``:294-306``), and at every output one line of
  the accumulated reaction rates and one of the species amounts;
* the stdout status (output_status ``:852-867``).

The reductions run on the state's device; what comes to the host is their
values. The other writers of the JAX package (npz, VTK, checkpoint,
lineout, plane, cross section, field maxima, the extra output variables and
the surface data) are not part of this package: a configuration that turns
one on raises NotImplementedError.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core import reductions as red
from ..physics import analysis

#: writers that are off unless the configuration turns them on; refused
#: when on
_OPT_IN = ("output%npz", "output%vtk", "datfile%write", "lineout%write",
           "plane%write", "cross%write", "field_maxima%write",
           "compute_power_density", "output%electron_energy",
           "output%conductivity", "output%electron_current",
           "dielectric%write")


class Output:
    def __init__(self, cfg, registry):
        self.registry = registry
        self.name = cfg.add_get("output%name", "output/sim",
                                "Name for the output files (e.g. output/sim)")
        self.dt = cfg.add_get("output%dt", 1.0e-10,
                              "The timestep for writing output (s)")
        self.dt_factor_pulse_off = cfg.add_get(
            "output%dt_factor_pulse_off", 1,
            "Output dt multiplier when the voltage is off")
        self.write_log = cfg.add_get("output%log", True,
                                     "Write a log file with observables")
        self.regression_test = cfg.add_get(
            "output%regression_test", False,
            "Write a regression-test log")
        # the Silo grid output of the reference maps to a compressed
        # per-box .npz dump of the leaves
        self.silo_write = cfg.add_get(
            "silo_write", True,
            "Write grid output (per-box .npz, replaces the Silo files)")
        self.silo_per_outputs = cfg.add_get(
            "silo%per_outputs", 1, "Write grid output every N outputs")
        self.max_lvl = cfg.add_get(
            "output%max_lvl", 100,
            "Maximum refinement level in grid output")
        self.only = [s for s in cfg.add_get(
            "output%only", [""],
            "If non-empty, only output these variables") if s]
        self.status_delay = cfg.add_get(
            "output%status_delay", 60.0,
            "Interval between writing status line (s)")
        self.density_threshold = cfg.add_get(
            "output%density_threshold", 1e18,
            "Electron density threshold for detecting plasma regions "
            "(1/m3, will be scaled by gas density)")
        for key in _OPT_IN:
            if cfg.add_get(key, False, "Not available in this package"):
                raise NotImplementedError(f"io/output.py: {key}")
        if [s for s in cfg.add_get("output%write_source", [""],
                                   "Not available in this package") if s]:
            raise NotImplementedError("io/output.py: output%write_source")
        os.makedirs(os.path.dirname(self.name) or ".", exist_ok=True)

    # --------------------------------------------------- regression log
    def regression_log(self, sim, out_cnt: int) -> None:
        """output_regression_log (``m_output.f90:783-837``)."""
        fname = self.name + "_rtest.log"
        species = sim.chem.species_list
        vol = sim.tree.total_volume()
        sums, sums2, maxs = [], [], []
        ngas = sim.chem.n_gas_species
        for n, _name in enumerate(species):
            if n < ngas:  # the gas species are not stored in the tree
                sums.append(0.0)
                sums2.append(0.0)
                maxs.append(0.0)
                continue
            iv = sim.species_cc[n - ngas]
            sums.append(red.tree_sum_cc(sim.cc, sim.mesh, iv) / vol)
            sums2.append(red.tree_sum_cc(sim.cc, sim.mesh, iv, power=2) / vol)
            maxs.append(red.tree_max_cc(sim.cc, sim.mesh, iv)[0])
        if out_cnt == 0:
            with open(fname, "w") as f:
                f.write("it time dt")
                for n in species:
                    f.write(f" sum({n})")
                for n in species:
                    f.write(f" sum({n}^2)")
                for n in species:
                    f.write(f" max({n})")
                f.write("\n")
        with open(fname, "a") as f:
            f.write(f"{out_cnt}")
            for v in ([sim.global_time, sim.global_dt] + sums + sums2 + maxs):
                f.write(f" {v:20.8E}")
            f.write("\n")

    # ----------------------------------------------------------- log
    def log(self, sim, out_cnt: int, wc_time: float) -> None:
        """The text log (output_log, ``m_output.f90:496-670``): streamer
        velocity, species sums, net charge, J.E, field/density maxima with
        locations, radial-field extrema (2D), Sato currents, plasma
        z-extent, tip field, cell counts and dt restrictions, then the
        user's columns."""
        fname = self.name + "_log.txt"
        t, mesh = sim.tree, sim.mesh
        ndim = t.ndim
        max_fld, loc_fld = red.tree_max_cc(sim.cc, mesh, sim.i_electric_fld)
        max_ne, loc_ne = red.tree_max_cc(sim.cc, mesh, sim.i_electron)
        sum_ne = red.tree_sum_cc(sim.cc, mesh, sim.i_electron)
        sum_ni = red.tree_sum_cc(sim.cc, mesh, sim.i_1pos_ion)
        n_cells = red.n_leaf_cells(t)
        min_dx = float(t.lvl_dr(t.highest_lvl).min())

        # net charge: charge-weighted species sums + surface charge
        sum_elem_charge = 0.0
        ngas = sim.chem.n_gas_species
        for n in range(ngas, len(sim.chem.species_list)):
            q = sim.chem.species_charge[n]
            if q != 0:
                sum_elem_charge += q * red.tree_sum_cc(
                    sim.cc, mesh, sim.species_cc[n - ngas])
        if sim.surfaces is not None:
            sum_elem_charge += sim.surfaces.get_integral(sim.cc)

        # plasma z-extent above a scaled density threshold
        thr = self.density_threshold * (
            sim.gas.number_density / 2.414e25) ** 2
        zlim = [float(sim.st.domain_origin[ndim - 1]
                      + sim.st.domain_len[ndim - 1]),
                float(sim.st.domain_origin[ndim - 1])]
        ne_zminmax = analysis.zmin_zmax_threshold(
            sim.cc, mesh, sim.i_electron, thr, zlim)

        # tip field: max E near the z-extent farthest from the boundary
        r0 = np.array(sim.st.domain_origin, np.float64)
        r1 = r0 + np.asarray(sim.st.domain_len)
        Lz = float(sim.st.domain_len[ndim - 1])
        oz = float(sim.st.domain_origin[ndim - 1])
        if ne_zminmax[0] - oz < oz + Lz - ne_zminmax[1]:
            r0[ndim - 1] = ne_zminmax[1] - 0.02 * Lz
            r1[ndim - 1] = ne_zminmax[1] + 0.02 * Lz
        else:
            r0[ndim - 1] = ne_zminmax[0] - 0.02 * Lz
            r1[ndim - 1] = ne_zminmax[0] + 0.02 * Lz
        max_field_tip, r_tip = analysis.max_var_region(
            sim.cc, mesh, sim.i_electric_fld, r0, r1)
        if r_tip is None:
            r_tip = np.zeros(ndim)

        user_names: list = []
        user_vals: list = []
        if sim.user.log_variables is not None:
            user_names, user_vals = sim.user.log_variables(sim)

        if out_cnt == 1 or not os.path.exists(fname):
            cols = ["it", "time", "dt", "v", "sum(n_e)", "sum(n_i)",
                    "sum(charge)", "sum(J.E)", "max(E)"]
            ax = ["x", "y", "z"][:ndim]
            cols += ax + ["max(n_e)"] + ax
            if ndim == 2:
                cols += ["max(E_r)", "x", "y", "min(E_r)"]
            cols += ["voltage", "current_J.E", "current_displ",
                     "ne_zmin", "ne_zmax", "max(Etip)"] + ax
            cols += ["wc_time", "n_cells", "min(dx)", "dt_cfl", "dt_diff",
                     "dt_drt", "dt_chem", "highest(lvl)"]
            cols += list(user_names)
            with open(fname, "w") as f:
                f.write(" ".join(cols) + "\n")

        vals = [sim.global_time, sim.global_dt, sim.velocity,
                sum_ne, sum_ni, sum_elem_charge, sim.global_JdotE,
                max_fld, *loc_fld, max_ne, *loc_ne]
        if ndim == 2:
            max_Er, loc_Er = red.tree_max_fc(sim.fc, mesh, 0, sim.field.fc_E)
            min_Er = red.tree_min_fc(sim.fc, mesh, 0, sim.field.fc_E)
            vals += [max_Er, *loc_Er, min_Er]
        vals += [sim.field.current_voltage, sim.global_JdotE_current,
                 sim.global_displ_current, *ne_zminmax,
                 max_field_tip, *r_tip, wc_time]
        with open(fname, "a") as f:
            f.write(f"{out_cnt:6d}"
                    + "".join(f" {float(v):19.8E}" for v in vals)
                    + f" {n_cells:11d}"
                    + "".join(f" {float(v):19.8E}" for v in
                              [min_dx, *sim.dt_limits])
                    + f" {t.highest_lvl:2d}"
                    + "".join(f" {float(v):19.8E}" for v in user_vals)
                    + "\n")

    # ------------------------------------------------------- grid file
    def write_grid(self, sim, out_cnt: int) -> None:
        """The leaves' boxes, ghost layer included, of every variable
        marked for output (or of ``output%only``) up to ``output%max_lvl``
        (with every box of that level), and the boxes' geometry, as one
        compressed ``<name>_grid_<cnt>.npz``: the JAX package's write_grid,
        which takes the place of the reference's Silo files. One gather on
        the device and one copy to the host."""
        t = sim.tree
        nc, ndim = t.nc, t.ndim
        reg = self.registry
        max_lvl = min(self.max_lvl, t.highest_lvl)
        names = [nm for iv, nm in enumerate(reg.cc_names)
                 if reg.cc_write_output[iv]
                 and (not self.only or nm in self.only)]
        ivs = [reg.cc_names.index(nm) for nm in names]
        leaves, lvls = [], []
        for lvl in range(1, max_lvl + 1):
            ls = np.asarray(t.lvl_leaves[lvl - 1])
            if lvl == max_lvl:
                # include boxes that are still refined beyond max_lvl
                ls = np.asarray(t.lvl_ids[lvl - 1])
            if len(ls):
                leaves.append(ls)
                lvls.append(np.full(len(ls), lvl))
        ids = np.concatenate(leaves)
        lvls = np.concatenate(lvls)
        dev = sim.cc.device
        rows = sim.cc[torch.as_tensor(ivs, device=dev)[:, None],
                      torch.as_tensor(ids, device=dev)[None, :]]
        rows = rows.cpu().numpy()
        data = {nm: rows[k] for k, nm in enumerate(names)}
        np.savez_compressed(
            f"{self.name}_grid_{out_cnt:06d}.npz",
            box_id=ids, box_lvl=lvls, box_r_min=t.box_r_min(ids),
            dr_base=t.dr_base, nc=nc, ndim=ndim, coord=t.coord,
            time=sim.global_time, cycle=out_cnt, var_names=np.asarray(names),
            **data)

    # ----------------------------------------------------- chemistry
    def chemical_rates(self, sim, first_time: bool = False) -> None:
        """Append time + accumulated reaction rates
        (output_chemical_rates); at setup remove an old file."""
        fname = self.name + "_rates.txt"
        if first_time:
            if os.path.exists(fname):
                os.remove(fname)
            return
        with open(fname, "a") as f:
            f.write(f" {sim.global_time:.8E} " + " ".join(
                f"{x:.8E}" for x in np.atleast_1d(sim.global_rates)) + "\n")

    def chemical_amounts(self, sim, first_time: bool = False) -> None:
        """Append time + space-integrated species densities, zero for the
        gas species (output_chemical_amounts); at setup remove an old
        file."""
        fname = self.name + "_amounts.txt"
        if first_time:
            if os.path.exists(fname):
                os.remove(fname)
            return
        ngas = sim.chem.n_gas_species
        sums = [0.0 if n < ngas else red.tree_sum_cc(
            sim.cc, sim.mesh, sim.species_cc[n - ngas])
            for n in range(len(sim.chem.species_list))]
        with open(fname, "a") as f:
            f.write(f" {sim.global_time:.8E} "
                    + " ".join(f"{x:.8E}" for x in sums) + "\n")

    def initial_summary(self, sim) -> None:
        """The model summary and the chemistry listings written once at
        setup (output_initial_summary, ``m_output.f90:294-306``)."""
        sim.chem.write_summary(self.name + "_summary.txt")
        with open(self.name + "_stoich_matrix.txt", "w") as f:
            for row in sim.chem.stoich_matrix().T:
                # per species, columns = reactions
                f.write(" ".join(str(int(x)) for x in row) + "\n")
        with open(self.name + "_species.txt", "w") as f:
            for s in sim.chem.species_list:
                f.write(s + "\n")
            f.write("\n")
        with open(self.name + "_reactions.txt", "w") as f:
            for r in sim.chem.reactions:
                f.write(r.description + "\n")
            f.write("\n")
        self.chemical_rates(sim, first_time=True)
        self.chemical_amounts(sim, first_time=True)

    # ----------------------------------------------------------- status
    def status(self, sim, wc_time: float) -> None:
        """output_status (``m_output.f90:852-867``): progress line plus the
        four time-step restrictions."""
        pct = 100.0 * sim.global_time / max(sim.st.end_time, 1e-300)
        print(f"{self.name}: {pct:.1f}% it={sim.it} t={sim.global_time:.3E} "
              f"dt={sim.global_dt:.3E} wc={wc_time:.1f}s "
              f"ncell={red.n_leaf_cells(sim.tree)} "
              f"lvl={sim.tree.highest_lvl}", flush=True)
        print("         dt: "
              + " ".join(f"{float(v):10.3E}" for v in sim.dt_limits)
              + " (cfl drt chem other)", flush=True)
