"""Simulation output: the regression log, the text log, the grid files, the
chemistry files, the opt-in writers and the status line.

Re-implements the writers of the reference's ``src/m_output.f90``, as the
JAX package's ``io/output.py`` has them:

* the regression-test log with per-species volume-averaged sum(n),
  sum(n^2), max(n) at every output time (output_regression_log
  ``:783-837``);
* the text log of the streamer's observables (output_log ``:496-670``),
  with the user's extra columns (``log_variables``);
* the per-box grid file of the leaves, a compressed ``.npz`` that takes the
  place of the Silo output (``silo_write``, every ``silo%per_outputs``
  outputs), with the surfaces' data under ``dielectric%write``;
* the chemistry files: at setup the species, the reactions, the
  stoichiometric matrix and, at constant gas density, the swarm summary
  (output_initial_summary ``:294-306``), and at every output one line of
  the accumulated reaction rates and one of the species amounts;
* the opt-in writers: the uniform-grid ``.npz`` (``output%npz``, with the
  extra variables ``eV``, ``sigma``, ``Je_i`` and ``src_<species>``), the
  samples along a line (``lineout%write``, af_write_line), in a plane as
  structured-points VTK (``plane%write``, af_write_plane), the
  cross-section integrals (``cross%write``) and the field maxima
  (``field_maxima%write``); the unstructured VTK grid is io/vtk.py and the
  checkpoints io/checkpoint.py;
* the stdout status (output_status ``:852-867``).

The reductions, interpolations and grids are computed on the state's
device; what comes to the host is their values.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from .. import constants as uc
from ..core import reductions as red
from ..core import rowops as ro
from ..core import spatial as sp
from ..physics import analysis
from ..physics.transport_data import TD_MOBILITY
from ..utils.table_data import table_from_file


def interp(x: torch.Tensor, xp: np.ndarray, fp: np.ndarray) -> torch.Tensor:
    """np.interp on a tensor: linear between the points (xp, fp), the end
    values beyond them."""
    xp_t = torch.as_tensor(xp, dtype=x.dtype, device=x.device)
    fp_t = torch.as_tensor(fp, dtype=x.dtype, device=x.device)
    j = torch.clamp(torch.searchsorted(xp_t, x, right=True), 1,
                    len(xp) - 1)
    x0, x1 = xp_t[j - 1], xp_t[j]
    f0, f1 = fp_t[j - 1], fp_t[j]
    out = (f1 - f0) / (x1 - x0) * (x - x0) + f0
    out = torch.where(x <= xp_t[0], fp_t[0], out)
    return torch.where(x >= xp_t[-1], fp_t[-1], out)


class Output:
    def __init__(self, cfg, registry, ndim: int):
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
        self.npz_write = cfg.add_get(
            "output%npz", False, "Write .npz grid output")
        self.write_vtk_files = cfg.add_get(
            "output%vtk", False, "Write VTK unstructured output")
        self.datfile_write = cfg.add_get(
            "datfile%write", False,
            "Write binary output files (dat files)")
        self.datfile_per_outputs = cfg.add_get(
            "datfile%per_outputs", 1,
            "Write binary output files every N outputs")
        self.surface_write = cfg.add_get(
            "dielectric%write", False,
            "Output surface related information (into the grid .npz)")
        self.status_delay = cfg.add_get(
            "output%status_delay", 60.0,
            "Interval between writing status line (s)")
        self.density_threshold = cfg.add_get(
            "output%density_threshold", 1e18,
            "Electron density threshold for detecting plasma regions "
            "(1/m3, will be scaled by gas density)")

        # the secondary writers (output_initialize, m_output.f90:150-250)
        self.lineout_write = cfg.add_get(
            "lineout%write", False, "Write output along a line")
        self.lineout_varname = cfg.add_get(
            "lineout%varname", ["e"],
            "Names of variable to write in lineout")
        self.lineout_npoints = cfg.add_get(
            "lineout%npoints", 500, "Use this many points for lineout data")
        self.lineout_rmin = np.asarray(cfg.add_get(
            "lineout%rmin", [0.0] * ndim,
            "Relative position of line minimum coordinate"), np.float64)
        self.lineout_rmax = np.asarray(cfg.add_get(
            "lineout%rmax", [1.0] * ndim,
            "Relative position of line maximum coordinate"), np.float64)
        self.plane_write = cfg.add_get(
            "plane%write", False, "Write uniform output in a plane")
        self.plane_varname = cfg.add_get(
            "plane%varname", ["e"], "Names of variable to write in plane")
        self.plane_npixels = cfg.add_get(
            "plane%npixels", [64, 64], "Use this many pixels for plane data")
        self.plane_rmin = np.asarray(cfg.add_get(
            "plane%rmin", [0.0] * ndim,
            "Relative position of plane minimum coordinate"), np.float64)
        self.plane_rmax = np.asarray(cfg.add_get(
            "plane%rmax", [1.0] * ndim,
            "Relative position of plane maximum coordinate"), np.float64)
        self.cross_write = cfg.add_get(
            "cross%write", False,
            "Write integral over cross-section data output")
        self.cross_rmax = cfg.add_get(
            "cross%rmax", 2.0e-3, "Integrate up to this radius")
        self.cross_npoints = cfg.add_get(
            "cross%npoints", 500,
            "Use this many points for cross-section data")
        self.field_maxima_write = cfg.add_get(
            "field_maxima%write", False,
            "Output electric field maxima and their locations")
        self.field_maxima_threshold = cfg.add_get(
            "field_maxima%threshold", 0.0,
            "Threshold value (V/m) for electric field maxima")
        self.field_maxima_distance = cfg.add_get(
            "field_maxima%distance", 0.0,
            "Minimal distance (m) between electric field maxima")

        # the extra variables of the uniform-grid output
        # (m_output.f90:251-290)
        self.extra_vars: List[str] = []
        self._ev_tbl = None
        if cfg.add_get("output%electron_energy", False,
                       "Show the electron energy in eV from the local field "
                       "approximation"):
            # the mean energy against E/N, read from the input file
            # (output_initialize, m_output.f90:251-264)
            td_file = cfg.add_get("input_data%file", "UNDEFINED", "")
            x, y = table_from_file(td_file, "Mean energy (eV)")
            self._ev_tbl = (np.asarray(x), np.asarray(y))
            self.extra_vars.append("eV")
        if cfg.add_get("output%conductivity", False,
                       "Output the conductivity of the plasma"):
            self.extra_vars.append("sigma")
        if cfg.add_get("output%electron_current", False,
                       "Output the electron current"):
            for i in range(ndim):
                self.extra_vars.append(f"Je_{i + 1}")
        for nm in cfg.add_get("output%write_source", [""],
                              "Write chemistry source terms of these "
                              "species to output"):
            if nm:
                self.extra_vars.append(f"src_{nm}")
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
        sf = sim.surfaces
        if self.surface_write and sf is not None and sf.active():
            # [surface, photon flux and sigma states, face cells] and
            # (gas-side box, dielectric-side box, direction) of each
            # active surface, as the JAX package stores them
            active = sf.active()
            rows_out = torch.as_tensor([s.id_out for s in active],
                                       device=dev)
            sd = sim.cc[torch.as_tensor(sf.state_vars, device=dev)[:, None],
                        rows_out[None, :], :sf.face_cells]
            data["surface_sd"] = sd.permute(1, 0, 2).cpu().numpy()
            data["surface_info"] = np.asarray(
                [[s.id_out, s.id_in, s.direction] for s in active])
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

    # ------------------------------------------- the secondary writers
    def _sample(self, sim, points, ivs, what: str) -> np.ndarray:
        """Values [n_points, len(ivs)] of variables ``ivs`` at ``points``
        (af_interp1; one gather on the device)."""
        vals, ok = analysis._interp_points(sim.cc, sim.tree, points, ivs)
        if not ok.all():
            raise RuntimeError(f"{what}: interpolation error")
        return vals

    def _rel_box(self, sim, rmin, rmax):
        ndim = sim.tree.ndim
        return (rmin[:ndim] * sim.st.domain_len + sim.st.domain_origin,
                rmax[:ndim] * sim.st.domain_len + sim.st.domain_origin)

    def write_line(self, sim, out_cnt: int) -> None:
        """Variables sampled at points along a line (af_write_line,
        ``afivo/src/m_af_output.f90:407-459``)."""
        t = sim.tree
        ndim = t.ndim
        ivs = [sim.registry.cc_names.index(v) for v in self.lineout_varname]
        r_min, r_max = self._rel_box(sim, self.lineout_rmin,
                                     self.lineout_rmax)
        npts = self.lineout_npoints
        dr_vec = (r_max - r_min) / max(1, npts - 1)
        hi = t.r_base + np.asarray(t.domain_len) * (1 - 1e-12)
        points = [np.minimum(np.maximum(r_min + i * dr_vec, t.r_base), hi)
                  for i in range(npts)]
        vals = self._sample(sim, points, ivs, "write_line")
        with open(f"{self.name}_line_{out_cnt:06d}.txt", "w") as f:
            f.write("# " + " ".join("xyz"[:ndim]) + " "
                    + " ".join(self.lineout_varname) + "\n")
            for r, v in zip(points, vals):
                f.write(" ".join(f"{x:.8E}" for x in list(r) + list(v))
                        + "\n")

    def write_plane(self, sim, out_cnt: int) -> None:
        """Variables resampled on a uniform plane, as a structured-points
        VTK file (af_write_plane, ``afivo/src/m_af_output.f90:465-551``)."""
        t = sim.tree
        ndim = t.ndim
        ivs = [sim.registry.cc_names.index(v) for v in self.plane_varname]
        r_min, r_max = self._rel_box(sim, self.plane_rmin, self.plane_rmax)
        npx = self.plane_npixels
        dvec = r_max - r_min
        if ndim == 2:
            v1 = np.array([dvec[0], 0.0]) / (npx[0] - 1)
            v2 = np.array([0.0, dvec[1]]) / (npx[1] - 1)
            n_points = [npx[0], npx[1], 1]
            origin = [r_min[0], r_min[1], 0.0]
        else:
            dim_unused = int(np.argmin(np.abs(dvec)))
            axes = [k for k in range(3) if k != dim_unused]
            v1 = np.zeros(3)
            v1[axes[0]] = dvec[axes[0]] / (npx[0] - 1)
            v2 = np.zeros(3)
            v2[axes[1]] = dvec[axes[1]] / (npx[1] - 1)
            n_points = [1, 1, 1]
            n_points[axes[0]] = npx[0]
            n_points[axes[1]] = npx[1]
            origin = list(r_min)
        hi_clip = t.r_base + np.asarray(t.domain_len) * (1 - 1e-12)
        points = [np.minimum(np.maximum(r_min + i * v1[:ndim] + j * v2[:ndim],
                                        t.r_base), hi_clip)
                  for j in range(npx[1]) for i in range(npx[0])]
        vals = self._sample(sim, points, ivs, "write_plane")
        # [var, i, j] as the JAX package fills it
        data = vals.reshape(npx[1], npx[0], len(ivs)).transpose(2, 1, 0)
        spacing = (v1 + v2) if ndim == 3 else \
            [v1[0] + v2[0], v1[1] + v2[1], 0.0]
        with open(f"{self.name}_plane_{out_cnt:06d}.vtk", "w") as f:
            f.write("# vtk DataFile Version 2.0\n")
            f.write(f"{self.name}_plane_{out_cnt:06d}\n")
            f.write("ASCII\nDATASET STRUCTURED_POINTS\n")
            f.write("DIMENSIONS " + " ".join(map(str, n_points)) + "\n")
            f.write("ORIGIN " + " ".join(f"{x:.8E}" for x in origin) + "\n")
            f.write("SPACING " + " ".join(f"{x:.8E}" for x in spacing)
                    + "\n")
            f.write(f"POINT_DATA {int(np.prod(n_points))}\n")
            for k, v in enumerate(self.plane_varname):
                f.write(f"SCALARS {v} double 1\nLOOKUP_TABLE default\n")
                np.savetxt(f, data[k].T.reshape(-1, npx[0]), fmt="%.8E")

    def write_cross(self, sim, out_cnt: int) -> None:
        """Axisymmetric cross-section integrals against z (output_cross)."""
        with open(f"{self.name}_cross_{out_cnt:06d}.txt", "w") as f:
            f.write("z elec_dens charge_dens current_dens\n")
            for i in range(1, self.cross_npoints + 1):
                z = i * float(sim.st.domain_len[1]) / (self.cross_npoints + 1)
                e, q, j = analysis.get_cross(sim, self.cross_rmax, z)
                f.write(f"{z:.8E} {e:.8E} {q:.8E} {j:.8E}\n")

    def write_fld_maxima(self, sim, out_cnt: int) -> None:
        """The electric field's local maxima, those closer than
        ``field_maxima%distance`` merged into the larger one
        (output_fld_maxima)."""
        n_max = 1000
        coord_val, n_found = analysis.get_maxima(
            sim.cc, sim.mesh, sim.i_electric_fld,
            self.field_maxima_threshold, n_max)
        n_found = min(n_found, n_max)
        cv = coord_val[:n_found].copy()
        ndim = sim.tree.ndim
        n = n_found
        i_n = n
        while i_n >= 1:
            for i in range(i_n - 1):
                d = float(np.linalg.norm(cv[i, :ndim] - cv[i_n - 1, :ndim]))
                if d < self.field_maxima_distance:
                    if cv[i, ndim] < cv[i_n - 1, ndim]:
                        cv[i] = cv[i_n - 1]
                    cv[i_n - 1] = cv[n - 1]
                    n -= 1
                    break
            i_n -= 1
        with open(f"{self.name}_Emax_{out_cnt:06d}.txt", "w") as f:
            for k in range(n):
                if cv[k, ndim] > self.field_maxima_threshold:
                    f.write(" ".join(f"{x:.8E}" for x in cv[k]) + "\n")

    # ------------------------------------------------ uniform-grid npz
    def extra_var_values(self, sim, name: str, lvl: int) -> torch.Tensor:
        """The interior values [n_leaves, nc^ndim] of a derived output
        variable on a level's leaves (add_variables, ``m_output.f90:413-``):
        the mean energy ``eV`` from E/N, the conductivity ``sigma``, the
        electron current ``Je_i`` and the chemistry source ``src_<name>``."""
        t, cc = sim.tree, sim.cc
        nc, ndim = t.nc, t.ndim
        leaves = sim.mesh.tb(lvl).d.leaves

        def inner(iv):
            return ro.cc_get_interior(cc, iv, leaves, nc, ndim)
        if sim.gas.constant_density:
            N_inv = sim.gas.inverse_number_density
        else:
            N_inv = 1.0 / inner(sim.i_gas_dens)
        Td = inner(sim.i_electric_fld) * uc.SI_to_Townsend * N_inv
        if name == "eV":
            return interp(Td, *self._ev_tbl)

        def sigma():
            return (sim.td.tbl.get_col(TD_MOBILITY, Td) * N_inv
                    * inner(sim.i_electron) * uc.elem_charge)
        if name == "sigma":
            return sigma()
        if name.startswith("Je_"):
            idim = int(name[3:]) - 1
            faxes = [np.arange(0, nc + 1) if k == idim else np.arange(0, nc)
                     for k in range(ndim)]
            fidx = torch.as_tensor(sp.fc_flat(ndim, nc, *faxes),
                                   dtype=torch.int64, device=cc.device)
            F = sim.fc[sim.fc_E, idim, leaves[:, None], fidx[None, :]]
            F = F.reshape((len(leaves),) + tuple(
                nc + 1 if k == idim else nc for k in range(ndim)))
            lo = tuple(slice(0, nc) if k == idim else slice(None)
                       for k in range(ndim))
            hi = tuple(slice(1, nc + 1) if k == idim else slice(None)
                       for k in range(ndim))
            Ecc = 0.5 * (F[(slice(None),) + lo] + F[(slice(None),) + hi])
            return sigma() * Ecc.reshape(len(leaves), -1)
        if name.startswith("src_"):
            six = sim.chem.species_list.index(name[4:])
            rates = sim.chem.get_rates(Td.reshape(-1))
            ngas = sim.chem.n_gas_species
            cols = [torch.full_like(Td.reshape(-1), sim.gas.densities[k])
                    for k in range(ngas)]
            cols += [inner(iv).reshape(-1) for iv in sim.species_cc]
            _, derivs = sim.chem.get_derivatives(torch.stack(cols, 1), rates)
            return derivs[:, six].reshape(Td.shape)
        raise ValueError(f"unknown extra output variable {name}")

    def _uniform_grid(self, sim, values) -> np.ndarray:
        """A variable on the uniform grid of the finest level, each leaf's
        cells repeated over the fine cells they cover; ``values(lvl)``
        gives the interior values [n_leaves, nc^ndim] of a level."""
        t = sim.tree
        nc, ndim = t.nc, t.ndim
        top = t.highest_lvl
        shape = tuple(int(x) for x in t.coarse_grid_size * 2 ** (top - 1))
        grid = torch.zeros(shape, dtype=torch.float64, device=sim.cc.device)
        for lvl in range(1, top + 1):
            leaves = np.asarray(t.lvl_leaves[lvl - 1])
            if len(leaves) == 0:
                continue
            n, scale = len(leaves), 2 ** (top - lvl)
            vals = values(lvl).to(torch.float64).reshape((n,) + (nc,) * ndim)
            for k in range(ndim):
                vals = vals.repeat_interleave(scale, dim=1 + k)
            m = nc * scale
            idx = []
            for k in range(ndim):
                ix = torch.as_tensor(t.ix[leaves, k] * m, device=grid.device)
                shp = [n] + [1] * ndim
                shp[1 + k] = m
                idx.append((ix[:, None] + torch.arange(
                    m, device=grid.device)[None, :]).reshape(shp))
            grid[tuple(idx)] = vals
        return grid.cpu().numpy()

    def write_npz(self, sim, out_cnt: int) -> None:
        """The variables marked for output and the extra variables on the
        uniform grid of the finest level (the JAX package's write_npz, an
        af_write_numpy analog)."""
        t = sim.tree
        nc, ndim = t.nc, t.ndim
        out = {}
        for iv, name in enumerate(self.registry.cc_names):
            if not self.registry.cc_write_output[iv]:
                continue
            out[name] = self._uniform_grid(sim, lambda lvl, iv=iv: (
                ro.cc_get_interior(sim.cc, iv, sim.mesh.tb(lvl).d.leaves,
                                   nc, ndim)))
        for name in self.extra_vars:
            out[name] = self._uniform_grid(
                sim, lambda lvl, name=name: self.extra_var_values(
                    sim, name, lvl))
        np.savez_compressed(f"{self.name}_{out_cnt:06d}.npz",
                            r_min=t.r_base,
                            r_max=t.r_base + t.domain_len, **out)

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
