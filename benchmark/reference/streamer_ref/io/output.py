"""Simulation output, as far as the benchmark's cells write it: the
chemistry files and the status line.

Of the writers of the reference's ``src/m_output.f90`` (and of the port's
``io/output.py``, which this copies) the benchmark's reference keeps:

* the chemistry files: at setup the species, the reactions, the
  stoichiometric matrix and, at constant gas density, the swarm summary
  (output_initial_summary ``:294-306``), and at every output one line of
  the accumulated reaction rates and one of the species amounts;
* the stdout status (output_status ``:852-867``).

Every other writer (the regression log, the text log, the grid files, the
uniform-grid npz, lines, planes, cross sections, field maxima, VTK and
checkpoints) was taken out: a configuration that turns one on raises
NotImplementedError.
"""

from __future__ import annotations

import os

import numpy as np

from ..core import reductions as red


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

        on = [key for key, value in (
            ("output%log", self.write_log),
            ("output%regression_test", self.regression_test),
            ("silo_write", self.silo_write), ("output%npz", self.npz_write),
            ("output%vtk", self.write_vtk_files),
            ("datfile%write", self.datfile_write),
            ("lineout%write", self.lineout_write),
            ("plane%write", self.plane_write),
            ("cross%write", self.cross_write),
            ("field_maxima%write", self.field_maxima_write)) if value]
        if on:
            raise NotImplementedError(
                "the benchmark's reference writes only the chemistry files "
                "and the status line; set off: " + ", ".join(on))
        os.makedirs(os.path.dirname(self.name) or ".", exist_ok=True)

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
