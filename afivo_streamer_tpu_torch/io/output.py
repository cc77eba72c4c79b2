"""Simulation output: the regression log and the status line.

Re-implements two writers of the reference's ``src/m_output.f90``: the
regression-test log with per-species volume-averaged sum(n), sum(n^2),
max(n) at every output time (output_regression_log ``:783-837``) and the
stdout status (output_status ``:852-867``). The other writers of the JAX
package (text log, grid, npz, VTK, checkpoint, lineout, plane, cross
section, field maxima) are not part of this package: a configuration that
turns one on raises NotImplementedError.
"""

from __future__ import annotations

import os

from ..core import reductions as red

#: writers that are off unless the configuration turns them on, and those
#: that are on by default; both are refused when on
_OPT_IN = ("output%npz", "output%vtk", "datfile%write", "lineout%write",
           "plane%write", "cross%write", "field_maxima%write",
           "compute_power_density", "output%electron_energy",
           "output%conductivity", "output%electron_current")
_ON_BY_DEFAULT = ("output%log", "silo_write")


class Output:
    def __init__(self, cfg):
        self.name = cfg.add_get("output%name", "output/sim",
                                "Name for the output files (e.g. output/sim)")
        self.dt = cfg.add_get("output%dt", 1.0e-10,
                              "The timestep for writing output (s)")
        self.dt_factor_pulse_off = cfg.add_get(
            "output%dt_factor_pulse_off", 1,
            "Output dt multiplier when the voltage is off")
        self.regression_test = cfg.add_get(
            "output%regression_test", False,
            "Write a regression-test log")
        self.status_delay = cfg.add_get(
            "output%status_delay", 60.0,
            "Interval between writing status line (s)")
        for key in _OPT_IN:
            if cfg.add_get(key, False, "Not available in this package"):
                raise NotImplementedError(f"io/output.py: {key}")
        for key in _ON_BY_DEFAULT:
            if cfg.add_get(key, True, "Not available in this package; set "
                           "to f"):
                raise NotImplementedError(
                    f"io/output.py: {key} (set {key} = f)")
        if [s for s in cfg.add_get("output%write_source", [""],
                                   "Not available in this package") if s]:
            raise NotImplementedError("io/output.py: output%write_source")
        os.makedirs(os.path.dirname(self.name) or ".", exist_ok=True)

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
