"""Electric field computation: Poisson solve + gradient.

Re-implements the reference's ``src/m_field.f90``: the space-charge
right-hand side (field_set_rhs ``:363-401``), voltage control with
rise/fall/pulse trains and tabulated time series (field_set_voltage
``:508-543``), the convergence-controlled multigrid solve (field_compute
``:405-485``: initial FMG loop with stagnation detection, then V-cycles
against a residual threshold scaled by max|rhs| and a roundoff estimate),
the field from the potential (field_from_potential ``:488-505``), and the
built-in boundary conditions (homogeneous / neumann / all_neumann,
``:547-608``). With dielectrics (``surfaces`` set) the rhs takes the
base-state surface charge and the face field the surface-charge jump;
the permittivity enters through the multigrid's ``eps_data``.

The whole solve runs on the per-level block arrays of
solvers/mg_blocks.py: cc is read once and written once per solve, and the
residual check of each cycle is the only value that goes to the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import constants as uc
from ..core import ghostcell as gc
from ..core.reductions import tree_maxabs_cc
from ..core.rowops import cc_get_interior
from ..solvers import mg_blocks as mgb
from ..solvers.multigrid import Multigrid
from ..utils.lookup_table import lin_interp_list
from ..utils.table_data import table_from_file


class FieldSolver:
    SCALAR_VOLTAGE = 1
    TABULATED_VOLTAGE = 2

    def __init__(self, cfg, mesh, settings, i_phi, i_rhs, i_electric_fld,
                 fc_E, charged_species_cc, charged_sign):
        self.tree = mesh.tree
        self.mesh = mesh
        self.st = settings
        self.i_phi, self.i_rhs = i_phi, i_rhs
        self.i_electric_fld = i_electric_fld
        self.fc_E = fc_E
        self.charged_species_cc = list(charged_species_cc)
        self.charged_sign = np.asarray(charged_sign, np.float64)
        ndim = self.tree.ndim

        # ------------------------------------------------ voltage control
        self.field_rise_time = cfg.add_get(
            "field_rise_time", 0.0, "Linear rise time of field (s)")
        self.field_pulse_width = cfg.add_get(
            "field_pulse_width", uc.huge_real,
            "Pulse width excluding rise and fall time (s)")
        self.field_num_pulses = cfg.add_get(
            "field_num_pulses", 1, "Number of voltage pulses (default: 1)")
        self.field_pulse_period = cfg.add_get(
            "field_pulse_period", uc.huge_real,
            "Time of one complete voltage pulse (s)")
        field_amplitude = cfg.add_get(
            "field_amplitude", uc.undefined_real,
            "The (initial) vertical applied electric field (V/m)")
        given_by = cfg.add_get("field_given_by", "undefined",
                               "How the electric field or voltage is specified")
        domain_len = settings.domain_len[ndim - 1]
        self.field_table = None
        if given_by != "undefined":
            kind, _, value = given_by.partition(" ")
            value = value.strip()
            if kind == "voltage":
                self.given_by = self.SCALAR_VOLTAGE
                self.field_voltage = float(value)
            elif kind == "field":
                self.given_by = self.SCALAR_VOLTAGE
                self.field_voltage = -domain_len * float(value)
            elif kind == "voltage_table":
                self.given_by = self.TABULATED_VOLTAGE
                self.field_table = table_from_file(value, "voltage_vs_time")
            elif kind == "field_table":
                self.given_by = self.TABULATED_VOLTAGE
                tt, tv = table_from_file(value, "field_vs_time")
                self.field_table = (tt, -domain_len * tv)
            else:
                raise ValueError(f"Unknown field_given_by value: {given_by}")
        elif field_amplitude > uc.undefined_real:
            self.given_by = self.SCALAR_VOLTAGE
            self.field_voltage = -domain_len * field_amplitude
        else:
            raise ValueError("field_amplitude not specified")

        self.bc_type = cfg.add_get("field_bc_type", "homogeneous",
                                   "Boundary condition for electric potential")
        self.current_voltage = 0.0
        self.mg = Multigrid(mesh, i_phi, i_rhs, self.phi_bc)
        self.surfaces = None  # solvers/surface.Surfaces with dielectrics

    # ------------------------------------------------- boundary conditions
    def phi_bc(self, iv, d, coords, params):
        """Potential BC (field_bc_homogeneous / _neumann / _all_neumann)."""
        ndim = self.tree.ndim
        voltage = params.get("voltage", 0.0)
        if self.bc_type == "homogeneous":
            if d // 2 == ndim - 1:
                if d % 2 == 0:
                    return gc.BC_DIRICHLET, 0.0
                return gc.BC_DIRICHLET, voltage
            return gc.BC_NEUMANN, 0.0
        if self.bc_type == "neumann":
            if d // 2 == ndim - 1:
                if d % 2 == 0:
                    return gc.BC_DIRICHLET, 0.0
                return gc.BC_NEUMANN, voltage / float(
                    self.st.domain_len[ndim - 1])
            return gc.BC_NEUMANN, 0.0
        if self.bc_type == "all_neumann":
            return gc.BC_NEUMANN, 0.0
        raise ValueError(f"invalid field_bc_type {self.bc_type}")

    # -------------------------------------------------------- voltage
    def set_voltage(self, time: float) -> float:
        """Set current_voltage (field_set_voltage, ``m_field.f90:508-543``)."""
        if self.given_by == self.TABULATED_VOLTAGE:
            tt, tv = self.field_table
            self.current_voltage = float(lin_interp_list(tt, tv, time))
            return self.current_voltage
        v = 0.0
        if time < self.field_pulse_period * self.field_num_pulses:
            t = np.mod(time, self.field_pulse_period)
            if t < self.field_rise_time:
                v = self.field_voltage * (t / self.field_rise_time)
            elif t < self.field_pulse_width + self.field_rise_time:
                v = self.field_voltage
            else:
                tmp = t - (self.field_pulse_width + self.field_rise_time)
                v = self.field_voltage * max(
                    0.0, 1.0 - tmp / self.field_rise_time)
        self.current_voltage = float(v)
        return self.current_voltage

    # ------------------------------------------------------------- rhs
    def set_rhs(self, cc, s_in: int):
        """rhs = -sum(q_s n_s) e / eps0 on all boxes (field_set_rhs)."""
        allids = self.mesh.all_ids()
        fac = -uc.elem_charge / uc.eps0
        acc = 0.0
        for s_cc, q in zip(self.charged_species_cc, self.charged_sign):
            acc = acc + (float(q) * fac) * cc[s_cc + s_in, allids]
        cc[self.i_rhs, allids] = acc
        if self.surfaces is not None:
            # the reference always deposits the base-state surface charge
            # (field_set_rhs, m_field.f90:398-400)
            cc = self.surfaces.charge_to_rhs(cc, self.i_rhs, fac)
        return cc

    # ------------------------------------------------------------ solve
    def compute(self, cc, fc, s_in: int, time: float, have_guess: bool,
                params: Optional[dict] = None):
        """field_compute (``m_field.f90:405-485``)."""
        t = self.tree
        mg = self.mg
        cc = self.set_rhs(cc, s_in)
        self.set_voltage(time)
        params = dict(params or {})
        params["voltage"] = self.current_voltage
        max_rhs = tree_maxabs_cc(cc, self.mesh, self.i_rhs)
        min_dr = float(t.lvl_dr(t.highest_lvl).min())
        residual_threshold = max(
            1e-6,
            max_rhs * self.st.multigrid_max_rel_residual,
            1e-10 * abs(self.current_voltage)
            / (self.st.domain_len[t.ndim - 1] * min_dr))

        P, R = mgb.gather_levels(mg, cc)
        if not have_guess:
            residuals = []
            for _ in range(100):
                # the reference always passes have_guess=.true. here
                # (field_compute, m_field.f90:448-450)
                P, R = mgb.fas_fmg_blocks(mg, P, R, params)
                res = float(mgb.max_leaf_residual_blocks(mg, P, R))
                residuals.append(res)
                if res < residual_threshold:
                    break
                if len(residuals) >= 3:
                    lo = min(residuals[-3:])
                    hi = max(residuals[-3:])
                    ratio = lo / hi if hi > 0 else 0.0
                    if 0.5 < ratio < 2.0 and res < 1e8:
                        break
            else:
                raise RuntimeError(
                    f"No convergence in initial field computation: "
                    f"{residuals}")

        for _ in range(self.st.multigrid_num_vcycles):
            P, R = mgb.fas_vcycle_blocks(mg, P, R, params)
            res = float(mgb.max_leaf_residual_blocks(mg, P, R))
            if res < residual_threshold:
                break
        cc = mgb.scatter_levels(mg, cc, P, R)
        return self.from_potential(cc, fc, params)

    def from_potential(self, cc, fc, params):
        """E = -grad phi; cell norm; ghost fill of the norm
        (field_from_potential)."""
        fc = self.mg.compute_phi_gradient(cc, fc, self.fc_E, -1.0)
        if self.surfaces is not None:
            fc = self.surfaces.correct_field_fc(
                cc, fc, self.fc_E, self.i_phi, uc.elem_charge / uc.eps0)
        cc = self.mg.compute_field_norm(cc, fc, self.fc_E,
                                        self.i_electric_fld)
        # gc for the norm: neumann-zero bc + unlimited interpolation rb
        for lvl in range(1, self.tree.highest_lvl + 1):
            gc.fill_ghosts_lvl(
                cc, self.mesh.gc(lvl), [self.i_electric_fld], gc.RB_INTERP,
                lambda iv, d, coords, p: (gc.BC_NEUMANN, 0.0), params)
        return cc, fc

    def compute_energy(self, cc) -> float:
        """Total field energy 0.5 eps0 E^2 dV (field_compute_energy)."""
        t = self.tree
        total = 0.0
        for lvl in range(1, t.highest_lvl + 1):
            tb = self.mesh.tb(lvl)
            if len(tb.leaves) == 0:
                continue
            Ecc = cc_get_interior(cc, self.i_electric_fld, tb.d.leaves,
                                  t.nc, t.ndim)
            total = total + float(torch.sum(Ecc ** 2 * tb.d.vol.to(cc.dtype)))
        return 0.5 * uc.eps0 * total
