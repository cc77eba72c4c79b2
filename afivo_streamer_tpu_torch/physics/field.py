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
the permittivity enters through the multigrid's ``eps_data``. With an
electrode (``use_electrode``): the level set of one of six shapes
(field_initialize, ``m_field.f90:197-345``) enters through the
multigrid's ``lsf_data``, the solve carries the electrode's potential as
``params["lsf_phi_b"]``, and the faces beside the electrode take the
one-sided gradient over the boundary distance (mg_box_lpllsf_gradient).

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
from ..core.rowops import (cc_get_interior, fc_get_faces, fc_set_faces,
                           interior)
from ..solvers import mg_blocks as mgb
from ..solvers.lsf import LsfData
from ..solvers.multigrid import Multigrid
from ..trace import to_list
from ..utils import geometry
from ..utils.lookup_table import lin_interp_list
from ..utils.table_data import table_from_file


def conical_rod_lsf(r, a0, a1, rad, tip_r, lfrac):
    """Level set of a rod from a0 to a1 of radius ``rad`` whose last
    fraction ``lfrac`` is a cone ending in a spherical tip of radius
    ``tip_r`` (conical_rod_lsf + get_conical_rod_properties,
    ``m_field.f90:633-700``)."""
    cone_length = lfrac * np.linalg.norm(a1 - a0)
    cone_angle = np.arctan((rad - tip_r) / cone_length)
    r_curv = tip_r / np.cos(cone_angle)
    ctr = a1 - (np.sin(cone_angle) * r_curv
                * (a1 - a0) / np.linalg.norm(a1 - a0))
    dist_vec, frac = geometry.dist_vec_line(r, a0, a1)
    dist = np.linalg.norm(dist_vec, axis=-1)
    tmp = (1.0 - frac) / lfrac
    radius_at_h = tip_r + tmp * (rad - tip_r)
    tip_d = np.linalg.norm(r - ctr, axis=-1) - r_curv
    return np.where(frac <= 1 - lfrac, dist - rad,
                    np.where(frac < 1.0, dist - radius_at_h, tip_d))


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
        self.field_amplitude = field_amplitude
        self.current_voltage = 0.0
        #: user hooks (m_field.f90:216-219, 515-519): the potential at the
        #: domain boundary, callable(iv, d, coords, params) ->
        #: (bc_type, values), and the applied field, callable(time) -> V/m,
        #: which overrides the voltage control
        self.user_potential_bc = None
        self.user_field_amplitude = None
        self.surfaces = None  # solvers/surface.Surfaces with dielectrics
        self.lsf_data = None
        self.user_lsf_bc = None
        self._init_electrode(cfg)
        self.mg = Multigrid(mesh, i_phi, i_rhs, self.phi_bc)
        self.mg.lsf_data = self.lsf_data

    # ------------------------------------------------- electrode geometry
    def _init_electrode(self, cfg):
        """The electrode settings and, with ``use_electrode``, the level set
        and the boundary coefficient of the chosen shape (field_initialize,
        ``m_field.f90:197-345``)."""
        ndim = self.tree.ndim
        settings = self.st
        self.electrode_grounded = cfg.add_get(
            "field_electrode_grounded", False,
            "Whether electrode 1 is grounded or at the applied voltage")
        self.electrode2_grounded = cfg.add_get(
            "field_electrode2_grounded", False,
            "Whether electrode 2 is grounded or at the applied voltage")

        def rel(key, doc):
            return np.asarray([float(x) for x in cfg.add_get(
                key, [-1.0e100] * ndim, doc, dynamic=True)])
        rod_r0 = rel("field_rod_r0", "Electrode 1: first relative coordinate")
        rod_r1 = rel("field_rod_r1", "Electrode 1: second relative coordinate")
        rod2_r0 = rel("field_rod2_r0",
                      "Electrode 2: first relative coordinate")
        rod2_r1 = rel("field_rod2_r1",
                      "Electrode 2: second relative coordinate")
        self.rod_radius = cfg.add_get("field_rod_radius", -1.0e100,
                                      "Electrode 1 radius (in m)")
        self.rod2_radius = cfg.add_get("field_rod2_radius", -1.0e100,
                                       "Electrode 2 radius (in m)")
        self.electrode_type = cfg.add_get(
            "field_electrode_type", "rod",
            "Type of electrode (sphere, rod, rod_cone_top, rod_rod, "
            "two_rod_cone_electrodes, user)")
        if not settings.use_electrode:
            return
        dl, o = settings.domain_len, settings.domain_origin
        r0, r1 = o + rod_r0 * dl, o + rod_r1 * dl
        r20, r21 = o + rod2_r0 * dl, o + rod2_r1 * dl
        rr, rr2 = self.rod_radius, self.rod2_radius
        et = self.electrode_type
        if et == "sphere":
            def lsf_fn(r):
                return np.linalg.norm(r - r0, axis=-1) - rr
        elif et == "rod":
            def lsf_fn(r):
                return geometry.dist_line(r, r0, r1) - rr
        elif et == "rod_rod":
            def lsf_fn(r):
                return np.minimum(geometry.dist_line(r, r0, r1) - rr,
                                  geometry.dist_line(r, r20, r21) - rr2)
        elif et in ("rod_cone_top", "two_rod_cone_electrodes"):
            # rod with a conical top ending in a spherical tip
            # (conical_rod_lsf + get_conical_rod_properties,
            # m_field.f90:633-700)
            tip_r = cfg.add_get(
                "cone_tip_radius", -1.0e100,
                "Radius of curvature of the conical electrode tip")
            clf = cfg.add_get(
                "cone_length_frac", -1.0e100,
                "Fraction of the rod length that is conical")
            if tip_r <= 0 or tip_r > rr:
                raise ValueError(
                    "cone_tip_radius should be smaller than rod radius")
            if clf < 0 or clf > 1:
                raise ValueError("cone_length_frac not set correctly")
            if et == "rod_cone_top":
                def lsf_fn(r):
                    return conical_rod_lsf(r, r0, r1, rr, tip_r, clf)
            else:
                tip_r2 = cfg.add_get(
                    "cone2_tip_radius", -1.0e100,
                    "Radius of curvature of the second conical tip")
                clf2 = cfg.add_get(
                    "cone2_length_frac", -1.0e100,
                    "Fraction of the second rod that is conical")
                if tip_r2 <= 0 or tip_r2 > rr2:
                    raise ValueError("cone2_tip_radius incorrect")
                if clf2 < 0 or clf2 > 1:
                    raise ValueError("cone2_length_frac incorrect")

                def lsf_fn(r):
                    return np.minimum(
                        conical_rod_lsf(r, r0, r1, rr, tip_r, clf),
                        conical_rod_lsf(r, r20, r21, rr2, tip_r2, clf2))
        elif et == "user":
            lsf_fn = None  # wired later via set_user_lsf
        else:
            raise ValueError(f"Invalid electrode type {et}")
        if rr <= 0:
            raise ValueError(
                "set field_rod_radius to the electrode length scale")

        g1 = 0.0 if self.electrode_grounded else 1.0
        g2 = 0.0 if self.electrode2_grounded else 1.0
        if et in ("rod_rod", "two_rod_cone_electrodes"):
            # electrode-dependent potential (rod_rod_get_potential /
            # two_conical_rods_get_potential)
            def bc_coeff_fn(r):
                lsf1 = geometry.dist_line(r, r0, r1) - rr
                lsf2 = geometry.dist_line(r, r20, r21) - rr2
                return np.where(lsf1 < lsf2, g1, g2)
        else:
            def bc_coeff_fn(r):
                return np.full(r.shape[:-1], g1)
        if lsf_fn is not None:
            self.lsf_data = LsfData(self.mesh, lsf_fn, length_scale=rr,
                                    boundary_coeff_fn=bc_coeff_fn)
        self._default_bc_coeff_fn = bc_coeff_fn

    def set_user_lsf(self, lsf_fn, lsf_bc_fn=None):
        """Wire a user-supplied electrode geometry (field_electrode_type =
        user, m_field.f90:323-333). lsf_fn(r[...,ndim]) -> level set;
        lsf_bc_fn(r) -> boundary potential (overrides the grounded /
        at-voltage coefficient; the solve then uses lsf_phi_b = 1)."""
        if lsf_fn is None:
            raise ValueError("user electrode type requires user.lsf")
        self.user_lsf_bc = lsf_bc_fn
        coeff_fn = (lsf_bc_fn if lsf_bc_fn is not None
                    else self._default_bc_coeff_fn)
        self.lsf_data = LsfData(self.mesh, lsf_fn,
                                length_scale=self.rod_radius,
                                boundary_coeff_fn=coeff_fn)
        self.mg.lsf_data = self.lsf_data

    def lsf_phi_b(self) -> float:
        """The electrode's boundary potential of a solve: the applied
        voltage (grounded rods have a zero per-cell coefficient,
        mg_lsf_boundary_value), or 1 where a user boundary function gives
        the potential itself; 0 without an electrode."""
        if self.lsf_data is None:
            return 0.0
        return 1.0 if self.user_lsf_bc is not None else self.current_voltage

    def solve_params(self, params: Optional[dict] = None) -> dict:
        """``params`` with the current voltage and, with an electrode, its
        boundary potential."""
        params = dict(params or {})
        params["voltage"] = self.current_voltage
        if self.lsf_data is not None:
            params["lsf_phi_b"] = self.lsf_phi_b()
        return params

    # ------------------------------------------------- boundary conditions
    def phi_bc(self, iv, d, coords, params):
        """Potential BC (field_bc_homogeneous / _neumann / _all_neumann), or
        the user's."""
        ndim = self.tree.ndim
        voltage = params.get("voltage", 0.0)
        if self.user_potential_bc is not None:
            return self.user_potential_bc(iv, d, coords, params)
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
        if self.user_field_amplitude is not None:
            amp = self.user_field_amplitude(time)
            self.current_voltage = float(
                -self.st.domain_len[self.tree.ndim - 1] * amp)
            return self.current_voltage
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
        """field_compute (``m_field.f90:405-485``): the tracer's span
        ``field``, holding ``field.rhs``, ``field.fmg`` (each cycle of a
        solve without a guess), ``field.vcycle`` (each V-cycle with the
        read of its residual, ``sync.field_residual``) and
        ``field.gradient`` (from_potential); the V-cycles of each solve
        are the series ``vcycles``."""
        tr = self.mesh.tracer
        with tr.span("field"):
            t = self.tree
            mg = self.mg
            with tr.span("field.rhs"):
                cc = self.set_rhs(cc, s_in)
                self.set_voltage(time)
                params = self.solve_params(params)
                max_rhs = tree_maxabs_cc(cc, self.mesh, self.i_rhs)
                min_dr = float(t.lvl_dr(t.highest_lvl).min())
                residual_threshold = max(
                    1e-6,
                    max_rhs * self.st.multigrid_max_rel_residual,
                    (1e-8 if self.st.use_electrode else 1e-10)
                    * abs(self.current_voltage)
                    / (self.st.domain_len[t.ndim - 1] * min_dr))
                P, R = mgb.gather_levels(mg, cc)

            if not have_guess:
                residuals = []
                for _ in range(100):
                    # the reference always passes have_guess=.true. here
                    # (field_compute, m_field.f90:448-450)
                    with tr.span("field.fmg"):
                        P, R = mgb.fas_fmg_blocks(mg, P, R, params)
                        res = tr.host_read(mgb.max_leaf_residual_blocks(
                            mg, P, R, params), "field_residual")
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

            n = 0
            for n in range(1, self.st.multigrid_num_vcycles + 1):
                with tr.span("field.vcycle"):
                    P, R = mgb.fas_vcycle_blocks(mg, P, R, params)
                    res = tr.host_read(mgb.max_leaf_residual_blocks(
                        mg, P, R, params), "field_residual")
                if res < residual_threshold:
                    break
            tr.sample("vcycles", n)
            with tr.span("field.gradient"):
                cc = mgb.scatter_levels(mg, cc, P, R)
                return self.from_potential(cc, fc, params)

    def from_potential(self, cc, fc, params):
        """E = -grad phi; cell norm; ghost fill of the norm
        (field_from_potential)."""
        fc = self.mg.compute_phi_gradient(cc, fc, self.fc_E, -1.0)
        if self.lsf_data is not None:
            fc = self._lsf_gradient_correction(cc, fc, params)
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

    def _lsf_gradient_tables(self, lvl: int):
        """Device tables of a level's leaf boxes that hold the electrode
        boundary: their ids, boundary distances dd [n] + [nc]^ndim +
        [2 ndim], the cells outside the electrode and the boundary
        coefficient; None where there is no such box. Cached with the
        mesh's plans."""
        def make():
            data = self.lsf_data.level_data(lvl)
            tb = self.mesh.tb(lvl)
            nc, ndim = self.tree.nc, self.tree.ndim
            is_leaf = np.zeros(len(tb.ids), bool)
            is_leaf[tb.leaves_pos] = True
            # the level's own boxes come first (a sharded run's halo after)
            sel = np.nonzero(data["has_bnd"][:data["n_own"]] & is_leaf)[0]
            if len(sel) == 0:
                return None
            cshape = (len(sel),) + (nc,) * ndim
            dev = self.mesh.device

            def real(a, shape):
                return torch.as_tensor(a.reshape(shape),
                                       dtype=self.mesh.dtype, device=dev)
            return {"boxes": torch.as_tensor(data["ids"][sel],
                                             dtype=torch.int64, device=dev),
                    "dd": real(data["dd"][sel], cshape + (2 * ndim,)),
                    "outside": torch.as_tensor(
                        data["lsf_cc"][sel].reshape(cshape) >= 0, device=dev),
                    "bc_coeff": real(data["bc_coeff"][sel], cshape)}
        return self.mesh.cached(("lsf_grad", self.lsf_data, lvl), make,
                                (lvl,))

    def _lsf_gradient_correction(self, cc, fc, params):
        """Correct E at faces adjacent to the electrode boundary
        (mg_box_lpllsf_gradient, ``m_af_multigrid.f90:2030-2122``):
        one-sided gradients over the boundary distance toward the electrode
        potential, applied on leaf boxes containing the boundary."""
        t = self.tree
        nc, ndim = t.nc, t.ndim
        phi_b = float(params.get("lsf_phi_b", 0.0))
        inner = interior(nc, ndim)
        for lvl in range(1, t.highest_lvl + 1):
            tab = self._lsf_gradient_tables(lvl)
            if tab is None:
                continue
            boxes = tab["boxes"]
            dd = tab["dd"].to(cc.dtype)
            dr = t.lvl_dr(lvl)
            bc_val = tab["bc_coeff"].to(cc.dtype) * phi_b
            phi = cc[self.i_phi, boxes].reshape(
                (len(boxes),) + (nc + 2,) * ndim)[inner]
            for d in range(ndim):
                F = fc_get_faces(fc, self.fc_E, d, boxes, nc, ndim)
                inv_dr = -1.0 / float(dr[d])
                m_lo = (dd[..., 2 * d] < 1) & tab["outside"]
                m_hi = (dd[..., 2 * d + 1] < 1) & tab["outside"]
                v_lo = inv_dr * (phi - bc_val) / torch.clamp(
                    dd[..., 2 * d], min=uc.tiny(cc.dtype))
                v_hi = inv_dr * (bc_val - phi) / torch.clamp(
                    dd[..., 2 * d + 1], min=uc.tiny(cc.dtype))
                lo = (slice(None),) + tuple(
                    slice(0, nc) if k == d else slice(None)
                    for k in range(ndim))
                hi = (slice(None),) + tuple(
                    slice(1, nc + 1) if k == d else slice(None)
                    for k in range(ndim))
                F[lo] = torch.where(m_lo, v_lo, F[lo])
                F[hi] = torch.where(m_hi, v_hi, F[hi])
                fc_set_faces(fc, self.fc_E, d, boxes, F, nc, ndim)
        return fc

    def compute_energy(self, cc) -> float:
        """Total field energy 0.5 eps0 E^2 dV (field_compute_energy)."""
        t = self.tree
        sums = []
        for lvl in range(1, t.highest_lvl + 1):
            tb = self.mesh.tb(lvl)
            if len(tb.leaves) == 0:  # every rank of a sharded run sums it
                sums.append(cc.new_zeros(()))
                continue
            Ecc = cc_get_interior(cc, self.i_electric_fld, tb.d.leaves,
                                  t.nc, t.ndim)
            sums.append(torch.sum(Ecc ** 2 * tb.d.vol.to(cc.dtype)))
        total = 0.0
        # the ranks' partial sums of each level in a sharded run
        for s in self.mesh.tracer.host_read(
                self.mesh.reduce(torch.stack(sums), "sum"),
                "compute_energy", to_list):
            total = total + s
        return 0.5 * uc.eps0 * total
