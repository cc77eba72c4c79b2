"""Photoionization: Zheleznyak source + Helmholtz-approximation solver.

Re-implements the reference's ``src/m_photoi.f90`` (method switch, quench
factor p_q/(p+p_q), source = eta * quench * ionization rate,
photoionization_rate_from_alpha ``:233-265``, excited-species decay source
``:268-286``) and ``src/m_photoi_helmh.f90`` (multi-mode Helmholtz
nabla^2 phi_i - lambda_i^2 phi_i = f with Luque / Bourdon-2 / Bourdon-3 /
custom coefficient sets scaled by p*O2-fraction ``:80-139``; each mode
reuses the geometric multigrid with helmholtz_lambda = lambda_i^2 and runs
FMG cycles until the relative residual is below 1e-2 ``:162-204``).

With ``photoi%method = montecarlo`` the photo row comes instead from
discrete photons (physics/photoi_mc.py), without modes or multigrids.

Each mode has its own variable and its own multigrid, so its smoother
tables, stencil coefficients and dense level-1 inverse are cached apart
from the field solver's and the other modes'. The stop test reads the
leaf residual after every FMG cycle: one host sync per cycle and mode, and
the number of cycles each mode took is kept in ``fmg_cycles``.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from .. import constants as uc
from ..core import ghostcell as gc
from ..core import rowops as ro
from ..core.reductions import tree_maxabs_cc
from ..solvers import mg_blocks as mgb
from ..solvers.multigrid import Multigrid
from .photoi_mc import PhotoiMC
from .transport_data import TD_ALPHA, TD_MOBILITY

MAX_FMG_CYCLES = 10  # photoi_helmh_compute, m_photoi_helmh.f90:185


def helmh_bc(iv, d, coords, params, ndim=2):
    """Dirichlet zero in the last dimension, Neumann zero otherwise
    (photoi_helmh_bc)."""
    if d // 2 == ndim - 1:
        return gc.BC_DIRICHLET, 0.0
    return gc.BC_NEUMANN, 0.0


class Photoionization:
    def __init__(self, cfg, mesh, registry, gas, transport, chemistry,
                 i_rhs, i_electron, i_electric_fld, settings=None):
        """settings: the StreamerSettings (the domain, the dielectric and
        the random seed of the Monte-Carlo method)."""
        self.mesh = mesh
        self.tree = mesh.tree
        self.gas = gas
        self.td = transport
        self.i_rhs = i_rhs
        self.i_electron = i_electron
        self.i_electric_fld = i_electric_fld

        self.enabled = cfg.add_get("photoi%enabled", False,
                                   "Whether photoionization is enabled")
        self.per_steps = cfg.add_get(
            "photoi%per_steps", 5, "Update photoionization every N time steps")
        self.method = cfg.add_get(
            "photoi%method", "helmholtz",
            "Which photoionization method to use (helmholtz, montecarlo)")
        self.eta = cfg.add_get(
            "photoi%eta", 0.05,
            "Photoionization efficiency factor, typically around 0.05-0.1")
        self.quenching_pressure = cfg.add_get(
            "photoi%quenching_pressure", 40e-3,
            "Photoionization quenching pressure (bar)")
        # like the reference, the photoemission switch is exposed but the
        # surface photoemission runs through the Monte-Carlo photons + the
        # dielectric module (m_photoi.f90:18-19, 90-93)
        self.photoe_enabled = cfg.add_get(
            "photoe%enabled", False, "Whether photoemission is enabled")
        self.photoe_per_steps = cfg.add_get(
            "photoe%per_steps", 10,
            "Update photoemission every N time step")
        self.source_type = cfg.add_get(
            "photoi%source_type", "Zheleznyak",
            "How to compute the photoi. source (Zheleznyak, from_species)")
        self.excited_species = cfg.add_get(
            "photoi%excited_species", "UNDEFINED",
            "Which excited species to use when source_type = from_species")
        self.species = cfg.add_get(
            "photoi%species", "O2_plus",
            "Which species is ionized by photoionization")
        self.photoemission_time = cfg.add_get(
            "photoi%photoemission_time", 0.0,
            "Photoemission time delay for source_type = from_species")

        self.author = cfg.add_get(
            "photoi_helmh%author", "Bourdon-3",
            "Can be Bourdon-3 (default), Bourdon-2, Luque or custom")
        lam = cfg.add_get("photoi_helmh%lambdas", [],
                          "Lambdas to use in Helmholtz eq; unit 1/(m bar)",
                          dynamic=True)
        co = cfg.add_get("photoi_helmh%coeffs", [],
                         "Weights corresponding to the lambdas; "
                         "unit 1/(m bar)^2", dynamic=True)
        self.max_rel_residual = cfg.add_get(
            "photoi_helmh%max_rel_residual", 1.0e-2,
            "Maximum residual for Helmholtz solver, relative to max(|rhs|)")

        self.i_photo = -1
        self.species_cc = -1
        self.i_excited_cc = -1
        #: FMG cycles of each mode in the last update
        self.fmg_cycles: List[int] = []
        #: physics/photoi_mc.PhotoiMC under photoi%method = montecarlo
        self.mc = None
        if not self.enabled:
            return
        if not (0.0 < self.eta <= 1.0):
            raise ValueError("photoi%eta out of range")

        six = chemistry.species_index(self.species)
        if six < 0:
            raise ValueError(f"photoi%species not present: {self.species}")
        self.species_index = six

        ndim = self.tree.ndim

        def bc(iv, d, coords, params):
            return helmh_bc(iv, d, coords, params, ndim)

        self.i_photo = registry.add_cc("photo")
        registry.set_cc_methods(self.i_photo, bc, rb=gc.RB_INTERP,
                                prolong="linear")

        if self.method == "montecarlo":
            self.mc = PhotoiMC(cfg, mesh, gas, settings,
                               rng_seed=abs(settings.rng_seed[0]) + 1)
            self.n_modes = 0
            self.i_modes: List[int] = []
            self.mgs: List[Multigrid] = []
            return

        # Helmholtz coefficient sets (photoi_helmh_initialize :80-139)
        ix = gas.index("O2")
        frac_O2 = gas.fractions[ix] if ix >= 0 else 0.0
        p = gas.pressure
        if self.author == "Luque":
            if frac_O2 <= 0:
                raise ValueError("Photoionization: no oxygen present")
            lambdas = np.array([4425.38, 750.06]) * (frac_O2 / 0.2) * p
            coeffs = np.array([337557.38, 19972.14]) * ((frac_O2 / 0.2) * p)**2
            if abs(self.eta - 1.0) > 0:
                raise ValueError("With Luque photoionization, photoi%eta "
                                 "should be 1.0")
        elif self.author == "Bourdon-2":
            if frac_O2 <= 0:
                raise ValueError("Photoionization: no oxygen present")
            lambdas = np.array([7305.62, 44081.25]) * frac_O2 * p
            coeffs = np.array([11814508.38, 998607256.0]) * (frac_O2 * p)**2
        elif self.author == "Bourdon-3":
            if frac_O2 <= 0:
                raise ValueError("Photoionization: no oxygen present")
            lambdas = np.array([4147.85, 10950.93, 66755.67]) * frac_O2 * p
            coeffs = np.array([1117314.935, 28692377.5, 2748842283.0]) \
                * (frac_O2 * p)**2
        elif self.author == "custom":
            lambdas = np.array([float(x) for x in lam]) * p
            coeffs = np.array([float(x) for x in co]) * p**2
            if len(lambdas) < 1:
                raise ValueError("Custom photoionization lambdas missing")
        else:
            raise ValueError(f"Unknown photoi_helmh author {self.author}")
        self.lambdas = lambdas
        self.coeffs = coeffs
        self.n_modes = len(lambdas)

        # one multigrid solver + mode variable per lambda
        self.i_modes: List[int] = []
        self.mgs: List[Multigrid] = []
        for n in range(self.n_modes):
            iv = registry.add_cc(f"helmh_{n+1}", write_out=False)
            registry.set_cc_methods(iv, bc, rb=gc.RB_MG, prolong="linear")
            self.i_modes.append(iv)
            self.mgs.append(Multigrid(
                mesh, iv, i_rhs, bc,
                helmholtz_lambda=float(lambdas[n] ** 2)))

    # ------------------------------------------------------------ source
    def set_src(self, cc, dt: Optional[float] = None, params=None):
        """photoi_set_src (``m_photoi.f90:140-187``): the source on the
        leaf interiors of rhs, then the Helmholtz solves or the
        Monte-Carlo photons into photo; the tracer's span ``photoi``."""
        if not self.enabled:
            return cc
        with self.mesh.tracer.span("photoi"):
            return self._set_src(cc, dt, params)

    def _set_src(self, cc, dt, params):
        t = self.tree
        nc, ndim = t.nc, t.ndim
        quench_fac = (self.quenching_pressure
                      / (self.gas.pressure + self.quenching_pressure))
        if self.source_type not in ("Zheleznyak", "from_species"):
            raise ValueError("Unknown photoi%source_type")

        if self.source_type == "from_species":
            eff = self.photoemission_time
            decay_fraction = 1.0 - math.exp(-dt / eff)
            decay_rate = (decay_fraction / dt if dt > 1e-6 * eff
                          else 1.0 / eff)
        for lvl in range(1, t.highest_lvl + 1):
            tb = self.mesh.tb(lvl)
            if len(tb.leaves) == 0:
                continue
            leaves = tb.d.leaves
            if self.source_type == "Zheleznyak":
                coeff = self.eta * quench_fac
                fld = ro.cc_get_interior(cc, self.i_electric_fld, leaves,
                                         nc, ndim)
                td_ = fld * uc.SI_to_Townsend * self.gas.inverse_number_density
                alpha, mob = self.td.tbl.get_cols((TD_ALPHA, TD_MOBILITY),
                                                  td_)
                ne = ro.cc_get_interior(cc, self.i_electron, leaves, nc, ndim)
                src = (fld * mob * alpha * ne * coeff).clamp(min=0.0)
            else:  # excited-species decay (:268-286)
                exc = ro.cc_get_interior(cc, self.i_excited_cc, leaves, nc,
                                         ndim)
                src = quench_fac * decay_rate * exc
                ro.cc_set_interior(cc, self.i_excited_cc, leaves,
                                   (1 - decay_fraction) * exc, nc, ndim)
            ro.cc_set_interior(cc, self.i_rhs, leaves, src, nc, ndim)
        if self.method == "helmholtz":
            return self._helmh_compute(cc, params or {})
        return self.mc.set_src(self, cc, dt, params)

    def _helmh_compute(self, cc, params):
        """photoi_helmh_compute (``m_photoi_helmh.f90:162-204``): photo is
        zeroed on every box, each mode is solved from its last solution by
        FMG cycles until the leaf residual is below max_rel_residual times
        max|rhs| (at most 10), and photo -= c_n phi_n on the whole leaf
        rows, ghost cells included. Each mode is the tracer's span
        ``photoi.mode``, each of its cycles a span ``photoi.fmg_cycle``
        with the read of its residual (``sync.photoi_residual``); the
        cycles of each mode are the series ``fmg_cycles``, a list per
        update."""
        tr = self.mesh.tracer
        t = self.tree
        cc[self.i_photo, self.mesh.all_ids()] = 0.0
        # the floor is the state's (JAX photoi.py:280-283)
        max_rhs = max(tree_maxabs_cc(cc, self.mesh, self.i_rhs),
                      math.sqrt(torch.finfo(cc.dtype).eps))
        leaves = self.mesh.cached("all_leaves", lambda: torch.as_tensor(
            np.concatenate([self.mesh.tb(l).leaves
                            for l in range(1, t.highest_lvl + 1)]),
            dtype=torch.int64, device=self.mesh.device))
        self.fmg_cycles = []
        for n, mg in enumerate(self.mgs):
            with tr.span("photoi.mode"):
                P, R = mgb.gather_levels(mg, cc)
                for k in range(1, MAX_FMG_CYCLES + 1):
                    with tr.span("photoi.fmg_cycle"):
                        P, R = mgb.fas_fmg_blocks(mg, P, R, params)
                        residu = tr.host_read(mgb.max_leaf_residual_blocks(
                            mg, P, R), "photoi_residual")
                    if residu / max_rhs < self.max_rel_residual:
                        break
                self.fmg_cycles.append(k)
                cc = mgb.scatter_levels(mg, cc, P, R)
                cc[self.i_photo, leaves] = (
                    cc[self.i_photo, leaves]
                    - float(self.coeffs[n]) * cc[self.i_modes[n], leaves])
        tr.sample("fmg_cycles", list(self.fmg_cycles))
        return cc
