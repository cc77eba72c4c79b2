"""Simulation driver: module wiring + adaptive-dt main loop.

Port of the reference's ``src/streamer.f90``: module initialization
(initialize_modules ``:429-458``), the initial conditions with the initial
field solve and refinement loop (set_initial_conditions ``:460-519``), and
the main loop (``:177-415``) with output cadence, step rejection and retry
(up to 10 attempts), and a refinement epoch every ``refine_per_steps``
steps: restriction of the densities, the refinement criterion, the new
mesh with prolongation into its new boxes, and a fresh field solve.
Photoionization (physics/photoi.py; Helmholtz modes or Monte-Carlo
photons, physics/photoi_mc.py) is updated every ``photoi%per_steps`` steps
before the advance and after every epoch that changed the mesh.

Under the electron energy equation (``model%type = ee53``) the energy
density is one more species with a flux of its own (physics/fluid.py); the
plasma region masks the update outside a box of coordinates.

Dielectrics (``use_dielectric``) add the permittivity variable, the
surfaces on its jumps and their charge (solvers/surface.py,
physics/dielectric.py). An electrode (``use_electrode``) adds the ``lsf``
variable (the level set on every box, ghost layer included), the level-set
field solve (solvers/lsf.py, physics/field.py), no update and no density
inside the electrode, the species boundary condition on its surface before
every step (electrode_species_bc, streamer.f90:520-569) and the refinement
of its boundary boxes, coarser between voltage pulses.

Gas dynamics (``gas%dynamics``) add the Euler variables of the gas and its
number density ``M`` (physics/gas_dynamics.py): after every accepted step
and its field solve, the plasma heats and pushes the gas
(physics/coupling.py), the gas advances over the same dt with the same
integrator, and ``M`` follows its mass density; the next dt also respects
the gas's CFL limit. A user ``gas_density`` hook instead fills ``M`` on
every cell of a box once, at setup and in every new box. With either, the
gas components are the first species of the chemistry and are not stored
in the tree.

Every user hook of physics/user_methods.py runs where the JAX host path
calls it. Each output writes, in the JAX package's order, the regression
log, the text log (``output%log``, from the second output on), the grid
file (``silo_write``) and the chemistry files (io/output.py), and those
writers the configuration turns on: the VTK grid (io/vtk.py), the
checkpoint every ``datfile%per_outputs`` outputs (io/checkpoint.py), the
uniform-grid npz, the field maxima, the plane, the line and the cross
sections; setup writes the chemistry listings first.
``restart_from_file`` restores the tree and the state of a checkpoint
instead of the setup. A configuration that asks for another module this
package does not hold raises NotImplementedError naming that module.

``-compiled%enabled=T`` runs this path (parallel/compiled.py);
``-compiled%shards=N`` runs it over the N ranks of a torch.distributed
process group (parallel/halo.py): the state holds the rank's own boxes
and their halo, the tree and the plans are replicated, the refinement
flags are gathered so that every rank takes the same decision, the rows
move to their new owners after every epoch that changes the mesh, and
rank 0 gathers the state and writes every file. Every branch runs there:
the surfaces keep their state in the gas-side box's rows
(solvers/surface.py), every rank makes the same Monte-Carlo photons and
deposits those in its own boxes, and a user hook sees the rank's own
boxes as rows of its state (_hook_view).
"""

from __future__ import annotations

import contextlib
import time as _time
from typing import List, Optional

import numpy as np
import torch

from . import constants as uc
from .core import ghostcell as gc
from .core import prolong_restrict as pr
from .core import reductions as red
from .core import rowops as ro
from .core.batch import BoxBatch, capacity
from .core import spatial as sp
from .core.levels import MeshPlans
from .core.tree import Tree, box_flag_summary
from .io.checkpoint import read_checkpoint, write_checkpoint
from .io.output import Output
from .io.vtk import write_vtk
from .parallel import halo
from .parallel.compiled import CompiledSettings, Shards, pad_capacity_to
from .physics import advance as adv
from .physics.chemistry import Chemistry
from .physics.coupling import Coupling
from .physics.dielectric import Dielectric
from .physics.dt_control import DtConfig
from .physics.field import FieldSolver
from .physics.fluid import FluidModel, FluidIndices
from .physics.gas import Gas
from .physics.gas_dynamics import GasDynamics
from .physics.init_cond import InitCond
from .physics.model import Model
from .physics.photoi import Photoionization
from .physics.refine import RefineCriterion, RefineSettings
from .physics.streamer import (Registry, StreamerSettings,
                               bc_species_neumann_zero,
                               bc_species_dirichlet_zero)
from .physics.transport_data import TransportData
from .physics.user_methods import UserMethods, load_user_module
from .solvers.surface import Surfaces
from .trace import Tracer, to_numpy
from .utils.config import CFG
from .utils.table_data import TableDataSettings

MAX_ATTEMPTS_PER_TIME_STEP = 10  # streamer.f90:27
#: the parts of the JAX package's cost breakdown (its driver.py:287-288),
#: each the self time of the tracer's span of that name under a step
#: (``Simulation.wc``); "advance" is the JAX compiled engine's and stays 0
WC_KEYS = ("flux", "source", "advance", "copy", "field", "output", "refine",
           "photoi")


def resolve_device(name: str) -> torch.device:
    """The device of the simulation state; ``cuda`` requires a card."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda but CUDA is not available "
                           "(pass -device=cpu to run on the CPU)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return device


class Simulation:
    def __init__(self, argv: Optional[List[str]] = None,
                 cfg: Optional[CFG] = None, ndim: Optional[int] = None):
        if cfg is None:
            cfg = CFG()
            if argv:
                cfg.update_from_arguments(argv)
        self.cfg = cfg
        if ndim is None:
            ndim = cfg.add_get("ndim", 2, "Number of spatial dimensions")
        if ndim not in (1, 2, 3):
            raise ValueError(f"ndim={ndim}: 1, 2 or 3")
        self.ndim = ndim
        self.device = resolve_device(cfg.add_get(
            "device", "cuda", "Device of the simulation state (cuda, cpu)"))

        # ---- module initialization (initialize_modules order)
        self.model = Model(cfg)
        self.user = UserMethods()
        load_user_module(cfg, self)
        self.dt_cfg = DtConfig(cfg)
        if adv.REQUIRES_IMPLICIT[self.dt_cfg.integrator]:
            # the streamer model has no implicit part; as in the JAX driver,
            # which passes no solver (advance.py, m_af_advance.f90:146-147)
            raise ValueError(f"time integrator {self.dt_cfg.integrator} "
                             "requires an implicit_solver")
        # the compiled engine's options; N > 1 shards run over the ranks of
        # a process group of size N
        self.compiled = CompiledSettings(cfg)
        #: dtype of the state: float64 for the setup or a restart, as the
        #: JAX package's host path runs them; run() then switches to the
        #: compiled engine's compiled%dtype (_enter_state_dtype)
        self.dtype = torch.float64
        n_shards = self.compiled.n_shards
        self.shards = (Shards(n_shards, self.device.type) if n_shards > 1
                       else None)
        if self.shards is not None:
            self.device = self.shards.device
        #: whether this process writes the files and prints
        self.is_root = self.shards is None or self.shards.rank == 0
        table_settings = TableDataSettings(cfg)
        self.gas = Gas(cfg)
        if self.gas.dynamics and self.compiled.state_dtype == torch.float32:
            # the Euler equations of the gas are not ported to float32
            raise NotImplementedError(
                "physics/gas_dynamics.py under compiled%dtype=float32")
        if self.user.gas_density is not None and not self.gas.dynamics:
            # the gas density given by a user function (m_gas.f90:146-148)
            self.gas.constant_density = False
        self.td = TransportData(cfg, self.gas, table_settings,
                                self.model.has_energy_equation)
        self.chem = Chemistry(self.gas, self.td, self.td.file,
                              table_settings,
                              self.model.has_energy_equation, cfg)
        self.st = StreamerSettings(cfg, ndim)
        if self.st.cylindrical and ndim != 2:
            # the JAX package's Tree refuses the same
            raise ValueError("cylindrical coordinates only in 2D")
        self.refine_cfg = RefineSettings(cfg, ndim)

        # ---- variable registration (ST_initialize / chemistry_initialize)
        reg = Registry()
        self.registry = reg
        n_copies = self.dt_cfg.num_steps + 1
        # the gas species (first in the list under a varying gas density)
        # are not stored in the tree
        ngas = self.chem.n_gas_species
        self.species_cc: List[int] = [
            reg.add_cc(name, n_copies=n_copies)
            for name in self.chem.species_list[ngas:]]
        self.all_densities = list(self.species_cc)
        self.i_electron = self.species_cc[
            self.chem.species_list.index("e") - ngas]
        # first positive ion: charge exactly +1 (m_streamer.f90:226-235)
        pos = [i for i, q in enumerate(self.chem.species_charge)
               if q == 1 and i >= ngas]
        if not pos:
            raise ValueError("No positive ion species present")
        self.i_1pos_ion = self.species_cc[pos[0] - ngas]
        self.i_phi = reg.add_cc("phi", n_copies=2)
        self.i_electric_fld = reg.add_cc("electric_fld")
        self.i_rhs = reg.add_cc("rhs")
        self.i_tmp = reg.add_cc("tmp", write_out=False)
        # optional power-density output variable (m_streamer.f90:336-341)
        self.compute_power_density = cfg.add_get(
            "compute_power_density", False,
            "Whether to compute the deposited power density")
        self.i_power_density = (reg.add_cc("power_density")
                                if self.compute_power_density else -1)
        # optional output variable of the source factor
        # (m_streamer.f90:438-440)
        self.i_srcfac = -1
        if self.st.source_factor != "none" and cfg.add_get(
                "fixes%write_source_factor", False,
                "Whether to write the source factor to the output"):
            self.i_srcfac = reg.add_cc("srcfac")
        self.i_lsf = reg.add_cc("lsf") if self.st.use_electrode else -1
        self.i_eps = self.i_surf_photon = self.i_surf_sigma = -1
        if self.st.use_dielectric:
            self.i_eps = reg.add_cc("eps")
            reg.set_cc_methods(self.i_eps,
                               lambda iv, d, c, p: (gc.BC_NEUMANN, 0.0),
                               rb=gc.RB_PROLONG_COPY, prolong="zeroth")
            # the surface state, stored at the gas-side box row
            # (solvers/surface.py); moved by the surfaces at refinement
            self.i_surf_photon = reg.add_cc("surf_photon", write_out=False)
            self.i_surf_sigma = reg.add_cc("surf_sigma", n_copies=n_copies,
                                           write_out=False)

        # electron energy density: the chemistry appends it to the species;
        # it is flux variable 2 (m_streamer.f90:244-269)
        self.i_electron_energy = -1
        if self.model.has_energy_equation:
            self.i_electron_energy = self.species_cc[
                self.chem.species_list.index("e_energy") - ngas]

        # face-centered variables: electron flux, energy flux, mobile-ion
        # fluxes, E
        self.fc_flux: List[int] = [reg.add_fc("flux_elec")]
        self.flux_species = [self.i_electron]
        self.flux_charge_sign = [-1]
        if self.model.has_energy_equation:
            self.fc_flux.append(reg.add_fc("flux_energy"))
            self.flux_species.append(self.i_electron_energy)
            self.flux_charge_sign.append(-1)  # the upwind direction only
        for nm in self.td.mobile_ion_names:
            six = self.chem.species_list.index(nm)
            self.flux_species.append(self.species_cc[six - ngas])
            self.flux_charge_sign.append(
                1 if self.chem.species_charge[six] > 0 else -1)
            self.fc_flux.append(reg.add_fc(f"flux_{nm}"))
        self.fc_E = reg.add_fc("electric_fld")

        # ---- tree (refined at setup) and its cached plans; the spans and
        # counters of the run (trace.py), which every object built on the
        # plans reaches as mesh.tracer
        self.tracer = Tracer(groups=WC_KEYS)
        self.tree = Tree(ndim, self.st.box_size, self.st.domain_len,
                         self.st.coarse_grid_size, periodic=self.st.periodic,
                         coord=self.st.coord, r_min=self.st.domain_origin)
        self.layout = None
        if self.shards is None:
            self.mesh = MeshPlans(self.tree, self.device, tracer=self.tracer)
        else:
            # the rank's rows: its own boxes and their halo
            self._cap = pad_capacity_to(capacity(self.tree.highest_id),
                                        self.shards.world)
            self.layout = halo.Layout(self.tree, self.shards, self._cap)
            self.local_tree = halo.LocalTree(self.tree)
            self.local_tree.refresh(self.layout)
            self.mesh = MeshPlans(self.local_tree, self.device,
                                  full=MeshPlans(self.tree, self.device,
                                                 tracer=self.tracer),
                                  tracer=self.tracer)

        # ---- species BCs and methods
        if self.st.species_boundary_condition == "neumann_zero":
            self.bc_species = bc_species_neumann_zero
        elif self.st.species_boundary_condition == "dirichlet_zero":
            self.bc_species = lambda iv, d, c, p: bc_species_dirichlet_zero(
                iv, d, c, p, ndim=ndim)
        else:
            raise ValueError("Unknown species_boundary_condition")
        for iv in self.all_densities:
            reg.set_cc_methods(iv, self.bc_species, rb=gc.RB_INTERP_LIM,
                               prolong=self.st.prolong_density)

        # ---- field solver
        ch_ix, ch_q = self.chem.charged_species
        charged_cc = [self.species_cc[i - ngas] for i in ch_ix]
        self.field = FieldSolver(cfg, self.mesh, self.st, self.i_phi,
                                 self.i_rhs, self.i_electric_fld, self.fc_E,
                                 charged_cc, ch_q)
        if self.st.use_dielectric:
            self.field.mg.eps_data = self._eps_level_data
            self.field.mg.eps_level1 = self._eps_level1
        # user hooks into the field solver (m_field.f90:216-219, 515-519)
        if self.user.potential_bc is not None:
            self.field.user_potential_bc = self.user.potential_bc
        if self.user.field_amplitude is not None:
            self.field.user_field_amplitude = \
                lambda t: self.user.field_amplitude(self, t)
        if self.st.use_electrode and self.field.electrode_type == "user":
            self.field.set_user_lsf(self.user.lsf, self.user.lsf_bc)
        reg.set_cc_methods(self.i_phi, self.field.phi_bc, rb=gc.RB_MG,
                           prolong="linear")
        reg.set_cc_methods(self.i_electric_fld, bc_species_neumann_zero,
                           rb=gc.RB_INTERP, prolong="linear")

        # ---- gas dynamics (the Euler variables and M) or the user's M
        self.gasdyn = None
        self.coupling = None
        self.i_gas_dens = -1
        if self.gas.dynamics:
            self.gasdyn = GasDynamics(self.mesh, self.gas, reg, self.dt_cfg)
            self.i_gas_dens = self.gasdyn.i_gas_dens
        elif self.user.gas_density is not None:
            # M from the user function, on every cell; no methods
            self.i_gas_dens = reg.add_cc("M")
        self.dt_gas_lim = self.dt_cfg.dt_max

        # ---- photoionization (registers photo and the Helmholtz modes)
        self.photoi = Photoionization(cfg, self.mesh, reg, self.gas, self.td,
                                      self.chem, self.i_rhs, self.i_electron,
                                      self.i_electric_fld, self.st)
        if self.photoi.enabled:
            self.photoi.species_cc = self.species_cc[
                self.photoi.species_index - ngas]
            if self.photoi.source_type == "from_species":
                self.photoi.i_excited_cc = self.species_cc[
                    self.chem.species_index(self.photoi.excited_species)
                    - ngas]

        self.init_cond = InitCond(cfg, self.st, reg, self.i_electron,
                                  self.i_1pos_ion)
        for names, attr in ((self.init_cond.seed1_species_names,
                             "seed1_species"),
                            (self.init_cond.background_species_names,
                             "background_species")):
            setattr(self.init_cond, attr,
                    [reg.cc_names.index(nm) for nm in names])
        self.refiner = RefineCriterion(self.refine_cfg, self.tree, self.td,
                                       self.gas, self.init_cond,
                                       self.i_electric_fld, self.i_electron,
                                       self.mesh,
                                       lsf_data=self.field.lsf_data)
        self.output = Output(cfg, reg, ndim)

        # ---- fluid model
        idx = FluidIndices(
            i_electron=self.i_electron,
            i_electric_fld=self.i_electric_fld, fc_E=self.fc_E,
            flux_species=self.flux_species, flux_fc=self.fc_flux,
            flux_charge_sign=np.asarray(self.flux_charge_sign, np.float64),
            all_densities=self.all_densities, species_cc=self.species_cc,
            i_photo=self.photoi.i_photo,
            photoi_species_cc=self.photoi.species_cc,
            i_electron_energy=self.i_electron_energy,
            i_srcfac=self.i_srcfac,
            i_gas_dens=self.i_gas_dens)
        self.fluid = FluidModel(self.mesh, idx, self.chem, self.td, self.gas,
                                self.bc_species, self.dt_cfg, self.st,
                                prolong_limiter=pr.default_prolong_limiter(
                                    ndim))
        self.fluid.field_compute = self.field.compute
        if (self.st.use_electrode or self.st.use_dielectric
                or self.st.plasma_region_enabled):
            self.fluid.mask_provider = self._level_mask
        if self.gasdyn is not None:
            # registers vibrational_energy, the last variable
            self.coupling = Coupling(self.mesh, self.gas, self.gasdyn, idx,
                                     reg, charged_cc, ch_q)
        self.surfaces = None
        self.dielectric = None
        # ---- storage (grown with the mesh, _sync_capacity)
        batch = BoxBatch(self.tree, reg.n_cc, reg.n_fc,
                         capacity(self.tree.highest_id)
                         if self.layout is None else self.layout.n_rows,
                         self.dtype, self.device)
        self.cc, self.fc = batch.cc, batch.fc

        # runtime state
        self.it = 0
        self.out_cnt = 0
        self.global_time = 0.0
        self.global_dt = self.dt_cfg.dt_min
        self.dt_limits = np.full(4, 1e100)
        # the streamer velocity from the displacement of max(E) between
        # outputs (output_log, m_output.f90:628-630)
        self.velocity = 0.0
        self.prev_emax_pos = None
        self.global_rates = np.zeros(self.chem.n_reactions)
        self.global_JdotE = 0.0
        self.global_JdotE_current = 0.0
        self.global_displ_current = 0.0
        self._photoi_prev_time = 0.0
        self.refine_prepulse_time = cfg.add_get(
            "refine_prepulse_time", 1.0e-9,
            "Start refining electrode some time before the next pulse")
        self.electrode_derefine_factor = cfg.add_get(
            "electrode_derefine_factor", 1.0,
            "Multiplication factor to derefine electrode during interpulse")
        restart_from = cfg.add_get(
            "restart_from_file", "UNDEFINED",
            "If set, restart simulation from a previous checkpoint")
        if restart_from != "UNDEFINED":
            if self.st.use_dielectric:
                # the surface state is not in the checkpoint
                # (streamer.f90:138)
                raise ValueError("Restarting not support with dielectric")
            self._sync_capacity()
            read_checkpoint(restart_from, self)
        else:
            self.setup_initial_conditions()

    @property
    def wc(self) -> dict:
        """Host seconds by part of the steps so far (the JAX package's cost
        breakdown, which the command line prints), ``WC_KEYS`` in order:
        the self time of the tracer's spans under each step, by the
        innermost span named after a part (the flux and source of every
        substep, the field solves, the state copies, the outputs, the
        refinement, the photoionization updates), so that the solve and
        the update after a mesh change count under field and photoi and
        nothing counts twice."""
        return {k: self.tracer.group_seconds(k) for k in WC_KEYS}

    # ------------------------------------------------------------ helpers
    def _enter_state_dtype(self):
        """The compiled engine's state dtype from the first step on (JAX
        driver.py:1188-1200, where run() moves the state to the device in
        compiled%dtype): the state is cast, and the mesh's plans drop their
        cached objects, which the run rebuilds with float tables in that
        dtype. The setup and a restart run in float64: a float32 initial
        field solve stalls at its rounding floor on fine meshes (about
        ulp(phi) / dx^2), above the bound of its stagnation test."""
        dtype = self.compiled.state_dtype
        if dtype == self.dtype:
            return
        self.dtype = dtype
        self.cc, self.fc = self.cc.to(dtype), self.fc.to(dtype)
        self.mesh.set_dtype(dtype)
        self.mesh.full.set_dtype(dtype)

    @contextlib.contextmanager
    def _hook_view(self):
        """The simulation as a user hook sees it: in a sharded run ``tree``
        is the rank's LocalTree, whose box ids are the rows of the rank's
        state (a hook that takes box ids gets the rank's own boxes among
        them, in those rows), so that a hook written for one process
        addresses its own boxes; the whole tree again after the hook.
        Nothing changes when unsharded."""
        if self.layout is None:
            yield
            return
        tree, self.tree = self.tree, self.local_tree
        try:
            yield
        finally:
            self.tree = tree

    def _user_flags(self, ids) -> np.ndarray:
        """The user's refinement flags of boxes ``ids`` of the tree,
        ``refine(sim, cc, ids)``; in a sharded run every rank flags its own
        boxes (MeshPlans.map_boxes), gathered on every rank."""
        shape = (0,) + (self.tree.nc,) * self.ndim

        def flags(rows, _sel):
            if len(rows) == 0:
                return np.zeros(shape, np.int64)
            with self._hook_view():
                return np.asarray(self.user.refine(self, self.cc, rows),
                                  np.int64)
        return self.mesh.map_boxes(ids, flags)

    def _rows(self, ids):
        """(tree, rows) to address boxes ``ids`` of the tree in the state:
        the tree and the ids, or in a sharded run the LocalTree and the
        rows that the rank holds among them."""
        ids = np.asarray(ids, np.int64)
        if self.layout is None:
            return self.tree, ids
        rows = self.layout.row_of[ids]
        return self.local_tree, rows[rows >= 0]

    def _eps_level_data(self, lvl: int) -> np.ndarray:
        """Permittivity blocks of a level on the host (the variable-eps
        multigrid operator), of the rows its level arrays hold
        (MeshPlans.level_rows: in a sharded run the rank's own boxes, then
        its halo, which _refresh_eps_halo keeps current)."""
        rows = torch.as_tensor(self.mesh.level_rows(lvl), dtype=torch.int64,
                               device=self.device)
        return self.cc[self.i_eps, rows].cpu().numpy()

    def _eps_level1(self) -> np.ndarray:
        """Permittivity blocks of the whole of level 1 in the tree's order
        on every rank of a sharded run (the dense coarse solve's
        operator)."""
        return self.mesh.map_boxes(
            self.tree.lvl_ids[0], lambda rows, _sel: self.cc[
                self.i_eps, torch.as_tensor(rows, device=self.device)]
            .cpu().numpy())

    def _refresh_eps_halo(self):
        """In a sharded run, the permittivity of the halo rows on every
        level from their owners: only the setup and the prolongation into
        new boxes write it, and the multigrid's level operators read it on
        halo rows without an exchange of their own."""
        if self.i_eps >= 0:
            self.mesh.halo(self.cc, range(1, self.tree.highest_lvl + 1),
                           [self.i_eps])

    def _level_mask(self, lvl: int):
        """Cells of a level's leaves the fluid update may change
        (set_box_mask, m_fluid.f90:469-515): none inside an electrode or a
        dielectric and none outside the plasma region."""
        def make():
            tb = self.mesh.tb(lvl)
            nc, ndim = self.tree.nc, self.ndim
            mask = torch.ones((len(tb.leaves), nc ** ndim), dtype=torch.bool,
                              device=self.device)
            if self.field.lsf_data is not None:
                lsf_cc = self.field.lsf_data.level_data(lvl)["lsf_cc"]
                mask &= torch.as_tensor(lsf_cc[tb.leaves_pos] > 0.0,
                                        device=self.device)
            if self.st.use_dielectric:
                inner = torch.as_tensor(sp.interior_flat(ndim, nc),
                                        dtype=torch.int64, device=self.device)
                eps = self.cc[self.i_eps, tb.d.leaves[:, None],
                              inner[None, :]]
                mask &= (eps - 1.0).abs() <= 1e-10
            if self.st.plasma_region_enabled:
                # cell centres of all leaves: [n, nc^ndim, ndim]
                r0 = self.mesh.tree.box_r_min(np.asarray(tb.leaves))
                dr = self.tree.lvl_dr(lvl)
                axes = np.meshgrid(*[np.arange(nc) + 0.5] * ndim,
                                   indexing="ij")
                off = np.stack([a.ravel() for a in axes], -1) * dr
                coords = r0[:, None, :] + off[None, :, :]
                inside = np.all((coords >= self.st.plasma_region_rmin)
                                & (coords <= self.st.plasma_region_rmax),
                                axis=-1)
                mask &= torch.as_tensor(inside, device=self.device)
            return mask
        return self.mesh.cached(("fluid_mask", lvl), make, (lvl,))

    def _sync_capacity(self):
        """Grow the state so rows 0..highest_id exist (by 30 % and at
        least 64 rows, as the JAX package grows its batch). In a sharded
        run, after every change of the tree: the capacity grows by the
        same rule, padded to a multiple of the ranks, the new layout is
        made and the rows move to their new owners."""
        if self.layout is not None:
            return self._relayout()
        need = self.tree.highest_id
        cap = self.cc.shape[1]
        if need <= cap:
            return
        grow = max(need + 64, int(1.3 * cap))
        cc = self.cc.new_zeros((self.cc.shape[0], grow, self.cc.shape[2]))
        cc[:, :cap] = self.cc
        fc = self.fc.new_zeros(self.fc.shape[:2] + (grow,)
                               + self.fc.shape[3:])
        fc[:, :, :cap] = self.fc
        self.cc, self.fc = cc, fc

    def _relayout(self):
        need, cap = self.tree.highest_id, self._cap
        if need > cap:
            cap = pad_capacity_to(max(need + 64, int(1.3 * cap)),
                                  self.shards.world)
        new = halo.Layout(self.tree, self.shards, cap)
        self.cc = halo.relayout(self.cc, self.layout, new, 1)
        self.fc = halo.relayout(self.fc, self.layout, new, 2)
        new.stats = self.layout.stats
        self.layout, self._cap = new, cap
        self.local_tree.refresh(new)
        if self.is_root:
            print(f" shards: leaf cells per rank "
                  f"{new.leaf_cells(self.tree)}", flush=True)

    @contextlib.contextmanager
    def full_view(self):
        """The state as the writers see it: in float64 (a float32 state is
        cast, as the JAX package moves it to the host, driver.py:1202-1207)
        and, in a sharded run, gathered on rank 0 with the whole tree's
        MeshPlans. Yields True on the rank that holds it (every rank when
        unsharded)."""
        if self.layout is None:
            cc, fc, mesh = self.cc, self.fc, self.mesh
        else:
            cc = halo.gather_to_root(self.cc, self.layout, 1, self._cap)
            fc = halo.gather_to_root(self.fc, self.layout, 2, self._cap)
            mesh = self.mesh.full
            if not self.is_root:
                yield False
                return
        if self.layout is None and cc.dtype == torch.float64:
            yield True
            return
        saved = self.cc, self.fc, self.mesh
        self.cc, self.fc, self.mesh = cc.double(), fc.double(), mesh
        try:
            yield True
        finally:
            self.cc, self.fc, self.mesh = saved

    def _set_initial_values(self, ids):
        """The level set, the user's gas density, the initial conditions,
        the initial gas state and the user hook on boxes ``ids``; no
        density inside an electrode."""
        self._fill_lsf(ids)
        self._fill_user_gas_density(ids)
        tree, rows = self._rows(ids)
        self.cc = self.init_cond.apply(self.cc, tree, rows)
        self._init_gas_state(ids)
        if self.user.initial_conditions is not None:
            ids = np.asarray(ids, np.int64)
            if self.layout is not None:
                ids = self.layout.own_rows(ids)[1]
            if len(ids):
                with self._hook_view():
                    self.user.initial_conditions(self, ids)
        elif self.st.use_dielectric:
            raise ValueError(
                "use_dielectric requires user initial conditions")
        self._zero_inside_electrode(ids)
        self._refresh_eps_halo()

    # ---------------------------------------------------------------- gas
    def _fill_user_gas_density(self, ids):
        """Fill M from the user's gas density on every cell of boxes
        ``ids``, the ghost layer included
        (set_gas_density_from_user_function, streamer.f90:672-681)."""
        if self.gasdyn is not None or self.user.gas_density is None \
                or len(ids) == 0:
            return
        tree, rows = self._rows(ids)
        if len(rows) == 0:
            return
        coords = tree.boxes_cell_coords(rows).reshape(len(rows), -1,
                                                      self.ndim)
        dens = np.asarray(self.user.gas_density(self, coords))
        self.cc[self.i_gas_dens, torch.as_tensor(
            rows, device=self.device)] = torch.as_tensor(
                dens.reshape(len(rows), -1), dtype=self.dtype,
                device=self.device)

    def _init_gas_state(self, ids):
        """The initial Euler state: the configured density and pressure at
        rest (init_cond_set_box, m_init_cond.f90:245-258)."""
        if self.gasdyn is None or len(ids) == 0:
            return
        gd, gas = self.gasdyn, self.gas
        ids = torch.as_tensor(self._rows(ids)[1], device=self.device)
        N = gas.number_density
        self.cc[gd.i_gas_dens, ids] = N
        self.cc[gd.gas_vars[gd.i_rho], ids] = N * gas.molecular_weight
        for m in gd.i_mom:
            self.cc[gd.gas_vars[m], ids] = 0.0
        self.cc[gd.gas_vars[gd.i_e], ids] = (
            gas.pressure * 1e5 / (gas.euler_gamma - 1.0))

    def _gc_simple(self, cc, ivs):
        """Ghost cells of variables ``ivs`` on every level, with their
        registered methods."""
        for lvl in range(1, self.tree.highest_lvl + 1):
            plan = self.mesh.gc(lvl)
            for iv in ivs:
                m = self.registry.methods[iv]
                cc = gc.fill_ghosts_lvl(cc, plan, [iv], m["rb"], m["bc"], {})
        return cc

    def _advance_gas(self, dt: float, time: float, params) -> float:
        """af_advance on the Euler variables with the run's integrator
        (streamer.f90:330-333); returns the gas dt limit of the last
        substep."""
        def substep(cc, fc, dt_s, dt_lim, time_s, s_deriv, s_prev, w_prev,
                    s_out, i_step, n_steps, params_s):
            cc, fc, dt_lim = self.gasdyn.forward_euler(
                cc, fc, dt_s, dt_lim, time_s, s_deriv, s_prev, w_prev,
                s_out, i_step, n_steps, params_s)
            return cc, fc, dt_lim, {}

        self.cc, self.fc, dt_lim, _, _ = adv.advance(
            self.cc, self.fc, dt, time, self.dt_cfg.integrator, substep,
            params)
        return float(dt_lim)

    def _gas_step(self, dt: float, params):
        """After an accepted step and its field solve (streamer.f90:
        325-336): the plasma's heating and force on the gas, the gas
        advance from the step's start time, and M from the new density."""
        self.cc = self.coupling.add_fluid_source(self.cc, self.fc, dt)
        self.dt_gas_lim = self._advance_gas(dt, self.global_time, params)
        self.cc = self.coupling.update_gas_density(self.cc, self._gc_simple)

    # ---------------------------------------------------------- electrode
    def _fill_lsf(self, ids):
        """Evaluate the level-set function on boxes (funcval variable,
        set_lsf_box in m_field.f90): all cells incl. one ghost layer."""
        if self.field.lsf_data is None or len(ids) == 0:
            return
        tree, rows = self._rows(ids)
        if len(rows) == 0:
            return
        lsf = self.field.lsf_data.lsf(
            tree.boxes_cell_coords(rows).reshape(-1, self.ndim))
        self.cc[self.i_lsf, torch.as_tensor(rows, device=self.device)] = \
            torch.as_tensor(lsf.reshape(len(rows), -1), dtype=self.dtype,
                            device=self.device)

    def _zero_inside_electrode(self, ids):
        """Zero all densities where lsf <= 0 (init_cond_set_box,
        m_init_cond.f90:283-287)."""
        if self.i_lsf < 0 or len(ids) == 0:
            return
        ids = torch.as_tensor(self._rows(ids)[1], device=self.device)
        inside = self.cc[self.i_lsf, ids] <= 0.0
        for iv in self.all_densities:
            self.cc[iv, ids] = torch.where(inside, 0.0, self.cc[iv, ids])

    def _electrode_tables(self, lvl: int):
        """Device tables of a level's boxes that hold the electrode
        boundary, from their level-set values: the ids, the cells inside,
        per direction the neighbor cells outside, their count (at least 1)
        and the inside cells with a neighbor outside; None where there is
        no such box."""
        def make():
            data = self.field.lsf_data.level_data(lvl)
            # the level's own boxes (a sharded run's halo comes after)
            sel = np.nonzero(data["has_bnd"][:data["n_own"]])[0]
            if len(sel) == 0:
                return None
            nc, ndim = self.tree.nc, self.ndim
            boxes = torch.as_tensor(data["ids"][sel], dtype=torch.int64,
                                    device=self.device)
            lsf_b = ro.cc_rows(self.cc, self.i_lsf, boxes, nc, ndim)
            inside = lsf_b[ro.interior(nc, ndim)] < 0
            shifts, out_nb = [], []
            for d in range(ndim):
                for delta in (-1, 1):
                    sl = [slice(1, nc + 1)] * ndim
                    sl[d] = slice(1 + delta, nc + 1 + delta)
                    shifts.append((slice(None),) + tuple(sl))
                    out_nb.append(lsf_b[shifts[-1]] > 0)
            den = sum(m.to(self.dtype) for m in out_nb)
            return {"boxes": boxes, "inside": inside, "shifts": shifts,
                    "out_nb": out_nb, "den": torch.clamp(den, min=1.0),
                    "at_bnd": inside & (den > 0)}
        return self.mesh.cached(("electrode_bc", lvl), make, (lvl,))

    def _set_electrode_densities(self):
        """Species boundary conditions at the electrode
        (electrode_species_bc, streamer.f90:520-569): zero densities inside,
        and for Neumann species BCs set the electron density in boundary
        cells to the average of the neighbors outside the electrode, with
        the first positive ion following it there."""
        nc, ndim = self.tree.nc, self.ndim
        inner = ro.interior(nc, ndim)
        neumann = self.st.species_boundary_condition == "neumann_zero"
        for lvl in range(1, self.tree.highest_lvl + 1):
            tab = self._electrode_tables(lvl)
            if tab is None:
                continue
            boxes, n = tab["boxes"], len(tab["boxes"])
            for iv in self.all_densities:
                B = ro.cc_rows(self.cc, iv, boxes, nc, ndim)
                B[inner] = torch.where(tab["inside"], 0.0, B[inner])
                self.cc[iv, boxes] = B.reshape(n, -1)
            if not neumann:
                continue
            ne = ro.cc_rows(self.cc, self.i_electron, boxes, nc, ndim)
            num = 0.0
            for sl, out_nb in zip(tab["shifts"], tab["out_nb"]):
                num = num + torch.where(out_nb, ne[sl], 0.0)
            ne_new = torch.where(tab["at_bnd"], num / tab["den"], ne[inner])
            ne[inner] = ne_new
            self.cc[self.i_electron, boxes] = ne.reshape(n, -1)
            ni = ro.cc_rows(self.cc, self.i_1pos_ion, boxes, nc, ndim)
            ni[inner] = torch.where(tab["at_bnd"], ne_new, ni[inner])
            self.cc[self.i_1pos_ion, boxes] = ni.reshape(n, -1)

    # ------------------------------------------------- initial conditions
    def setup_initial_conditions(self):
        """set_initial_conditions (streamer.f90:460-519): the mesh refined
        up to refine_max_dx, initial densities, then up to 100 passes of a
        field solve and a refinement with initial values on new boxes."""
        t = self.tree
        lvl = 1
        while np.any(t.lvl_dr(lvl) > self.refine_cfg.max_dx) and lvl < 29:
            lvl += 1
        t.refine_up_to_lvl(lvl)
        self._sync_capacity()
        allids = np.concatenate([np.asarray(i) for i in t.lvl_ids])
        self._set_initial_values(allids)
        if self.st.use_dielectric:
            self._init_surfaces()

        for _ in range(100):
            self.cc, self.fc = self.field.compute(self.cc, self.fc, 0, 0.0,
                                                  False)
            info = self.adjust_refinement()
            if info.n_add == 0:
                break
            self._set_initial_values(np.asarray(info.added, np.int64))
        with self.full_view() as root:
            if root:
                self.output.initial_summary(self)
        self.output_write(0)

    def _init_surfaces(self):
        """The surfaces on the permittivity jumps (surface_initialize) and
        the dielectric physics on them."""
        n_states = self.dt_cfg.num_steps
        # the median permittivity of every box (each rank its own)
        ids = np.nonzero(self.tree.in_use[:self.tree.highest_id])[0]
        eps = np.zeros((self.tree.highest_id, 1))
        eps[ids, 0] = self.mesh.map_boxes(ids, lambda rows, _sel: np.median(
            self.cc[self.i_eps, torch.as_tensor(rows, device=self.device)]
            .cpu().numpy(), axis=1))
        self.surfaces = Surfaces(self.tree, eps, self.i_surf_photon,
                                 self.i_surf_sigma, n_states + 1,
                                 mesh_fn=lambda: self.mesh)
        # full charges of the flux species and the positive-ion fluxes
        ngas = self.chem.n_gas_species
        charges = [self.chem.species_charge[ngas + self.species_cc.index(iv)]
                   for iv in self.flux_species]
        pos_ion_fc = [f for f, q in zip(self.fc_flux, charges) if q > 0]
        self.dielectric = Dielectric(self.cfg, self.surfaces, self.fluid.idx,
                                     self.i_eps, charges, pos_ion_fc)
        self.field.surfaces = self.surfaces
        self.fluid.dielectric = self.dielectric
        if self.photoi.mc is not None:
            self.photoi.mc.dielectric = self.dielectric

    # ---------------------------------------------------- refinement step
    def adjust_refinement(self):
        """af_adjust_refinement and the data movement for new and removed
        boxes: the surfaces follow the mesh, the state grows, and every
        variable with methods is prolonged into the new boxes and
        ghost-filled, level by level. The span ``epoch`` holds
        ``epoch.flags`` (each call of the criterion, its summary per box and
        the read of it included), ``epoch.consistency`` and ``epoch.apply``
        (the two phases of ``Tree.adjust_refinement``), ``epoch.capacity``,
        ``epoch.prolong`` and ``epoch.eps_halo``."""
        tr = self.tracer
        with tr.span("epoch"):
            self.refiner.time = self.global_time
            links = (self.surfaces.refinement_links()
                     if self.surfaces is not None else None)
            buffer = self.refine_cfg.buffer_width
            if self.user.refine is not None:
                # the user's criterion replaces the default one, called
                # with the documented signature refine(sim, cc, ids)
                def criterion(ids):
                    return box_flag_summary(self._user_flags(ids), buffer)
            else:
                def criterion(ids):
                    return self.refiner.box_summary(self.cc, ids, buffer)

            def summary_fn(ids):
                with tr.span("epoch.flags"):
                    return criterion(ids)
            # Tree.adjust_refinement's two phases, each in its span
            with tr.span("epoch.consistency"):
                flags = self.tree._consistent_ref_flags(summary_fn, buffer,
                                                        links)
            with tr.span("epoch.apply"):
                info = self.tree._apply_flags(flags)
            tr.count("epochs")
            if info.n_add == 0 and info.n_rm == 0:
                return info
            tr.count("mesh_changes")
            gathered = (self.surfaces.gather_state(self.cc)
                        if self.surfaces is not None else None)
            with tr.span("epoch.capacity"):
                self._sync_capacity()
            if self.surfaces is not None:
                self.cc = self.surfaces.update_after_refinement(
                    self.cc, info, gathered)
            params = {"voltage": self.field.current_voltage}
            methods = self.registry.methods
            with tr.span("epoch.prolong"):
                for lvl in sorted(info.added_per_lvl):
                    self._fill_lsf(info.added_per_lvl[lvl])
                    self._fill_user_gas_density(info.added_per_lvl[lvl])
                    plan = self.mesh.prolong_plan(lvl,
                                                  info.added_per_lvl[lvl])
                    for iv in self.registry.auto_vars:
                        pr.prolong(self.cc, plan, [iv],
                                   methods[iv]["prolong"])
                    gplan = self.mesh.gc(lvl)
                    for iv in self.registry.auto_vars:
                        gc.fill_ghosts_lvl(self.cc, gplan, [iv],
                                           methods[iv]["rb"],
                                           methods[iv]["bc"], params)
            with tr.span("epoch.eps_halo"):
                self._refresh_eps_halo()
            return info

    def _set_power_density(self):
        """J.E deposited per cell on the leaves (set_power_density_box,
        ``m_output.f90:940-965``): the electron flux times the field on
        the faces, averaged to the cell centres, on the device."""
        t = self.tree
        nc, ndim = t.nc, self.ndim
        for lvl in range(1, t.highest_lvl + 1):
            tb = self.mesh.tb(lvl)
            if len(tb.leaves) == 0:
                continue
            leaves = tb.d.leaves[:, None]
            n = len(tb.leaves)
            acc = 0.0
            for d in range(ndim):
                faxes = [np.arange(0, nc + 1) if k == d else np.arange(0, nc)
                         for k in range(ndim)]
                fidx = torch.as_tensor(sp.fc_flat(ndim, nc, *faxes),
                                       dtype=torch.int64,
                                       device=self.device)[None, :]
                shp = (n,) + tuple(nc + 1 if k == d else nc
                                   for k in range(ndim))
                prod = (self.fc[self.fc_flux[0], d, leaves, fidx]
                        * self.fc[self.fc_E, d, leaves, fidx]).reshape(shp)
                lo = tuple(slice(0, nc) if k == d else slice(None)
                           for k in range(ndim))
                hi = tuple(slice(1, nc + 1) if k == d else slice(None)
                           for k in range(ndim))
                acc = acc + 0.5 * (prod[(slice(None),) + lo]
                                   + prod[(slice(None),) + hi]
                                   ).reshape(n, -1)
            ro.cc_set_interior(self.cc, self.i_power_density, tb.d.leaves,
                               acc * uc.elec_charge, nc, ndim)

    def output_write(self, out_cnt: int, wc_time: float = 0.0):
        """The writers of one output (output_write, m_output.f90:331-410),
        in the JAX package's order: the power density, the regression log,
        the VTK grid, the checkpoint, the text log (from the second output
        on, after the velocity from the displacement of max(E)), the
        uniform-grid npz, the grid file, the chemistry files, the field
        maxima, the plane, the line and the cross sections."""
        if self.compute_power_density:
            self._set_power_density()
        with self.full_view() as root:
            if root:
                self._write_outputs(out_cnt, wc_time)

    def _write_outputs(self, out_cnt: int, wc_time: float):
        out = self.output
        if out.regression_test:
            out.regression_log(self, out_cnt)
        if out.write_vtk_files:
            write_vtk(f"{out.name}_{out_cnt:06d}.vtk", self, out_cnt,
                      self.global_time)
        if out.datfile_write and out_cnt % out.datfile_per_outputs == 0:
            # ".dat.npz": np.savez appends ".npz" to other suffixes
            write_checkpoint(f"{out.name}_{out_cnt:06d}.dat.npz", self)
        if out.write_log and out_cnt > 0:
            _emax, pos = red.tree_max_cc(self.cc, self.mesh,
                                         self.i_electric_fld)
            if self.prev_emax_pos is not None:
                self.velocity = float(np.linalg.norm(pos - self.prev_emax_pos)
                                      / out.dt)
            self.prev_emax_pos = pos
            if self.user.log_subroutine is not None:
                # a user log writer replaces the default one
                self.user.log_subroutine(self, out_cnt)
            else:
                out.log(self, out_cnt, wc_time)
        if out.npz_write:
            out.write_npz(self, out_cnt)
        if out.silo_write and out_cnt % out.silo_per_outputs == 0:
            out.write_grid(self, out_cnt)
        out.chemical_rates(self)
        out.chemical_amounts(self)
        if out.field_maxima_write:
            out.write_fld_maxima(self, out_cnt)
        if out.plane_write and self.ndim > 1:
            out.write_plane(self, out_cnt)
        if out.lineout_write:
            out.write_line(self, out_cnt)
        if out.cross_write and self.ndim == 2 and self.tree.coord == "cyl":
            out.write_cross(self, out_cnt)

    def restrict_and_gc_densities(self):
        """Restrict + ghost-fill all densities (streamer.f90:383-386)."""
        self.cc = pr.restrict_tree(self.cc, self.mesh.pr_all(),
                                   self.all_densities)
        for lvl in range(1, self.tree.highest_lvl + 1):
            gc.fill_ghosts_lvl(self.cc, self.mesh.gc(lvl), self.all_densities,
                               gc.RB_INTERP_LIM, self.bc_species)

    def _photoi_set_src(self, time: float):
        """The photoionization source for the state at ``time``
        (streamer.f90:236-242)."""
        self.cc = self.photoi.set_src(
            self.cc, time - self._photoi_prev_time,
            {"voltage": self.field.current_voltage})
        self._photoi_prev_time = time

    # -------------------------------------------------------- main loop
    def _substep(self, cc, fc, dt, dt_lim, time, s_deriv, s_prev, w_prev,
                 s_out, i_step, n_steps, params):
        """One forward-Euler substep of the fluid, the tracer's span
        ``substep`` (the field solve of a later substep nested in it)."""
        self.cc, self.fc = cc, fc
        with self.tracer.span("substep"):
            return self.fluid.forward_euler(cc, fc, dt, dt_lim, time,
                                            s_deriv, s_prev, w_prev, s_out,
                                            i_step, n_steps, params)

    def run(self, end_time: Optional[float] = None,
            max_steps: Optional[int] = None):
        """The main time loop (streamer.f90:177-415). Each step is the
        tracer's span ``step`` (after the per-iteration user hook), holding
        ``photoi``, ``copy``, the substeps (``substep``, physics/fluid.py),
        ``field``, ``output`` and ``refine`` (``restrict``, then ``epoch``,
        then the field solve and the photoionization update after a mesh
        change); the blocking reads of the step are ``host_read``s."""
        self._enter_state_dtype()
        tr = self.tracer
        st = self.st
        end_time = end_time if end_time is not None else st.end_time
        n_states = self.dt_cfg.num_steps
        dt = self.global_dt
        time = self.global_time
        out_cnt = self.out_cnt
        time_last_output = time
        t_start = _time.perf_counter()
        time_last_print = -1e10
        field_energy_prev = self.field.compute_energy(self.cc)
        field_energy_prev_time = time
        fraction_steps_rejected = 0.0
        n_steps_rejected = 0

        while True:
            self.it += 1
            tr.step = self.it
            if time >= end_time:
                break
            if max_steps is not None and self.it > max_steps:
                break
            wc_time = _time.perf_counter() - t_start
            if wc_time - time_last_print > self.output.status_delay:
                if self.is_root:
                    self.output.status(self, wc_time)
                time_last_print = wc_time

            # per-iteration user hook (streamer.f90:181-183)
            if self.user.generic is not None:
                with self._hook_view():
                    self.user.generic(self, time)

            with tr.span("step"):
                # pulse-train bookkeeping (streamer.f90:216-234)
                time_until_next_pulse = (
                    self.field.field_pulse_period
                    - np.mod(time, self.field.field_pulse_period))
                self.field.set_voltage(time)
                if (abs(self.field.current_voltage) > 0.0
                        or time_until_next_pulse < self.refine_prepulse_time):
                    current_output_dt = self.output.dt
                    self.refiner.current_electrode_dx = \
                        self.refine_cfg.electrode_dx
                else:
                    current_output_dt = (self.output.dt
                                         * self.output.dt_factor_pulse_off)
                    self.refiner.current_electrode_dx = (
                        self.electrode_derefine_factor
                        * self.refine_cfg.electrode_dx)

                write_out = (time + dt >= time_last_output + current_output_dt)
                if write_out:
                    dt = max(0.0, time_last_output + current_output_dt - time)

                # make sure to capture the start of the next pulse
                start_of_new_pulse = dt >= time_until_next_pulse
                if start_of_new_pulse:
                    dt = max(time_until_next_pulse, self.dt_cfg.dt_min)

                # photoionization update (streamer.f90:236-242)
                if (self.photoi.enabled
                        and self.it % self.photoi.per_steps == 0):
                    self._photoi_set_src(time)

                if self.st.use_electrode:
                    self._set_electrode_densities()

                # attempt loop with state copy/rejection
                # (streamer.f90:251-288)
                params = {"voltage": self.field.current_voltage}
                dt_lim = uc.huge_real
                step_accepted = False
                for attempt in range(MAX_ATTEMPTS_PER_TIME_STEP):
                    with tr.span("copy"):
                        self._copy_state(n_states)
                    cc, fc, dt_lim_step, time_new, diag = adv.advance(
                        self.cc, self.fc, dt, time, self.dt_cfg.integrator,
                        self._substep, params)
                    self.cc, self.fc = cc, fc
                    dt_lim_step = tr.host_read(dt_lim_step, "dt_lim_step")
                    dt_lim = min(dt_lim, dt_lim_step)
                    if dt <= dt_lim_step:
                        step_accepted = True
                        time = time_new
                        break
                    n_steps_rejected += 1
                    tr.count("steps_rejected")
                    if self.is_root:
                        print(f"{self.it} Step rejected "
                              f"(#{n_steps_rejected}) "
                              f"(dt, dt_lim) = {dt:.4E} {dt_lim:.4E}")
                    dt = self.dt_cfg.safety_factor * dt_lim_step
                    time = self.global_time
                    write_out = False
                    self._restore_state(n_states, params)
                fraction_steps_rejected = 0.99 * fraction_steps_rejected
                if attempt > 0:
                    fraction_steps_rejected += 0.01
                if not step_accepted:
                    raise RuntimeError("All time steps were rejected")
                tr.sample("dt", dt)

                # global rate accounting
                if self.chem.n_reactions:
                    self.global_rates = (self.global_rates + tr.host_read(
                        diag["rates"].to(torch.float64), "rates", to_numpy)
                        * dt)
                jdote = tr.host_read(diag["JdotE"], "JdotE")
                self.global_JdotE += jdote * dt

                # electric current (Sato) every N steps
                # (streamer.f90:296-317)
                if self.it % st.current_update_per_steps == 0:
                    fe = self.field.compute_energy(self.cc)
                    d_fe = ((fe - field_energy_prev)
                            / max(time - field_energy_prev_time, 1e-300))
                    field_energy_prev, field_energy_prev_time = fe, time
                    if abs(self.field.current_voltage) > 0:
                        self.global_JdotE_current = (
                            jdote / self.field.current_voltage)
                        self.global_displ_current = (
                            d_fe / self.field.current_voltage)

                # field for the latest state
                self.cc, self.fc = self.field.compute(self.cc, self.fc, 0,
                                                      time, True)

                # gas dynamics advance (streamer.f90:325-336)
                if self.gasdyn is not None:
                    self._gas_step(dt, params)

                # new time step (streamer.f90:338-343)
                tmp = self.dt_cfg.max_growth_factor
                if fraction_steps_rejected > 0.1:
                    tmp = 1.0
                dt = min(tmp * self.global_dt,
                         self.dt_cfg.safety_factor
                         * min(dt_lim, self.dt_gas_lim))
                if start_of_new_pulse:
                    # start a new pulse with a small time step
                    dt = self.dt_cfg.dt_min
                    if self.user.new_pulse_conditions is not None:
                        with self._hook_view():
                            self.user.new_pulse_conditions(self)
                self.global_dt = dt
                self.global_time = time
                # float64 on the host (JAX driver.py:1957)
                self.dt_limits = tr.host_read(
                    diag["dt_limits"].to(torch.float64), "dt_limits",
                    to_numpy)

                if self.global_dt < self.dt_cfg.dt_min:
                    if self.is_root:
                        self.output.status(self, _time.perf_counter()
                                           - t_start)
                    raise RuntimeError(f"dt too small: {self.global_dt}")

                if write_out:
                    with tr.span("output"):
                        out_cnt += 1
                        self.out_cnt = out_cnt
                        time_last_output = self.global_time
                        self.output_write(out_cnt,
                                          _time.perf_counter() - t_start)

                # refinement every refine_per_steps (streamer.f90:380-411)
                if self.it % self.refine_cfg.per_steps == 0:
                    with tr.span("refine"):
                        self._refine_step(time)

        if self.is_root:
            self.output.status(self, _time.perf_counter() - t_start)
        return out_cnt

    def _refine_step(self, time: float):
        """A refinement epoch of the main loop: the densities (and the
        gas) restricted and ghost-filled (span ``restrict``), the epoch,
        and after a change of the mesh the field and the photoionization
        source anew."""
        with self.tracer.span("restrict"):
            self.restrict_and_gc_densities()
            if self.gasdyn is not None:
                self.cc = pr.restrict_tree(self.cc, self.mesh.pr_all(),
                                           self.gasdyn.gas_vars)
                self.cc = self._gc_simple(self.cc, self.gasdyn.gas_vars)
        info = self.adjust_refinement()
        if info.n_add > 0 or info.n_rm > 0:
            self.cc, self.fc = self.field.compute(self.cc, self.fc, 0, time,
                                                  True)
            if self.photoi.enabled:
                self._photoi_set_src(time)

    def _time_state_vars(self) -> List[int]:
        """Variables with time-state copies: the densities and, with
        dielectrics, the surface charge."""
        surf = [self.i_surf_sigma] if self.surfaces is not None else []
        return self.all_densities + surf

    def _copy_state(self, n_states: int):
        """copy_current_state (streamer.f90:571-583)."""
        for iv in self._time_state_vars():
            self.cc[iv + n_states] = self.cc[iv]
        self.cc[self.i_phi + 1] = self.cc[self.i_phi]

    def _restore_state(self, n_states: int, params):
        """restore_previous_state (streamer.f90:586-599)."""
        for iv in self._time_state_vars():
            self.cc[iv] = self.cc[iv + n_states]
        self.cc[self.i_phi] = self.cc[self.i_phi + 1]
        self.cc, self.fc = self.field.from_potential(
            self.cc, self.fc, self.field.solve_params(params))
