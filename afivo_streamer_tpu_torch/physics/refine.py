"""Adaptive-refinement criterion.

Re-implements the reference's ``src/m_refine.f90`` (default_refinement
``:198-298``): refine where alpha(f E)/f * dx exceeds refine_adx (with
optional effective alpha), derefine below an eighth of that, keep the seed
region refined until refine_init_time, user regions/limits, and dx clamps.

The alpha*dx test runs on the device (the field and electron density stay
there; only one int8 code per cell comes back to the host); the seed rule,
the electrode rule, the regions and the dx clamps are box-geometry rules
evaluated on the host, vectorized over the boxes.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as uc
from ..core.tree import DO_REF, KEEP_REF, RM_REF
from ..trace import to_numpy
from ..utils import geometry
from .transport_data import TD_ALPHA, TD_ETA


class RefineSettings:
    def __init__(self, cfg, ndim: int = 2):
        self.buffer_width = cfg.add_get(
            "refine_buffer_width", 4,
            "The refinement buffer width in cells (around flagged cells)")
        self.per_steps = cfg.add_get(
            "refine_per_steps", 2,
            "The number of steps after which the mesh is updated")
        self.min_dx = cfg.add_get(
            "refine_min_dx", 1.0e-7,
            "The grid spacing will always be larger than this value (m)")
        self.max_dx = cfg.add_get(
            "refine_max_dx", 1.0e-3,
            "The grid spacing will always be smaller than this value (m)")
        self.adx = cfg.add_get("refine_adx", 1.0,
                               "Refine if alpha*dx is larger than this value")
        self.derefine_dx = cfg.add_get(
            "derefine_dx", 1e-4,
            "Only derefine if grid spacing if smaller than this value")
        self.init_time = cfg.add_get(
            "refine_init_time", 10e-9,
            "Refine around initial conditions up to this time")
        self.init_fac = cfg.add_get(
            "refine_init_fac", 0.25,
            "Refine until dx is smaller than this factor times the seed width")
        self.electrode_dx = cfg.add_get(
            "refine_electrode_dx", 1e99,
            "Ensure grid spacing around electrode is less than this value (m)")
        self.adx_fac = cfg.add_get(
            "refine_adx_fac", 1.0,
            "For refinement, use alpha(f * E)/f, where f is this factor")
        self.cphi = cfg.add_get(
            "refine_cphi", 1e99,
            "Refine if the curvature in phi is larger than this value")
        self.derefine_cphi = cfg.add_get(
            "derefine_cphi", 1e99,
            "Allow derefinement if the curvature in phi is smaller than this")
        self.min_dens = cfg.add_get(
            "refine_min_dens", -1.0e99,
            "Minimum electron density for adding grid refinement")
        self.use_alpha_effective = cfg.add_get(
            "refine_use_alpha_effective", False,
            "Use effective alpha (minus attachment) for refinement")

        def floats(key, default, doc):
            return np.asarray([float(x) for x in cfg.add_get(
                key, default, doc, dynamic=True)])
        self.regions_dr = floats("refine_regions_dr", [1.0e99],
                                 "Refine regions up to this grid spacing (m)")
        self.regions_tstop = floats(
            "refine_regions_tstop", [1.0e99],
            "Refine regions up to this simulation time")
        self.regions_rmin = floats(
            "refine_regions_rmin", [0.0] * ndim,
            "Minimum coordinate of the refinement regions")
        self.regions_rmax = floats(
            "refine_regions_rmax", [0.0] * ndim,
            "Maximum coordinate of the refinement regions")
        self.limits_dr = floats("refine_limits_dr", [1.0e99],
                                "Refine regions at most up to this grid "
                                "spacing")
        self.limits_rmin = floats(
            "refine_limits_rmin", [0.0] * ndim,
            "Minimum coordinate of the refinement limits")
        self.limits_rmax = floats(
            "refine_limits_rmax", [0.0] * ndim,
            "Maximum coordinate of the refinement limits")


class RefineCriterion:
    def __init__(self, settings: RefineSettings, tree, transport, gas,
                 init_cond, i_electric_fld: int, i_electron: int, mesh,
                 lsf_data=None):
        self.rs = settings
        self.tree = tree
        #: the state's MeshPlans (a sharded run's rows)
        self.mesh = mesh
        self.td = transport
        self.gas = gas
        self.ic = init_cond
        self.i_electric_fld = i_electric_fld
        self.i_electron = i_electron
        #: solvers/lsf.LsfData of the electrode, and the spacing its
        #: boundary boxes are refined to (Simulation.run raises it between
        #: voltage pulses)
        self.lsf_data = lsf_data
        self.current_electrode_dx = settings.electrode_dx
        self.time = 0.0

    def _alpha_dx_codes(self, cc, ids: np.ndarray,
                        max_dx: np.ndarray) -> np.ndarray:
        """The alpha*dx codes of boxes ``ids`` (in a sharded run every
        rank evaluates its own boxes, MeshPlans.map_boxes)."""
        return self.mesh.map_boxes(
            ids, lambda rows, sel: self._alpha_dx_rows(cc, rows, max_dx[sel]))

    def _alpha_dx_rows(self, cc, ids: np.ndarray,
                       max_dx: np.ndarray) -> np.ndarray:
        """The alpha*dx rule on the device, on state rows ``ids``: per
        leaf-interior cell 1 to refine, 2 to derefine, 0 to keep (int8,
        to the host)."""
        t, rs = self.tree, self.rs
        nc, ndim = t.nc, t.ndim
        dev = cc.device
        idx = torch.as_tensor(ids, dtype=torch.int64, device=dev)
        inner = (slice(None),) + (slice(1, nc + 1),) * ndim
        shape = (len(ids),) + (nc + 2,) * ndim
        fld = cc[self.i_electric_fld, idx].reshape(shape)[inner]
        elec = cc[self.i_electron, idx].reshape(shape)[inner]
        gas_dens = self.gas.number_density
        fld_td = fld * uc.SI_to_Townsend / gas_dens
        alpha = self.td.tbl.get_col(TD_ALPHA, rs.adx_fac * fld_td)
        if rs.use_alpha_effective:
            alpha = torch.clamp(
                alpha - self.td.tbl.get_col(TD_ETA, rs.adx_fac * fld_td),
                min=0.0)
        alpha = alpha * gas_dens / rs.adx_fac
        mdx = torch.as_tensor(max_dx, dtype=cc.dtype, device=dev).reshape(
            (-1,) + (1,) * ndim)
        adx = alpha * mdx
        ref = (adx > rs.adx) & (elec > rs.min_dens)
        rm = (adx < 0.125 * rs.adx) & (mdx < rs.derefine_dx) & ~ref
        return self.mesh.tracer.host_read(
            ref.to(torch.int8) + 2 * rm.to(torch.int8), "refine_flags",
            to_numpy)

    def cell_flags(self, cc, ids) -> np.ndarray:
        """default_refinement for the given boxes; returns flags
        [n, [nc]^ndim]."""
        t, rs = self.tree, self.rs
        nc, ndim = t.nc, t.ndim
        ids = np.asarray(ids, np.int64)
        n = len(ids)
        shape = (n,) + (nc,) * ndim
        bshape = (n,) + (1,) * ndim
        lvls = t.lvl[ids]
        drs = t.dr_base[None, :] / 2.0 ** (lvls[:, None] - 1.0)  # [n, ndim]
        max_dx, min_dx = drs.max(axis=1), drs.min(axis=1)

        code = self._alpha_dx_codes(cc, ids, max_dx)
        flags = np.full(shape, KEEP_REF, dtype=np.int64)
        flags[code == 1] = DO_REF
        flags[code == 2] = RM_REF

        # refine around the initial seeds (m_refine.f90:248-259)
        if self.time < rs.init_time and self.ic is not None \
                and self.ic.n_cond:
            rmin = t.box_r_min(ids)
            axes = np.stack(np.meshgrid(
                *[np.arange(nc)] * ndim, indexing="ij"),
                axis=-1).reshape(-1, ndim)
            coords = rmin[:, None, :] + (axes[None] + 0.5) * drs[:, None, :]
            for s in range(self.ic.n_cond):
                w = self.ic.seed_width[s]
                sel = max_dx > rs.init_fac * w
                if not sel.any():
                    continue
                dv, _ = geometry.dist_vec_line(
                    coords[sel].reshape(-1, ndim), self.ic.seed_r0[s],
                    self.ic.seed_r1[s])
                dist = np.sqrt(np.sum(dv ** 2, axis=-1)).reshape(
                    (int(sel.sum()),) + (nc,) * ndim)
                flags[sel] = np.where(
                    dist - w < 2 * max_dx[sel].reshape((-1,) + (1,) * ndim),
                    DO_REF, flags[sel])

        # refine around the electrode (m_refine.f90:262-265)
        if self.lsf_data is not None:
            hit = (self.lsf_data.box_has_boundary(ids)
                   & (max_dx > self.current_electrode_dx))
            flags[hit] = DO_REF

        # fixed refinement regions, then limits (m_refine.f90:268-289)
        rmin = t.box_r_min(ids)
        rmax = rmin + drs * nc
        reg_min = rs.regions_rmin.reshape(-1, ndim)
        reg_max = rs.regions_rmax.reshape(-1, ndim)
        center = (slice(None),) + (nc // 2,) * ndim
        for k in range(min(len(rs.regions_dr), reg_min.shape[0])):
            hit = ((self.time <= rs.regions_tstop[k])
                   & (max_dx > rs.regions_dr[k])
                   & np.all(rmax >= reg_min[k], axis=1)
                   & np.all(rmin <= reg_max[k], axis=1))
            flags[center] = np.where(hit, DO_REF, flags[center])
        lim_min = rs.limits_rmin.reshape(-1, ndim)
        lim_max = rs.limits_rmax.reshape(-1, ndim)
        for k in range(min(len(rs.limits_dr), lim_min.shape[0])):
            hit = ((max_dx < 2 * rs.limits_dr[k])
                   & np.all(rmin >= lim_min[k], axis=1)
                   & np.all(rmax <= lim_max[k], axis=1)).reshape(bshape)
            flags = np.where(hit & (flags == DO_REF), KEEP_REF, flags)

        # dx clamps (m_refine.f90:292-296)
        too_coarse = max_dx > rs.max_dx
        too_fine = (min_dx < 2 * rs.min_dx) & ~too_coarse
        flags = np.where(too_coarse.reshape(bshape), DO_REF, flags)
        flags = np.where(too_fine.reshape(bshape) & (flags == DO_REF),
                         KEEP_REF, flags)
        return flags
