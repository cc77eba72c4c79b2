"""Adaptive-refinement criterion.

Re-implements the reference's ``src/m_refine.f90`` (default_refinement
``:198-298``): refine where alpha(f E)/f * dx exceeds refine_adx (with
optional effective alpha), derefine below an eighth of that, keep the seed
region refined until refine_init_time, user regions/limits, and dx clamps.

The flags are built on the device as int8, one per cell: the alpha*dx test
on the field and electron density there, then the rules of the box
geometry in the reference's order (the seed, the electrode, the regions,
the limits, the dx clamps). Those rules are decided per box on the host,
vectorized over the boxes, and go to the device in one copy; only the seed
rule is per cell, evaluated on the host for the boxes it selects alone. The
epoch reads back one summary per box (core/tree.box_flag_summary, reduced
on the device), ``cell_flags`` the per-cell flags.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as uc
from ..core.tree import (DO_REF, KEEP_REF, RM_REF, SUMMARY_ANY_DO,
                         SUMMARY_ANY_KEEP, SUMMARY_STRIP0, edge_strip,
                         neighbour_offsets)
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
        #: _strip_weights per buffer width
        self._strips = {}

    #: per-box rules of _box_rules, bits of the uploaded rule word
    _ELECTRODE = 1  # every cell DO_REF
    _REGION = 2  # the centre cell DO_REF
    _DEMOTE = 4  # DO_REF -> KEEP_REF (a limit, or too fine)
    _COARSE = 8  # every cell DO_REF (too coarse), last

    def cell_flags(self, cc, ids) -> np.ndarray:
        """default_refinement for the given boxes; returns flags
        [n, [nc]^ndim] (RM_REF / KEEP_REF / DO_REF, int64)."""
        t = self.tree
        shape = (len(ids),) + (t.nc,) * t.ndim
        return self._evaluate(cc, ids, lambda f: f).astype(
            np.int64).reshape(shape)

    def box_summary(self, cc, ids, ref_buffer: int) -> np.ndarray:
        """default_refinement for the given boxes, read back as one
        summary per box (core/tree.box_flag_summary with ``ref_buffer``,
        reduced on the device)."""
        return self._evaluate(
            cc, ids, lambda f: self._summarize(f, ref_buffer))

    def _evaluate(self, cc, ids, reduce) -> np.ndarray:
        """``reduce`` of the device flags of boxes ``ids``, read to the host
        (in a sharded run every rank its own boxes, MeshPlans.map_boxes)."""
        ids = np.asarray(ids, np.int64)
        max_dx, rules = self._box_rules(ids)

        def rows_fn(rows, sel):
            f = self._flag_rows(cc, ids[sel], rows, max_dx[sel], rules[sel])
            return self.mesh.tracer.host_read(reduce(f), "refine_flags",
                                              to_numpy)
        return self.mesh.map_boxes(ids, rows_fn)

    def _box_rules(self, ids: np.ndarray):
        """max_dx of boxes ``ids`` and their rules of the box geometry as
        _ELECTRODE / _REGION / _DEMOTE / _COARSE bits (m_refine.f90:262-296),
        on the host."""
        t, rs = self.tree, self.rs
        ndim = t.ndim
        drs = t.dr_base[None, :] / 2.0 ** (t.lvl[ids][:, None] - 1.0)
        max_dx, min_dx = drs.max(axis=1), drs.min(axis=1)
        rules = np.zeros(len(ids), np.int64)

        # refine around the electrode (m_refine.f90:262-265)
        if self.lsf_data is not None:
            hit = (self.lsf_data.box_has_boundary(ids)
                   & (max_dx > self.current_electrode_dx))
            rules |= hit * self._ELECTRODE

        # fixed refinement regions, then limits (m_refine.f90:268-289)
        rmin = t.box_r_min(ids)
        rmax = rmin + drs * t.nc
        reg_min = rs.regions_rmin.reshape(-1, ndim)
        reg_max = rs.regions_rmax.reshape(-1, ndim)
        for k in range(min(len(rs.regions_dr), reg_min.shape[0])):
            hit = ((self.time <= rs.regions_tstop[k])
                   & (max_dx > rs.regions_dr[k])
                   & np.all(rmax >= reg_min[k], axis=1)
                   & np.all(rmin <= reg_max[k], axis=1))
            rules |= hit * self._REGION
        lim_min = rs.limits_rmin.reshape(-1, ndim)
        lim_max = rs.limits_rmax.reshape(-1, ndim)
        for k in range(min(len(rs.limits_dr), lim_min.shape[0])):
            hit = ((max_dx < 2 * rs.limits_dr[k])
                   & np.all(rmin >= lim_min[k], axis=1)
                   & np.all(rmax <= lim_max[k], axis=1))
            rules |= hit * self._DEMOTE

        # dx clamps (m_refine.f90:292-296): too fine demotes as a limit
        # does; too coarse makes every cell DO_REF, whatever came before
        too_coarse = max_dx > rs.max_dx
        too_fine = min_dx < 2 * rs.min_dx
        rules |= too_fine * self._DEMOTE
        rules[too_coarse] = self._COARSE
        return max_dx, rules

    def _flag_rows(self, cc, ids: np.ndarray, rows: np.ndarray,
                   max_dx: np.ndarray, rules: np.ndarray) -> torch.Tensor:
        """The flags of boxes ``ids`` (state rows ``rows``) on the device,
        int8 [n, nc^ndim]: the alpha*dx test, the seed rule, then the box
        rules ``rules``."""
        t, rs = self.tree, self.rs
        nc, ndim = t.nc, t.ndim
        dev = cc.device
        # one copy to the device: the rows, max_dx's bits, the rule words
        box = torch.as_tensor(np.stack([
            np.asarray(rows, np.int64), max_dx.view(np.int64), rules]),
            device=dev)
        idx, mdx, rule = box[0], box[1].view(torch.float64), box[2]
        inner = (slice(None),) + (slice(1, nc + 1),) * ndim
        shape = (len(rows),) + (nc + 2,) * ndim
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
        mdx = mdx.to(cc.dtype).reshape((-1,) + (1,) * ndim)
        adx = alpha * mdx
        ref = (adx > rs.adx) & (elec > rs.min_dens)
        rm = (adx < 0.125 * rs.adx) & (mdx < rs.derefine_dx) & ~ref
        del fld, elec, fld_td, alpha, adx
        # DO_REF 1, RM_REF -1, KEEP_REF 0 (the two tests exclude each other)
        f = (ref.to(torch.int8) - rm.to(torch.int8)).reshape(len(rows),
                                                             nc ** ndim)
        self._seed_rule(f, ids, max_dx)

        def has(bit):
            return (rule & bit).bool()[:, None]
        f = torch.where(has(self._ELECTRODE), DO_REF, f)
        centre = int(np.ravel_multi_index((nc // 2,) * ndim, (nc,) * ndim))
        f[:, centre] = torch.where(has(self._REGION)[:, 0], DO_REF,
                                   f[:, centre])
        f = torch.where(has(self._DEMOTE) & (f == DO_REF), KEEP_REF, f)
        return torch.where(has(self._COARSE), DO_REF, f)

    def _seed_rule(self, f: torch.Tensor, ids: np.ndarray,
                   max_dx: np.ndarray) -> None:
        """Refine around the initial seeds (m_refine.f90:248-259): the
        cells of boxes ``ids`` (rows of ``f``) near a seed set to DO_REF,
        in place. Coordinates are built on the host for the boxes the rule
        selects alone; their count adds to ``refine.seed_boxes``."""
        t, rs = self.tree, self.rs
        tr = self.mesh.tracer
        if not (self.time < rs.init_time and self.ic is not None
                and self.ic.n_cond):
            tr.count("refine.seed_boxes", 0)
            return
        widths = [self.ic.seed_width[s] for s in range(self.ic.n_cond)]
        sels = [max_dx > rs.init_fac * w for w in widths]
        pos = np.nonzero(np.logical_or.reduce(sels))[0]
        tr.count("refine.seed_boxes", len(pos))
        if len(pos) == 0:
            return
        nc, ndim = t.nc, t.ndim
        axes = np.stack(np.meshgrid(*[np.arange(nc)] * ndim, indexing="ij"),
                        axis=-1).reshape(-1, ndim)
        hit = np.zeros((len(pos), nc ** ndim), bool)
        for s, (w, sel) in enumerate(zip(widths, sels)):
            sub = sel[pos]
            if not sub.any():
                continue
            b = ids[pos[sub]]
            drs = t.dr_base[None, :] / 2.0 ** (t.lvl[b][:, None] - 1.0)
            coords = (t.box_r_min(b)[:, None, :]
                      + (axes[None] + 0.5) * drs[:, None, :])
            dv, _ = geometry.dist_vec_line(
                coords.reshape(-1, ndim), self.ic.seed_r0[s],
                self.ic.seed_r1[s])
            dist = np.sqrt(np.sum(dv ** 2, axis=-1)).reshape(-1, nc ** ndim)
            hit[sub] |= dist - w < 2 * max_dx[pos[sub]][:, None]
        at = torch.as_tensor(pos, device=f.device)
        f[at] = torch.where(torch.as_tensor(hit, device=f.device), DO_REF,
                            f[at])

    def _summarize(self, f: torch.Tensor, ref_buffer: int) -> torch.Tensor:
        """box_flag_summary of device flags ``f`` [n, nc^ndim], on the
        device (int32): the DO_REF cells of the whole box and of each edge
        strip counted by one product with their 0/1 membership (exact in
        float32 up to 2^24 cells). The membership is copied to the device
        per call, so that nothing of it stays there between epochs."""
        w = torch.as_tensor(self._strip_weights(ref_buffer), device=f.device)
        hit = ((f == DO_REF).to(torch.float32) @ w > 0).to(torch.int32)
        shift = torch.arange(SUMMARY_STRIP0, SUMMARY_STRIP0 + w.shape[1] - 1,
                             dtype=torch.int32, device=f.device)
        keep = (f == KEEP_REF).any(dim=1).to(torch.int32)
        return ((hit[:, 1:] << shift).sum(dim=1, dtype=torch.int32)
                | hit[:, 0] * SUMMARY_ANY_DO | keep * SUMMARY_ANY_KEEP)

    def _strip_weights(self, ref_buffer: int) -> np.ndarray:
        """The columns [every cell, each neighbour's edge strip] as 0/1
        float32 [nc^ndim, 3^ndim], per buffer width, on the host."""
        if ref_buffer not in self._strips:
            nc, ndim = self.tree.nc, self.tree.ndim
            cols = [np.ones((nc,) * ndim, np.float32)]
            for off in neighbour_offsets(ndim):
                m = np.zeros((nc,) * ndim, np.float32)
                m[edge_strip(off, nc, ref_buffer)] = 1.0
                cols.append(m)
            self._strips[ref_buffer] = np.stack(
                [c.reshape(-1) for c in cols], axis=1)
        return self._strips[ref_buffer]
