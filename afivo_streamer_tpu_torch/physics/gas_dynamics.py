"""Compressible gas dynamics (the Euler equations) coupled to the plasma.

Port of the JAX package's ``physics/gas_dynamics.py``, which re-implements
the reference's dynamic-gas path: ``src/m_gas.f90`` (gas_forward_euler
``:202-233``, the primitive/conservative conversions ``:292-323``, the
wavespeed ``:325-335``, the Euler fluxes ``:337-372``, the axisymmetric
geometric source ``:237-266`` and the radial-momentum axis condition
``:375-392``) on the MUSCL/Kurganov-Tadmor finite-volume scheme of
``afivo/src/m_af_flux_schemes.f90`` (flux_generic_tree/box ``:439-663``,
reconstruct_lr_1d ``:252-279``, flux_kurganovTadmor_1d ``:306-318``) with
the van Leer limiter.

The state is rho, the momentum per dimension and the energy density E,
each a variable with ``dt_cfg.num_steps`` time-state copies, and the
number density ``M``. Each level pass works on the 2-ghost extended
arrays of the plasma fluid model (physics/fluid.py); every stage is a
batched tensor operation.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core import ghostcell as gc
from ..core import prolong_restrict as pr
from ..core import rowops as ro
from ..ops.limiters import limiter_apply, LIMITER_VANLEER
from .fluid import _lo_hi, consistent_fluxes, consistent_plan, gc2_extend, \
    gc2_plan


def _neumann(iv, d, coords, params):
    return gc.BC_NEUMANN, 0.0


def _bc_radial_momentum(iv, d, coords, params):
    """bc_radial_momentum: antisymmetric on the axis (the low radial
    side), Neumann elsewhere."""
    if d == 0:
        return gc.BC_DIRICHLET, 0.0
    return gc.BC_NEUMANN, 0.0


class GasDynamics:
    def __init__(self, mesh, gas, registry, dt_cfg):
        self.mesh = mesh
        self.tree = mesh.tree
        self.gas = gas
        ndim = self.tree.ndim
        self.n_vars = 2 + ndim  # rho, mom(ndim), E
        self.i_rho = 0
        self.i_mom = list(range(1, 1 + ndim))
        self.i_e = 1 + ndim
        names = (["gas_rho"] + [f"gas_mom_{'xyz'[d]}" for d in range(ndim)]
                 + ["gas_e"])
        self.i_gas_dens = registry.add_cc("M")
        self.gas_vars: List[int] = [
            registry.add_cc(nm, n_copies=dt_cfg.num_steps) for nm in names]
        self.gas_fluxes: List[int] = [registry.add_fc(f"flux_{nm}")
                                      for nm in names]
        self.gamma = gas.euler_gamma
        self.cyl = self.tree.coord == "cyl"
        registry.set_cc_methods(self.i_gas_dens, _neumann, rb=gc.RB_INTERP,
                                prolong="linear")
        for n, iv in enumerate(self.gas_vars):
            bc = _bc_radial_momentum if self.cyl and n == 1 else _neumann
            registry.set_cc_methods(iv, bc, rb=gc.RB_INTERP, prolong="limit")

    def _bc_fn(self, iv, d, coords, params):
        """The boundary condition of a time-state copy: ``iv`` is the
        variable plus ``params["_s_deriv"]``."""
        if self.cyl and iv - params.get("_s_deriv", 0) == self.gas_vars[1]:
            return _bc_radial_momentum(iv, d, coords, params)
        return gc.BC_NEUMANN, 0.0

    # ------------------------------------------------------- conversions
    def to_primitive(self, U):
        """[n, n_vars, ...]: rho, momentum -> velocity, E -> pressure.
        Cells with rho <= 0 divide by 1 instead of giving NaN."""
        rho = U[:, self.i_rho]
        rho_safe = torch.where(rho > 0.0, rho, 1.0)
        vel = [U[:, m] / rho_safe for m in self.i_mom]
        ke = 0.5 * rho * sum(v * v for v in vel)
        p = (self.gamma - 1.0) * (U[:, self.i_e] - ke)
        return torch.stack([rho] + vel + [p], dim=1)

    def to_conservative(self, P):
        rho = P[:, self.i_rho]
        vel = [P[:, m] for m in self.i_mom]
        ke = 0.5 * rho * sum(v * v for v in vel)
        E = P[:, self.i_e] / (self.gamma - 1.0) + ke
        return torch.stack([rho] + [rho * v for v in vel] + [E], dim=1)

    def max_wavespeed(self, P, d: int):
        """Sound speed plus |velocity| along d; rho <= 0 or p < 0 give a
        finite value."""
        rho = P[:, self.i_rho]
        arg = self.gamma * P[:, self.i_e] / torch.where(rho > 0.0, rho, 1.0)
        return torch.sqrt(torch.clamp(arg, min=0.0)) + \
            torch.abs(P[:, self.i_mom[d]])

    def fluxes(self, P, d: int):
        """Euler fluxes along d from primitive face states (get_fluxes)."""
        rho = P[:, self.i_rho]
        vd = P[:, self.i_mom[d]]
        p = P[:, self.i_e]
        out = [rho * vd]
        for k in range(len(self.i_mom)):
            f = rho * P[:, self.i_mom[k]] * vd
            if k == d:
                f = f + p
            out.append(f)
        E = p / (self.gamma - 1.0) + 0.5 * rho * sum(
            P[:, m] ** 2 for m in self.i_mom)
        out.append(vd * (E + p))
        return torch.stack(out, dim=1)

    def _inv_r(self, lvl: int):
        """1 / r of the cell centres of a level's leaves [n, nc]."""
        def make():
            t = self.tree
            tb = self.mesh.tb(lvl)
            r0 = t.box_r_min(tb.leaves)[:, 0]
            off = (np.arange(1, t.nc + 1) - 0.5) * t.lvl_dr(lvl)[0]
            return torch.as_tensor(1.0 / (r0[:, None] + off[None, :]),
                                   device=self.mesh.device)
        return self.mesh.cached(("gas_inv_r", lvl), make, (lvl,))

    # ------------------------------------------------------------- step
    def forward_euler(self, cc, fc, dt: float, dt_lim_state, time: float,
                      s_deriv: int, s_prev: List[int], w_prev: List[float],
                      s_out: int, i_step: int, n_steps: int, params):
        """gas_forward_euler: KT/MUSCL fluxes, fine-to-coarse flux
        matching and the conservative update. Returns (cc, fc, dt_lim)
        with dt_lim a 0-d tensor."""
        t = self.tree
        nc, ndim = t.nc, t.ndim
        dev = dict(dtype=cc.dtype, device=cc.device)
        ivs = [iv + s_deriv for iv in self.gas_vars]
        nv = self.n_vars
        cc = pr.restrict_tree(cc, self.mesh.pr_all(), ivs, use_geometry=True)
        params = dict(params or {})
        params["_s_deriv"] = s_deriv
        inv_max_cfl = torch.full((), 1e-100, **dev)
        limiter = pr.default_prolong_limiter(ndim)

        for lvl in range(1, t.highest_lvl + 1):
            plan = gc2_plan(self.mesh, lvl)
            # the neighbors and coarse boxes of a sharded run's 2-ghost fill
            self.mesh.halo(cc, (lvl - 1, lvl), ivs)
            n = len(plan.leaves)
            if n == 0:
                continue
            leaves = plan.d.leaves
            E, cc = gc2_extend(cc, plan, ivs, self._bc_fn, params, limiter)
            Pb = self.to_primitive(E).reshape((n, nv) + (nc + 4,) * ndim)
            cfl_sum = torch.zeros((n,) + (nc,) * ndim, **dev)

            for d in range(ndim):
                def sl(start):
                    return Pb[(Ellipsis,) + tuple(
                        slice(start, start + nc + 1) if k == d
                        else slice(2, 2 + nc) for k in range(ndim))]

                cL2, cL, cR, cR2 = sl(0), sl(1), sl(2), sl(3)
                slope_f = limiter_apply(cR - cL, cL - cL2, LIMITER_VANLEER)
                slope_g = limiter_apply(cR2 - cR, cR - cL, LIMITER_VANLEER)
                u_l = cL + 0.5 * slope_f
                u_r = cR - 0.5 * slope_g
                w_l = self.max_wavespeed(u_l, d)
                w_r = self.max_wavespeed(u_r, d)
                fl = self.fluxes(u_l, d)
                fr = self.fluxes(u_r, d)
                Ul = self.to_conservative(u_l)
                Ur = self.to_conservative(u_r)
                w = torch.maximum(w_l, w_r)
                flux = 0.5 * (fl + fr - w[:, None] * (Ur - Ul))

                # the reference divides every direction by inv_dr(NDIM)
                # (flux_generic_box, m_af_flux_schemes.f90:613); copied
                w_lo, w_hi = _lo_hi(w, d, nc)
                cfl_sum = cfl_sum + torch.maximum(w_lo, w_hi) / \
                    float(plan.dr[ndim - 1])
                for m, f_iv in enumerate(self.gas_fluxes):
                    ro.fc_set_faces(fc, f_iv, d, leaves, flux[:, m], nc, ndim)
            inv_max_cfl = torch.maximum(inv_max_cfl, cfl_sum.max())

        self.mesh.halo(fc, range(2, t.highest_lvl + 1), self.gas_fluxes,
                       fc=True)
        fc = consistent_fluxes(fc, consistent_plan(self.mesh), self.gas_fluxes)
        # the CFL limit over every rank's leaves (a max: exact)
        inv_max_cfl = self.mesh.reduce(inv_max_cfl, "max")

        # conservative update with the cylindrical geometric source
        for lvl in range(1, t.highest_lvl + 1):
            tb = self.mesh.tb(lvl)
            n = len(tb.leaves)
            if n == 0:
                continue
            leaves = tb.d.leaves
            dr = t.lvl_dr(lvl)
            outs = []
            for iv in self.gas_vars:
                acc = 0.0
                for s, w in zip(s_prev, w_prev):
                    acc = acc + w * ro.cc_get_interior(cc, iv + s, leaves,
                                                       nc, ndim)
                outs.append(acc)
            if self.cyl:
                # p / r on the radial momentum (add_geometric_source)
                U = [ro.cc_get_interior(cc, iv + s_deriv, leaves, nc, ndim)
                     for iv in self.gas_vars]
                rho = U[self.i_rho]
                ke = 0.5 * sum(U[m] ** 2 for m in self.i_mom) \
                    / torch.where(rho > 0.0, rho, 1.0)
                p = (self.gamma - 1.0) * (U[self.i_e] - ke)
                inv_r = self._inv_r(lvl).to(cc.dtype)
                inv_r = inv_r[:, :, None].expand(n, nc, nc ** (ndim - 1))
                outs[1] = outs[1] + dt * p * inv_r.reshape(n, -1)
                rfac_lo = tb.d.rfac_lo.to(cc.dtype)[:, :, None]
                rfac_hi = tb.d.rfac_hi.to(cc.dtype)[:, :, None]
            for m, iv in enumerate(self.gas_vars):
                div = 0.0
                for d in range(ndim):
                    F = ro.fc_get_faces(fc, self.gas_fluxes[m], d, leaves, nc,
                                        ndim)
                    F_lo, F_hi = _lo_hi(F, d, nc)
                    if self.cyl and d == 0:
                        F_lo = F_lo * rfac_lo
                        F_hi = F_hi * rfac_hi
                    div = div + (F_lo - F_hi) / float(dr[d])
                ro.cc_set_interior(cc, iv + s_out, leaves,
                                   outs[m] + dt * div.reshape(n, -1), nc,
                                   ndim)
        return cc, fc, 1.0 / inv_max_cfl
