"""A stiff reaction-diffusion problem advanced with the IMEX integrators.

The reference builds ``imex_euler`` and ``imex_trapezoidal`` from the
forward-Euler callback plus an implicit solver of the user
(``afivo/src/m_af_advance.f90:185-200``); its reaction_diffusion example
solves the stiff diffusion implicitly as a Helmholtz problem per step.
This is the problem of the JAX package's ``tests/test_imex.py``:
u_t = D lap(u) - a u on [0, 1]^2 with zero Dirichlet sides and
u(0) = sin(k x) sin(k y), whose solution is
exp(-(2 D k^2 + a) t) sin(k x) sin(k y). The loss -a u is the explicit
part; the diffusion is the stiff part, applied explicitly with the
substep's ``dt_stiff`` and implicitly by solving
(1 - dt D lap) u = sum(w u_prev), i.e. lap(u) - lambda u = -lambda
sum(w u_prev) with lambda = 1/(dt D), through the package's Multigrid
(``helmholtz_lambda``): FAS FMG cycles from the current state until the
max leaf residual is below 1e-8 of the max leaf rhs, at most 10. On the
card every smoothing half sweep and ghost fill of the solve is a K1-K3
kernel launch (ops/smoother.py). ``ReactionDiffusion(16, 2, "cpu").run(
"imex_trapezoidal", 2e-3, 10)`` gives the relative error against the
solution.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..core import ghostcell as gc
from ..core.batch import BoxBatch
from ..core.levels import MeshPlans
from ..core.tree import Tree
from ..physics import advance as adv
from ..solvers import mg_blocks as mgb
from ..solvers.multigrid import Multigrid

I_U = 0          # 3 time states: 0..2
I_PHI, I_RHS, I_TMP = 3, 4, 5

D = 1.0          # diffusion coefficient (stiff)
A = 5.0          # linear loss rate (non-stiff)
K = np.pi


def bc_zero(iv, d, coords, params):
    return gc.BC_DIRICHLET, 0.0


class ReactionDiffusion:
    """The problem on a uniform mesh: ``coarse`` cells a side at level 1,
    refined to ``level`` (the JAX test: 16 and 2, 32^2 leaf cells), in
    float64 on ``device``. ``fmg_cycles`` lists the FMG cycles of every
    implicit solve."""

    MAX_FMG = 10
    REL_RESIDUAL = 1e-8

    def __init__(self, coarse: int = 16, level: int = 2, device="cuda"):
        self.device = torch.device(device)
        t = Tree(2, 8, [1.0, 1.0], [coarse, coarse])
        t.refine_up_to_lvl(level)
        self.tree = t
        self.mesh = MeshPlans(t, self.device)
        self.nc = t.nc
        self.mgs: Dict[float, Multigrid] = {}
        self.fmg_cycles: List[int] = []
        self.ids = self.mesh.all_ids()
        self.cc = BoxBatch(t, 6, 0, t.highest_id, torch.float64,
                           self.device).cc
        coords = self._coords(np.asarray(self.ids.cpu()))
        self.cc[I_U, self.ids] = torch.as_tensor(
            (np.sin(K * coords[..., 0]) * np.sin(K * coords[..., 1]))
            .reshape(len(coords), -1), device=self.device)
        self.time = 0.0

    def _coords(self, ids) -> np.ndarray:
        """Cell centers of boxes ``ids`` incl. the ghost layer [n, nc+2,
        nc+2, 2]."""
        t = self.tree
        off = np.arange(-1, t.nc + 1) + 0.5
        r0, dr = t.box_r_min(ids), t.box_dr(ids)
        x = r0[:, 0, None] + off[None, :] * dr[:, 0, None]
        y = r0[:, 1, None] + off[None, :] * dr[:, 1, None]
        return np.stack(np.broadcast_arrays(x[:, :, None], y[:, None, :]),
                        -1)

    def _interior(self, iv: int):
        """Interiors of variable ``iv`` on all boxes [n, nc, nc]."""
        nc = self.nc
        return self.cc[iv, self.ids].reshape(-1, nc + 2, nc + 2)[
            :, 1:nc + 1, 1:nc + 1]

    def _set_interior(self, iv: int, vals):
        nc = self.nc
        B = self.cc[iv, self.ids].reshape(-1, nc + 2, nc + 2)
        B[:, 1:nc + 1, 1:nc + 1] = vals
        self.cc[iv, self.ids] = B.reshape(len(self.ids), -1)

    def _fill_ghosts(self, iv: int):
        for lvl in range(1, self.tree.highest_lvl + 1):
            gc.fill_ghosts_lvl(self.cc, self.mesh.gc(lvl), [iv],
                               gc.RB_INTERP, bc_zero, {})

    def _laplacian(self, iv: int):
        """D-free 5-point Laplacian on the interiors of all boxes."""
        nc, t = self.nc, self.tree
        out = []
        for lvl in range(1, t.highest_lvl + 1):
            ids = self.mesh.tb(lvl).d.ids
            dx = float(t.lvl_dr(lvl)[0])
            B = self.cc[iv, ids].reshape(-1, nc + 2, nc + 2)
            out.append((B[:, 2:, 1:-1] + B[:, :-2, 1:-1] + B[:, 1:-1, 2:]
                        + B[:, 1:-1, :-2] - 4.0 * B[:, 1:-1, 1:-1]) / dx**2)
        return torch.cat(out)

    def _weighted(self, s_prev, w_prev):
        acc = 0.0
        for s, w in zip(s_prev, w_prev):
            acc = acc + w * self._interior(I_U + s)
        return acc

    # the two callbacks of physics/advance.advance
    def substep(self, cc, fc, dt_s, dt_lim, time, s_deriv, s_prev, w_prev,
                s_out, i_step, n_steps, params):
        """Forward Euler of the loss with dt and of the diffusion with
        ``params["dt_stiff"]`` (m_af_advance.f90:31, the reference's
        reaction_diffusion step_F)."""
        dt_stiff = params["dt_stiff"]
        acc = self._weighted(s_prev, w_prev)
        du = dt_s * -A * self._interior(I_U + s_deriv)
        if dt_stiff != 0.0:
            self._fill_ghosts(I_U + s_deriv)
            du = du + dt_stiff * D * self._laplacian(I_U + s_deriv)
        self._set_interior(I_U + s_out, acc + du)
        return self.cc, fc, 1.0, {}

    def multigrid(self, lam: float) -> Multigrid:
        if lam not in self.mgs:
            self.mgs[lam] = Multigrid(self.mesh, I_PHI, I_RHS, bc_zero,
                                      helmholtz_lambda=lam)
        return self.mgs[lam]

    def implicit_solver(self, cc, fc, dt_stiff, time, s_prev, w_prev,
                        s_out, params):
        """u(s_out) = sum(w u(s_prev)) + dt_stiff D lap(u(s_out)) as the
        Helmholtz problem lap(phi) - lambda phi = -lambda sum(w u_prev),
        lambda = 1/(dt_stiff D), from u(s_out) as the guess."""
        lam = 1.0 / (dt_stiff * D)
        mg = self.multigrid(lam)
        self._set_interior(I_RHS, -lam * self._weighted(s_prev, w_prev))
        self.cc[I_PHI, self.ids] = self.cc[I_U + s_out, self.ids]
        mg.fill_ghosts_phi(self.cc, {})
        P, R = mgb.gather_levels(mg, self.cc)
        leaves = self.mesh.tb(self.tree.highest_lvl).d.leaves_pos
        rhs_max = float(R[-1][leaves].abs().max())
        for n in range(1, self.MAX_FMG + 1):
            P, R = mgb.fas_fmg_blocks(mg, P, R, {})
            res = float(mgb.max_leaf_residual_blocks(mg, P, R, {}))
            if res < self.REL_RESIDUAL * max(rhs_max, 1e-30):
                break
        self.fmg_cycles.append(n)
        mgb.scatter_levels(mg, self.cc, P, R)
        self.cc[I_U + s_out, self.ids] = self.cc[I_PHI, self.ids]
        return self.cc, fc

    def run(self, integrator: str, dt: float, n_steps: int) -> float:
        """Advance ``n_steps`` steps of ``dt``; returns the max relative
        error on the finest leaves against the solution."""
        for _ in range(n_steps):
            _, _, _, self.time, _ = adv.advance(
                self.cc, None, dt, self.time, integrator, self.substep,
                implicit_solver=self.implicit_solver)
        return self.error()

    def exact(self, ids) -> np.ndarray:
        c = self._coords(ids)[:, 1:-1, 1:-1]
        return (np.sin(K * c[..., 0]) * np.sin(K * c[..., 1])
                * np.exp(-(2 * D * K**2 + A) * self.time))

    def error(self) -> float:
        t = self.tree
        leaves = np.asarray(t.lvl_leaves[t.highest_lvl - 1])
        nc = self.nc
        num = self.cc[I_U, torch.as_tensor(leaves, device=self.device)]
        num = num.reshape(-1, nc + 2, nc + 2)[:, 1:-1, 1:-1].cpu().numpy()
        exact = self.exact(leaves)
        return float(np.max(np.abs(num - exact)) / np.max(np.abs(exact)))

