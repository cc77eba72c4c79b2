"""Coarse-grid solvers for multigrid level 1.

Replace the reference's HYPRE bridge (``afivo/src/m_coarse_solver.f90``:
the level-1 grid is assembled into a HYPRE StructMatrix and solved with
SMG/PFMG). ``make_coarse_solver`` chooses as the JAX package does: a level-1
grid of up to 32,768 unknowns, which never changes during a run (16 x 16
cells in the 2D slice, 16^3 in the 3D one), is assembled once into a dense
matrix with the boundary conditions eliminated and inverted on the host
(``CoarseSolver``; a solve is then one matrix-vector product on the
device); a larger one with the constant operator is solved by a geometric
multigrid on the uniform grid (``UniformCoarseMG``, the analog of HYPRE
PFMG), in tensor operations on the device.

Supports the constant Laplacian/Helmholtz operator with cylindrical radial
factors, or any per-cell level-1 operator (``level1_op``, a
multigrid.LevelOp such as the variable-permittivity one or that of a level
set): the dense solve must use the fine levels' stencil, or FAS stalls.
The eliminated couplings of a level set's boundary add the
voltage-proportional rhs term f bc_coeff phi_b (hypre_set_matrix /
bc_to_rhs, ``m_coarse_solver.f90:104-194``); the cells inside the
electrode are part of the system.
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional

import numpy as np
import torch

from ..core import spatial as sp
from ..core.rowops import as_value
from ..core.tree import Tree, neighb_dim, neighb_low
from ..core.ghostcell import (BC_DIRICHLET, BC_NEUMANN, BC_CONTINUOUS,
                              BC_DIRICHLET_COPY, bc_to_ghost)
from ..trace import Tracer

_MAX_DENSE = 32768  # beyond this a dense inverse is unreasonable


def make_coarse_solver(tree: Tree, sides_bc: Callable, lam: float, device,
                       level1_op=None, dtype=torch.float64,
                       tracer: Optional[Tracer] = None):
    """The level-1 solver (JAX ``make_coarse_solver``): the dense inverse up
    to 32,768 unknowns or with a per-cell operator, else the uniform-grid
    multigrid, whose reads to the host go through ``tracer``. Its device
    tables are built in float64 and cast to ``dtype``, the state's (JAX
    coarse.py:231, 494)."""
    if int(np.prod(tree.coarse_grid_size)) > _MAX_DENSE and level1_op is None:
        return UniformCoarseMG(tree, sides_bc, lam, device, dtype, tracer)
    return CoarseSolver(tree, sides_bc, lam, device, level1_op, dtype)


def _rows_map(tree: Tree, shape) -> np.ndarray:
    """Row of each level-1 box's interior cells in the uniform grid."""
    ndim, nc = tree.ndim, tree.nc
    ids1 = np.asarray(tree.lvl_ids[0])
    rows_map = np.zeros((len(ids1), nc**ndim), np.int64)
    cell_local = np.stack(np.meshgrid(*[np.arange(nc)] * ndim,
                                      indexing="ij"), -1).reshape(-1, ndim)
    for n, b in enumerate(ids1):
        g = cell_local + tree.ix[b] * nc
        rows_map[n] = np.ravel_multi_index(
            [g[:, k] for k in range(ndim)], shape)
    return rows_map


class CoarseSolver:
    def __init__(self, tree: Tree, sides_bc: Callable, lam: float, device,
                 level1_op=None, dtype=torch.float64):
        self.tree = tree
        self.sides_bc = sides_bc
        ndim, nc = tree.ndim, tree.nc
        cgs = tree.coarse_grid_size  # cells per dim at level 1
        N = int(np.prod(cgs))
        if N > _MAX_DENSE:
            raise NotImplementedError(
                f"coarse grid with {N} unknowns too large for a dense "
                "solve with a per-cell (electrode/eps) level-1 operator; "
                "reduce coarse_grid_size")
        self.shape = tuple(int(x) for x in cgs)
        dr = tree.dr_base
        inv_dr2 = 1.0 / dr**2

        # gather map: rows of each level-1 box's interior cells
        ids1 = np.asarray(tree.lvl_ids[0])
        self.n1 = len(ids1)
        rows_map = _rows_map(tree, self.shape)

        # global per-cell coefficients
        C0 = np.zeros(N)
        CNb = [np.zeros(N) for _ in range(2 * ndim)]
        lsf_rhs = None  # f * bc_coeff per unknown with a level set
        if level1_op is not None:
            shape = (len(ids1), nc ** ndim)
            rows = rows_map.ravel()
            for dst, c in zip([C0] + CNb,
                              [level1_op.c0] + list(level1_op.c_nb)):
                dst[rows] = np.broadcast_to(
                    np.asarray(c).reshape(len(ids1), -1) if np.ndim(c)
                    else np.full(shape, c), shape).ravel()
            if level1_op.f is not None:
                lsf_rhs = np.zeros(N)
                lsf_rhs[rows] = (level1_op.f * level1_op.bc_coeff).ravel()
        for idx in (() if level1_op is not None else
                    itertools.product(*[range(s) for s in self.shape])):
            r = int(np.ravel_multi_index(idx, self.shape))
            cs = [inv_dr2[d // 2] for d in range(2 * ndim)]
            if tree.coord == "cyl":
                rr = tree.r_base[0] + (idx[0] + 0.5) * dr[0]
                cs[0] *= (rr - 0.5 * dr[0]) / rr
                cs[1] *= (rr + 0.5 * dr[0]) / rr
            C0[r] = -float(np.sum(cs)) - lam
            for d in range(2 * ndim):
                CNb[d][r] = cs[d]

        def row(idx):
            return int(np.ravel_multi_index(idx, self.shape))

        A = np.zeros((N, N))
        self.bc_rows, self.bc_coeff, self.bc_coords = [], [], []
        probe_params = {"voltage": 0.0}
        bdry_cells = [[] for _ in range(2 * ndim)]
        for idx in itertools.product(*[range(s) for s in self.shape]):
            r = row(idx)
            A[r, r] += C0[r]
            for d in range(2 * ndim):
                dim = d // 2
                step = -1 if d % 2 == 0 else 1
                nb = list(idx)
                nb[dim] += step
                if 0 <= nb[dim] < self.shape[dim]:
                    A[r, row(nb)] += CNb[d][r]
                elif tree.periodic[dim]:
                    nb[dim] %= self.shape[dim]
                    A[r, row(nb)] += CNb[d][r]
                else:
                    bdry_cells[d].append((idx, r, CNb[d][r]))

        for d in range(2 * ndim):
            if not bdry_cells[d]:
                self.bc_rows.append(np.zeros(0, np.int64))
                self.bc_coeff.append(np.zeros(0))
                self.bc_coords.append(np.zeros((0, ndim)))
                continue
            dim, low = neighb_dim(d), neighb_low(d)
            coords = []
            for idx, r, cg in bdry_cells[d]:
                x = [tree.r_base[k] + (idx[k] + 0.5) * dr[k]
                     for k in range(ndim)]
                x[dim] = tree.r_base[dim] + (0.0 if low else
                                             self.shape[dim] * dr[dim])
                coords.append(x)
            coords = np.asarray(coords)
            bc_type, _ = sides_bc(0, d, coords[None], probe_params)
            rows = np.array([r for _, r, _ in bdry_cells[d]], dtype=np.int64)
            cgs_ = np.array([cg for _, _, cg in bdry_cells[d]])
            if bc_type == BC_DIRICHLET:
                A[rows, rows] += -cgs_
                coeff = 2.0 * cgs_
            elif bc_type == BC_NEUMANN:
                A[rows, rows] += cgs_
                sign = 1.0 if not low else -1.0
                coeff = sign * dr[dim] * cgs_
            elif bc_type == BC_DIRICHLET_COPY:
                coeff = cgs_
            elif bc_type == BC_CONTINUOUS:
                A[rows, rows] += 2.0 * cgs_
                x2rows = []
                for idx, r, cg in bdry_cells[d]:
                    nb2 = list(idx)
                    nb2[dim] += (1 if low else -1)
                    x2rows.append(row(nb2))
                A[rows, np.asarray(x2rows)] += -cgs_
                coeff = np.zeros_like(cgs_)
            else:
                raise ValueError("unsupported bc type for coarse solver")
            self.bc_rows.append(rows)
            self.bc_coeff.append(coeff)
            self.bc_coords.append(coords)

        self.A_inv = np.linalg.inv(A)
        self.d = sp.device_copy(
            {"A_inv": self.A_inv, "rows_map": rows_map}, device, dtype)
        self.d.lsf_rhs = (None if lsf_rhs is None else torch.as_tensor(
            lsf_rhs, dtype=dtype, device=device))
        self.d.bc_rows = [torch.as_tensor(r, dtype=torch.int64, device=device)
                          for r in self.bc_rows]
        self.d.bc_coeff = [torch.as_tensor(c, dtype=dtype, device=device)
                           for c in self.bc_coeff]

    def solve_blocks(self, P1, R1, i_phi: int, params):
        """Solve the level-1 grid: rhs from the level-1 rhs blocks R1
        [n1] + [nc]^ndim and the boundary values; returns P1 with new
        interiors."""
        nc, ndim = self.tree.nc, self.tree.ndim
        dtype = P1.dtype
        rm = self.d.rows_map
        rhs = torch.zeros(self.A_inv.shape[0], dtype=dtype, device=P1.device)
        rhs[rm.reshape(-1)] = R1[:self.n1].reshape(-1)
        phi_b = float(params.get("lsf_phi_b", 0.0))
        if self.d.lsf_rhs is not None and phi_b != 0.0:
            # the level set's boundary: rhs + f bc_coeff phi_b
            rhs = rhs + self.d.lsf_rhs.to(dtype) * phi_b
        for d in range(len(self.bc_rows)):
            if len(self.bc_rows[d]) == 0:
                continue
            _, bval = self.sides_bc(i_phi, d, self.bc_coords[d][None],
                                    params)
            contrib = self.d.bc_coeff[d].to(dtype) * (
                as_value(bval, rhs) + torch.zeros(
                    len(self.bc_rows[d]), dtype=dtype, device=rhs.device))
            rhs.index_add_(0, self.d.bc_rows[d], -contrib.reshape(-1))
        x = self.d.A_inv.to(dtype) @ rhs
        out = P1.clone()
        out[(slice(0, self.n1),) + (slice(1, nc + 1),) * ndim] = \
            x[rm].reshape((self.n1,) + (nc,) * ndim)
        return out


# ---------------------------------------------------------------------------
# Geometric multigrid on the uniform level-1 grid (large coarse grids)
# ---------------------------------------------------------------------------
class UniformCoarseMG:
    """Correction-scheme multigrid on the uniform level-1 grid (JAX
    ``UniformCoarseMG``, the analog of HYPRE PFMG on big coarse grids,
    ``m_coarse_solver.f90:15-21``).

    The grid is halved (factor 2 per dimension) while it is even, holds
    more than 2,048 unknowns and has at least 4 cells a side; the last grid
    is solved with a dense inverse built once. Smoothing is red-black
    Gauss-Seidel on the whole grid, restriction the 2^ndim average and
    prolongation the 0.75/0.25 stencil. The constant Laplacian/Helmholtz
    operator (lambda), cylindrical radial factors, and Dirichlet, Neumann,
    continuous and periodic sides; the finest grid carries the boundary
    values of the solve (the applied voltage), the coarser ones the
    homogeneous error equation. V-cycles until the max residual is at most
    1e-10 of max|rhs|, at most 50: one host sync per V-cycle. Every grid
    operation is a tensor operation on the device, in the JAX host path's
    order. ``last_vcycles`` holds the V-cycles of the last solve."""

    #: relative residual tolerance and V-cycle cap
    TOL = 1e-10
    MAX_VCYCLES = 50
    #: stop coarsening at or below this many unknowns and solve densely
    MIN_DENSE = 2048

    def __init__(self, tree: Tree, sides_bc: Callable, lam: float, device,
                 dtype=torch.float64, tracer: Optional[Tracer] = None):
        self.tree = tree
        self.sides_bc = sides_bc
        self.lam = lam
        self.tracer = Tracer() if tracer is None else tracer
        self.device, self.dtype = device, dtype
        ndim, nc = tree.ndim, tree.nc
        self.ndim = ndim
        self.shape = tuple(int(x) for x in tree.coarse_grid_size)
        self.periodic = [bool(p) for p in tree.periodic]
        self.n1 = len(tree.lvl_ids[0])
        self.last_vcycles = 0

        # grid hierarchy: halve while even and large
        self.levels = []  # (shape, dr)
        shape = np.asarray(self.shape)
        dr = np.asarray(tree.dr_base, np.float64)
        while True:
            self.levels.append((tuple(int(x) for x in shape), dr.copy()))
            if (np.prod(shape) <= self.MIN_DENSE
                    or np.any(shape % 2) or np.any(shape < 4)):
                break
            shape = shape // 2
            dr = dr * 2.0

        # per-grid coefficients (host float64, then on the device): c0,
        # the difference-form c_sum and c_nb[d], broadcastable over the grid
        host_ops, self.ops = [], []
        for shp, drl in self.levels:
            inv_dr2 = 1.0 / drl ** 2
            c_nb = [np.asarray(inv_dr2[d // 2]) for d in range(2 * ndim)]
            c0 = -2.0 * float(np.sum(inv_dr2)) - lam
            if tree.coord == "cyl":
                r = tree.r_base[0] + (np.arange(shp[0]) + 0.5) * drl[0]
                shape_r = (shp[0],) + (1,) * (ndim - 1)
                lo = ((r - 0.5 * drl[0]) / r).reshape(shape_r) * inv_dr2[0]
                hi = ((r + 0.5 * drl[0]) / r).reshape(shape_r) * inv_dr2[0]
                c0 = c0 - (lo - inv_dr2[0]) - (hi - inv_dr2[0])
                c_nb[0], c_nb[1] = lo, hi
            c_sum = c0 + sum(np.broadcast_to(c, ()) if np.ndim(c) == 0
                             else c for c in c_nb)
            host_ops.append((c0, c_nb))
            self.ops.append((self._coef(c0), self._coef(c_sum),
                             [self._coef(c) for c in c_nb]))

        # boundary types and the finest grid's face coordinates
        self.bc_types, self.bc_coords = [], []
        probe_params = {"voltage": 0.0}
        for d in range(2 * ndim):
            dim, low = neighb_dim(d), neighb_low(d)
            if self.periodic[dim]:
                self.bc_types.append(None)
                self.bc_coords.append(None)
                continue
            axes = []
            for k in range(ndim):
                if k == dim:
                    axes.append(np.array([tree.r_base[k] + (
                        0.0 if low else self.shape[k] * tree.dr_base[k])]))
                else:
                    axes.append(tree.r_base[k] + (np.arange(self.shape[k])
                                                  + 0.5) * tree.dr_base[k])
            mesh = np.meshgrid(*axes, indexing="ij")
            coords = np.stack([m.ravel() for m in mesh], -1)
            bc_type, _ = sides_bc(0, d, coords[None], probe_params)
            self.bc_types.append(int(bc_type))
            self.bc_coords.append(coords)

        self._bottom_inv = self._dev(self._assemble_bottom_inverse(
            *host_ops[-1]))
        self._masks = {}
        self._rows = self._dev(_rows_map(tree, self.shape), torch.int64)

    def _dev(self, a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a),
                               dtype=self.dtype if dtype is None else dtype,
                               device=self.device)

    def _coef(self, c):
        """A coefficient as a float, or as a device tensor where it varies
        over the grid."""
        return self._dev(c) if np.ndim(c) else float(c)

    def _parity_mask(self, shp, parity: int):
        key = (shp, parity)
        if key not in self._masks:
            mesh = np.meshgrid(*[np.arange(s) for s in shp], indexing="ij")
            self._masks[key] = self._dev((sum(mesh) % 2) == parity,
                                         torch.bool)
        return self._masks[key]

    def _assemble_bottom_inverse(self, c0, c_nb) -> np.ndarray:
        """The dense inverse of the last grid's homogeneous operator."""
        shp, _ = self.levels[-1]
        ndim = self.ndim
        N = int(np.prod(shp))
        A = np.zeros((N, N))
        idxs = np.stack(np.meshgrid(*[np.arange(s) for s in shp],
                                    indexing="ij"), -1).reshape(-1, ndim)
        rows = np.arange(N)
        A[rows, rows] += np.broadcast_to(c0, shp).reshape(-1)
        for d in range(2 * ndim):
            dim, low = neighb_dim(d), neighb_low(d)
            step = -1 if low else 1
            cg = np.broadcast_to(c_nb[d], shp).reshape(-1)
            nb = idxs.copy()
            nb[:, dim] += step
            inside = (nb[:, dim] >= 0) & (nb[:, dim] < shp[dim])
            if self.periodic[dim]:
                nb[:, dim] %= shp[dim]
                cols = np.ravel_multi_index(
                    [nb[:, k] for k in range(ndim)], shp)
                np.add.at(A, (rows, cols), cg)
                continue
            cols = np.ravel_multi_index(
                [np.where(inside, nb[:, k], 0) for k in range(ndim)], shp)
            np.add.at(A, (rows[inside], cols[inside]), cg[inside])
            bnd = ~inside
            bt = self.bc_types[d]
            if bt == BC_DIRICHLET:
                # homogeneous error equation: ghost = -inner
                A[rows[bnd], rows[bnd]] += -cg[bnd]
            elif bt == BC_NEUMANN:
                A[rows[bnd], rows[bnd]] += cg[bnd]
            elif bt == BC_CONTINUOUS:
                A[rows[bnd], rows[bnd]] += 2.0 * cg[bnd]
                nb2 = idxs[bnd].copy()
                nb2[:, dim] -= step
                cols2 = np.ravel_multi_index(
                    [nb2[:, k] for k in range(ndim)], shp)
                np.add.at(A, (rows[bnd], cols2), -cg[bnd])
        return np.linalg.inv(A)

    def _fill_ghosts(self, u, lvl_i: int, bvals):
        """u with one ghost layer; bvals: per-direction boundary values
        (None on the coarser grids: homogeneous)."""
        _, drl = self.levels[lvl_i]
        ndim = self.ndim
        up = torch.nn.functional.pad(u, (1, 1) * ndim)
        for d in range(2 * ndim):
            dim, low = neighb_dim(d), neighb_low(d)
            gsl, in1, in2 = ([slice(1, -1)] * ndim for _ in range(3))
            gsl[dim] = 0 if low else -1
            in1[dim] = 1 if low else -2
            in2[dim] = 2 if low else -3
            if self.periodic[dim]:
                wrap = [slice(1, -1)] * ndim
                wrap[dim] = -2 if low else 1
                val = up[tuple(wrap)]
            else:
                bval = 0.0 if bvals is None else bvals[d]
                val = bc_to_ghost(self.bc_types[d], bval, up[tuple(in1)],
                                  up[tuple(in2)], float(drl[dim]), not low)
            up[tuple(gsl)] = val
        return up

    def _apply(self, u, lvl_i: int, bvals):
        """L(u) with ghosts from bvals, in difference form."""
        _c0, c_sum, c_nb = self.ops[lvl_i]
        ndim = self.ndim
        up = self._fill_ghosts(u, lvl_i, bvals)
        out = c_sum * u
        for d in range(2 * ndim):
            dim, low = neighb_dim(d), neighb_low(d)
            sl = [slice(1, -1)] * ndim
            sl[dim] = slice(0, -2) if low else slice(2, None)
            out = out + c_nb[d] * (up[tuple(sl)] - u)
        return out

    def _gsrb(self, u, rhs, lvl_i: int, bvals, n_sweeps: int = 2):
        shp, _ = self.levels[lvl_i]
        c0 = self.ops[lvl_i][0]
        for sweep in range(2 * n_sweeps):
            new = u + (rhs - self._apply(u, lvl_i, bvals)) / c0
            u = torch.where(self._parity_mask(shp, sweep % 2), new, u)
        return u

    def _restrict(self, r):
        """2^ndim average to the next coarser grid."""
        for d in range(self.ndim):
            shp = tuple(r.shape)
            r = r.reshape(shp[:d] + (shp[d] // 2, 2) + shp[d + 1:]).mean(
                dim=d + 1)
        return r

    def _prolong_add(self, u_f, e_c):
        """u_f + the 0.75/0.25 prolongation of the coarse error."""
        e = e_c
        for d in range(self.ndim):
            n = e.shape[d]
            ep = torch.cat([e.narrow(d, 0, 1), e, e.narrow(d, n - 1, 1)], d)
            ctr, lo, hi = ep.narrow(d, 1, n), ep.narrow(d, 0, n), \
                ep.narrow(d, 2, n)
            f_lo = 0.75 * ctr + 0.25 * lo
            f_hi = 0.75 * ctr + 0.25 * hi
            e = torch.stack([f_lo, f_hi], dim=d + 1).reshape(
                e.shape[:d] + (2 * n,) + e.shape[d + 1:])
        return u_f + e

    def _vcycle(self, u, rhs, lvl_i: int, bvals):
        if lvl_i == len(self.levels) - 1:
            if bvals is not None:
                # eliminate the inhomogeneous ghosts into the rhs
                rhs = rhs - (self._apply(u, lvl_i, bvals)
                             - self._apply(u, lvl_i, None))
            return (self._bottom_inv.to(rhs.dtype)
                    @ rhs.reshape(-1)).reshape(rhs.shape)
        u = self._gsrb(u, rhs, lvl_i, bvals, 2)
        res = rhs - self._apply(u, lvl_i, bvals)
        r_c = self._restrict(res)
        e_c = self._vcycle(torch.zeros_like(r_c), r_c, lvl_i + 1, None)
        u = self._prolong_add(u, e_c)
        return self._gsrb(u, rhs, lvl_i, bvals, 2)

    def _boundary_values(self, i_phi: int, params, like):
        """Per direction the boundary values of this solve as a slab over
        the other dimensions (0.0 on a periodic side)."""
        ndim = self.ndim
        out = []
        for d in range(2 * ndim):
            if self.bc_coords[d] is None:
                out.append(0.0)
                continue
            _, bval = self.sides_bc(i_phi, d, self.bc_coords[d][None], params)
            val = as_value(bval, like) + torch.zeros(
                len(self.bc_coords[d]), dtype=like.dtype, device=like.device)
            out.append(val.reshape([self.shape[k] for k in range(ndim)
                                    if k != neighb_dim(d)]))
        return out

    def solve_blocks(self, P1, R1, i_phi: int, params):
        """Solve the level-1 grid from the level-1 rhs blocks R1 [n1] +
        [nc]^ndim and the boundary values, with the level-1 phi of P1 as
        the initial guess; returns P1 with new interiors."""
        nc, ndim = self.tree.nc, self.ndim
        N = int(np.prod(self.shape))
        rows = self._rows.reshape(-1)
        interior = (slice(0, self.n1),) + (slice(1, nc + 1),) * ndim
        rhs = R1.new_zeros(N)
        u = R1.new_zeros(N)
        rhs[rows] = R1[:self.n1].reshape(-1)
        u[rows] = P1[interior].reshape(-1)
        rhs = rhs.reshape(self.shape)
        u = u.reshape(self.shape)
        bvals = self._boundary_values(i_phi, params, rhs)
        rhs_scale = self.tracer.host_read(rhs.abs().max(), "coarse_scale")
        for it in range(self.MAX_VCYCLES):
            u = self._vcycle(u, rhs, 0, bvals)
            if rhs.dtype == torch.float32:
                # float32 does not reach the 1e-10 residual: 4 V-cycles,
                # as the JAX package's traced path runs (coarse.py:560-564)
                if it >= 3:
                    break
                continue
            res = self.tracer.host_read(
                (rhs - self._apply(u, 0, bvals)).abs().max(),
                "coarse_residual")
            if res <= self.TOL * max(rhs_scale, 1e-300):
                break
        self.last_vcycles = it + 1
        out = P1.clone()
        out[interior] = u.reshape(-1)[self._rows].reshape(
            (self.n1,) + (nc,) * ndim)
        return out
