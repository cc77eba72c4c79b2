"""Direct coarse-grid solver for multigrid level 1.

Replaces the reference's HYPRE bridge (``afivo/src/m_coarse_solver.f90``:
the level-1 grid is assembled into a HYPRE StructMatrix and solved with
SMG/PFMG). Here the level-1 grid, which never changes during a run and is
small (16 x 16 cells in the 2D slice, 16^3 in the 3D one), is assembled
once into a dense matrix with the boundary conditions eliminated and
inverted on the host; a solve is then one matrix-vector product on the
device.

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
from typing import Callable

import numpy as np
import torch

from ..core import spatial as sp
from ..core.rowops import as_value
from ..core.tree import Tree, neighb_dim, neighb_low
from ..core.ghostcell import (BC_DIRICHLET, BC_NEUMANN, BC_CONTINUOUS,
                              BC_DIRICHLET_COPY)

_MAX_DENSE = 32768  # beyond this a dense inverse is unreasonable


class CoarseSolver:
    def __init__(self, tree: Tree, sides_bc: Callable, lam: float, device,
                 level1_op=None):
        self.tree = tree
        self.sides_bc = sides_bc
        ndim, nc = tree.ndim, tree.nc
        cgs = tree.coarse_grid_size  # cells per dim at level 1
        N = int(np.prod(cgs))
        if N > _MAX_DENSE:
            raise NotImplementedError(
                "solvers/coarse.py: UniformCoarseMG (coarse grid with "
                f"{N} unknowns)")
        self.shape = tuple(int(x) for x in cgs)
        dr = tree.dr_base
        inv_dr2 = 1.0 / dr**2

        # gather map: rows of each level-1 box's interior cells
        ids1 = np.asarray(tree.lvl_ids[0])
        self.n1 = len(ids1)
        rows_map = np.zeros((len(ids1), nc**ndim), np.int64)
        cell_local = np.stack(np.meshgrid(*[np.arange(nc)] * ndim,
                                          indexing="ij"), -1).reshape(-1, ndim)
        for n, b in enumerate(ids1):
            g = cell_local + tree.ix[b] * nc
            rows_map[n] = np.ravel_multi_index(
                [g[:, k] for k in range(ndim)], self.shape)

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
            {"A_inv": self.A_inv, "rows_map": rows_map}, device)
        self.d.lsf_rhs = (None if lsf_rhs is None else torch.as_tensor(
            lsf_rhs, dtype=torch.float64, device=device))
        self.d.bc_rows = [torch.as_tensor(r, dtype=torch.int64, device=device)
                          for r in self.bc_rows]
        self.d.bc_coeff = [torch.as_tensor(c, dtype=torch.float64,
                                           device=device)
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
