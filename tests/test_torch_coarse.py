"""The uniform coarse-grid multigrid (solvers/coarse.UniformCoarseMG) of the
port against the JAX package's host path, float64, and the two cases of
tests/test_multigrid.py::test_large_coarse_grid_uniform_mg on the port.

``UniformCoarseMG`` solves a level-1 grid of more than 32,768 unknowns
without a per-cell operator: a 2D Cartesian grid of 192^2 cells
(192 -> 96 -> 48 -> 24, dense), a cylindrical one, a 3D grid of 40^3
(40 -> 20 -> 10, dense), the Helmholtz operator (lambda = 1e4, as a
photoionization mode or an implicit step gives it), a periodic side and
continuous sides; each with the potential's Dirichlet values (0 below, a
voltage above, Neumann sides unless stated), a random rhs and a random
initial guess from one seed. The same level-1 phi at rtol 1e-10 of its
scale and the same count of V-cycles to the 1e-10 relative residual in
both packages (10-12 V-cycles; with continuous sides neither package
reaches 1e-10 and both stop at the cap of 50).
With a per-cell (eps or level-set) operator such a grid still raises, as
in the JAX package.
"""

import numpy as np
import pytest
import torch

from afivo_streamer_tpu.core import ghostcell as jgc
from afivo_streamer_tpu.core.tree import Tree as JTree
from afivo_streamer_tpu.solvers.coarse import UniformCoarseMG as JUMG
from afivo_streamer_tpu_torch.core import ghostcell as gc
from afivo_streamer_tpu_torch.core.batch import BoxBatch
from afivo_streamer_tpu_torch.core.levels import MeshPlans
from afivo_streamer_tpu_torch.core.tree import Tree
from afivo_streamer_tpu_torch.solvers import mg_blocks as mgb
from afivo_streamer_tpu_torch.solvers.coarse import (UniformCoarseMG,
                                                     make_coarse_solver)
from afivo_streamer_tpu_torch.solvers.multigrid import Multigrid
from test_multigrid import exact_and_rhs

torch.set_num_threads(1)

RTOL = 1e-10
NC = 8
#: name: (ndim, cells per side, coord, lambda, periodic, side bc)
CASES = {
    "xyz2d": (2, 192, "xyz", 0.0, None, "neumann"),
    "cyl": (2, 192, "cyl", 0.0, None, "neumann"),
    "xyz3d": (3, 40, "xyz", 0.0, None, "neumann"),
    "continuous": (2, 192, "xyz", 0.0, None, "continuous"),
    "helmholtz": (2, 192, "xyz", 1e4, None, "neumann"),
    "periodic": (2, 192, "xyz", 0.0, [True, False], "neumann"),
}
VOLTAGE = 2.5


def make_bc(ndim, side, jax_side):
    """The potential's sides: Dirichlet 0 below and the voltage above
    along the last dimension, Neumann zero (or continuous) elsewhere."""
    g = jgc if jax_side else gc

    def bc(iv, d, coords, params):
        if d // 2 == ndim - 1:
            return g.BC_DIRICHLET, (0.0 if d % 2 == 0
                                    else params.get("voltage", 0.0))
        if side == "continuous":
            return g.BC_CONTINUOUS, 0.0
        return g.BC_NEUMANN, 0.0
    return bc


def both_solvers(name):
    ndim, n1, coord, lam, periodic, side = CASES[name]
    args = (ndim, NC, [0.016] * ndim, [n1] * ndim)
    kw = dict(periodic=periodic, coord=coord)
    jt, tt = JTree(*args, **kw), Tree(*args, **kw)
    np.testing.assert_array_equal(np.asarray(jt.lvl_ids[0]),
                                  np.asarray(tt.lvl_ids[0]))
    j = JUMG(jt, make_bc(ndim, side, True), lam)
    t = make_coarse_solver(tt, make_bc(ndim, side, False), lam, "cpu")
    assert isinstance(t, UniformCoarseMG)
    assert [s for s, _ in t.levels] == [s for s, _ in j.levels]
    return j, t


@pytest.mark.parametrize("name", list(CASES))
def test_uniform_coarse_mg_matches_jax(name):
    j, t = both_solvers(name)
    ndim = t.ndim
    n1 = len(j.ids1)
    S = (NC + 2) ** ndim
    rng = np.random.default_rng(7)
    phi = rng.standard_normal((n1, S))
    rhs = rng.standard_normal((n1, S)) * 1e6
    cc = np.zeros((2, n1, S))
    cc[0], cc[1] = phi, rhs
    # the JAX solver reads level-1 rows by box id: make the ids 0..n1-1
    assert np.array_equal(np.sort(j.ids1), np.arange(n1))
    counts = []
    vcycle = j._vcycle

    def counted(u, r, lvl_i, bvals):
        if lvl_i == 0:
            counts.append(1)
        return vcycle(u, r, lvl_i, bvals)
    j._vcycle = counted
    params = {"voltage": VOLTAGE}
    want = j.solve(cc.copy(), 0, 1, params)[0]
    block = (n1,) + (NC + 2,) * ndim
    inner = (slice(None),) + (slice(1, NC + 1),) * ndim
    P1 = torch.as_tensor(phi[np.argsort(j.ids1)].reshape(block))
    R1 = torch.as_tensor(rhs[np.argsort(j.ids1)].reshape(block)[inner])
    got = t.solve_blocks(P1, R1, 0, params)
    assert t.last_vcycles == len(counts) >= 2
    want = want[np.argsort(j.ids1)].reshape(block)[inner]
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got[inner].numpy(), want, rtol=RTOL,
                               atol=RTOL * scale)
    # the ghost layer of the guess is left as it was
    np.testing.assert_array_equal(got.numpy()[:, 0], P1.numpy()[:, 0])


def test_per_cell_operator_refuses_a_large_coarse_grid():
    t = Tree(2, NC, [0.016] * 2, [192, 192])
    with pytest.raises(NotImplementedError, match="per-cell"):
        make_coarse_solver(t, make_bc(2, "neumann", False), 0.0, "cpu",
                           level1_op=object())


@pytest.mark.parametrize("coord", ["xyz", "cyl"])
def test_large_coarse_grid_uniform_mg(coord):
    """tests/test_multigrid.py::test_large_coarse_grid_uniform_mg on the
    port: Poisson on a 256 x 256 level-1-only tree (65,536 unknowns) through
    the port's Multigrid, one FMG cycle; the same residual and error
    bounds."""
    nc, n1, ndim = 8, 256, 2
    t = Tree(ndim, nc, [1.0] * ndim, [n1] * ndim, coord=coord)
    mesh = MeshPlans(t, "cpu")
    cc = BoxBatch(t, 2, 0, t.highest_id, torch.float64, "cpu").cc
    phi_f, rhs_f = exact_and_rhs(ndim, coord)
    ids = np.asarray(t.lvl_ids[0])
    for b in ids:
        cc[1, int(b)] = torch.as_tensor(rhs_f(t.cell_coords(int(b))).ravel())

    def bc(iv, d, coords, params):
        if coord == "cyl" and d == 0:
            return gc.BC_NEUMANN, 0.0
        return gc.BC_DIRICHLET, phi_f(coords)

    mg = Multigrid(mesh, 0, 1, bc)
    assert isinstance(mg.coarse_solver(), UniformCoarseMG)
    cc = mg.fill_ghosts_phi(cc, {})
    P, R = mgb.gather_levels(mg, cc)
    P, R = mgb.fas_fmg_blocks(mg, P, R, {})
    res = float(mgb.max_leaf_residual_blocks(mg, P, R, {}))
    max_rhs = float(cc[1].abs().max())
    assert res < 1e-8 * max(max_rhs, 1.0), f"coarse MG did not converge: {res}"
    cc = mgb.scatter_levels(mg, cc, P, R)
    err = 0.0
    itr = tuple([slice(1, nc + 1)] * ndim)
    for b in ids:
        got = cc[0, int(b)].reshape([nc + 2] * ndim).numpy()
        expect = phi_f(t.cell_coords(int(b)))
        err = max(err, np.max(np.abs(got[itr] - expect[itr])))
    h = float(t.lvl_dr(1).max())
    scale = 1.0 if coord == "cyl" else 4.0 * np.pi**2
    assert err < 2.0 * scale * h**2, f"error {err} too large (h={h})"
