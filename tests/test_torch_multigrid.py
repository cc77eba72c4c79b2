"""The port's block FAS V-cycle (afivo_streamer_tpu_torch, plain smoother
kernels on the CPU) against the JAX package's host V-cycle on NumPy, on
the refined meshes and boundary conditions of tests/test_mg_blocks.py and
on their 3D counterpart ("xyz3d": 16^3 level-1 cells refined twice over
one corner, Dirichlet z-faces and Neumann elsewhere; the JAX block cycle
is 2D-only, so in 3D the host cycle is the reference).

Tolerance: rtol 1e-10, atol 1e-12 on phi after 3 cycles, as the JAX block
path is held to the host path (tests/test_mg_blocks.py). The two differ
only in the order of floating-point sums.

With a variable permittivity (eps = 2 below y = 0.3125, the ghost layer
included) the mesh's refinement boundary crosses the interface, so some
level has extrapolating refinement-boundary ghosts and smooths through
K3-swap; the port is held to the JAX host V-cycle with ``eps_data`` the
same way, and solves the dielectric capacitor of tests/test_multigrid.py
to roundoff.
"""

import numpy as np
import pytest
import torch

from afivo_streamer_tpu.core.tree import Tree, DO_REF, KEEP_REF
from afivo_streamer_tpu.core.batch import BoxBatch
from afivo_streamer_tpu.core import ghostcell as gc
from afivo_streamer_tpu.solvers.multigrid import Multigrid

from afivo_streamer_tpu_torch.core.tree import Tree as TTree
from afivo_streamer_tpu_torch.core import ghostcell as tgc
from afivo_streamer_tpu_torch.core.levels import MeshPlans
from afivo_streamer_tpu_torch.solvers import mg_blocks as mgb
from afivo_streamer_tpu_torch.solvers.multigrid import Multigrid as TMultigrid

torch.set_num_threads(1)

I_PHI, I_RHS, I_TMP = 0, 1, 2
NC = 8


def make_tree(cls, coord="xyz"):
    """Level 1 16^ndim cells, refined twice where r0 < 0.45."""
    ndim = 3 if coord == "xyz3d" else 2
    t = cls(ndim, NC, [1.0] * ndim, [16] * ndim,
            coord="cyl" if coord == "cyl" else "xyz")

    def flags(ids):
        out = np.full([len(ids)] + [NC] * ndim, KEEP_REF, np.int64)
        for n, b in enumerate(ids):
            r0 = t.box_r_min(np.asarray([int(b)]))[0]
            if np.all(r0 < 0.45) and t.lvl[int(b)] == t.highest_lvl:
                out[n] = DO_REF
        return out

    t.adjust_refinement(flags, ref_buffer=1)
    t.adjust_refinement(flags, ref_buffer=1)
    return t


def make_bc(mod, ndim=2):
    """Dirichlet faces in the last dimension (0 low, the voltage high),
    Neumann elsewhere."""
    def bc(iv, d, coords, params):
        if d == 2 * ndim - 1:
            return mod.BC_DIRICHLET, params.get("voltage", 0.0)
        if d == 2 * ndim - 2:
            return mod.BC_DIRICHLET, 0.0
        return mod.BC_NEUMANN, 0.0
    return bc


def setup_cc(t, pad=8, seed=3):
    batch = BoxBatch(t, 3, 0)
    cc = np.array(batch.cc)
    grow = np.zeros((cc.shape[0], cc.shape[1] + pad, cc.shape[2]))
    grow[:, :cc.shape[1]] = cc
    cc = grow
    rng = np.random.default_rng(seed)
    k = 2.0 * np.pi
    for lvl in range(1, t.highest_lvl + 1):
        for b in t.lvl_ids[lvl - 1]:
            r = t.cell_coords(int(b))
            cc[I_RHS, int(b)] = (-t.ndim * k**2 * np.prod(
                np.sin(k * r), axis=-1)).ravel()
    cc[I_PHI] = rng.random(cc.shape[1:]) * 0.01
    return cc


def port_mg(coord):
    t = make_tree(TTree, coord)
    return TMultigrid(MeshPlans(t, "cpu"), I_PHI, I_RHS,
                      make_bc(tgc, t.ndim))


@pytest.mark.parametrize("coord", ["xyz", "cyl", "xyz3d"])
def test_block_vcycle_matches_jax_host(coord):
    t = make_tree(Tree, coord)
    cc0 = setup_cc(t)
    params = {"voltage": 25.0}

    mg_h = Multigrid(t, I_PHI, I_RHS, I_TMP, make_bc(gc, t.ndim))
    h = mg_h.fill_ghosts_phi(cc0.copy(), params)
    for _ in range(3):
        h = mg_h.fas_vcycle(h, params, set_residual=True)
    res_h = float(mg_h.max_abs_residual(h))

    mg_t = port_mg(coord)
    d = torch.as_tensor(cc0.copy())
    d = mg_t.fill_ghosts_phi(d, params)
    for _ in range(3):
        d, res_d = mg_t.vcycle(d, params)

    real = t.highest_id
    np.testing.assert_allclose(d.numpy()[I_PHI, :real], h[I_PHI, :real],
                               rtol=1e-10, atol=1e-12)
    assert float(res_d) == pytest.approx(res_h, rel=1e-6, abs=1e-10)


def test_block_vcycle_converges_poisson():
    """The block V-cycle drives the residual down by >= 1e3 over 4 cycles
    on this smooth problem (the check of tests/test_mg_blocks.py)."""
    t = make_tree(Tree)
    cc0 = setup_cc(t)
    params = {"voltage": 0.0}
    mg_t = port_mg("xyz")
    d = mg_t.fill_ghosts_phi(torch.as_tensor(cc0), params)
    residuals = []
    for _ in range(4):
        d, res = mg_t.vcycle(d, params)
        residuals.append(float(res))
    assert residuals[-1] < residuals[0] / 1e3


I_EPS = 3


def with_eps(t, cc, e1=2.0, y_if=0.3125):
    """cc with an eps variable: e1 below y_if, 1 above (by cell
    coordinates, ghost layer included)."""
    cc = np.concatenate([cc, np.ones_like(cc[:1])])
    for lvl in range(1, t.highest_lvl + 1):
        for b in t.lvl_ids[lvl - 1]:
            r = t.cell_coords(int(b))
            cc[I_EPS, int(b)] = np.where(r[..., 1] < y_if, e1, 1.0).ravel()
    return cc


def eps_of(t, cc):
    return lambda lvl: cc[I_EPS, np.asarray(t.lvl_ids[lvl - 1])]


@pytest.mark.parametrize("coord", ["xyz", "cyl"])
def test_eps_block_vcycle_matches_jax_host(coord):
    t = make_tree(Tree, coord)
    cc0 = with_eps(t, setup_cc(t))
    params = {"voltage": 25.0}
    mg_h = Multigrid(t, I_PHI, I_RHS, I_TMP, make_bc(gc, 2),
                     eps_data=eps_of(t, cc0))
    h = mg_h.fill_ghosts_phi(cc0.copy(), params)
    for _ in range(3):
        h = mg_h.fas_vcycle(h, params, set_residual=True)
    res_h = float(mg_h.max_abs_residual(h))

    mg_t = port_mg(coord)
    mg_t.eps_data = eps_of(mg_t.tree, cc0)
    d = mg_t.fill_ghosts_phi(torch.as_tensor(cc0.copy()), params)
    for _ in range(3):
        d, res_d = mg_t.vcycle(d, params)
    swap = [l for l in range(1, mg_t.n_levels + 1)
            if mg_t.smoother(l).has_swap]
    assert swap, "some level must have extrapolating ghosts"
    real = t.highest_id
    np.testing.assert_allclose(d.numpy()[I_PHI, :real], h[I_PHI, :real],
                               rtol=1e-10, atol=1e-12)
    assert float(res_d) == pytest.approx(res_h, rel=1e-6, abs=1e-10)


@pytest.mark.parametrize("refine", [False, True])
def test_eps_capacitor_solved_to_roundoff(refine):
    """The planar capacitor with a dielectric slab of
    tests/test_multigrid.py::test_poisson_dielectric_capacitor (eps = 2 for
    y < 0.25, Dirichlet by the exact piecewise-linear potential top and
    bottom): the discrete solution is exact, so the port's FMG and
    V-cycles must reproduce it to roundoff."""
    nc, n1, ndim = 8, 16, 2
    a, e1, e2, V = 0.25, 2.0, 1.0, 100.0
    c2 = V / ((e2 / e1) * a + (1 - a))
    c1 = (e2 / e1) * c2

    def phi_f(r):
        y = r[..., 1]
        return np.where(y < a, c1 * y, c1 * a + c2 * (y - a))

    t = TTree(ndim, nc, [1.0] * ndim, [n1] * ndim)
    if refine:
        def flags(ids):
            out = np.full([len(ids)] + [nc] * ndim, KEEP_REF, np.int64)
            for n, b in enumerate(ids):
                r0 = t.box_r_min(np.asarray([int(b)]))[0]
                ctr = r0 + 0.5 * t.nc * t.lvl_dr(int(t.lvl[int(b)]))
                if ctr[1] > 0.5 and t.lvl[int(b)] == t.highest_lvl:
                    out[n] = DO_REF
            return out
        t.adjust_refinement(flags, ref_buffer=0)
    cc = np.zeros((4, t.highest_id, (nc + 2) ** ndim))
    for b in range(t.highest_id):
        r = t.cell_coords(b)
        cc[I_EPS, b] = np.where(r[..., 1] < a, e1, e2).ravel()

    def bc_fn(iv, d, coords, params):
        if d // 2 == 0:
            return tgc.BC_NEUMANN, 0.0
        return tgc.BC_DIRICHLET, torch.as_tensor(phi_f(np.asarray(coords)))

    mg = TMultigrid(MeshPlans(t, "cpu"), I_PHI, I_RHS, bc_fn)
    mg.eps_data = eps_of(t, cc)
    d = mg.fill_ghosts_phi(torch.as_tensor(cc), {})
    P, R = mgb.gather_levels(mg, d)
    P, R = mgb.fas_fmg_blocks(mg, P, R, {})
    for _ in range(10):
        P, R = mgb.fas_vcycle_blocks(mg, P, R, {})
    assert float(mgb.max_leaf_residual_blocks(mg, P, R)) < 1e-7
    d = mgb.scatter_levels(mg, d, P, R).numpy()
    err = 0.0
    for lvl in range(1, t.highest_lvl + 1):
        for b in t.lvl_leaves[lvl - 1]:
            r = t.cell_coords(int(b))
            itr = (slice(1, nc + 1),) * ndim
            got = d[I_PHI, int(b)].reshape([nc + 2] * ndim)
            err = max(err, np.max(np.abs(got[itr] - phi_f(r)[itr])))
    assert err < 1e-8 * V, f"capacitor solution error {err}"
