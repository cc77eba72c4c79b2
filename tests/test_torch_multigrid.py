"""The port's block FAS V-cycle (afivo_streamer_tpu_torch, plain smoother
kernels on the CPU) against the JAX package's host V-cycle on NumPy, on
the refined meshes and boundary conditions of tests/test_mg_blocks.py and
on their 3D counterpart ("xyz3d": 16^3 level-1 cells refined twice over
one corner, Dirichlet z-faces and Neumann elsewhere; the JAX block cycle
is 2D-only, so in 3D the host cycle is the reference).

Tolerance: rtol 1e-10, atol 1e-12 on phi after 3 cycles, as the JAX block
path is held to the host path (tests/test_mg_blocks.py). The two differ
only in the order of floating-point sums.
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
