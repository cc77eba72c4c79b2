"""The port's grid substrate against the JAX package's host (NumPy) path on
the refined meshes of tests/test_mg_blocks.py (two refinement levels over
one corner, so every level has same-level, physical and refinement
boundaries), and on their 3D counterpart ("xyz3d": the mesh of
tests/test_pallas_smoother.py::test_pallas_vcycle_matches_host_3d refined
a second time, so that it has refinement boundaries, edges and corners
without diagonal neighbors):

* equal tree tables;
* equal ghost fills (mg_sides_rb, interp, interp_lim, prolong_copy and
  the extrapolating ghosts of variable-eps boxes; side + corner, and the
  3D edges);
* equal restriction (plain and cylindrical-volume weighted);
* equal linear prolongation of a correction (the block form of the port
  against the host af_prolong_linear), and every prolongation method into
  a set of new boxes;
* plans that follow a refinement: after a mesh change the cached plans
  of the changed levels are rebuilt and equal fresh ones, the others kept;
* equal 2-ghost extended arrays (incl. the limited refinement-boundary
  prolongation with the limiter each package's driver chooses for the
  dimension: MC in 2D, gminmod43 in 3D) and fine-to-coarse flux matching
  of the fluid step.

All float64; rtol 1e-13 (the operations are the same arithmetic in the
same order except the block prolongation, whose sums are reordered).
"""

import threading

import numpy as np
import pytest
import torch

from afivo_streamer_tpu.core import ghostcell as gc
from afivo_streamer_tpu.core import prolong_restrict as pr
from afivo_streamer_tpu.core.tree import Tree, DO_REF, KEEP_REF
from afivo_streamer_tpu.ops.limiters import LIMITER_GMINMOD43, LIMITER_MC
from afivo_streamer_tpu.physics import fluid as jfl

from afivo_streamer_tpu_torch.core import ghostcell as tgc
from afivo_streamer_tpu_torch.core import prolong_restrict as tpr
from afivo_streamer_tpu_torch.core.levels import MeshPlans
from afivo_streamer_tpu_torch.core.tree import Tree as TTree
from afivo_streamer_tpu_torch.physics import fluid as tfl
from afivo_streamer_tpu_torch.solvers import mg_blocks as mgb

torch.set_num_threads(1)

NC = 8
COORDS = ["xyz", "cyl", "xyz3d"]


def make_tree(cls, coord):
    """Level 1 16^ndim cells on [0, 1]^ndim (cylindrical: r from 0.5),
    refined twice where the box corner is below 0.45."""
    ndim = 3 if coord == "xyz3d" else 2
    t = cls(ndim, NC, [1.0] * ndim, [16] * ndim,
            coord="cyl" if coord == "cyl" else "xyz",
            r_min=[0.5, 0.0] if coord == "cyl" else None)

    def flags(ids):
        out = np.full([len(ids)] + [NC] * ndim, KEEP_REF, np.int64)
        for n, b in enumerate(ids):
            r0 = t.box_r_min(np.asarray([int(b)]))[0] - t.r_base
            if np.all(r0 < 0.45) and t.lvl[int(b)] == t.highest_lvl:
                out[n] = DO_REF
        return out

    t.adjust_refinement(flags, ref_buffer=1)
    t.adjust_refinement(flags, ref_buffer=1)
    return t


def trees(coord):
    return make_tree(Tree, coord), make_tree(TTree, coord)


def random_cc(t, n_var=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (n_var, t.highest_id, (NC + 2) ** t.ndim)) + 2.0


def bc(mod):
    def fn(iv, d, coords, params):
        if d == 3:
            return mod.BC_DIRICHLET, 0.7
        if d == 2:
            return mod.BC_DIRICHLET_COPY, -0.3
        return mod.BC_NEUMANN, 0.25
    return fn


@pytest.mark.parametrize("coord", COORDS)
def test_tree_tables_equal(coord):
    tj, tt = trees(coord)
    assert tj.highest_lvl == tt.highest_lvl == 3
    for name in ("lvl", "ix", "parent", "children", "neighbors", "in_use"):
        np.testing.assert_array_equal(getattr(tt, name)[:tt.highest_id],
                                      getattr(tj, name)[:tj.highest_id])
    for name in ("lvl_ids", "lvl_leaves", "lvl_parents"):
        for a, b in zip(getattr(tt, name), getattr(tj, name)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("coord", COORDS)
@pytest.mark.parametrize("rb", [gc.RB_MG, gc.RB_INTERP, gc.RB_INTERP_LIM])
def test_ghost_fill_matches(coord, rb):
    tj, tt = trees(coord)
    cc = random_cc(tj, seed=1)
    mesh = MeshPlans(tt, "cpu")
    want = cc.copy()
    got = torch.as_tensor(cc.copy())
    for lvl in range(1, tj.highest_lvl + 1):
        want = gc.fill_ghosts_lvl(want, gc.get_gc_plan(tj, lvl), [0, 2], rb,
                                  bc(gc), {})
        tgc.fill_ghosts_lvl(got, mesh.gc(lvl), [0, 2], rb, bc(tgc), {})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("coord", COORDS)
@pytest.mark.parametrize("geometry", [True, False])
def test_restriction_matches(coord, geometry):
    tj, tt = trees(coord)
    cc = random_cc(tj, seed=2)
    want = pr.restrict_tree(cc.copy(), tj, [0, 1], use_geometry=geometry)
    got = tpr.restrict_tree(torch.as_tensor(cc.copy()),
                            MeshPlans(tt, "cpu").pr_all(), [0, 1],
                            use_geometry=geometry)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("coord", COORDS)
def test_prolongation_of_correction_matches(coord):
    """Host: phi(children) += prolong_linear(tmp(parents)); port: the same
    on the level block arrays (mg_blocks.prolong_add_correction)."""
    tj, tt = trees(coord)
    cc = random_cc(tj, seed=3)
    mesh = MeshPlans(tt, "cpu")
    block = (NC + 2,) * tt.ndim
    for lvl in range(2, tj.highest_lvl + 1):
        want = pr.prolong(cc.copy(), pr.get_full_plan(tj, lvl), [1],
                          "linear", add=True, ivs_to=[0])
        bp = mgb.LevelBlockPlan(mesh, lvl)
        ct = torch.as_tensor(cc)
        ids_f = mesh.tb(lvl).d.ids
        ids_c = mesh.tb(lvl - 1).d.ids
        P_f = ct[0, ids_f].reshape((-1,) + block)
        corr = ct[1, ids_c].reshape((-1,) + block)
        got = mgb.prolong_add_correction(P_f, corr, bp, NC)
        np.testing.assert_allclose(
            got.reshape(len(ids_f), -1).numpy(),
            want[0, mesh.tb(lvl).ids], rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("coord", COORDS)
def test_gc2_extend_matches(coord):
    """Each package with the prolongation limiter its driver passes to the
    fluid model for the mesh's dimension."""
    tj, tt = trees(coord)
    lim_j = pr.default_prolong_limiter(tj.ndim)
    lim_t = tpr.default_prolong_limiter(tt.ndim)
    assert lim_t == lim_j == (LIMITER_MC if tt.ndim == 2
                              else LIMITER_GMINMOD43)
    cc = random_cc(tj, seed=4)
    want_cc = cc.copy()
    got_cc = torch.as_tensor(cc.copy())
    for lvl in range(1, tj.highest_lvl + 1):
        if len(tj.lvl_leaves[lvl - 1]) == 0:
            continue
        E_w, want_cc = jfl.gc2_extend(want_cc, jfl.get_gc2_plan(tj, lvl),
                                      [0, 2], bc(gc), {}, lim_j)
        E_g, got_cc = tfl.gc2_extend(got_cc, tfl.Gc2LevelPlan(tt, lvl, "cpu"),
                                     [0, 2], bc(tgc), {}, lim_t)
        np.testing.assert_allclose(E_g.numpy(), E_w, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(got_cc.numpy(), want_cc, rtol=1e-13,
                               atol=1e-13)


@pytest.mark.parametrize("coord", COORDS)
def test_consistent_fluxes_match(coord):
    tj, tt = trees(coord)
    rng = np.random.default_rng(5)
    fc = rng.standard_normal((2, tj.ndim, tj.highest_id,
                              (NC + 1) ** tj.ndim))
    fm = jfl.FluidModel.__new__(jfl.FluidModel)
    fm.tree, fm._pack_tls = tj, threading.local()
    want = fm.consistent_fluxes(fc.copy(), [0, 1])
    groups = tfl.build_consistent_plan(tt, "cpu")
    assert groups, "the mesh must have coarse-fine faces"
    got = tfl.consistent_fluxes(torch.as_tensor(fc.copy()), groups, [0, 1])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("coord", COORDS)
def test_ghost_fill_prolong_copy_and_extrap_match(coord):
    """af_gc_prolong_copy (the permittivity's refinement-boundary ghosts),
    and mg_sides_rb with a random extrapolation mask (the ghosts of boxes
    with variable eps: the 2D pair-swap form, the 1D form in 3D)."""
    tj, tt = trees(coord)
    cc = random_cc(tj, seed=6)
    mesh = MeshPlans(tt, "cpu")
    rng = np.random.default_rng(7)
    want, got = cc.copy(), torch.as_tensor(cc.copy())
    n_extrap = 0
    for lvl in range(1, tj.highest_lvl + 1):
        pj = gc.get_gc_plan(tj, lvl)
        want = gc.fill_ghosts_lvl(want, pj, [1], gc.RB_PROLONG_COPY,
                                  bc(gc), {})
        tgc.fill_ghosts_lvl(got, mesh.gc(lvl), [1], tgc.RB_PROLONG_COPY,
                            bc(tgc), {})
        em = {d: rng.random(len(p.rb_ids)) < 0.5
              for d, p in enumerate(pj.dirs) if len(p.rb_ids)}
        em = {d: m for d, m in em.items() if m.any()}
        n_extrap += sum(int(m.sum()) for m in em.values())
        want = gc.fill_ghosts_lvl(want, pj, [0, 2], gc.RB_MG, bc(gc), {},
                                  rb_extrap_mask=em)
        tgc.fill_ghosts_lvl(got, mesh.gc(lvl), [0, 2], tgc.RB_MG, bc(tgc), {},
                            rb_extrap_mask={d: torch.as_tensor(m)
                                            for d, m in em.items()})
    assert n_extrap > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("coord", COORDS)
@pytest.mark.parametrize("method", ["zeroth", "sparse", "linear", "limit",
                                    "linear_cons"])
def test_prolong_into_new_boxes_matches(coord, method):
    """af_prolong_* into a set of children (every other box of each level,
    as the new boxes of a refinement epoch), with the default limiter."""
    tj, tt = trees(coord)
    cc = random_cc(tj, seed=8)
    want, got = cc.copy(), torch.as_tensor(cc.copy())
    for lvl in range(2, tj.highest_lvl + 1):
        ids = np.asarray(tj.lvl_ids[lvl - 1])[::2]
        want = pr.prolong(want, pr.ProlongRestrictPlan(tj, ids), [0, 2],
                          method)
        tpr.prolong(got, tpr.ProlongRestrictPlan(tt, ids, "cpu"), [0, 2],
                    method)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("coord", ["xyz", "xyz3d"])
def test_mesh_plans_follow_refinement(coord):
    """Refining the finest level adds a level and changes the previous
    finest (its boxes get children): those levels' plans are rebuilt and
    equal the plans of a fresh MeshPlans; level 1's are kept."""
    _, tt = trees(coord)
    mesh = MeshPlans(tt, "cpu")
    old = {l: (mesh.gc(l), mesh.tb(l)) for l in range(1, tt.highest_lvl + 1)}
    top = tt.highest_lvl

    def flags(ids):
        out = np.full([len(ids)] + [NC] * tt.ndim, KEEP_REF, np.int64)
        for n, b in enumerate(ids):
            r0 = tt.box_r_min(np.asarray([int(b)]))[0]
            if np.all(r0 < 0.1) and tt.lvl[int(b)] == top:
                out[n] = DO_REF
        return out
    info = tt.adjust_refinement(flags, ref_buffer=0)
    assert info.n_add > 0 and tt.highest_lvl == top + 1
    fresh = MeshPlans(tt, "cpu")
    assert mesh.gc(1) is old[1][0] and mesh.tb(1) is old[1][1]
    assert mesh.tb(top) is not old[top][1]
    for lvl in range(1, tt.highest_lvl + 1):
        a, b = mesh.tb(lvl), fresh.tb(lvl)
        for name in ("ids", "leaves", "parents"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        for pa, pb in zip(mesh.gc(lvl).dirs, fresh.gc(lvl).dirs):
            for name in ("copy_ids", "copy_nb", "bc_ids", "rb_ids",
                         "rb_parent"):
                np.testing.assert_array_equal(getattr(pa, name),
                                              getattr(pb, name))
