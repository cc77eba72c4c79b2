"""One dimension: the port's grid substrate, multigrid and planar 1D slice
against the JAX package's host (NumPy) path, float64.

The mesh of the module tests is 64 level-1 cells on [0, 1] in boxes of 8,
refined twice where the box starts between 0.3 and 0.7, so every level
above the first has a refinement boundary at its low and at its high end
(one face cell: every per-face table degenerates to one column).
Tolerances as the 2D and 3D cases have: tree tables equal; ghost fills,
restriction, prolongation, the 2-ghost extended arrays and flux matching
rtol 1e-13; three V-cycles and an FMG cycle rtol 1e-10 (atol 1e-12) on
phi with the residuals at rel 1e-6. The JAX package
has no kernel for one dimension (it smooths through MGOperator.gsrb), so
the port's sweep_1d and fill_1d are tensor operations held here directly
against that host smoother.

The slice afivo_streamer_tpu_torch/data/air_1d_slice.cfg (144 cells on 5
levels) runs through ``python -m afivo_streamer_tpu_torch ... -ndim=1``
under the local field approximation and under the electron energy
equation and writes the _rtest.log the JAX package writes (rtol 1e-8);
tests/test_torch_slice.py holds its mesh, dt and state step by step.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from afivo_streamer_tpu.core import ghostcell as gc
from afivo_streamer_tpu.core import prolong_restrict as pr
from afivo_streamer_tpu.core.tree import Tree, DO_REF, KEEP_REF
from afivo_streamer_tpu.ops.limiters import LIMITER_MC
from afivo_streamer_tpu.physics import fluid as jfl
from afivo_streamer_tpu.solvers.multigrid import Multigrid
from afivo_streamer_tpu.__main__ import main as jmain
from afivo_streamer_tpu.driver import Simulation as JSim

from afivo_streamer_tpu_torch.core import ghostcell as tgc
from afivo_streamer_tpu_torch.core import prolong_restrict as tpr
from afivo_streamer_tpu_torch.core.levels import MeshPlans
from afivo_streamer_tpu_torch.core.tree import Tree as TTree
from afivo_streamer_tpu_torch.physics import fluid as tfl
from afivo_streamer_tpu_torch.solvers import mg_blocks as mgb
from afivo_streamer_tpu_torch.solvers.multigrid import Multigrid as TMultigrid
from afivo_streamer_tpu_torch.__main__ import main as tmain
from afivo_streamer_tpu_torch.driver import Simulation as TSim
from afivo_streamer_tpu_torch import interop

from test_torch_grid import random_cc
from test_torch_multigrid import make_bc, setup_cc, I_PHI, I_RHS, I_TMP
from test_torch_slice import heun_substeps_both

torch.set_num_threads(1)

NC = 8
DATA = (Path(__file__).resolve().parent.parent / "afivo_streamer_tpu_torch"
        / "data")
NEW_TABLE = DATA / "td_air_synthetic_new.txt"
EE = ["-model%type=ee53", "-input_data%old_style=f",
      f"-input_data%file={NEW_TABLE}"]


def make_tree(cls):
    t = cls(1, NC, [1.0], [64])

    def flags(ids):
        out = np.full([len(ids), NC], KEEP_REF, np.int64)
        for n, b in enumerate(ids):
            r0 = t.box_r_min(np.asarray([int(b)]))[0]
            if 0.3 < r0[0] < 0.7 and t.lvl[int(b)] == t.highest_lvl:
                out[n] = DO_REF
        return out

    t.adjust_refinement(flags, ref_buffer=1)
    t.adjust_refinement(flags, ref_buffer=1)
    return t


def trees():
    return make_tree(Tree), make_tree(TTree)


def bc(mod):
    """Dirichlet at the low end, Neumann at the high end."""
    def fn(iv, d, coords, params):
        if d == 0:
            return mod.BC_DIRICHLET, 0.7
        return mod.BC_NEUMANN, 0.25
    return fn


def bc_copy(mod):
    """Dirichlet-copy at the low end (the species' dirichlet_zero form)."""
    def fn(iv, d, coords, params):
        if d == 0:
            return mod.BC_DIRICHLET_COPY, -0.3
        return mod.BC_NEUMANN, 0.25
    return fn


def test_tree_tables_equal():
    tj, tt = trees()
    assert tj.highest_lvl == tt.highest_lvl == 3
    for name in ("lvl", "ix", "parent", "children", "neighbors", "in_use"):
        np.testing.assert_array_equal(getattr(tt, name)[:tt.highest_id],
                                      getattr(tj, name)[:tj.highest_id])
    for name in ("lvl_ids", "lvl_leaves", "lvl_parents"):
        for a, b in zip(getattr(tt, name), getattr(tj, name)):
            np.testing.assert_array_equal(a, b)
    assert any(np.any(tj.neighbors[np.asarray(ids)] == -1)
               for ids in tj.lvl_ids[1:]), "no refinement boundary"


@pytest.mark.parametrize("rb", [gc.RB_MG, gc.RB_INTERP, gc.RB_INTERP_LIM,
                                gc.RB_PROLONG_COPY])
def test_ghost_fill_matches(rb):
    tj, tt = trees()
    cc = random_cc(tj, seed=1)
    mesh = MeshPlans(tt, "cpu")
    want, got = cc.copy(), torch.as_tensor(cc.copy())
    n_rb = [0, 0]
    for lvl in range(1, tj.highest_lvl + 1):
        for d, p in enumerate(gc.get_gc_plan(tj, lvl).dirs):
            n_rb[d] += len(p.rb_ids)
        want = gc.fill_ghosts_lvl(want, gc.get_gc_plan(tj, lvl), [0, 2], rb,
                                  bc(gc), {})
        tgc.fill_ghosts_lvl(got, mesh.gc(lvl), [0, 2], rb, bc(tgc), {})
    assert n_rb == [2, 2]  # low and high ends of levels 2 and 3
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)


def test_ghost_fill_extrapolating_matches():
    """mg_sides_rb with every refinement-boundary entry taking the
    extrapolating ghost (the one-dimensional form 0.75, -0.25)."""
    tj, tt = trees()
    cc = random_cc(tj, seed=6)
    mesh = MeshPlans(tt, "cpu")
    want, got = cc.copy(), torch.as_tensor(cc.copy())
    for lvl in range(1, tj.highest_lvl + 1):
        pj = gc.get_gc_plan(tj, lvl)
        em = {d: np.ones(len(p.rb_ids), bool)
              for d, p in enumerate(pj.dirs) if len(p.rb_ids)}
        want = gc.fill_ghosts_lvl(want, pj, [0, 2], gc.RB_MG, bc(gc), {},
                                  rb_extrap_mask=em)
        tgc.fill_ghosts_lvl(got, mesh.gc(lvl), [0, 2], tgc.RB_MG, bc(tgc), {},
                            rb_extrap_mask={d: torch.as_tensor(m)
                                            for d, m in em.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)


def test_restriction_matches():
    tj, tt = trees()
    cc = random_cc(tj, seed=2)
    want = pr.restrict_tree(cc.copy(), tj, [0, 1])
    got = tpr.restrict_tree(torch.as_tensor(cc.copy()),
                            MeshPlans(tt, "cpu").pr_all(), [0, 1])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("method", ["zeroth", "sparse", "linear", "limit",
                                    "linear_cons"])
def test_prolong_into_new_boxes_matches(method):
    tj, tt = trees()
    cc = random_cc(tj, seed=8)
    want, got = cc.copy(), torch.as_tensor(cc.copy())
    for lvl in range(2, tj.highest_lvl + 1):
        ids = np.asarray(tj.lvl_ids[lvl - 1])[::2]
        want = pr.prolong(want, pr.ProlongRestrictPlan(tj, ids), [0, 2],
                          method)
        tpr.prolong(got, tpr.ProlongRestrictPlan(tt, ids, "cpu"), [0, 2],
                    method)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)


def test_prolongation_of_correction_matches():
    tj, tt = trees()
    cc = random_cc(tj, seed=3)
    mesh = MeshPlans(tt, "cpu")
    for lvl in range(2, tj.highest_lvl + 1):
        want = pr.prolong(cc.copy(), pr.get_full_plan(tj, lvl), [1],
                          "linear", add=True, ivs_to=[0])
        bp = mgb.LevelBlockPlan(mesh, lvl)
        ct = torch.as_tensor(cc)
        P_f = ct[0, mesh.tb(lvl).d.ids]
        corr = ct[1, mesh.tb(lvl - 1).d.ids]
        got = mgb.prolong_add_correction(P_f, corr, bp, NC)
        np.testing.assert_allclose(got.numpy(), want[0, mesh.tb(lvl).ids],
                                   rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("bc_fn", [bc, bc_copy], ids=["dirichlet", "copy"])
def test_gc2_extend_matches(bc_fn):
    tj, tt = trees()
    assert (tpr.default_prolong_limiter(1) == pr.default_prolong_limiter(1)
            == LIMITER_MC)
    cc = random_cc(tj, seed=4)
    want_cc, got_cc = cc.copy(), torch.as_tensor(cc.copy())
    for lvl in range(1, tj.highest_lvl + 1):
        if len(tj.lvl_leaves[lvl - 1]) == 0:
            continue
        E_w, want_cc = jfl.gc2_extend(want_cc, jfl.get_gc2_plan(tj, lvl),
                                      [0, 2], bc_fn(gc), {}, LIMITER_MC)
        E_g, got_cc = tfl.gc2_extend(got_cc, tfl.Gc2LevelPlan(tt, lvl, "cpu"),
                                     [0, 2], bc_fn(tgc), {}, LIMITER_MC)
        assert E_g.shape == E_w.shape == (len(tj.lvl_leaves[lvl - 1]), 2,
                                          NC + 4)
        np.testing.assert_allclose(E_g.numpy(), E_w, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(got_cc.numpy(), want_cc, rtol=1e-13,
                               atol=1e-13)


def test_consistent_fluxes_match():
    import threading
    tj, tt = trees()
    rng = np.random.default_rng(5)
    fc = rng.standard_normal((2, 1, tj.highest_id, NC + 1))
    fm = jfl.FluidModel.__new__(jfl.FluidModel)
    fm.tree, fm._pack_tls = tj, threading.local()
    want = fm.consistent_fluxes(fc.copy(), [0, 1])
    groups = tfl.build_consistent_plan(tt, "cpu")
    assert groups, "the mesh must have coarse-fine faces"
    got = tfl.consistent_fluxes(torch.as_tensor(fc.copy()), groups, [0, 1])
    assert not np.array_equal(want, fc)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("lam", [0.0, 37.0], ids=["poisson", "helmholtz"])
def test_vcycle_and_fmg_match_jax_host(lam):
    """Three V-cycles, then an FMG cycle from that guess, each with its
    leaf residual."""
    t = make_tree(Tree)
    cc0 = setup_cc(t)
    params = {"voltage": 25.0}
    mg_h = Multigrid(t, I_PHI, I_RHS, I_TMP, make_bc(gc, 1),
                     helmholtz_lambda=lam)
    h = mg_h.fill_ghosts_phi(cc0.copy(), params)
    mg_t = TMultigrid(MeshPlans(make_tree(TTree), "cpu"), I_PHI, I_RHS,
                      make_bc(tgc, 1), helmholtz_lambda=lam)
    d = mg_t.fill_ghosts_phi(torch.as_tensor(cc0.copy()), params)
    real = t.highest_id
    residuals = []
    for _ in range(3):
        h = mg_h.fas_vcycle(h, params, set_residual=True)
        d, res_d = mg_t.vcycle(d, params)
        residuals.append(float(res_d))
        assert float(res_d) == pytest.approx(float(mg_h.max_abs_residual(h)),
                                             rel=1e-6, abs=1e-10)
    np.testing.assert_allclose(d.numpy()[I_PHI, :real], h[I_PHI, :real],
                               rtol=1e-10, atol=1e-12)
    assert residuals[-1] < residuals[0]
    h = mg_h.fas_fmg(h, params, set_residual=True, have_guess=True)
    P, R = mgb.gather_levels(mg_t, d)
    P, R = mgb.fas_fmg_blocks(mg_t, P, R, params)
    res_d = float(mgb.max_leaf_residual_blocks(mg_t, P, R))
    d = mgb.scatter_levels(mg_t, d, P, R)
    np.testing.assert_allclose(d.numpy()[I_PHI, :real], h[I_PHI, :real],
                               rtol=1e-10, atol=1e-12)
    assert res_d == pytest.approx(float(mg_h.max_abs_residual(h)), rel=1e-6,
                                  abs=1e-10)


def test_cpu_smoother_has_no_launch_counter():
    """The 1D smoother is tensor operations on any device: it is no entry
    of the kernel tables and counts no launch."""
    from afivo_streamer_tpu_torch.ops import smoother as ks
    assert all(not name.endswith("_1d") for name in ks.KERNELS)
    assert not hasattr(ks.sweep_1d, "launches")
    assert not hasattr(ks.fill_1d, "launches")


@pytest.mark.parametrize("extra", [[], EE], ids=["lfa", "ee53"])
def test_heun_substeps_from_jax_state(extra, tmp_path):
    """interop carries a 1D state across: the JAX package's mesh after an
    epoch that removed boxes replaces the port's setup mesh, with the
    energy density, its time-state copies and the energy flux under ee53;
    then both substeps of a Heun step at rtol 1e-8."""
    args = [str(DATA / "air_1d_slice.cfg"), "-ndim=1",
            f"-input_data%file={DATA / 'td_air_synthetic.txt'}"] + extra
    j = JSim(argv=args + [f"-output%name={tmp_path / 'j'}"])
    t = TSim(argv=args + [f"-output%name={tmp_path / 't'}", "-device=cpu"])
    boxes_at_setup = j.tree.highest_id
    j.run(max_steps=4)
    assert int(j.tree.in_use[:j.tree.highest_id].sum()) < boxes_at_setup
    interop.state_from_numpy(t, j.cc, j.fc, interop.tree_arrays(j.tree),
                             it=j.it, global_time=j.global_time,
                             global_dt=j.global_dt)
    for a, b in zip(j.tree.lvl_ids, t.tree.lvl_ids):
        np.testing.assert_array_equal(a, b)
    assert ("flux_energy" in t.registry.fc_names) == bool(extra)
    assert ("e_energy_2" in t.registry.cc_names) == bool(extra)
    heun_substeps_both(j, tmp_path, t)


@pytest.mark.parametrize("extra", [[], EE], ids=["lfa", "ee53"])
def test_command_line_writes_the_same_log(extra, tmp_path, capsys):
    """``python -m <package> air_1d_slice.cfg -ndim=1`` in both packages to
    0.1 ns: the _rtest.log rows at rtol 1e-8 (the printed digits, but for a
    last digit that rounds the other way)."""
    args = [str(DATA / "air_1d_slice.cfg"), "-ndim=1",
            f"-input_data%file={DATA / 'td_air_synthetic.txt'}",
            "-end_time=1e-10", "-output%dt=2e-11"] + extra
    jmain(args + [f"-output%name={tmp_path / 'j'}"])
    tmain(args + [f"-output%name={tmp_path / 't'}", "-device=cpu"])
    capsys.readouterr()
    head_j = (tmp_path / "j_rtest.log").read_text().splitlines()[0]
    head_t = (tmp_path / "t_rtest.log").read_text().splitlines()[0]
    assert head_t == head_j
    assert ("sum(e_energy)" in head_t) == bool(extra)
    rows_j = np.loadtxt(tmp_path / "j_rtest.log", skiprows=1)
    rows_t = np.loadtxt(tmp_path / "t_rtest.log", skiprows=1)
    assert rows_j.shape == rows_t.shape and rows_j.shape[0] == 6
    np.testing.assert_allclose(rows_t, rows_j, rtol=1e-8, atol=0.0)
