"""Helmholtz photoionization of the port (afivo_streamer_tpu_torch, CPU,
plain smoother kernels, float64) against the JAX package's host (NumPy)
path.

(a) The Helmholtz multigrid alone: one block V-cycle, one FMG cycle with
    the current phi as the guess and the leaf residual against the host
    ``Multigrid(..., helmh_bc, helmholtz_lambda=lambda^2)``, rtol 1e-10,
    on a 16 mm domain with 1 mm level-1 cells refined over one corner
    (four times in 2D, down to dx = 6.25e-5 m; twice in 3D), in 2D
    cylindrical, 2D Cartesian and 3D, for the smallest and the largest
    Bourdon-3 lambda at 1 bar and 20 % O2 (829.57 and 13351.134 1/m):
    lambda^2 dx^2 runs from 2.7e-3 on the finest 2D level to 178 on
    level 1. Solvers of different modes on one mesh share no cached table,
    and the level-1 solve with lambda > 0 is exact without any projection.
(b) The Luque, Bourdon-2, Bourdon-3 and custom coefficient sets and the
    constructor's error cases.
(c) One source update from a JAX state carried over through interop, for
    the Zheleznyak source (also with a tight residual limit, which takes
    several FMG cycles) and for the excited-species source: rhs, photo,
    every Helmholtz mode and the FMG cycle count of every mode, rtol 1e-8.
(d) Both Heun substeps from a state with a photoionization source.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from afivo_streamer_tpu.core.tree import Tree, DO_REF, KEEP_REF
from afivo_streamer_tpu.core.batch import BoxBatch
from afivo_streamer_tpu.driver import Simulation as JSim
from afivo_streamer_tpu.physics.photoi import helmh_bc as j_helmh_bc
from afivo_streamer_tpu.solvers.multigrid import Multigrid

from afivo_streamer_tpu_torch import interop
from afivo_streamer_tpu_torch.core import ghostcell as tgc
from afivo_streamer_tpu_torch.core.levels import MeshPlans
from afivo_streamer_tpu_torch.core.tree import Tree as TTree
from afivo_streamer_tpu_torch.driver import Simulation as TSim
from afivo_streamer_tpu_torch.physics.photoi import helmh_bc as t_helmh_bc
from afivo_streamer_tpu_torch.solvers import mg_blocks as mgb
from afivo_streamer_tpu_torch.solvers.multigrid import Multigrid as TMultigrid
from test_torch_physics import REACTIONS
from test_torch_slice import assert_state_close, heun_substeps_both

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "afivo_streamer_tpu_torch" / "data"
I_PHI, I_RHS, I_TMP = 0, 1, 2
NC = 8
DOMAIN = 16e-3
#: smallest and largest Bourdon-3 lambda times 0.2 (O2 fraction) x 1 bar
LAMBDAS = {"lambda-min": 4147.85 * 0.2, "lambda-max": 66755.67 * 0.2}


# ------------------------------------------------ (a) Helmholtz multigrid
def make_tree(cls, coord, n_ref=None):
    """Level 1 16^ndim cells of 1 mm, refined n_ref times over the corner
    r < 0.2 x the domain."""
    ndim = 3 if coord == "xyz3d" else 2
    n_ref = n_ref if n_ref is not None else (2 if ndim == 3 else 4)
    t = cls(ndim, NC, [DOMAIN] * ndim, [16] * ndim,
            coord="cyl" if coord == "cyl" else "xyz")

    def flags(ids):
        out = np.full([len(ids)] + [NC] * ndim, KEEP_REF, np.int64)
        for n, b in enumerate(ids):
            r0 = t.box_r_min(np.asarray([int(b)]))[0]
            if np.all(r0 < 0.2 * DOMAIN) and t.lvl[int(b)] == t.highest_lvl:
                out[n] = DO_REF
        return out

    for _ in range(n_ref):
        t.adjust_refinement(flags, ref_buffer=1)
    return t


def setup_cc(t, seed=5):
    """A source blob (rhs >= 0, as a photoionization source) and a small
    random guess for phi, ghost cells included."""
    cc = np.array(BoxBatch(t, 3, 0).cc)
    cc = np.concatenate([cc, np.zeros((3, 8, cc.shape[2]))], axis=1)
    rng = np.random.default_rng(seed)
    for lvl in range(1, t.highest_lvl + 1):
        for b in t.lvl_ids[lvl - 1]:
            r = t.cell_coords(int(b))
            d2 = np.sum((r - 0.15 * DOMAIN) ** 2, axis=-1)
            cc[I_RHS, int(b)] = (1e24 * np.exp(-d2 / (1e-3) ** 2)).ravel()
    cc[I_PHI] = rng.random(cc.shape[1:]) * 1e10
    return cc


def bcs(ndim):
    return (lambda iv, d, c, p: j_helmh_bc(iv, d, c, p, ndim),
            lambda iv, d, c, p: t_helmh_bc(iv, d, c, p, ndim))


@pytest.mark.parametrize("lam", list(LAMBDAS.values()), ids=list(LAMBDAS))
@pytest.mark.parametrize("coord", ["cyl", "xyz", "xyz3d"])
def test_helmholtz_cycles_match_jax_host(coord, lam):
    t = make_tree(Tree, coord)
    j_bc, t_bc = bcs(t.ndim)
    cc0 = setup_cc(t)
    real = t.highest_id
    dx = t.lvl_dr(t.highest_lvl)[0]
    assert t.highest_lvl == (3 if t.ndim == 3 else 5)
    if t.ndim == 2:
        assert 2e-3 < LAMBDAS["lambda-min"] ** 2 * dx ** 2 < 3e-3
    assert 170 < LAMBDAS["lambda-max"] ** 2 * t.lvl_dr(1)[0] ** 2 < 180

    mg_h = Multigrid(t, I_PHI, I_RHS, I_TMP, j_bc, helmholtz_lambda=lam ** 2)
    mg_t = TMultigrid(MeshPlans(make_tree(TTree, coord), "cpu"), I_PHI,
                      I_RHS, t_bc, helmholtz_lambda=lam ** 2)
    h = mg_h.fill_ghosts_phi(cc0.copy(), {})
    d = mg_t.fill_ghosts_phi(torch.as_tensor(cc0.copy()), {})

    def check(h, d, res_d):
        np.testing.assert_allclose(
            d.numpy()[I_PHI, :real], h[I_PHI, :real], rtol=1e-10,
            atol=1e-10 * float(np.abs(h[I_PHI, :real]).max()))
        assert float(res_d) == pytest.approx(
            float(mg_h.max_abs_residual(h)), rel=1e-10)

    # the leaf residual of the guess, one V-cycle, one FMG cycle
    P, R = mgb.gather_levels(mg_t, d)
    check(h, d, mgb.max_leaf_residual_blocks(mg_t, P, R))
    h = mg_h.fas_vcycle(h, {}, set_residual=True)
    d, res_d = mg_t.vcycle(d, {})
    check(h, d, res_d)
    h = mg_h.fas_fmg(h, {}, set_residual=True, have_guess=True)
    P, R = mgb.gather_levels(mg_t, d)
    P, R = mgb.fas_fmg_blocks(mg_t, P, R, {})
    res_d = mgb.max_leaf_residual_blocks(mg_t, P, R)
    d = mgb.scatter_levels(mg_t, d, P, R)
    check(h, d, res_d)


@pytest.mark.parametrize("coord", ["cyl", "xyz3d"])
def test_modes_share_no_tables(coord):
    """A field solver (lambda = 0, a voltage on the last high face) and
    two Helmholtz modes on one mesh: each V-cycle gives, bit for bit, what
    a solver alone on its own mesh gives, whatever was solved before."""
    t = make_tree(TTree, coord, n_ref=2)
    _, h_bc = bcs(t.ndim)

    def f_bc(iv, d, coords, params):
        if d // 2 == t.ndim - 1:
            return tgc.BC_DIRICHLET, params.get("voltage", 0.0) * (d % 2)
        return h_bc(iv, d, coords, params)

    cc0 = np.concatenate([setup_cc(t), np.zeros((2,) + setup_cc(t).shape[1:])])
    cc0[3:5] = cc0[I_PHI]
    specs = [(I_PHI, f_bc, 0.0), (3, h_bc, LAMBDAS["lambda-min"] ** 2),
             (4, h_bc, LAMBDAS["lambda-max"] ** 2)]
    params = {"voltage": 3e4}

    def solve(mesh, spec, cc):
        iv, bc, lam2 = spec
        mg = TMultigrid(mesh, iv, I_RHS, bc, helmholtz_lambda=lam2)
        cc = mg.fill_ghosts_phi(cc, params)
        return mg.vcycle(cc, params)[0], mg

    shared = MeshPlans(t, "cpu")
    cc, mgs = torch.as_tensor(cc0.copy()), []
    for spec in specs:
        cc, mg = solve(shared, spec, cc)
        mgs.append(mg)
    for a in range(3):
        for b in range(a + 1, 3):
            assert mgs[a].coarse_solver() is not mgs[b].coarse_solver()
            assert not np.array_equal(mgs[a].coarse_solver().A_inv,
                                      mgs[b].coarse_solver().A_inv)
            assert mgs[a].smoother(2) is not mgs[b].smoother(2)
            assert not torch.equal(mgs[a].cs(2, cc.dtype),
                                   mgs[b].cs(2, cc.dtype))
    for spec in specs:
        # the rhs of the parents is overwritten by every cycle (FAS), and
        # every cycle overwrites it before it reads it
        alone, _ = solve(MeshPlans(make_tree(TTree, coord, n_ref=2), "cpu"),
                         spec, torch.as_tensor(cc0.copy()))
        assert torch.equal(alone[spec[0]], cc[spec[0]])


@pytest.mark.parametrize("coord", ["cyl", "xyz", "xyz3d"])
def test_level1_helmholtz_solve_is_exact(coord):
    """lambda > 0 with Dirichlet faces is non-singular: on a one-level mesh
    a cycle is the dense level-1 solve, which leaves a residual at roundoff
    and a solution with a non-zero mean (no null-space projection)."""
    t = make_tree(TTree, coord, n_ref=0)
    _, t_bc = bcs(t.ndim)
    mg = TMultigrid(MeshPlans(t, "cpu"), I_PHI, I_RHS, t_bc,
                    helmholtz_lambda=LAMBDAS["lambda-min"] ** 2)
    cc = torch.as_tensor(setup_cc(t))
    cc, res = mg.vcycle(mg.fill_ghosts_phi(cc, {}), {})
    assert float(res) < 1e-12 * float(cc[I_RHS].abs().max())
    inner = cc[I_PHI, :t.highest_id].reshape((-1,) + (NC + 2,) * t.ndim)[
        (slice(None),) + (slice(1, NC + 1),) * t.ndim]
    assert float(inner.max()) < 0.0 and float(inner.mean()) < -1e12


# ------------------------------------------ (b) coefficient sets, errors
def sim_argv(out, *extra, cfg="air_cyl_amr_slice.cfg", td=None):
    return [str(DATA / cfg), "-ndim=2", "-refine_max_dx=5e-4",
            "-refine_min_dx=2e-4",
            f"-input_data%file={td or DATA / 'td_air_synthetic.txt'}",
            "-output%dt=5e-14", f"-output%name={out}", *extra]


@pytest.mark.parametrize("extra, n_modes", [
    (["-photoi_helmh%author=Luque", "-photoi%eta=1.0"], 2),
    (["-photoi_helmh%author=Bourdon-2"], 2),
    ([], 3),
    (["-photoi_helmh%author=custom", "-photoi_helmh%lambdas=5e3 2e4 9e4 3e5",
      "-photoi_helmh%coeffs=1e6 3e7 2e9 1e10", "-gas%pressure=0.5"], 4),
], ids=["Luque", "Bourdon-2", "Bourdon-3", "custom"])
def test_coefficient_sets_match_jax(tmp_path, extra, n_modes):
    j = JSim(argv=sim_argv(tmp_path / "j", *extra))
    t = TSim(argv=sim_argv(tmp_path / "t", "-device=cpu", *extra))
    jp, tp = j.photoi, t.photoi
    assert tp.n_modes == jp.n_modes == n_modes
    np.testing.assert_array_equal(tp.lambdas, jp.lambdas)
    np.testing.assert_array_equal(tp.coeffs, jp.coeffs)
    assert [mg.lam for mg in tp.mgs] == [mg.lam for mg in jp.mgs]
    assert t.registry.cc_names == j.registry.cc_names
    assert (tp.i_photo, tp.i_modes) == (jp.i_photo, jp.i_modes)
    assert tp.species_cc == jp.species_cc == t.i_1pos_ion
    assert t.fluid.idx.i_photo == j.fluid.idx.i_photo
    assert t.fluid.idx.photoi_species_cc == j.fluid.idx.photoi_species_cc
    for iv in [tp.i_photo] + tp.i_modes:
        mt, mj = t.registry.methods[iv], j.registry.methods[iv]
        assert (mt["rb"], mt["prolong"]) == (mj["rb"], mj["prolong"])
        for d in range(4):
            assert mt["bc"](iv, d, None, {}) == mj["bc"](iv, d, None, {})
    for key in ("per_steps", "eta", "quenching_pressure", "source_type",
                "max_rel_residual", "photoe_enabled", "photoe_per_steps"):
        assert getattr(tp, key) == getattr(jp, key)


@pytest.mark.parametrize("extra, message", [
    (["-photoi%eta=1.5"], "eta out of range"),
    (["-photoi%species=O2_plus"], "species not present"),
    (["-photoi_helmh%author=Luque"], "eta should be 1.0"),
    (["-photoi_helmh%author=custom"], "lambdas missing"),
    (["-photoi_helmh%author=Nobody"], "Unknown photoi_helmh author"),
    (["-gas%components=N2 Ar", "-gas%fractions=0.8 0.2"],
     "no oxygen present"),
], ids=["eta", "species", "luque-eta", "custom-empty", "author", "no-oxygen"])
def test_constructor_errors_match_jax(tmp_path, extra, message):
    with pytest.raises(ValueError, match=message):
        JSim(argv=sim_argv(tmp_path / "j", *extra))
    with pytest.raises(ValueError, match=message):
        TSim(argv=sim_argv(tmp_path / "t", "-device=cpu", *extra))


# ------------------------------------------------- (c) one source update
def port_from(jsim, args):
    sim = TSim(argv=args + ["-device=cpu"])
    interop.state_from_numpy(sim, jsim.cc, jsim.fc,
                             interop.tree_arrays(jsim.tree), it=jsim.it,
                             global_time=jsim.global_time,
                             global_dt=jsim.global_dt,
                             photoi_prev_time=jsim._photoi_prev_time)
    return sim


def count_fmg(jsim):
    counts = [0] * len(jsim.photoi.mgs)
    for n, mg in enumerate(jsim.photoi.mgs):
        def wrapped(*args, _n=n, _fmg=mg.fas_fmg, **kwargs):
            counts[_n] += 1
            return _fmg(*args, **kwargs)
        mg.fas_fmg = wrapped
    return counts


@pytest.mark.parametrize("extra, min_cycles", [
    ([], 1),
    (["-photoi_helmh%max_rel_residual=1e-7"], 2),
    (["-photoi%source_type=from_species", "-photoi%excited_species=A",
      "-photoi%photoemission_time=2e-13"], 1),
], ids=["Zheleznyak", "Zheleznyak-tight", "from_species"])
def test_set_src_from_jax_state(tmp_path, extra, min_cycles):
    td = tmp_path / "td_with_reactions.txt"
    td.write_text((DATA / "td_air_synthetic.txt").read_text() + REACTIONS)
    args = sim_argv(tmp_path / "run", "-refine_max_dx=2.5e-4",
                    "-refine_min_dx=3e-5", "-photoi%per_steps=2", *extra,
                    td=td)
    j = JSim(argv=args)
    j.run(max_steps=3)
    assert j._photoi_prev_time > 0.0 and j.tree.highest_lvl == 6
    if "from_species" in " ".join(extra):
        # the excited species starts empty: give it a density
        rng = np.random.default_rng(17)
        j.cc[j.photoi.i_excited_cc] = rng.random(j.cc.shape[1:]) * 1e16
    t = port_from(j, args)
    assert t._photoi_prev_time == j._photoi_prev_time
    assert t.photoi.i_excited_cc == j.photoi.i_excited_cc
    assert interop.state_to_numpy(t)["photoi_prev_time"] == \
        j._photoi_prev_time
    counts = count_fmg(j)
    dt = j.global_time - j._photoi_prev_time
    params = {"voltage": j.field.current_voltage}
    jcc = j.photoi.set_src(j.cc.copy(), dt, params)
    tcc = t.photoi.set_src(t.cc, dt, params)
    assert t.photoi.fmg_cycles == counts
    assert max(counts) >= min_cycles and max(counts) < 10
    n = j.tree.highest_id
    use = j.tree.in_use[:n]
    worst = assert_state_close(jcc[:, :n][:, use], tcc.numpy()[:, :n][:, use],
                               skip={j.i_tmp})
    assert worst < 1e-8
    assert float(np.abs(jcc[j.photoi.i_photo]).max()) > 1e15
    for iv in j.photoi.i_modes:
        assert float(np.abs(jcc[iv]).max()) > 0.0


# ------------------------------ (d) the substeps with a photoi source
def test_heun_substeps_with_photo_source(tmp_path):
    args = sim_argv(tmp_path / "run", "-refine_max_dx=2.5e-4",
                    "-refine_min_dx=3e-5", "-photoi%per_steps=2")
    j = JSim(argv=args)
    j.run(max_steps=3)
    n = j.tree.highest_id
    assert float(np.abs(j.cc[j.photoi.i_photo, :n]).max()) > 1e15
    heun_substeps_both(j, tmp_path, port_from(j, args))
    # the source matters: without it the ion density differs
    t = port_from(j, args)
    t.cc[t.photoi.i_photo] = 0.0
    params = {"voltage": j.field.current_voltage}
    jcc, *_ = j.fluid.forward_euler(j.cc.copy(), j.fc.copy(), 1e-13, None,
                                    j.global_time, 0, [0], [1.0], 1, 1, 2,
                                    params)
    tcc, *_ = t.fluid.forward_euler(t.cc, t.fc, 1e-13, None, t.global_time,
                                    0, [0], [1.0], 1, 1, 2, params)
    ion = t.photoi.species_cc + 1
    assert not np.allclose(tcc.numpy()[ion, :n], jcc[ion, :n], rtol=1e-8,
                           atol=0.0)
