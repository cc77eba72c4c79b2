"""Dielectrics in 1D, cylindrical coordinates and 3D, and with an electrode,
against the JAX package's host (NumPy) path, float64, on the states of the
committed slices after setup, carried into the port through interop:
air_1d_slice.cfg with a dielectric on the left (surfaces of one cell; on
24 level-1 cells for the ghosts and cycles, so that the surface lies inside
a box at a refinement boundary),
dielectric_cyl_slice.cfg (z-normal surfaces, so r varies along them),
dielectric_3d_slice.cfg (y-normal surfaces of nc^2 cells over the x and z
dimensions) and, for the operators, electrode_dielectric_cyl_slice.cfg in
Cartesian coordinates (a level with the level set and eps). Each has a
mobile positive ion, so ion impact emits secondary electrons.

* The surfaces, on random surface data (so a transposed quarter of a 3D
  face fails): discovery, charge to rhs, the field correction, both Heun
  substeps' charge update with secondary and photon emission, the
  integral, and update_after_refinement when the interface boxes of the
  finest level are refined and then derefined, at rtol 1e-12.
* LevelOp with eps in 3D and with eps plus a level set in 2D, at rtol
  1e-12: the harmonic-mean couplings, the variable-eps flags and the
  level-set rows.
* The extrapolating refinement-boundary ghosts of the variable-eps boxes
  (the one-dimensional form 0.5 pcopy + 0.75 f1 - 0.25 f2 in 1D and 3D,
  the parity-swap form in 2D) on every level, from a random potential.
* A V-cycle, then an FMG cycle, with eps from a random state, with the
  leaf residual, at rtol 1e-10.
* The plain K4/K5 against the Pallas kernels in interpret mode, and the
  plain K2 and K3-swap against the kernel bodies (K3-swap through the
  grid loop of tests/test_torch_smoother.py), on the stencil, ghost
  weights and constants of real levels: the 3D slab's variable-eps level
  and the pair's level with both the level set and eps, rtol 1e-12 of
  the result's scale.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from afivo_streamer_tpu import constants as juc
from afivo_streamer_tpu.core.tree import DO_REF, KEEP_REF, RM_REF
from afivo_streamer_tpu.driver import Simulation as JSim
from afivo_streamer_tpu.ops import pallas_smoother as ps
from afivo_streamer_tpu.solvers.multigrid import LevelOp as JLevelOp
from afivo_streamer_tpu_torch import interop
from afivo_streamer_tpu_torch.driver import Simulation as TSim
from afivo_streamer_tpu_torch.ops import smoother as ks
from afivo_streamer_tpu_torch.solvers import mg_blocks as mgb
from afivo_streamer_tpu_torch.solvers.multigrid import LevelOp as TLevelOp
from test_torch_smoother import (_grid_pallas_call, jax_call, random_inputs,
                                 torch_call)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "afivo_streamer_tpu_torch" / "data"
RTOL = 1e-12
MOBILE = ["-input_data%mobile_ions=M_plus",
          "-input_data%ion_mobilities=2.2e-4"]
DIEL_1D = ["-ndim=1", "-use_dielectric=t", "-dielectric_type=left"] + MOBILE
#: name: (config, flags, dimension normal to the interface at 4 mm)
GEOMS = {
    "1d": ("air_1d_slice.cfg", DIEL_1D, 0),
    # 24 level-1 cells: x = 4 mm lies inside a level-5 box with a
    # refinement boundary, which takes the extrapolating ghost
    "1d-rb": ("air_1d_slice.cfg", DIEL_1D + ["-coarse_grid_size=24",
                                             "-refine_max_dx=1e-3"], 0),
    "cyl": ("dielectric_cyl_slice.cfg", MOBILE, 1),
    "3d": ("dielectric_3d_slice.cfg", ["-ndim=3"], 1),
    "pair": ("electrode_dielectric_cyl_slice.cfg",
             ["-cylindrical=f"] + MOBILE, 1),
}
SURFACE_GEOMS = ["1d", "cyl", "3d"]
_SIMS = {}


def sims(geom, tmp_path_factory):
    """The JAX simulation after setup and a port simulation of the same
    configuration, built once per geometry."""
    if geom not in _SIMS:
        cfg, extra, _ = GEOMS[geom]
        out = tmp_path_factory.mktemp(geom)
        base = [str(DATA / cfg), "-ndim=2",
                f"-input_data%file={DATA / 'td_air_synthetic.txt'}"] + extra
        j = JSim(argv=base + [
            f"-user%module={ROOT / 'programs' / 'dielectric_2d'}/user.py",
            f"-output%name={out / 'j'}"])
        t = TSim(argv=base + [
            f"-user%module={DATA.parent / 'programs'}/dielectric_2d.py",
            f"-output%name={out / 't'}", "-device=cpu"])
        _SIMS[geom] = (j, t)
    return _SIMS[geom]


@pytest.fixture
def pair(request, tmp_path_factory):
    """(JAX simulation, copies of its cc and fc, the port loaded from
    them) with random surface data."""
    j, t = sims(request.param, tmp_path_factory)
    rng = np.random.default_rng(11)
    for s in j.surfaces.surfaces:
        s.sd[:] = rng.standard_normal(s.sd.shape) * 1e-6
    cc, fc = j.cc.copy(), j.fc.copy()
    interop.state_from_numpy(t, cc, fc, interop.tree_arrays(j.tree),
                             it=j.it, global_time=j.global_time,
                             global_dt=j.global_dt, surfaces=j.surfaces)
    return j, cc, fc, t


def close(got, want, rtol=RTOL):
    scale = float(np.max(np.abs(want))) if np.size(want) else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def assert_surfaces_equal(jsf, t):
    got = interop.surface_data(t)
    want = {s.id_out: s.sd for s in jsf.active()}
    assert got.keys() == want.keys() and len(want) > 0
    for k in want:
        close(got[k], want[k])


# ---------------------------------------------------------------------------
# surfaces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pair", SURFACE_GEOMS, indirect=True)
def test_surface_discovery_matches(pair):
    j, _, _, t = pair
    key = [(s.in_use, s.id_in, s.id_out, s.direction, s.eps)
           for s in j.surfaces.surfaces]
    own = [(s.in_use, s.id_in, s.id_out, s.direction, s.eps)
           for s in t.surfaces.surfaces]
    assert own == key and sum(k[0] for k in key) > 0
    assert t.surfaces.face_cells == j.surfaces.face_cells == \
        t.tree.nc ** (t.ndim - 1)
    fresh_j = j.surfaces.__class__(
        j.tree, lambda b: np.asarray(j.cc[j.i_eps, b]),
        j.surfaces.n_variables)
    fresh_t = t.surfaces.__class__(
        t.tree, t.cc[t.i_eps, :t.tree.highest_id].numpy(), t.i_surf_photon,
        t.i_surf_sigma, t.dt_cfg.num_steps + 1)
    assert ([(s.id_in, s.id_out, s.direction, s.eps)
             for s in fresh_t.surfaces]
            == [(s.id_in, s.id_out, s.direction, s.eps)
                for s in fresh_j.surfaces])
    np.testing.assert_array_equal(t.surfaces.refinement_links(),
                                  j.surfaces.refinement_links())


@pytest.mark.parametrize("pair", SURFACE_GEOMS, indirect=True)
def test_surface_charge_rhs_field_and_integral_match(pair):
    j, cc, fc, t = pair
    fac = -juc.elem_charge / juc.eps0
    n = j.tree.highest_id
    want = j.surfaces.charge_to_rhs(cc.copy(), 1, j.i_rhs, fac)
    got = t.surfaces.charge_to_rhs(t.cc.clone(), t.i_rhs, fac)
    close(got[t.i_rhs, :n].numpy(), want[j.i_rhs, :n])
    want_fc = j.surfaces.correct_field_fc(cc, fc.copy(), 1, j.fc_E,
                                          j.i_phi, -fac)
    got_fc = t.surfaces.correct_field_fc(t.cc, t.fc.clone(), t.fc_E,
                                         t.i_phi, -fac)
    close(got_fc[t.fc_E, :, :n].numpy(), want_fc[j.fc_E, :, :n])
    for k in range(t.surfaces.n_sigma):
        assert t.surfaces.get_integral(t.cc, k) == pytest.approx(
            j.surfaces.get_integral(1 + k), rel=RTOL)


@pytest.mark.parametrize("pair", SURFACE_GEOMS, indirect=True)
def test_surface_charge_update_matches(pair):
    """Both Heun substeps' surface updates (with ion secondary emission),
    then photon emission, on random face fluxes and fields."""
    j, cc, fc, t = pair
    rng = np.random.default_rng(12)
    fc = rng.standard_normal(fc.shape) * 1e20
    fc[j.fc_E] = rng.standard_normal(fc[j.fc_E].shape) * 1e6
    n = j.tree.highest_id
    t.fc[:, :, :n] = torch.as_tensor(fc[:, :, :n])
    jd = j.dielectric
    for s_prev, w_prev, s_out in (([0], [1.0], 1), ([0, 1], [0.5, 0.5], 0)):
        cc = jd.update_surface_charge(cc, fc, 1e-12, s_prev, w_prev, s_out,
                                      jd.flux_species_charge,
                                      jd.flux_pos_ion)
        cc = jd.photon_emission(cc, fc, 1e-12, s_out)
        t.dielectric.update_surface_charge(t.cc, t.fc, 1e-12, s_prev,
                                           w_prev, s_out)
        t.dielectric.photon_emission(t.cc, t.fc, 1e-12, s_out)
        close(t.cc[t.i_electron + s_out, :n].numpy(),
              cc[j.i_electron + s_out, :n])
        assert_surfaces_equal(j.surfaces, t)
    assert jd.gamma_se_ion > 0 and len(jd.flux_pos_ion)


# ---------------------------------------------------------------------------
# the variable-eps operator, ghosts, cycles and kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pair", ["3d", "pair"], indirect=True)
def test_level_op_matches_jax(pair):
    j, _, _, t = pair
    n_eps = n_lsf = 0
    for lvl in range(1, t.tree.highest_lvl + 1):
        a = JLevelOp(j.tree, lvl, 0.0, j.field.lsf_data, j._eps_level_data)
        b = TLevelOp(t.tree, lvl, 0.0, t._eps_level_data(lvl),
                     t.field.lsf_data)
        close(b.c0 + np.zeros_like(a.c0), a.c0)
        for d in range(2 * t.ndim):
            close(b.c_nb[d] + np.zeros_like(a.c_nb[d]), a.c_nb[d])
        np.testing.assert_array_equal(b.veps, a.veps)
        n_eps += int(a.veps.any())
        assert (b.f is None) == (a.f is None)
        if a.f is not None:
            n_lsf += 1
            close(b.f, np.asarray(a.f).reshape(b.f.shape))
            close(b.bc_coeff, np.asarray(a.bc_coeff).reshape(b.f.shape))
    assert n_eps > 0 and (n_lsf > 0) == (t.field.lsf_data is not None)


def random_phi(j, seed=5):
    cc = j.cc.copy()
    rng = np.random.default_rng(seed)
    cc[j.i_phi] = 100.0 * rng.random(cc.shape[1:])
    cc[j.i_rhs] = 1e9 * rng.standard_normal(cc.shape[1:])
    return cc


@pytest.mark.parametrize("pair", ["1d-rb", "cyl", "3d"], indirect=True)
def test_extrapolating_ghosts_match_jax(pair):
    """The potential's ghosts on every level from a random potential: the
    variable-eps boxes at a refinement boundary take the extrapolating
    ghost (in 1D and 3D the one-dimensional form)."""
    j, _, _, t = pair
    cc = random_phi(j)
    params = {"voltage": j.field.current_voltage}
    want = j.field.mg.fill_ghosts_phi(cc.copy(), params)
    got = t.field.mg.fill_ghosts_phi(torch.as_tensor(cc.copy()), params)
    n = j.tree.highest_id
    use = j.tree.in_use[:n]
    close(got[t.i_phi, :n].numpy()[use], want[j.i_phi, :n][use])
    n_extrap = sum(int(m.sum()) for l in range(1, t.tree.highest_lvl + 1)
                   for m in (t.field.mg.rb_extrap(l) or {}).values())
    assert n_extrap > 0
    if t.ndim != 2:
        assert not any(t.field.mg.smoother(l).has_swap
                       for l in range(1, t.tree.highest_lvl + 1))


@pytest.mark.parametrize("pair", ["1d-rb", "cyl", "3d"], indirect=True)
def test_cycles_with_eps_match_jax(pair):
    j, _, _, t = pair
    params = {"voltage": j.field.current_voltage}
    mg_h, mg_t = j.field.mg, t.field.mg
    cc0 = random_phi(j)
    h = mg_h.fill_ghosts_phi(cc0.copy(), params)
    d = mg_t.fill_ghosts_phi(torch.as_tensor(cc0.copy()), params)
    P, R = mgb.gather_levels(mg_t, d)
    n = j.tree.highest_id
    use = j.tree.in_use[:n]

    def check(what):
        got = mgb.scatter_levels(mg_t, d, P, R).numpy()[t.i_phi, :n]
        want = h[j.i_phi, :n]
        np.testing.assert_allclose(got[use], want[use], rtol=1e-10,
                                   atol=1e-10 * np.abs(want[use]).max(),
                                   err_msg=what)
        res_h = float(mg_h.max_abs_residual(h))
        res_t = float(mgb.max_leaf_residual_blocks(mg_t, P, R, params))
        assert res_t == pytest.approx(res_h, rel=1e-6)
        return res_h

    res0 = check("ghost fill")
    h = mg_h.fas_vcycle(h, params, set_residual=True)
    P, R = mgb.fas_vcycle_blocks(mg_t, P, R, params)
    res1 = check("V-cycle")
    h = mg_h.fas_fmg(h, params, set_residual=True, have_guess=True)
    P, R = mgb.fas_fmg_blocks(mg_t, P, R, params)
    res2 = check("FMG cycle")
    assert res2 < res1 < res0


def real_level_inputs(t, lvl, seed):
    """Kernel inputs on six boxes of a real level of ``t`` with the most
    extrapolating ghost entries: the level's stencil, ghost weights and
    ghost constants (from a random potential), random blocks and rhs of
    the level's scale and a random neighbor table."""
    mg = t.field.mg
    sm = mg.smoother(lvl)
    W = sm.W(torch.float64).numpy()
    extrap = np.zeros(sm.n, np.int64)
    for d in range(2 * t.ndim):
        if sm.rb_extrap[d] is not None:
            np.add.at(extrap, sm.rb_pos[d][sm.rb_extrap[d]].numpy(), 1)
    rows = np.argsort(-extrap, kind="stable")[:6]
    assert (extrap[rows] > 0).sum() >= 2 and mg.op(lvl).veps[rows].any()
    P, _ = mgb.gather_levels(mg, t.cc)
    A = mgb.build_A_blocks(mg, lvl, P[lvl - 2] if lvl > 1 else None,
                           {"voltage": t.field.current_voltage},
                           torch.float64).numpy()
    ndim = t.ndim
    x = random_inputs(seed=seed, n=len(rows), ndim=ndim)
    x["cs"] = mg.cs(lvl, torch.float64).numpy()[rows]
    x["W"] = W[rows]
    scale = float(np.abs(A[rows]).max()) or 1.0
    x["A"] = A[rows]
    x["phi3"] = x["phi3"] * scale
    x["R"] = x["R"] * scale * float(np.abs(x["cs"][:, 0]).max())
    return x


@pytest.mark.parametrize("pair, name", [
    ("3d", "sweep_3d"), ("3d", "fill_3d"), ("pair", "sweep_2d"),
    ("pair", "fill_2d_swap")], indirect=["pair"])
def test_plain_kernels_match_pallas_on_eps_levels(pair, name, monkeypatch):
    j, _, _, t = pair
    mg = t.field.mg
    if t.ndim == 3:
        lvl = max(l for l in range(1, t.tree.highest_lvl + 1)
                  if mg.rb_extrap(l))
    else:
        lvl = max(l for l in range(1, t.tree.highest_lvl + 1)
                  if mg.smoother(l).has_swap and mg.op(l).f is not None)
    x = real_level_inputs(t, lvl, seed=21)
    if name == "fill_2d_swap":
        monkeypatch.setattr(ps.pl, "pallas_call", _grid_pallas_call)
    want = jax_call(name, x)
    got = torch_call(ks.KERNELS[name], x).numpy()
    np.testing.assert_allclose(got, want, rtol=0.0,
                               atol=RTOL * np.abs(want).max())


# ---------------------------------------------------------------------------
# refinement (last: it changes the shared meshes)
# ---------------------------------------------------------------------------
def touches_interface(tree, b, dim) -> bool:
    lo = tree.box_r_min(np.asarray([int(b)]))[0][dim]
    hi = lo + tree.nc * tree.lvl_dr(int(tree.lvl[int(b)]))[dim]
    return lo <= 4e-3 <= hi


def interface_flags(tree, lvl, action, dim):
    """Flags that refine (DO) the boxes of level ``lvl`` touching the
    interface, or derefine (RM) the boxes of level ``lvl`` whose parent
    touches it; keep the rest."""
    def fn(ids):
        out = np.full((len(ids),) + (tree.nc,) * tree.ndim, KEEP_REF,
                      np.int64)
        for n, b in enumerate(ids):
            probe = b if action == DO_REF else tree.parent[int(b)]
            if tree.lvl[int(b)] == lvl and touches_interface(tree, probe,
                                                             dim):
                out[n] = action
        return out
    return fn


@pytest.mark.parametrize("pair", SURFACE_GEOMS, indirect=True)
def test_surfaces_follow_refinement(pair, request):
    """update_after_refinement: the interface boxes of the finest level
    are refined (the parents' surfaces prolonged onto the children) and
    then derefined again (restricted back); the surfaces' state equal at
    every stage, on random data."""
    j, _, _, t = pair
    dim = GEOMS[request.node.callspec.params["pair"]][2]
    top = max(int(j.tree.lvl[b]) for b in j.tree.all_leaves
              if touches_interface(j.tree, b, dim))
    active = sorted(s.id_out for s in j.surfaces.active())
    for lvl, action in ((top, DO_REF), (top + 1, RM_REF)):
        infos = []
        for sim in (j, t):
            info = sim.tree.adjust_refinement(
                interface_flags(sim.tree, lvl, action, dim), ref_buffer=0,
                ref_links=sim.surfaces.refinement_links())
            infos.append(info)
        assert infos[0].added == infos[1].added
        assert infos[0].removed == infos[1].removed
        assert infos[0].n_add + infos[0].n_rm > 0
        n_before = len(j.surfaces.surfaces)
        j.surfaces.update_after_refinement(infos[0])
        t._sync_capacity()
        t.surfaces.update_after_refinement(t.cc, infos[1])
        if t.ndim == 1 and action == DO_REF:
            # the JAX package moves no 1D surface data (ROADMAP queue C):
            # its children start at zero, the port's copy the parent
            for s in j.surfaces.surfaces[n_before:]:
                assert not s.sd.any()
                s.sd[:] = j.surfaces.surfaces[s.ix_parent].sd
        assert_surfaces_equal(j.surfaces, t)
        now = sorted(s.id_out for s in j.surfaces.active())
        assert now != active
        active = now
