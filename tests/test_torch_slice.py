"""The slices end to end: the committed configs at -refine_max_dx=5e-4,
afivo_streamer_tpu_torch/data/air_cyl_slice.cfg (a uniform 32 x 32-cell
cylindrical mesh, 20 boxes) and air_3d_slice.cfg (a uniform 32^3-cell
Cartesian mesh, 72 boxes), in the JAX package (host NumPy path) and in
the port (CPU, plain smoother kernels), float64. With live refinement:
dielectric_2d_slice.cfg (a dielectric slab, 52,480 cells on 6 levels) for
8 steps, with an epoch that removes boxes, and air_cyl_slice.cfg with the
alpha*dx criterion and seed refinement on (11,392 cells on 6 levels) for
6 steps; the same mesh at every refinement epoch. With Helmholtz
photoionization (updated every 2 steps and after a changing epoch):
air_cyl_amr_slice.cfg (16,960 cells on 6 levels, an epoch that removes
64 boxes), the same in Cartesian 2D, and air_3d_amr_slice.cfg in 3D
(an epoch that removes boxes); the same FMG cycle count of every
Helmholtz mode at every update. The fluid-model variants the same way:
the planar 1D slice air_1d_slice.cfg (144 cells on 5 levels, an epoch that
removes boxes, 16 steps) under the local field approximation and under the
electron energy equation (ee53, the new-style table); air_cyl_ee_slice.cfg
(ee53 with live refinement and photoionization); the frozen 3D slice under
ee53; and air_cyl_amr_slice.cfg with the source factor and with a plasma
region. Every live case also holds dt at every attempted step.

Tolerance rtol 1e-8 on every cc variable, with an absolute floor of 1e-8
times the variable's largest magnitude (the FAS rhs of parent boxes is a
difference of large terms), on dt and on the _rtest.log rows.
The 5-step run also covers Cartesian coordinates, a mobile ion, the
Dirichlet species boundary with RK4, and an 8-species reaction list.
Measured worst deviations on the CPU, relative to each variable's
largest magnitude: 5 steps 1.0e-15 (Cartesian 6.3e-16, mobile ion
6.3e-16, Dirichlet/RK4 7.9e-16, reaction list 5.2e-16; dt and the rtest
rows identical); the Heun substep pair from the JAX state 7.9e-16; one
field solve 8.7e-16. In 3D: 5 steps 2.9e-15 (dt and the rtest rows
identical), the Heun substep pair from the JAX state 2.6e-15, one field
solve 2.1e-15.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from afivo_streamer_tpu.driver import Simulation as JSim
from afivo_streamer_tpu_torch.driver import Simulation as TSim
from afivo_streamer_tpu_torch import interop
from test_torch_physics import REACTIONS

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "afivo_streamer_tpu_torch" / "data"
RTOL = 1e-8
#: config and box count of each dimension's slice at -refine_max_dx=5e-4
SLICES = {2: ("air_cyl_slice.cfg", 20), 3: ("air_3d_slice.cfg", 72)}


def argv(out, ndim=2):
    return [str(DATA / SLICES[ndim][0]), f"-ndim={ndim}",
            "-refine_max_dx=5e-4",
            f"-input_data%file={DATA / 'td_air_synthetic.txt'}",
            "-output%dt=5e-14", f"-output%name={out}"]


def assert_state_close(jcc, tcc, skip=()):
    """Every cc variable (except ``skip``) of the real boxes, rtol RTOL
    with an absolute floor of RTOL times the variable's scale; returns
    the worst scaled deviation."""
    n = jcc.shape[1]
    worst = 0.0
    for iv in range(jcc.shape[0]):
        if iv in skip:
            continue
        a, b = jcc[iv], tcc[iv, :n]
        scale = float(np.max(np.abs(a)))
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=RTOL * scale,
                                   err_msg=f"cc variable {iv}")
        if scale > 0:
            worst = max(worst, float(np.max(np.abs(b - a))) / scale)
    return worst


@pytest.fixture(scope="module")
def jax_after_two_steps(tmp_path_factory):
    sim = JSim(argv=argv(tmp_path_factory.mktemp("j") / "run"))
    sim.run(max_steps=2)
    return sim


@pytest.fixture(scope="module")
def jax_3d_after_two_steps(tmp_path_factory):
    sim = JSim(argv=argv(tmp_path_factory.mktemp("j3") / "run", ndim=3))
    sim.run(max_steps=2)
    return sim


def port_from(jsim, tmp_path):
    sim = TSim(argv=argv(tmp_path / "t", jsim.ndim) + ["-device=cpu"])
    interop.state_from_numpy(sim, jsim.cc, jsim.fc,
                             interop.tree_arrays(jsim.tree), it=jsim.it,
                             global_time=jsim.global_time,
                             global_dt=jsim.global_dt)
    return sim


@pytest.mark.parametrize("ndim, extra", [
    (2, []),
    (2, ["-cylindrical=f"]),
    (2, ["-input_data%mobile_ions=M_plus",
         "-input_data%ion_mobilities=2.2e-4"]),
    (2, ["-species_boundary_condition=dirichlet_zero",
         "-time_integrator=rk4"]),
    (3, []),
], ids=["cyl", "xyz", "cyl-mobile-ions", "cyl-dirichlet-rk4", "xyz3d"])
def test_slice_five_steps_matches_jax(tmp_path, ndim, extra):
    five_steps_both(tmp_path, extra, ndim)


def test_slice_reaction_list_matches_jax(tmp_path):
    """The slice with the 8-species reaction list of
    tests/test_torch_physics.py appended to the table."""
    td = tmp_path / "td_with_reactions.txt"
    td.write_text((DATA / "td_air_synthetic.txt").read_text() + REACTIONS)
    five_steps_both(tmp_path, [f"-input_data%file={td}"])


def five_steps_both(tmp_path, extra, ndim=2):
    j = JSim(argv=argv(tmp_path / "j", ndim) + extra)
    t = TSim(argv=argv(tmp_path / "t", ndim) + extra + ["-device=cpu"])
    real = j.tree.highest_id
    assert t.tree.highest_id == real == SLICES[ndim][1]
    # the prolongation limiter of the refinement-boundary ghosts of the
    # fluid step: MC in 2D, gminmod43 in 3D
    assert t.fluid.prolong_limiter == j.fluid.prolong_limiter
    assert_state_close(j.cc[:, :real], t.cc.numpy(), skip={j.i_tmp})
    j.run(max_steps=5)
    t.run(max_steps=5)
    assert t.global_dt == pytest.approx(j.global_dt, rel=RTOL)
    assert t.global_time == pytest.approx(j.global_time, rel=RTOL)
    assert_state_close(j.cc[:, :real], t.cc.numpy(), skip={j.i_tmp})
    rows_j = np.loadtxt(tmp_path / "j_rtest.log", skiprows=1)
    rows_t = np.loadtxt(tmp_path / "t_rtest.log", skiprows=1)
    assert rows_j.shape == rows_t.shape and rows_j.shape[0] >= 3
    np.testing.assert_allclose(rows_t, rows_j, rtol=RTOL, atol=0.0)


def test_heun_substeps_from_jax_state(jax_after_two_steps, tmp_path):
    """Both substeps of a Heun step (the second includes a field solve),
    started through interop from the JAX package's state."""
    heun_substeps_both(jax_after_two_steps, tmp_path)


def test_heun_substeps_from_jax_state_3d(jax_3d_after_two_steps, tmp_path):
    """The same in 3D: interop carries the 3D state (fc [n_fc, 3, boxes,
    9^3])."""
    heun_substeps_both(jax_3d_after_two_steps, tmp_path)


def heun_substeps_both(j, tmp_path, t=None):
    """Both substeps in both packages from the state of ``j``; ``t`` is the
    port's simulation holding that state (built from the slice's
    configuration when not given)."""
    t = t or port_from(j, tmp_path)
    n = j.tree.highest_id
    assert t.fc.shape[1] == j.ndim and t.fc.shape[3] == (j.tree.nc + 1) ** j.ndim
    np.testing.assert_array_equal(interop.state_to_numpy(t)["cc"][:, :n],
                                  j.cc[:, :n])
    dt, time = 1e-13, j.global_time
    params = {"voltage": j.field.current_voltage}
    jcc, jfc = j.cc.copy(), j.fc.copy()
    tcc, tfc = t.cc, t.fc
    for args in ((0, [0], [1.0], 1, 1), (1, [0, 1], [0.5, 0.5], 0, 2)):
        s_deriv, s_prev, w_prev, s_out, i_step = args
        step_time = time + (dt if i_step == 2 else 0.0)
        step_dt = dt if i_step == 1 else 0.5 * dt
        jcc, jfc, jlim, _ = j.fluid.forward_euler(
            jcc, jfc, step_dt, None, step_time, s_deriv, s_prev, w_prev,
            s_out, i_step, 2, params)
        tcc, tfc, tlim, _ = t.fluid.forward_euler(
            tcc, tfc, step_dt, None, step_time, s_deriv, s_prev, w_prev,
            s_out, i_step, 2, params)
        assert float(tlim) == pytest.approx(float(jlim), rel=RTOL)
        assert_state_close(jcc[:, :n], tcc.numpy(), skip={j.i_tmp})
        np.testing.assert_allclose(tfc.numpy()[:, :, :n], jfc[:, :, :n],
                                   rtol=RTOL,
                                   atol=RTOL * float(np.abs(jfc).max()))


def test_field_solve_from_jax_state(jax_after_two_steps, tmp_path):
    field_solve_both(jax_after_two_steps, tmp_path)


def test_field_solve_from_jax_state_3d(jax_3d_after_two_steps, tmp_path):
    field_solve_both(jax_3d_after_two_steps, tmp_path)


def field_solve_both(j, tmp_path):
    t = port_from(j, tmp_path)
    n = j.tree.highest_id
    jcc, jfc = j.field.compute(j.cc.copy(), j.fc.copy(), 0, j.global_time,
                               True)
    tcc, tfc = t.field.compute(t.cc, t.fc, 0, t.global_time, True)
    assert_state_close(jcc[:, :n], tcc.numpy(), skip={j.i_tmp})
    f = j.fc_E
    np.testing.assert_allclose(tfc.numpy()[f, :, :n], jfc[f, :, :n],
                               rtol=RTOL,
                               atol=RTOL * float(np.abs(jfc[f]).max()))


def record_epochs(sim, out):
    """Record the level id lists and the change counts after each
    refinement epoch of ``sim``."""
    orig = sim.adjust_refinement

    def wrapped(*args, **kwargs):
        info = orig(*args, **kwargs)
        out.append(([np.array(x) for x in sim.tree.lvl_ids], info.n_add,
                    info.n_rm))
        return info
    sim.adjust_refinement = wrapped


def record_photoi(jsim, tsim, out):
    """Record the FMG cycle count of every Helmholtz mode at every
    photoionization update of both packages."""
    counts = [0] * len(jsim.photoi.mgs)

    def counted(n, fmg):
        def wrapped(*args, **kwargs):
            counts[n] += 1
            return fmg(*args, **kwargs)
        return wrapped
    for n, mg in enumerate(jsim.photoi.mgs):
        mg.fas_fmg = counted(n, mg.fas_fmg)
    j_set, t_set = jsim.photoi.set_src, tsim.photoi.set_src

    def j_wrapped(*args, **kwargs):
        counts[:] = [0] * len(counts)
        cc = j_set(*args, **kwargs)
        out["j"].append((jsim.it, list(counts)))
        return cc

    def t_wrapped(*args, **kwargs):
        cc = t_set(*args, **kwargs)
        out["t"].append((tsim.it, list(tsim.photoi.fmg_cycles)))
        return cc
    jsim.photoi.set_src, tsim.photoi.set_src = j_wrapped, t_wrapped


def record_dts(sim, out):
    """Record dt of every attempted step of ``sim`` (rejected ones too)."""
    orig = sim._substep

    def wrapped(cc, fc, dt, dt_lim, time, s_deriv, s_prev, w_prev, s_out,
                i_step, n_steps, params):
        if i_step == 1:
            out.append(dt)
        return orig(cc, fc, dt, dt_lim, time, s_deriv, s_prev, w_prev, s_out,
                    i_step, n_steps, params)
    sim._substep = wrapped


PHOTOI = ["-photoi%per_steps=2"]
#: the electron energy equation on the new-style table
EE = ["-model%type=ee53", "-input_data%old_style=f",
      f"-input_data%file={DATA / 'td_air_synthetic_new.txt'}"]


@pytest.mark.parametrize("cfg, extra, steps", [
    ("dielectric_2d_slice.cfg", [], 8),
    ("air_cyl_slice.cfg", ["-refine_max_dx=2.5e-4", "-refine_min_dx=3e-5",
                           "-refine_adx=1", "-refine_init_time=1e-8"], 6),
    ("air_cyl_amr_slice.cfg", PHOTOI, 8),
    ("air_cyl_amr_slice.cfg", PHOTOI + ["-cylindrical=f"], 8),
    ("air_3d_amr_slice.cfg", PHOTOI + ["-ndim=3"], 6),
    ("air_1d_slice.cfg", ["-ndim=1"], 16),
    ("air_1d_slice.cfg", ["-ndim=1"] + EE, 16),
    ("air_cyl_ee_slice.cfg", PHOTOI + EE, 8),
    ("air_cyl_ee_slice.cfg", PHOTOI + EE + ["-cylindrical=f"], 6),
    ("air_3d_slice.cfg", ["-ndim=3", "-refine_max_dx=5e-4"] + EE, 5),
    ("air_cyl_amr_slice.cfg", PHOTOI + [
        "-fixes%source_factor=flux", "-fixes%write_source_factor=t"], 8),
    ("air_cyl_amr_slice.cfg", PHOTOI + [
        "-plasma_region_enabled=t", "-plasma_region_rmin=0 0.0135",
        "-plasma_region_rmax=0.002 0.0155"], 8),
], ids=["dielectric", "cyl-live-amr", "cyl-live-amr-photoi", "cart2d-photoi",
        "3d-live-amr-photoi", "1d-lfa", "1d-ee53", "cyl-ee53-photoi",
        "cart2d-ee53-photoi", "3d-ee53", "cyl-source-factor",
        "cyl-plasma-region"])
def test_live_refinement_slice_matches_jax(tmp_path, cfg, extra, steps):
    """The same mesh at setup and after every refinement epoch, then the
    state (densities, phi, E, surface charge, and with photoionization the
    source and every Helmholtz mode), dt and the _rtest.log rows at rtol
    1e-8; with photoionization also the same FMG cycle counts per mode at
    every update, and an epoch that changes the mesh."""
    base = [str(DATA / cfg), "-ndim=2",
            f"-input_data%file={DATA / 'td_air_synthetic.txt'}",
            "-output%dt=5e-14"] + extra
    user = {"j": [], "t": []}
    if cfg.startswith("dielectric"):
        user = {"j": [f"-user%module={ROOT / 'programs' / 'dielectric_2d'}"
                      "/user.py"],
                "t": [f"-user%module={DATA.parent / 'programs'}"
                      "/dielectric_2d.py"]}
    j = JSim(argv=base + user["j"] + [f"-output%name={tmp_path / 'j'}"])
    t = TSim(argv=base + user["t"] + [f"-output%name={tmp_path / 't'}",
                                      "-device=cpu"])
    for a, b in zip(j.tree.lvl_ids, t.tree.lvl_ids):
        np.testing.assert_array_equal(a, b)
    epochs = {"j": [], "t": []}
    record_epochs(j, epochs["j"])
    record_epochs(t, epochs["t"])
    dts = {"j": [], "t": []}
    record_dts(j, dts["j"])
    record_dts(t, dts["t"])
    updates = {"j": [], "t": []}
    if t.photoi.enabled:
        assert t.registry.cc_names == j.registry.cc_names
        assert t.photoi.i_modes == j.photoi.i_modes
        record_photoi(j, t, updates)
    j.run(max_steps=steps)
    t.run(max_steps=steps)
    if t.photoi.enabled:
        assert any(a + r for _m, a, r in epochs["j"]), "no epoch changed"
        # every 2 steps and once more after each changing epoch
        assert len(updates["j"]) >= steps // 2 + 1
        assert updates["t"] == updates["j"]
        assert t._photoi_prev_time == j._photoi_prev_time
    if cfg.startswith("air_1d"):
        assert any(a + r for _m, a, r in epochs["j"]), "no epoch changed"
    assert len(epochs["t"]) == len(epochs["j"]) == steps // 2
    assert len(dts["t"]) == len(dts["j"]) >= steps
    np.testing.assert_allclose(dts["t"], dts["j"], rtol=RTOL, atol=0.0)
    if "-model%type=ee53" in extra:
        assert t.registry.cc_names == j.registry.cc_names
        assert "e_energy" in t.chem.species_list
        assert t.dt_limits[3] < 1e99
        np.testing.assert_allclose(t.dt_limits, j.dt_limits, rtol=RTOL)
    for (mj, aj, rj), (mt, at, rt) in zip(epochs["j"], epochs["t"]):
        assert (at, rt) == (aj, rj) and len(mt) == len(mj)
        for a, b in zip(mj, mt):
            np.testing.assert_array_equal(a, b)
    if cfg.startswith("dielectric"):
        assert any(a + r for _m, a, r in epochs["j"]), "no epoch changed"
        got = interop.surface_data(t)
        want = {s.id_out: s.sd for s in j.surfaces.active()}
        assert got.keys() == want.keys() and len(want) == 25
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                       atol=RTOL * float(np.abs(
                                           want[k]).max()))
    assert t.global_dt == pytest.approx(j.global_dt, rel=RTOL)
    assert t.global_time == pytest.approx(j.global_time, rel=RTOL)
    n = j.tree.highest_id
    use = j.tree.in_use[:n]
    skip = {j.i_tmp}
    if t.surfaces is not None:
        skip |= set(t.surfaces.state_vars)  # compared per surface above
    assert_state_close(j.cc[:, :n][:, use], t.cc.numpy()[:, :n][:, use],
                       skip=skip)
    rows_j = np.loadtxt(tmp_path / "j_rtest.log", skiprows=1)
    rows_t = np.loadtxt(tmp_path / "t_rtest.log", skiprows=1)
    assert rows_j.shape == rows_t.shape and rows_j.shape[0] >= 3
    np.testing.assert_allclose(rows_t, rows_j, rtol=RTOL, atol=0.0)
