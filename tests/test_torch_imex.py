"""The IMEX integrators on the port: the stiff reaction-diffusion problem of
tests/test_imex.py (afivo_streamer_tpu_torch/programs/reaction_diffusion.py:
u_t = D lap(u) - a u on a uniform 32 x 32-cell mesh, dt about 8 times the
explicit diffusion limit) through physics/advance.advance with the port's
Multigrid as the implicit Helmholtz solver, on the CPU, float64.

* The three tests of tests/test_imex.py with their bounds: imex_euler
  stable and first order (error below 0.05, halving dt takes it below 0.65
  of itself), imex_trapezoidal second order (below 0.15 of imex_euler's
  error and below 5e-4), and the ValueError without an implicit solver,
  also from the driver.
* One step of each scheme against the JAX package's host path from the
  same state, both stopping the FMG cycles of each implicit solve when the
  max leaf residual is below 1e-8 of the max leaf rhs (the port's
  criterion; the JAX test takes all boxes): u at rtol 1e-10 of its scale
  and the same FMG count per implicit solve.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from afivo_streamer_tpu.physics import advance as jadv
from afivo_streamer_tpu.solvers.multigrid import Multigrid as JMultigrid
from afivo_streamer_tpu_torch.driver import Simulation as TSim
from afivo_streamer_tpu_torch.physics import advance as adv
from afivo_streamer_tpu_torch.programs import reaction_diffusion as rd
import test_imex as jt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-10


def run(integrator, dt, n_steps):
    prob = rd.ReactionDiffusion(16, 2, device="cpu")
    return prob.run(integrator, dt, n_steps)


def test_imex_euler_stable_and_first_order():
    err = run("imex_euler", 2.0e-3, 10)
    assert np.isfinite(err) and err < 0.05, err
    err2 = run("imex_euler", 1.0e-3, 20)
    assert err2 < 0.65 * err, (err, err2)


def test_imex_trapezoidal_second_order():
    err = run("imex_trapezoidal", 2.0e-3, 10)
    err_e = run("imex_euler", 2.0e-3, 10)
    assert err < 0.15 * err_e, (err, err_e)
    assert err < 5.0e-4, err


def test_imex_requires_implicit_solver(tmp_path):
    with pytest.raises(ValueError, match="implicit_solver"):
        adv.advance(None, None, 1e-3, 0.0, "imex_euler",
                    lambda *a: (None, None, 1.0, {}))
    # the streamer driver has no implicit part, as in the JAX package
    cfg = ROOT / "afivo_streamer_tpu_torch" / "data" / "air_cyl_slice.cfg"
    with pytest.raises(ValueError, match="implicit_solver"):
        TSim(argv=[str(cfg), "-device=cpu", "-time_integrator=imex_euler",
                   f"-output%name={tmp_path / 'r'}"])


def jax_step(integrator, dt):
    """One step in the JAX package (tests/test_imex.py's problem) with the
    port's stop criterion; returns the state and the FMG counts."""
    t, cc, allids = jt._setup()
    itr = jt._interior(t)
    nc = t.nc
    leaves = np.asarray(t.lvl_leaves[t.highest_lvl - 1])
    mgs, counts = {}, []
    pos = {int(b): i for i, b in enumerate(allids)}

    def laplacian(cc, iv):
        out = np.zeros((len(allids), nc * nc))
        for lvl in range(1, t.highest_lvl + 1):
            ids = np.asarray(t.lvl_ids[lvl - 1])
            dx = float(t.lvl_dr(lvl)[0])
            B = cc[iv, ids].reshape(len(ids), nc + 2, nc + 2)
            lap = (B[:, 2:, 1:-1] + B[:, :-2, 1:-1] + B[:, 1:-1, 2:]
                   + B[:, 1:-1, :-2] - 4.0 * B[:, 1:-1, 1:-1]) / dx**2
            out[np.array([pos[int(b)] for b in ids])] = \
                lap.reshape(len(ids), -1)
        return out

    def substep(cc, fc, dt_s, dt_lim, time, s_deriv, s_prev, w_prev,
                s_out, i_step, n_steps, params):
        dt_stiff = params["dt_stiff"]
        acc = 0.0
        for s, w in zip(s_prev, w_prev):
            acc = acc + w * cc[jt.I_U + s][allids[:, None], itr[None, :]]
        du = dt_s * -jt.A * cc[jt.I_U + s_deriv][allids[:, None],
                                                 itr[None, :]]
        if dt_stiff != 0.0:
            for lvl in range(1, t.highest_lvl + 1):
                cc = jt.gc.fill_ghosts_lvl(cc, jt.gc.get_gc_plan(t, lvl),
                                           [jt.I_U + s_deriv],
                                           jt.gc.RB_INTERP, jt._bc_zero, {})
            du = du + dt_stiff * jt.D * laplacian(cc, jt.I_U + s_deriv)
        cc[jt.I_U + s_out, allids[:, None], itr[None, :]] = acc + du
        return cc, fc, 1.0, {}

    def implicit_solver(cc, fc, dt_stiff, time, s_prev, w_prev, s_out,
                        params):
        lam = 1.0 / (dt_stiff * jt.D)
        if lam not in mgs:
            mgs[lam] = JMultigrid(t, jt.I_PHI, jt.I_RHS, jt.I_TMP,
                                  jt._bc_zero, helmholtz_lambda=lam)
        mg = mgs[lam]
        acc = 0.0
        for s, w in zip(s_prev, w_prev):
            acc = acc + w * cc[jt.I_U + s][allids[:, None], itr[None, :]]
        cc[jt.I_RHS, allids[:, None], itr[None, :]] = -lam * acc
        cc[jt.I_PHI, allids] = cc[jt.I_U + s_out, allids]
        cc = mg.fill_ghosts_phi(cc, {})
        rhs_max = float(np.max(np.abs(
            cc[jt.I_RHS, leaves[:, None], itr[None, :]])))
        for n in range(1, 11):
            cc = mg.fas_fmg(cc, {}, set_residual=True, have_guess=True)
            res = float(np.max(np.abs(
                cc[jt.I_TMP, leaves[:, None], itr[None, :]])))
            if res < 1e-8 * max(rhs_max, 1e-30):
                break
        counts.append(n)
        cc[jt.I_U + s_out, allids] = cc[jt.I_PHI, allids]
        return cc, fc

    cc, _, _, _, _ = jadv.advance(cc, None, dt, 0.0, integrator, substep,
                                  implicit_solver=implicit_solver)
    return t, cc, counts


@pytest.mark.parametrize("integrator", ["imex_euler", "imex_trapezoidal"])
def test_one_step_matches_jax(integrator):
    t, jcc, jcounts = jax_step(integrator, 2.0e-3)
    prob = rd.ReactionDiffusion(16, 2, device="cpu")
    ids = prob.ids.numpy()
    np.testing.assert_array_equal(ids, np.concatenate(
        [np.asarray(x) for x in t.lvl_ids]))
    np.testing.assert_array_equal(prob.cc[rd.I_U, prob.ids].numpy(),
                                  jt._setup()[1][rd.I_U, ids])
    prob.run(integrator, 2.0e-3, 1)
    assert prob.fmg_cycles == jcounts and len(jcounts) == 1
    for s in range(3):
        want = jcc[rd.I_U + s, ids]
        np.testing.assert_allclose(prob.cc[rd.I_U + s, prob.ids].numpy(),
                                   want, rtol=RTOL,
                                   atol=RTOL * float(np.abs(want).max()))
