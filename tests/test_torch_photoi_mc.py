"""Monte-Carlo photoionization of the port (afivo_streamer_tpu_torch/
physics/photoi_mc.py and the dielectric's photon absorption) against the
JAX package's host path, on the CPU in float64.

Both packages draw the photons from the same NumPy stream
(``np.random.default_rng(|rng_seed[0]| + 1)``), with the same draws in the
same order, so the port is held at rtol 1e-8 like every other slice:

(a) the absorption function and the inverse-CDF table (get_table_air) and
    its fraction, with and without dielectrics;
(b) the vectorised locate against the JAX package's ``_locate`` (a loop
    over photons), exactly, on 2D and 3D meshes after refinement and
    derefinement epochs, for photons inside, on box faces and corners,
    outside the domain, with a target level per photon and targets above
    the highest level;
(c) runs of both packages, 20,000 photons per update every 2 steps: the
    cylindrical, 3D and 1D slices, the adaptive absorption level
    (``photoi_mc%const_dx = f``, whose level draw both consume and then
    overwrite), the cylindrical dielectric with its surfaces' photon fluxes
    with and without ``dielectric%photons_no_absorption``, and physical
    photons (``photoi_mc%physical_photons = t``), which on the committed
    slice make no photon at all: the same mesh at every epoch, dt at every
    step, cycle counts, every variable and every surface row;
(d) with physical photons the update that follows a changing epoch gets
    dt = 0 and clears the photo row until the next update, in both
    packages (ROADMAP queue C);
(e) a distribution gate the JAX package has no test for: absorption
    distances drawn through the table against the CDF integrated from the
    absorption function with scipy, by a Kolmogorov-Smirnov bound.
"""

import numpy as np
import pytest
import torch
from scipy import integrate

from afivo_streamer_tpu.core.tree import Tree as JTree, DO_REF, KEEP_REF
from afivo_streamer_tpu.core.tree import RM_REF
from afivo_streamer_tpu.physics import photoi_mc as jmc
from afivo_streamer_tpu_torch.core.levels import MeshPlans
from afivo_streamer_tpu_torch.core.tree import Tree as TTree
from afivo_streamer_tpu_torch.physics import photoi_mc as tmc
from torch_pairs import DATA, RTOL, assert_runs_agree, build_pair

torch.set_num_threads(1)

#: O2 partial pressure (bar) of the configs' air, and the table's range
P_O2 = 0.2
MAX_DIST = 2 * 16e-3
MC = ["-photoi%method=montecarlo", "-photoi%per_steps=2",
      "-photoi_mc%physical_photons=f", "-photoi_mc%num_photons=20000"]
DIELECTRIC = ["-dielectric%gamma_se_ph_highenergy=0.1",
              "-dielectric%gamma_se_ph_lowenergy=0.1"]
JAX_DIELECTRIC_USER = ["-user%module=programs/dielectric_2d/user.py"]


# --------------------------------------------------------------- (a) table
def test_absorption_function_matches_jax():
    dist = np.concatenate([[0.0, 1e-12], np.geomspace(1e-8, 1.0, 200)])
    np.testing.assert_allclose(tmc.absorption_func_air(dist, P_O2),
                               jmc.absorption_func_air(dist, P_O2),
                               rtol=1e-15, atol=0.0)


@pytest.mark.parametrize("frac_is_one", [False, True],
                         ids=["air", "dielectric"])
def test_table_matches_jax(frac_is_one):
    jt, jfrac = jmc.get_table_air(P_O2, MAX_DIST, 0.25, frac_is_one)
    tt, tfrac = tmc.get_table_air(P_O2, MAX_DIST, 0.25, frac_is_one)
    assert tfrac == jfrac and (tfrac == 1.0) == frac_is_one
    np.testing.assert_array_equal(tt.rows_cols, jt.rows_cols)
    u = np.random.default_rng(1).random(10000)
    np.testing.assert_array_equal(tt.host_col(0, u), jt.get_col(0, u))


# -------------------------------------------------------------- (b) locate
def epoch_trees(ndim):
    """The same mesh in both packages: a 16^ndim-cell level 1 of 1 mm
    boxes refined around (4.1 mm, ...) down to level 4 (level 3 in 3D),
    then a derefinement of the boxes of the highest level beyond 3 mm from
    that point, which frees ids for the next refinement around a second
    point."""
    nc = 8
    top = 4 if ndim == 2 else 3
    out = []
    for cls in (JTree, TTree):
        t = cls(ndim, nc, [16e-3] * ndim, [16] * ndim)
        for centre, passes in ((4.1e-3, top - 1), (9.7e-3, 1)):
            def flags(ids, centre=centre):
                res = []
                for b in ids:
                    b = int(b)
                    mid = t.box_r_min(np.asarray([b]))[0] + \
                        0.5 * nc * t.lvl_dr(int(t.lvl[b]))
                    d = np.linalg.norm(mid - centre)
                    if d < 4e-3 and t.lvl[b] < top:
                        f = DO_REF
                    elif t.lvl[b] == top and d > 3e-3:
                        f = RM_REF
                    else:
                        f = KEEP_REF
                    res.append(np.full((nc,) * ndim, f))
                return np.asarray(res)
            for _ in range(passes):
                t.adjust_refinement(flags)
        out.append(t)
    assert out[0].removed_ids == out[1].removed_ids
    return out


def locators(jt, tt):
    j = jmc.PhotoiMC.__new__(jmc.PhotoiMC)
    j.tree = jt
    t = tmc.PhotoiMC.__new__(tmc.PhotoiMC)
    t.tree, t.mesh = tt, MeshPlans(tt, "cpu")
    return j, t


@pytest.mark.parametrize("ndim", [2, 3])
def test_locate_matches_jax(ndim):
    jt, tt = epoch_trees(ndim)
    for a, b in zip(jt.lvl_ids, tt.lvl_ids):
        np.testing.assert_array_equal(a, b)
    j, t = locators(jt, tt)
    rng = np.random.default_rng(11)
    L = 16e-3
    inside = rng.uniform(0.0, L, size=(3000, ndim))
    # box faces and corners of every level, the domain's lower faces
    faces = []
    for lvl in range(1, tt.highest_lvl + 1):
        w = 8 * tt.lvl_dr(lvl)[0]
        grid = np.arange(0.0, L, w)
        p = rng.uniform(0.0, L, size=(200, ndim))
        p[:, 0] = rng.choice(grid, 200)
        p[100:, -1] = rng.choice(grid, 100)
        faces.append(p)
    faces.append(np.zeros((1, ndim)))
    outside = np.concatenate([
        rng.uniform(-L, 0.0, size=(50, ndim)),
        L + rng.uniform(0.0, L, size=(50, ndim)),
        np.full((1, ndim), L), np.full((1, ndim), -1e-300)])
    pos = np.concatenate([inside] + faces + [outside])
    per_photon = rng.integers(1, tt.highest_lvl + 3, size=len(pos))
    for target in (1, 2, tt.highest_lvl, 40, per_photon):
        ids_t, cells_t = t.locate(pos, target)
        ids_j, cells_j = j._locate(pos, target)
        np.testing.assert_array_equal(ids_t, ids_j)
        np.testing.assert_array_equal(cells_t, cells_j)
        assert (ids_t[-102:] == -1).all() and (ids_t[:3000] >= 0).all()
    # a deeper target finds boxes of more than one level, not only leaves
    lv = tt.lvl[ids_t[ids_t >= 0]]
    assert len(set(lv)) == tt.highest_lvl


# ------------------------------------------------------------ (c) the runs
CASES = {
    "cyl": ("air_cyl_amr_slice.cfg", 2, [], 6),
    "3d": ("air_3d_amr_slice.cfg", 3, [], 4),
    "1d": ("air_1d_slice.cfg", 1, ["-photoi%enabled=t",
                                   "-photoi%species=M_plus"], 8),
    "const-dx-f": ("air_cyl_amr_slice.cfg", 2, ["-photoi_mc%const_dx=f"], 6),
    "dielectric": ("dielectric_cyl_slice.cfg", 2, DIELECTRIC, 6),
    "dielectric-no-absorption": ("dielectric_cyl_slice.cfg", 2, DIELECTRIC
                                 + ["-dielectric%photons_no_absorption=t"],
                                 6),
    "physical-photons": ("air_cyl_amr_slice.cfg", 2,
                         ["-photoi_mc%physical_photons=t"], 6),
}


def record_updates(sim, out):
    """Record (dt, max |photo|) of every photoionization update."""
    orig = sim.photoi.set_src

    def wrapped(cc, dt=None, params=None):
        cc = orig(cc, dt, params)
        photo = cc[sim.photoi.i_photo, :sim.tree.highest_id]
        out.append((dt, float(abs(photo).max())))
        return cc
    sim.photoi.set_src = wrapped


def run_pair(tmp_path, monkeypatch, cfg, ndim, extra, steps):
    juser = JAX_DIELECTRIC_USER if "dielectric" in cfg else ()
    j, t, rec = build_pair(tmp_path, monkeypatch,
                           [str(DATA / cfg), f"-ndim={ndim}"] + extra,
                           juser=juser)
    updates = {"j": [], "t": []}
    record_updates(j, updates["j"])
    record_updates(t, updates["t"])
    j.run(max_steps=steps)
    t.run(max_steps=steps)
    assert_runs_agree(j, t, rec, steps)
    assert len(updates["t"]) == len(updates["j"]) >= 2
    for (dj, pj), (dt_, pt) in zip(updates["j"], updates["t"]):
        assert dt_ == pytest.approx(dj, rel=RTOL, abs=0.0)
        assert pt == pytest.approx(pj, rel=RTOL, abs=0.0)
    return j, t, updates["t"]


@pytest.mark.parametrize("case", list(CASES))
def test_monte_carlo_run_matches_jax(tmp_path, monkeypatch, case):
    cfg, ndim, extra, steps = CASES[case]
    j, t, updates = run_pair(tmp_path, monkeypatch, cfg, ndim, MC + extra,
                             steps)
    assert t.photoi.mc is not None and t.photoi.n_modes == 0
    photo = [p for _dt, p in updates]
    if case == "physical-photons":
        # dt * sum(rate) is 0.3 photons at the first update: none is made
        assert max(photo) == 0.0 and t.photoi.mc.n_photons == 0
        return
    assert min(photo) > 0.0
    assert abs(t.photoi.mc.n_photons / 20000 - 1) < 0.02
    if t.surfaces is not None:
        flux = t.cc[t.surfaces.i_photon, [s.id_out for s in
                                          t.surfaces.active()]]
        assert float(flux.abs().max()) > 0.0
        assert t.photoi.mc.n_deposited < t.photoi.mc.n_photons


def test_epoch_update_with_zero_dt_clears_photons(tmp_path, monkeypatch):
    """Physical photons of weight 1e-4, an update every step: the update
    after a changing epoch comes at the epoch's time, so with dt = 0 it
    makes no photon and leaves the photo row 0 until the next update."""
    _j, _t, updates = run_pair(
        tmp_path, monkeypatch, "air_cyl_amr_slice.cfg", 2,
        MC + ["-photoi_mc%physical_photons=t", "-photoi_mc%min_weight=1e-4",
              "-photoi%per_steps=1"], 6)
    zero = [p for dt, p in updates if dt == 0.0]
    assert zero and max(zero) == 0.0
    assert min(p for dt, p in updates if dt > 0.0) > 0.0


# ----------------------------------------------------- (e) distribution
def test_absorption_distances_follow_the_absorption_function():
    """N = 200,000 distances through the table (the photons' own draw)
    against F(r) = int_0^r f / int_0^R f with f the absorption function and
    R = 32 mm the table's range. The Kolmogorov-Smirnov statistic must stay
    below 1.63 / sqrt(N) = 3.64e-3, the 1 % critical value, plus 1e-3 for
    the table: 500 rows of an RK4 inverse, linear in between."""
    tbl, _frac = tmc.get_table_air(P_O2, MAX_DIST, 0.25)
    n = 200_000
    dist = np.sort(tbl.host_col(0, np.random.default_rng(12).random(n)))
    assert dist.min() >= 0.0 and dist.max() <= MAX_DIST

    def f(r):
        return float(tmc.absorption_func_air(np.asarray(r), P_O2))
    # the CDF on a grid fine near 0, where f is largest
    grid = np.concatenate([[0.0], np.geomspace(1e-7, MAX_DIST, 3000)])
    parts = [integrate.quad(f, a, b, epsabs=0.0, epsrel=1e-10)[0]
             for a, b in zip(grid[:-1], grid[1:])]
    cdf = np.concatenate([[0.0], np.cumsum(parts)])
    cdf /= cdf[-1]
    F = np.interp(dist, grid, cdf)
    emp_hi = np.arange(1, n + 1) / n
    emp_lo = np.arange(0, n) / n
    ks = max(np.abs(emp_hi - F).max(), np.abs(F - emp_lo).max())
    assert ks < 1.63 / np.sqrt(n) + 1e-3, ks
