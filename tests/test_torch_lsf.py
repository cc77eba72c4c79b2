"""The port's level-set (electrode) machinery against the JAX package, on
the CPU in float64.

* ``LsfData.level_data`` (dd, has_bnd, lsf_cc, bc_coeff) and
  ``lsf_stencil_coefficients`` on every level of a mesh refined twice
  around the electrode (2D; once in 3D), for the six electrode shapes of
  physics/field.py (built by both packages' FieldSolver from the same
  flags; ``user`` through ``set_user_lsf`` with a boundary function), in
  Cartesian 2D, cylindrical and 3D coordinates, with the ``gss`` and the
  ``linear`` distance: rtol 1e-12. The rod's radius (0.4 mm) is below the
  spacing of levels 1 and 2 (1 and 0.5 mm), so those levels take the
  gradient-descent search; one test holds that this search, and not the
  axis search, found boundary cells there.
* ``LevelOp`` with a level set, and with a permittivity and a level set
  together: c0, the neighbor coefficients, c_sum, f and bc_coeff at rtol
  1e-12; ``box_has_boundary`` for ids of mixed levels.
* The two analytic checks of tests/test_lsf.py on the port: a planar
  electrode is solved exactly (1D, 2D, 2D refined) with the corrected
  field at its surface, and a disk electrode follows ln r.
* One V-cycle, one FMG cycle and the leaf residual with phi_b != 0 against
  the JAX host multigrid: rtol 1e-10 (atol 1e-10 of phi's scale).
* The plain K1, K2 and K4 against the Pallas kernels in interpret mode on
  the stencil blocks of boxes that hold the electrode boundary (neighbor
  coefficients 0 toward the electrode and up to 1e4 times the plain ones
  beside it) with the boundary term in R: 1e-12 of the block's scale.
"""

import numpy as np
import pytest
import torch

from afivo_streamer_tpu.core import ghostcell as gc
from afivo_streamer_tpu.core.batch import BoxBatch
from afivo_streamer_tpu.core.tree import DO_REF, KEEP_REF, Tree
from afivo_streamer_tpu.physics.field import FieldSolver as JField
from afivo_streamer_tpu.physics.streamer import StreamerSettings as JSettings
from afivo_streamer_tpu.solvers import lsf as jlsf
from afivo_streamer_tpu.solvers.multigrid import LevelOp as JLevelOp
from afivo_streamer_tpu.solvers.multigrid import Multigrid
from afivo_streamer_tpu.utils.config import CFG as JCFG

from afivo_streamer_tpu_torch.core import ghostcell as tgc
from afivo_streamer_tpu_torch.core import spatial as tsp
from afivo_streamer_tpu_torch.core.levels import MeshPlans
from afivo_streamer_tpu_torch.core.tree import Tree as TTree
from afivo_streamer_tpu_torch.ops import smoother as ks
from afivo_streamer_tpu_torch.physics.field import FieldSolver as TField
from afivo_streamer_tpu_torch.physics.streamer import \
    StreamerSettings as TSettings
from afivo_streamer_tpu_torch.solvers import lsf as tlsf
from afivo_streamer_tpu_torch.solvers import mg_blocks as mgb
from afivo_streamer_tpu_torch.solvers.multigrid import LevelOp as TLevelOp
from afivo_streamer_tpu_torch.solvers.multigrid import Multigrid as TMultigrid
from afivo_streamer_tpu_torch.utils.config import CFG as TCFG
from test_torch_smoother import jax_call, random_inputs, torch_call

torch.set_num_threads(1)

I_PHI, I_RHS, I_TMP, I_EPS = 0, 1, 2, 3
NC = 8
L = 16e-3
RTOL = 1e-12
SHAPES = ("sphere", "rod", "rod_rod", "rod_cone_top",
          "two_rod_cone_electrodes", "user")
GEOMETRIES = {"xyz": (2, "xyz"), "cyl": (2, "cyl"), "xyz3d": (3, "xyz")}


def electrode_flags(shape, geom):
    """Flags of a needle (and for the two-electrode shapes a second,
    grounded one from the bottom plate) on the axis of the domain."""
    ndim, coord = GEOMETRIES[geom]
    x = "0.0" if coord == "cyl" else "0.5"
    mid = " ".join([x] * (ndim - 1))
    return [f"-cylindrical={'t' if coord == 'cyl' else 'f'}",
            "-field_given_by=field -1.8e6", "-use_electrode=t",
            f"-field_electrode_type={shape}",
            f"-field_rod_r0={mid} 1.0", f"-field_rod_r1={mid} 0.85",
            "-field_rod_radius=4e-4", f"-field_rod2_r0={mid} 0.0",
            f"-field_rod2_r1={mid} 0.1", "-field_rod2_radius=6e-4",
            "-field_electrode2_grounded=t", "-cone_tip_radius=1e-4",
            "-cone_length_frac=0.3", "-cone2_tip_radius=2e-4",
            "-cone2_length_frac=0.3"]


def user_lsf(ndim):
    """A user electrode: an ellipsoid hanging from the top plate, its
    potential varying along its surface."""
    centre = np.array([0.0] * (ndim - 1) + [L])
    axes = np.array([4e-4] * (ndim - 1) + [2.4e-3])

    def lsf(r):
        return (np.linalg.norm((r - centre) / axes, axis=-1) - 1.0) * 4e-4

    def lsf_bc(r):
        return 2.0e4 + 1.0e6 * r[..., -1]
    return lsf, lsf_bc


def refined_tree(cls, geom, n_ref=None):
    """Level 1 of 16^ndim cells of 1 mm, refined where a box comes within
    1.5 mm of the domain's axis in its upper 4 mm or lower 3 mm (where the
    electrodes are): twice in 2D, once in 3D."""
    ndim, coord = GEOMETRIES[geom]
    t = cls(ndim, NC, [L] * ndim, [16] * ndim, coord=coord)
    x_axis = 0.0 if coord == "cyl" else 0.5 * L

    def flags(ids):
        out = np.full([len(ids)] + [NC] * ndim, KEEP_REF, np.int64)
        for n, b in enumerate(ids):
            lo = t.box_r_min(np.asarray([int(b)]))[0]
            hi = lo + NC * t.lvl_dr(int(t.lvl[int(b)]))
            near = all(lo[k] - 1.5e-3 <= x_axis <= hi[k] + 1.5e-3
                       for k in range(ndim - 1))
            if near and (hi[-1] > L - 4e-3 or lo[-1] < 3e-3) \
                    and t.lvl[int(b)] == t.highest_lvl:
                out[n] = DO_REF
        return out

    for _ in range(n_ref or (1 if ndim == 3 else 2)):
        t.adjust_refinement(flags, ref_buffer=1)
    return t


def both_lsf(shape, geom, dist_mode="gss"):
    """The two packages' LsfData of one electrode shape on equal meshes."""
    ndim, _ = GEOMETRIES[geom]
    flags = electrode_flags(shape, geom)
    jt, tt = refined_tree(Tree, geom), refined_tree(TTree, geom)
    for a, b in zip(jt.lvl_ids, tt.lvl_ids):
        np.testing.assert_array_equal(a, b)
    jcfg, tcfg = JCFG(), TCFG()
    jcfg.update_from_arguments(flags)
    tcfg.update_from_arguments(flags)
    jf = JField(jcfg, jt, JSettings(jcfg, ndim), None, I_PHI, I_RHS, I_TMP,
                3, 0, [], [])
    tf = TField(tcfg, MeshPlans(tt, "cpu"), TSettings(tcfg, ndim), I_PHI,
                I_RHS, 3, 0, [], [])
    if shape == "user":
        jf.set_user_lsf(*user_lsf(ndim))
        tf.set_user_lsf(*user_lsf(ndim))
    jf.lsf_data.dist_mode = tf.lsf_data.dist_mode = dist_mode
    return jf, tf


@pytest.mark.parametrize("geom", list(GEOMETRIES))
@pytest.mark.parametrize("shape", SHAPES)
def test_level_data_and_stencil_match_jax(shape, geom):
    for mode in ("gss", "linear"):
        jf, tf = both_lsf(shape, geom, mode)
        jd, td = jf.lsf_data, tf.lsf_data
        assert td.length_scale == jd.length_scale == 4e-4
        some_bnd = 0
        for lvl in range(1, jf.tree.highest_lvl + 1):
            a, b = jd.level_data(lvl), td.level_data(lvl)
            np.testing.assert_array_equal(b["ids"], a["ids"])
            np.testing.assert_array_equal(b["has_bnd"], a["has_bnd"])
            for key in ("dd", "lsf_cc", "bc_coeff"):
                np.testing.assert_allclose(b[key], a[key], rtol=RTOL,
                                           atol=0.0, err_msg=f"{key} {lvl}")
            some_bnd += int(a["has_bnd"].sum())
            want = jlsf.lsf_stencil_coefficients(jf.tree, lvl, a, 0.0)
            got = tlsf.lsf_stencil_coefficients(tf.tree, lvl, b, 0.0)
            for x, y in zip([want[0], *want[1], want[2]],
                            [got[0], *got[1], got[2]]):
                np.testing.assert_allclose(y, x, rtol=RTOL, atol=0.0)
        assert some_bnd > 0
        if shape in ("rod_rod", "two_rod_cone_electrodes", "user"):
            # two potentials (or a varying one) on the boundary
            assert len(np.unique(td.level_data(1)["bc_coeff"])) > 1


def test_thin_electrode_takes_the_gradient_descent_search():
    """On the 1 mm cells of level 1 the 0.4 mm rod crosses no cell-to-cell
    segment along an axis for some cells near it: only the gradient-descent
    search (min_dr > length_scale) finds their boundary distance. Without
    it (length_scale = 1e100) the same cells have none."""
    jf, tf = both_lsf("rod", "xyz")
    with_search = tf.lsf_data.level_data(1)
    plain = tlsf.LsfData(tf.mesh, tf.lsf_data.lsf).level_data(1)
    found = (with_search["dd"] < 1).any(axis=2)
    by_axes = (plain["dd"] < 1).any(axis=2)
    assert (found & ~by_axes).sum() > 0 and not (by_axes & ~found).any()
    # those distances are scaled by the step length over the spacing
    only = found & ~by_axes
    want = jf.lsf_data.level_data(1)["dd"]
    np.testing.assert_allclose(with_search["dd"][only], want[only],
                               rtol=RTOL, atol=0.0)
    # on a level finer than the rod the search is not made
    assert float(tf.tree.lvl_dr(3).min()) < tf.lsf_data.length_scale


def eps_blocks(tree, y_if=0.3 * L, e1=2.0):
    """lvl -> permittivity blocks [n, (nc+2)^ndim]: e1 below y_if."""
    def data(lvl):
        return np.stack([np.where(tree.cell_coords(int(b))[..., -1] < y_if,
                                  e1, 1.0).ravel()
                         for b in tree.lvl_ids[lvl - 1]])
    return data


@pytest.mark.parametrize("geom, with_eps", [
    ("xyz", False), ("cyl", False), ("xyz3d", False), ("xyz", True),
    ("cyl", True)])
def test_level_op_with_level_set_matches_jax(geom, with_eps):
    jf, tf = both_lsf("rod_rod", geom)
    nd = 2 * jf.tree.ndim
    for lvl in range(1, jf.tree.highest_lvl + 1):
        je = eps_blocks(jf.tree) if with_eps else None
        a = JLevelOp(jf.tree, lvl, 0.0, jf.lsf_data, je)
        b = TLevelOp(tf.tree, lvl, 0.0,
                     eps_blocks(tf.tree)(lvl) if with_eps else None,
                     tf.lsf_data)
        assert a.f is not None and b.f is not None
        n = len(jf.tree.lvl_ids[lvl - 1])
        shape = (n,) + (NC,) * jf.tree.ndim
        for x, y in zip([a.c0, a.c_sum, a.f, a.bc_coeff, *a.c_nb],
                        [b.c0, b.c_sum, b.f, b.bc_coeff, *b.c_nb]):
            np.testing.assert_allclose(np.broadcast_to(y, shape),
                                       np.broadcast_to(x, shape), rtol=RTOL,
                                       atol=0.0)
        # on a boundary box c_sum is not -lambda; elsewhere it is
        bnd = tf.lsf_data.level_data(lvl)["has_bnd"]
        c_sum = np.broadcast_to(b.c_sum, shape)
        scale = np.abs(np.broadcast_to(b.c0, shape)).max()
        assert np.abs(c_sum[bnd]).max() > 1e-3 * scale
        if (~bnd).any():
            assert np.abs(c_sum[~bnd]).max() < 1e-9 * scale
        assert len(b.c_nb) == nd
        if with_eps:
            np.testing.assert_array_equal(b.veps, a.veps)


def test_box_has_boundary_for_ids_of_mixed_levels():
    jf, tf = both_lsf("rod_cone_top", "cyl")
    rng = np.random.default_rng(4)
    ids = rng.permutation(np.concatenate(
        [np.asarray(x) for x in tf.tree.lvl_ids]))
    got = tf.lsf_data.box_has_boundary(ids)
    np.testing.assert_array_equal(got, jf.lsf_data.box_has_boundary(ids))
    assert got.any() and not got.all()
    assert len(tf.lsf_data.box_has_boundary(np.zeros(0, np.int64))) == 0


def test_level_data_is_recomputed_only_where_boxes_changed():
    """Refining the boundary boxes of the finest level changes that level's
    leaf status and adds a level: the data of the old levels, whose boxes
    stayed where they were, is kept, and only the new level is computed."""
    _, tf = both_lsf("rod", "xyz")
    t, d = tf.tree, tf.lsf_data
    top = t.highest_lvl
    before = {lvl: d.level_data(lvl) for lvl in range(1, top + 1)}
    ops = {lvl: TLevelOp(t, lvl, 0.0, None, d) for lvl in before}

    def flags(ids):
        out = np.full([len(ids)] + [NC] * 2, KEEP_REF, np.int64)
        out[d.box_has_boundary(ids) & (t.lvl[np.asarray(ids)] == top)] = DO_REF
        return out

    info = t.adjust_refinement(flags, ref_buffer=0)
    assert info.n_add > 0 and t.highest_lvl == top + 1
    for lvl, data in before.items():
        assert d.level_data(lvl) is data
        np.testing.assert_array_equal(TLevelOp(t, lvl, 0.0, None, d).f,
                                      ops[lvl].f)
    new = d.level_data(top + 1)
    assert new["has_bnd"].any() and len(new["ids"]) == info.n_add
    # the finest level now resolves the rod: no gradient-descent search
    assert float(t.lvl_dr(top + 1).min()) < d.length_scale


# ---------------------------------------------------------------------------
# analytic checks (tests/test_lsf.py, on the port)
# ---------------------------------------------------------------------------
def solve(mg, cc, params, n_cycles):
    cc = mg.fill_ghosts_phi(cc, params)
    P, R = mgb.gather_levels(mg, cc)
    for _ in range(n_cycles):
        P, R = mgb.fas_vcycle_blocks(mg, P, R, params)
    res = float(mgb.max_leaf_residual_blocks(mg, P, R, params))
    return mgb.scatter_levels(mg, cc, P, R), res


@pytest.mark.parametrize("ndim, refine", [(1, False), (2, False), (2, True)])
def test_planar_electrode_exact(ndim, refine):
    """A planar electrode (z < 0.303) at V0 and phi(1) = 0: the solution is
    linear and the generalized-distance stencil reproduces it, with the
    corrected field V0 / (1 - z0) on every face of a cell outside."""
    t = TTree(ndim, NC, [1.0] * ndim, [16] * ndim)
    if refine:
        def flags(ids):
            out = np.full([len(ids)] + [NC] * ndim, KEEP_REF, np.int64)
            for n, b in enumerate(ids):
                if t.box_r_min(np.asarray([int(b)]))[0][-1] < 0.5:
                    out[n] = DO_REF
            return out
        t.adjust_refinement(flags, ref_buffer=2)
    z0, V0 = 0.303, 750.0
    mesh = MeshPlans(t, "cpu")

    def bc(iv, d, coords, params):
        return ((tgc.BC_DIRICHLET, 0.0) if d // 2 == ndim - 1
                else (tgc.BC_NEUMANN, 0.0))

    cfg = TCFG()
    cfg.update_from_arguments(["-field_given_by=voltage 750.0",
                               "-use_electrode=t",
                               "-field_electrode_type=user",
                               "-field_rod_radius=1.0",
                               "-cylindrical=f",
                               "-domain_len=" + " ".join(["1.0"] * ndim)])
    field = TField(cfg, mesh, TSettings(cfg, ndim), I_PHI, I_RHS, 2, 0, [],
                   [])
    field.set_user_lsf(lambda r: r[..., -1] - z0)
    field.mg.sides_bc = bc
    params = {"lsf_phi_b": V0}
    cc = torch.zeros((4, t.highest_id, (NC + 2) ** ndim), dtype=torch.float64)
    fc = torch.zeros((1, ndim, t.highest_id, (NC + 1) ** ndim),
                     dtype=torch.float64)
    cc, res = solve(field.mg, cc, params, 12)
    assert res < 1e-6
    cc, fc = field.from_potential(cc, fc, params)
    inner = tsp.interior_flat(ndim, NC)
    E = V0 / (1.0 - z0)
    d = ndim - 1
    checked = 0
    for lvl in range(1, t.highest_lvl + 1):
        for b in t.lvl_leaves[lvl - 1]:
            z = t.cell_coords(int(b))[(slice(1, NC + 1),) * ndim][..., -1]
            out = z > z0
            if not out.any():
                continue
            phi = cc[I_PHI, int(b)].numpy()[inner].reshape(z.shape)
            assert np.abs(phi[out] - V0 * (1 - z[out]) / (1 - z0)).max() \
                < 1e-6 * V0
            # both faces (in z) of every cell outside carry E, the one
            # toward the electrode through the one-sided gradient
            F = fc[0, d, int(b)].numpy().reshape((NC + 1,) * ndim)[
                tuple(slice(0, NC + 1) if k == d else slice(0, NC)
                      for k in range(ndim))]
            lo = tuple(slice(0, NC) if k == d else slice(None)
                       for k in range(ndim))
            hi = tuple(slice(1, NC + 1) if k == d else slice(None)
                       for k in range(ndim))
            # the distance comes from a root search of tolerance 1e-8 on a
            # segment of dr >= 1/256
            assert np.abs(F[lo][out] - E).max() < 1e-4 * E
            assert np.abs(F[hi][out] - E).max() < 1e-4 * E
            checked += int(out.sum())
    assert checked > 0


@pytest.mark.parametrize("refine", [False, True])
def test_cylinder_electrode_analytic(refine):
    """A disk electrode at V0 with the analytic ln r potential on the outer
    boundary: the error is at the discretization level."""
    t = TTree(2, NC, [1.0, 1.0], [32, 32])
    ctr, r_el, r_out, V0 = np.array([0.5, 0.5]), 0.1, 2.0, 100.0

    def exact(r):
        rr = np.maximum(np.linalg.norm(np.asarray(r) - ctr, axis=-1), r_el)
        return V0 * np.log(r_out / rr) / np.log(r_out / r_el)

    if refine:
        def flags(ids):
            out = np.full([len(ids), NC, NC], KEEP_REF, np.int64)
            for n, b in enumerate(ids):
                c = (t.box_r_min(np.asarray([int(b)]))[0]
                     + 0.5 * NC * t.lvl_dr(int(t.lvl[int(b)])))
                if np.linalg.norm(c - ctr) < 0.25:
                    out[n] = DO_REF
            return out
        t.adjust_refinement(flags, ref_buffer=2)
    mesh = MeshPlans(t, "cpu")

    def bc(iv, d, coords, params):
        return tgc.BC_DIRICHLET, torch.as_tensor(exact(coords))

    mg = TMultigrid(mesh, I_PHI, I_RHS, bc)
    mg.lsf_data = tlsf.LsfData(
        mesh, lambda r: np.linalg.norm(r - ctr, axis=-1) - r_el)
    cc = torch.zeros((3, t.highest_id, (NC + 2) ** 2), dtype=torch.float64)
    cc, res = solve(mg, cc, {"lsf_phi_b": V0}, 15)
    assert res < 1e-5
    inner = tsp.interior_flat(2, NC)
    err = 0.0
    for lvl in range(1, t.highest_lvl + 1):
        for b in t.lvl_leaves[lvl - 1]:
            r = t.cell_coords(int(b))[1:-1, 1:-1].reshape(-1, 2)
            out = np.linalg.norm(r - ctr, axis=-1) > r_el + 0.01
            phi = cc[I_PHI, int(b)].numpy()[inner]
            if out.any():
                err = max(err, np.abs(phi[out] - exact(r[out])).max())
    assert err < 0.5


# ---------------------------------------------------------------------------
# cycles against the JAX host multigrid
# ---------------------------------------------------------------------------
def phi_bc(mod, ndim):
    def bc(iv, d, coords, params):
        if d == 2 * ndim - 1:
            return mod.BC_DIRICHLET, params.get("voltage", 0.0)
        if d == 2 * ndim - 2:
            return mod.BC_DIRICHLET, 0.0
        return mod.BC_NEUMANN, 0.0
    return bc


def random_state(t, seed=5):
    cc = np.array(BoxBatch(t, 3, 0).cc)
    rng = np.random.default_rng(seed)
    cc[I_RHS] = 1e9 * rng.standard_normal(cc.shape[1:])
    cc[I_PHI] = 100.0 * rng.random(cc.shape[1:])
    return cc


@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_cycles_with_boundary_potential_match_jax_host(geom):
    """From one random state: one V-cycle, then one FMG cycle, each with
    the leaf residual, the electrode at phi_b = 28.8 kV and (rod_rod) a
    grounded second electrode."""
    jf, tf = both_lsf("rod_rod", geom)
    ndim = jf.tree.ndim
    params = {"voltage": 28.8e3, "lsf_phi_b": 28.8e3}
    mg_h = Multigrid(jf.tree, I_PHI, I_RHS, I_TMP, phi_bc(gc, ndim),
                     lsf_data=jf.lsf_data)
    mg_t = TMultigrid(tf.mesh, I_PHI, I_RHS, phi_bc(tgc, ndim))
    mg_t.lsf_data = tf.lsf_data
    cc0 = random_state(jf.tree)
    h = mg_h.fill_ghosts_phi(cc0.copy(), params)
    d = mg_t.fill_ghosts_phi(torch.as_tensor(cc0.copy()), params)
    P, R = mgb.gather_levels(mg_t, d)
    real = jf.tree.highest_id

    def check(what):
        got = mgb.scatter_levels(mg_t, d, P, R).numpy()[I_PHI, :real]
        want = h[I_PHI, :real]
        np.testing.assert_allclose(got, want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max(),
                                   err_msg=what)
        res_h = float(mg_h.max_abs_residual(h, phi_b=params["lsf_phi_b"]))
        res_t = float(mgb.max_leaf_residual_blocks(mg_t, P, R, params))
        # the residual is a difference of terms ~1e4 times larger beside
        # the electrode
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
    # without the boundary term the port's residual is another one
    other = float(mgb.max_leaf_residual_blocks(mg_t, P, R, {}))
    assert abs(other - res2) > 1e-3 * res2


# ---------------------------------------------------------------------------
# the plain kernels against Pallas on level-set stencils
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name, geom", [
    ("sweep_2d", "xyz"), ("fill_sweep_2d", "xyz"), ("sweep_2d", "cyl"),
    ("fill_sweep_2d", "cyl"), ("sweep_3d", "xyz3d")])
def test_plain_sweeps_match_pallas_on_level_set_stencils(name, geom):
    _, tf = both_lsf("rod_cone_top", geom)
    ndim = tf.tree.ndim
    lvl = tf.tree.highest_lvl
    mg = TMultigrid(tf.mesh, I_PHI, I_RHS, phi_bc(tgc, ndim))
    mg.lsf_data = tf.lsf_data
    cs = mg.cs(lvl, torch.float64).numpy()
    # the six boundary boxes with the largest centre coefficients
    bnd = np.nonzero(tf.lsf_data.level_data(lvl)["has_bnd"])[0]
    bnd = bnd[np.argsort(-np.abs(cs[bnd, 0]).reshape(len(bnd), -1).max(1))][:6]
    n = len(bnd)
    assert n >= 2
    cs = cs[bnd]
    corr = mg.corr(lvl, torch.float64).numpy()[bnd]
    plain = -2.0 * ndim / float(tf.tree.lvl_dr(lvl)[0]) ** 2
    assert np.abs(cs[:, 0]).max() > 10.0 * abs(plain)   # beside the surface
    assert (cs[:, 1:1 + 2 * ndim] == 0.0).any()         # toward the electrode
    x = random_inputs(seed=11, n=n, nc=NC, ndim=ndim)
    x["cs"] = cs
    # rhs of the scale of L(phi) for phi of order one, with the boundary
    # term of an electrode at 2 V
    x["R"] = x["R"] * abs(plain) + corr * 2.0
    want = jax_call(name, x)
    got = torch_call(ks.KERNELS[name], x).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-12 * scale)
