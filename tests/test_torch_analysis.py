"""physics/analysis.py of the port against the JAX package's, on the CPU
in float64: the four cases of tests/test_analysis.py on the port, and each
of the eight functions (get_id_at, interp1, interp1_fc, get_maxima,
zmin_zmax_threshold, max_var_region, max_var_product, get_cross) on a
state of the JAX package after 2 steps, carried into the port by interop:
the cylindrical slice with live refinement (air_cyl_amr_slice.cfg on a
coarser mesh, a neutral seed, no photoionization) and the 3D one
(stability_3d.cfg without its user module). Values at rtol 1e-12; ids,
counts and locations exact. Besides, the reductions of core/reductions.py
that the log reads (the cell and face maxima and minima with their
locations)."""

import numpy as np
import pytest
import torch

from afivo_streamer_tpu.core import reductions as jred
from afivo_streamer_tpu.driver import Simulation as JSim
from afivo_streamer_tpu.physics import analysis as jan
from afivo_streamer_tpu_torch import interop
from afivo_streamer_tpu_torch.core import reductions as red
from afivo_streamer_tpu_torch.core.levels import MeshPlans
from afivo_streamer_tpu_torch.core.tree import Tree
from afivo_streamer_tpu_torch.driver import Simulation as TSim
from afivo_streamer_tpu_torch.physics import analysis
from torch_pairs import DATA

torch.set_num_threads(1)

RTOL = 1e-12


# ------------------------------------- tests/test_analysis.py, mirrored
def make_tree(ndim=2, nc=8, n1=16):
    t = Tree(ndim, nc, [1.0] * ndim, [n1] * ndim)
    cc = torch.zeros((2, t.highest_id, (nc + 2) ** ndim), dtype=torch.float64)
    return t, MeshPlans(t, "cpu"), cc


def fill(t, cc, iv, f):
    for lvl in range(1, t.highest_lvl + 1):
        for b in t.lvl_ids[lvl - 1]:
            r = t.cell_coords(int(b))
            cc[iv, int(b)] = torch.as_tensor(f(r).ravel())


def test_interp1_linear_exact():
    t, _mesh, cc = make_tree()
    fill(t, cc, 0, lambda r: 2.0 * r[..., 0] + 3.0 * r[..., 1] + 1.0)
    for pt in ([0.3, 0.4], [0.51, 0.73], [0.03, 0.97]):
        vals, ok = analysis.interp1(cc, t, np.array(pt), [0])
        assert ok
        expect = 2.0 * pt[0] + 3.0 * pt[1] + 1.0
        assert abs(vals[0] - expect) < 1e-12
    # outside the domain
    _, ok = analysis.interp1(cc, t, np.array([1.5, 0.5]), [0])
    assert not ok


def test_get_maxima():
    t, mesh, cc = make_tree()

    def f(r):
        x, y = r[..., 0], r[..., 1]
        return (np.exp(-200 * ((x - 0.3) ** 2 + (y - 0.3) ** 2))
                + 2.0 * np.exp(-200 * ((x - 0.7) ** 2 + (y - 0.6) ** 2)))
    fill(t, cc, 0, f)
    coord_val, n_found = analysis.get_maxima(cc, mesh, 0, 0.5, 10)
    assert n_found == 2
    peaks = coord_val[np.argsort(coord_val[:, 2])]
    assert np.allclose(peaks[0, :2], [0.3, 0.3], atol=0.05)
    assert np.allclose(peaks[1, :2], [0.7, 0.6], atol=0.05)


def test_zmin_zmax_threshold():
    t, mesh, cc = make_tree()
    fill(t, cc, 0, lambda r: np.where(
        (r[..., 1] > 0.25) & (r[..., 1] < 0.6), 1.0, 0.0))
    zm = analysis.zmin_zmax_threshold(cc, mesh, 0, 0.5, [1.0, 0.0])
    # as in the reference, the upper bound is the first above-threshold
    # plane of the last box row that holds plasma, not 0.6
    assert abs(zm[0] - 0.25) < 0.1
    assert 0.4 < zm[1] <= 0.6


def test_max_var_region():
    t, mesh, cc = make_tree()
    fill(t, cc, 0, lambda r: r[..., 0] + 10.0 * r[..., 1])
    val, loc = analysis.max_var_region(cc, mesh, 0, [0.0, 0.0], [1.0, 0.30])
    # the boxes partially inside y < 0.30 reach to y = 0.5; the maximum is
    # over whole boxes
    assert loc is not None and loc[1] <= 0.5
    assert val > 10.0 * 0.25


# ------------------------------------------- against the JAX package
STATES = {
    "cyl": [str(DATA / "air_cyl_amr_slice.cfg"), "-ndim=2",
            f"-input_data%file={DATA / 'td_air_synthetic.txt'}",
            "-refine_max_dx=5e-4", "-refine_min_dx=1.25e-4",
            "-refine_regions_dr=2.5e-4", "-photoi%enabled=f",
            "-seed_charge_type=0", "-output%dt=5e-14"],
    "3d": [str(DATA / "stability_3d.cfg"), "-ndim=3",
           f"-input_data%file={DATA / 'td_air_synthetic.txt'}",
           "-user%module=UNDEFINED", "-output%dt=5e-14"],
}


@pytest.fixture(scope="module", params=list(STATES))
def pair(request, tmp_path_factory):
    """The JAX simulation after 2 steps and the port holding its state."""
    out = tmp_path_factory.mktemp(request.param)
    argv = STATES[request.param]
    j = JSim(argv=argv + [f"-output%name={out / 'j'}"])
    j.run(max_steps=2)
    t = TSim(argv=argv + [f"-output%name={out / 't'}", "-device=cpu"])
    interop.state_from_numpy(t, j.cc, j.fc, interop.tree_arrays(j.tree),
                             it=j.it, global_time=j.global_time,
                             global_dt=j.global_dt)
    assert len(j.tree.lvl_ids) == t.tree.highest_lvl >= 3
    return j, t


def points(sim, n=7):
    """A grid of points over the domain and a little beyond it."""
    r0 = np.asarray(sim.st.domain_origin, np.float64)
    L = np.asarray(sim.st.domain_len, np.float64)
    axes = [r0[k] + L[k] * np.linspace(-0.05, 0.999, n)
            for k in range(sim.ndim)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1)
    return grid.reshape(-1, sim.ndim)


def test_get_id_at_and_interpolation_match(pair):
    j, t = pair
    pts = points(j)
    ids = [jan.get_id_at(j.tree, r) for r in pts]
    assert [analysis.get_id_at(t.tree, r) for r in pts] == ids
    assert -1 in ids and len(set(ids)) > 10
    ivs = [j.i_electron, j.i_electric_fld, j.i_phi]
    for r in pts:
        want, ok = jan.interp1(j.cc, j.tree, r, ivs)
        got, tok = analysis.interp1(t.cc, t.tree, r, ivs)
        assert tok == ok
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0.0)
        want, ok = jan.interp1_fc(j.fc, j.tree, r, j.fc_E)
        got, tok = analysis.interp1_fc(t.fc, t.tree, r, t.fc_E)
        assert tok == ok
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())


def test_get_maxima_matches(pair):
    j, t = pair
    found = []
    for iv, frac in ((j.i_electric_fld, 0.3), (j.i_electron, 1e-3),
                     (j.i_phi, 0.0)):
        thr = frac * float(j.cc[iv].max())
        for n_max in (1000, 3):
            want, n_want = jan.get_maxima(j.cc, j.tree, iv, thr, n_max)
            got, n_got = analysis.get_maxima(t.cc, t.mesh, iv, thr, n_max)
            assert n_got == n_want
            assert got.shape == want.shape
            np.testing.assert_array_equal(got[:, :-1], want[:, :-1])
            np.testing.assert_allclose(got[:, -1], want[:, -1], rtol=RTOL)
        found.append(n_want)
    assert found[0] > 0 and found[1] > 0


def test_zmin_zmax_threshold_matches(pair):
    j, t = pair
    top = float(j.st.domain_origin[-1] + j.st.domain_len[-1])
    for thr in (1e16, 1e18, 1e30):
        for limits in ([1e100, -1e100], [top, 0.0]):
            want = jan.zmin_zmax_threshold(j.cc, j.tree, j.i_electron, thr,
                                           limits)
            got = analysis.zmin_zmax_threshold(t.cc, t.mesh, t.i_electron,
                                               thr, limits)
            np.testing.assert_array_equal(got, want)
    # the neutral seed is above 1e18 /m3
    assert analysis.zmin_zmax_threshold(t.cc, t.mesh, t.i_electron, 1e18,
                                        [1e100, -1e100])[0] < 1e99


def test_max_var_region_and_product_match(pair):
    j, t = pair
    r0 = np.asarray(j.st.domain_origin, np.float64)
    L = np.asarray(j.st.domain_len, np.float64)
    for lo, hi in ((0.0, 1.0), (0.8, 0.95), (0.1, 0.2), (2.0, 3.0)):
        a, b = r0.copy(), r0 + L
        a[-1], b[-1] = r0[-1] + lo * L[-1], r0[-1] + hi * L[-1]
        want, wloc = jan.max_var_region(j.cc, j.tree, j.i_electric_fld, a, b)
        got, gloc = analysis.max_var_region(t.cc, t.mesh, t.i_electric_fld,
                                            a, b)
        assert got == pytest.approx(want, rel=RTOL)
        if wloc is None:
            assert gloc is None and lo > 1.0
        else:
            np.testing.assert_array_equal(gloc, wloc)
    for ivs in ([j.i_electron, j.i_electric_fld], [j.i_phi],
                [j.i_1pos_ion, j.i_electron, j.i_electron]):
        want, wloc = jan.max_var_product(j.cc, j.tree, ivs)
        got, gloc = analysis.max_var_product(t.cc, t.mesh, ivs)
        assert got == pytest.approx(want, rel=RTOL)
        np.testing.assert_array_equal(gloc, wloc)


def test_get_cross_matches(pair):
    j, t = pair
    if j.ndim != 2:
        with pytest.raises(ValueError, match="cylindrical"):
            analysis.get_cross(t, 2e-3, 0.5 * t.st.domain_len[-1])
        return
    for z in (0.3, 0.85, 0.93):
        zz = z * float(j.st.domain_len[1])
        want = jan.get_cross(j, 2e-3, zz)
        got = analysis.get_cross(t, 2e-3, zz)
        np.testing.assert_allclose(got, want, rtol=RTOL)
        assert want[0] > 0


def test_log_reductions_match(pair):
    """The cell and face maxima and minima of core/reductions.py, with
    their locations (ties broken by the first level, box and cell, as the
    JAX package's np.argmax does)."""
    j, t = pair
    for iv in (j.i_electron, j.i_electric_fld, j.i_phi, j.i_rhs):
        want, wloc = jred.tree_max_cc(j.cc, j.tree, iv)
        got, gloc = red.tree_max_cc(t.cc, t.mesh, iv)
        assert got == want
        np.testing.assert_array_equal(gloc, wloc)
        assert red.tree_min_cc(t.cc, t.mesh, iv) == \
            jred.tree_min_cc(j.cc, j.tree, iv)
        assert red.tree_maxabs_cc(t.cc, t.mesh, iv) == \
            jred.tree_maxabs_cc(j.cc, j.tree, iv)
        assert red.tree_sum_cc(t.cc, t.mesh, iv) == pytest.approx(
            jred.tree_sum_cc(j.cc, j.tree, iv), rel=RTOL)
    for dim in range(j.ndim):
        want, wloc = jred.tree_max_fc(j.fc, j.tree, dim, j.fc_E)
        got, gloc = red.tree_max_fc(t.fc, t.mesh, dim, t.fc_E)
        assert got == want
        np.testing.assert_array_equal(gloc, wloc)
        assert red.tree_min_fc(t.fc, t.mesh, dim, t.fc_E) == \
            jred.tree_min_fc(j.fc, j.tree, dim, j.fc_E)
    # a tie: a constant variable has its maximum at the first leaf cell
    # of the coarsest level with leaves
    cc = t.cc.clone()
    cc[t.i_tmp] = 1.0
    jcc = j.cc.copy()
    jcc[j.i_tmp] = 1.0
    _v, gloc = red.tree_max_cc(cc, t.mesh, t.i_tmp)
    _v, wloc = jred.tree_max_cc(jcc, j.tree, j.i_tmp)
    np.testing.assert_array_equal(gloc, wloc)
