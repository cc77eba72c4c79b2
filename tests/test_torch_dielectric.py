"""The port's live refinement and dielectric surfaces against the JAX
package's host (NumPy) path, on the state of the committed dielectric slice
(afivo_streamer_tpu_torch/data/dielectric_2d_slice.cfg with a mobile
positive ion: 52,480 cells on 6 levels, a dielectric slab below y = 4 mm
with 25 surfaces) after setup, carried into the port through interop,
float64:

* the refinement criterion: the same cell flags on every box the tree
  evaluates, and one refinement epoch (region 2 expired, so boxes are
  removed; then active again, so they come back) gives the same mesh and
  the same prolonged state;
* the surfaces: discovery, charge to rhs, the field correction, the
  surface-charge update with ion secondary emission and photon emission,
  the surface integral, and update_after_refinement when the boxes along
  the interface are refined and derefined, on random surface data.

Tolerance rtol 1e-12 (the same arithmetic; a few products are taken in
another order).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from afivo_streamer_tpu import constants as juc
from afivo_streamer_tpu.core.tree import DO_REF, KEEP_REF, RM_REF
from afivo_streamer_tpu.driver import Simulation as JSim
from afivo_streamer_tpu_torch import interop
from afivo_streamer_tpu_torch.driver import Simulation as TSim

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "afivo_streamer_tpu_torch" / "data"
RTOL = 1e-12


def argv(out):
    """The slice with a mobile positive ion (so ions reach the surface and
    emit secondary electrons)."""
    return [str(DATA / "dielectric_2d_slice.cfg"), "-ndim=2",
            f"-input_data%file={DATA / 'td_air_synthetic.txt'}",
            "-input_data%mobile_ions=M_plus",
            "-input_data%ion_mobilities=2.2e-4", f"-output%name={out}"]


def new_jax_sim(out):
    return JSim(argv=argv(out) + [
        f"-user%module={ROOT / 'programs' / 'dielectric_2d' / 'user.py'}"])


@pytest.fixture(scope="module")
def jax_sim(tmp_path_factory):
    """The JAX package after setup, shared by the tests that leave its
    mesh as it is."""
    return new_jax_sim(tmp_path_factory.mktemp("j") / "run")


@pytest.fixture
def pair(jax_sim, tmp_path):
    return port_pair(jax_sim, tmp_path)


@pytest.fixture
def fresh_pair(tmp_path):
    """As ``pair``, from a JAX simulation of its own (the test changes
    its mesh)."""
    return port_pair(new_jax_sim(tmp_path / "j"), tmp_path)


def port_pair(j, tmp_path):
    """A copy of the JAX state (with random surface data) and the port
    loaded from it."""
    rng = np.random.default_rng(11)
    cc, fc = j.cc.copy(), j.fc.copy()
    for s in j.surfaces.surfaces:
        s.sd[:] = rng.standard_normal(s.sd.shape) * 1e-6
    t = TSim(argv=argv(tmp_path / "t") + [
        "-device=cpu",
        f"-user%module={ROOT / 'afivo_streamer_tpu_torch' / 'programs'}"
        "/dielectric_2d.py"])
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
    assert got.keys() == want.keys()
    for k in want:
        close(got[k], want[k])


def test_surface_discovery_matches(pair):
    j, _, _, t = pair
    key = [(s.in_use, s.id_in, s.id_out, s.direction, s.eps)
           for s in j.surfaces.surfaces]
    own = [(s.in_use, s.id_in, s.id_out, s.direction, s.eps)
           for s in t.surfaces.surfaces]
    assert own == key and sum(k[0] for k in key) == 25
    # discovery on the final mesh
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


def test_surface_charge_rhs_field_and_integral_match(pair):
    j, cc, fc, t = pair
    fac = -juc.elem_charge / juc.eps0
    want = j.surfaces.charge_to_rhs(cc.copy(), 1, j.i_rhs, fac)
    got = t.surfaces.charge_to_rhs(t.cc.clone(), t.i_rhs, fac)
    n = j.tree.highest_id
    close(got[t.i_rhs, :n].numpy(), want[j.i_rhs, :n])
    want_fc = j.surfaces.correct_field_fc(cc, fc.copy(), 1, j.fc_E,
                                          j.i_phi, -fac)
    got_fc = t.surfaces.correct_field_fc(t.cc, t.fc.clone(), t.fc_E,
                                         t.i_phi, -fac)
    close(got_fc[t.fc_E, :, :n].numpy(), want_fc[j.fc_E, :, :n])
    assert t.surfaces.get_integral(t.cc) == pytest.approx(
        j.surfaces.get_integral(1), rel=RTOL)


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
    n = j.tree.highest_id
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


def touches_interface(tree, b) -> bool:
    lo = tree.box_r_min(np.asarray([int(b)]))[0][1]
    hi = lo + tree.nc * tree.lvl_dr(int(tree.lvl[int(b)]))[1]
    return lo <= 4e-3 <= hi


def interface_flags(tree, lvl, action):
    """Flags that refine (DO) the boxes of level ``lvl`` touching y = 4 mm,
    or derefine (RM) the boxes of level ``lvl`` whose parent touches it;
    keep the rest."""
    def fn(ids):
        out = np.full((len(ids),) + (tree.nc,) * tree.ndim, KEEP_REF,
                      np.int64)
        for n, b in enumerate(ids):
            probe = b if action == DO_REF else tree.parent[int(b)]
            if tree.lvl[int(b)] == lvl and touches_interface(tree, probe):
                out[n] = action
        return out
    return fn


def test_surfaces_follow_refinement(fresh_pair):
    """update_after_refinement: the interface boxes of the finest level are
    refined (the parents' surfaces prolonged onto the children) and then
    derefined again (restricted back)."""
    j, _, _, t = fresh_pair
    top = max(int(j.tree.lvl[b]) for b in j.tree.all_leaves
              if touches_interface(j.tree, b))
    for lvl, action in ((top, DO_REF), (top + 1, RM_REF)):
        infos = []
        for sim in (j, t):
            info = sim.tree.adjust_refinement(
                interface_flags(sim.tree, lvl, action), ref_buffer=0,
                ref_links=sim.surfaces.refinement_links())
            infos.append(info)
        assert infos[0].added == infos[1].added
        assert infos[0].removed == infos[1].removed
        assert infos[0].n_add + infos[0].n_rm > 0
        j.surfaces.update_after_refinement(infos[0])
        t._sync_capacity()
        t.surfaces.update_after_refinement(t.cc, infos[1])
        assert_surfaces_equal(j.surfaces, t)


def test_refinement_epoch_matches(fresh_pair):
    """cell_flags on the evaluated boxes, then a refinement epoch with
    region 2 expired (boxes removed) and one with it active again (boxes
    added): the same meshes and states."""
    j, _, _, t = fresh_pair
    ids = j.tree.criterion_eval_ids()
    np.testing.assert_array_equal(ids, t.tree.criterion_eval_ids())
    np.testing.assert_array_equal(t.refiner.cell_flags(t.cc, ids),
                                  j.refiner.cell_flags(j.cc, ids))
    changes = []
    for time in (3e-13, 0.0):
        for sim in (j, t):
            sim.global_time = time
        info_j = j.adjust_refinement()
        info_t = t.adjust_refinement()
        changes.append((info_j.n_add, info_j.n_rm))
        assert (info_t.n_add, info_t.n_rm) == changes[-1]
        for a, b in zip(j.tree.lvl_ids, t.tree.lvl_ids):
            np.testing.assert_array_equal(a, b)
        n = j.tree.highest_id
        use = j.tree.in_use[:n]
        skip = {j.i_tmp} | set(t.surfaces.state_vars)
        for iv in range(j.cc.shape[0]):
            if iv not in skip:
                close(t.cc[iv, :n].numpy()[use], j.cc[iv, :n][use], 1e-10)
        assert_surfaces_equal(j.surfaces, t)
    assert changes[0][1] > 0 and changes[1][0] > 0
