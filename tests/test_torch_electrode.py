"""The electrode slices end to end: the port (CPU, plain smoother kernels)
against the JAX package's host path, float64, from the committed configs
afivo_streamer_tpu_torch/data/electrode_2d_slice.cfg (a rod from the top
plate in Cartesian 2D, 15,424 cells on 6 levels), electrode_cyl_slice.cfg
(a needle with a conical tip on the axis, Helmholtz photoionization, 13,312
cells on 6 levels), electrode_3d_slice.cfg (a rod in 3D, 219,136 cells on 4
levels) and air_1d_slice.cfg with a grounded electrode at the cathode.

Seven slices: the Cartesian rod as anode and as cathode (the cathode emits
through the electron average of the electrode's species boundary
condition), the cylindrical needle with photoionization, the 3D rod, the 1D
cathode, a pulsed variant (two pulses with a rise time; between them the
voltage is zero and the electrode's boxes are refined only to
electrode_derefine_factor times refine_electrode_dx, so epochs remove
boxes), and a user electrode (programs/electrode_user.py: an elliptic blade
at a potential of its own). Each holds the mesh at setup and after every
refinement epoch (one of which changes it), dt of every attempted step, the
counts of FMG cycles and V-cycles of the field solves (and with
photoionization of every Helmholtz mode at every update), the state and the
_rtest.log rows: rtol 1e-8 with an absolute floor of 1e-8 times each
variable's largest magnitude, as tests/test_torch_slice.py.

From the JAX package's state after two steps, loaded through interop (the
``lsf`` row is all of an electrode that is state): the electrode's species
boundary condition bit for bit, both substeps of a Heun step and one field
solve.

The fluid update writes the weighted sum of the previous states into every
cell and masks only the divergence and the sources: with the sum masked
too, the cathode run leaves the tolerance (the cells inside the electrode
at its boundary would keep a stale copy of the emission average).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from afivo_streamer_tpu.driver import Simulation as JSim
from afivo_streamer_tpu.solvers.multigrid import Multigrid as JMultigrid
from afivo_streamer_tpu_torch import interop
from afivo_streamer_tpu_torch.core import rowops as ro
from afivo_streamer_tpu_torch.driver import Simulation as TSim
from afivo_streamer_tpu_torch.solvers import mg_blocks as mgb
from test_torch_slice import (RTOL, assert_state_close, heun_substeps_both,
                              record_dts, record_epochs, record_photoi)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "afivo_streamer_tpu_torch" / "data"
USER_MODULE = ROOT / "afivo_streamer_tpu_torch" / "programs" / \
    "electrode_user.py"
CATHODE_1D = ["-ndim=1", "-use_electrode=T", "-field_electrode_grounded=T",
              "-field_rod_r0=0.0", "-field_rod_r1=0.1",
              "-field_rod_radius=5e-4"]
PULSED = ["-field_rise_time=5e-14", "-field_pulse_width=1e-13",
          "-field_pulse_period=1.2e-12", "-field_num_pulses=2",
          "-electrode_derefine_factor=4", "-refine_prepulse_time=2e-13",
          "-derefine_dx=3e-4"]
NEGATIVE = ["-field_given_by=field 1.8e6"]
SLICES = {
    "cart-positive": ("electrode_2d_slice.cfg", [], 8),
    "cart-negative": ("electrode_2d_slice.cfg", NEGATIVE, 8),
    "cyl-needle-photoi": ("electrode_cyl_slice.cfg",
                          ["-photoi%per_steps=2"], 8),
    "3d-rod": ("electrode_3d_slice.cfg", ["-ndim=3"], 6),
    "1d-cathode": ("air_1d_slice.cfg", CATHODE_1D, 16),
    "pulsed": ("electrode_2d_slice.cfg", PULSED, 12),
    "user-electrode": ("electrode_2d_slice.cfg",
                       ["-field_electrode_type=user",
                        f"-user%module={USER_MODULE}"], 8),
}


def count_field_cycles(monkeypatch):
    """Count the FMG cycles and the V-cycles over all levels that each
    package makes, per multigrid (keyed by its phi variable)."""
    counts = {"j": {}, "t": {}}

    def bump(side, i_phi, kind):
        c = counts[side].setdefault(i_phi, {"fmg": 0, "vcycle": 0})
        c[kind] += 1

    j_v, j_f = JMultigrid.fas_vcycle, JMultigrid.fas_fmg
    t_v, t_f = mgb.fas_vcycle_blocks, mgb.fas_fmg_blocks

    def jv(self, cc, params=None, set_residual=False, highest_lvl=None):
        if highest_lvl is None:
            bump("j", self.i_phi, "vcycle")
        return j_v(self, cc, params, set_residual, highest_lvl)

    def jf(self, *args, **kwargs):
        bump("j", self.i_phi, "fmg")
        return j_f(self, *args, **kwargs)

    def tv(mg, P, R, params, top=None):
        if top is None:
            bump("t", mg.i_phi, "vcycle")
        return t_v(mg, P, R, params, top)

    def tf(mg, P, R, params):
        bump("t", mg.i_phi, "fmg")
        return t_f(mg, P, R, params)

    monkeypatch.setattr(JMultigrid, "fas_vcycle", jv)
    monkeypatch.setattr(JMultigrid, "fas_fmg", jf)
    monkeypatch.setattr(mgb, "fas_vcycle_blocks", tv)
    monkeypatch.setattr(mgb, "fas_fmg_blocks", tf)
    return counts


def run_both(tmp_path, monkeypatch, name, before_port_run=None):
    """Both packages through setup and the slice's steps; returns the
    simulations and what was recorded."""
    cfg, extra, steps = SLICES[name]
    base = [str(DATA / cfg), "-ndim=2",
            f"-input_data%file={DATA / 'td_air_synthetic.txt'}",
            "-output%dt=5e-14"] + extra
    cycles = count_field_cycles(monkeypatch)
    j = JSim(argv=base + [f"-output%name={tmp_path / 'j'}"])
    t = TSim(argv=base + [f"-output%name={tmp_path / 't'}", "-device=cpu"])
    assert t.registry.cc_names == j.registry.cc_names
    assert t.i_lsf == j.i_lsf >= 0
    for a, b in zip(j.tree.lvl_ids, t.tree.lvl_ids):
        np.testing.assert_array_equal(a, b)
    rec = {"epochs": {"j": [], "t": []}, "dts": {"j": [], "t": []},
           "updates": {"j": [], "t": []}, "cycles": cycles}
    for side, sim in (("j", j), ("t", t)):
        record_epochs(sim, rec["epochs"][side])
        record_dts(sim, rec["dts"][side])
    if t.photoi.enabled:
        record_photoi(j, t, rec["updates"])
    j.run(max_steps=steps)
    if before_port_run is not None:
        before_port_run(t)
    t.run(max_steps=steps)
    return j, t, rec, steps


def compare_states(j, t):
    n = j.tree.highest_id
    use = j.tree.in_use[:n]
    return assert_state_close(j.cc[:, :n][:, use],
                              t.cc.numpy()[:, :n][:, use], skip={j.i_tmp})


@pytest.mark.parametrize("name", list(SLICES))
def test_electrode_slice_matches_jax(tmp_path, monkeypatch, name):
    j, t, rec, steps = run_both(tmp_path, monkeypatch, name)
    epochs, dts = rec["epochs"], rec["dts"]
    assert len(epochs["t"]) == len(epochs["j"]) == steps // 2
    assert any(a + r for _m, a, r in epochs["j"]), "no epoch changed"
    for (mj, aj, rj), (mt, at, rt) in zip(epochs["j"], epochs["t"]):
        assert (at, rt) == (aj, rj) and len(mt) == len(mj)
        for a, b in zip(mj, mt):
            np.testing.assert_array_equal(a, b)
    # no step of these runs is rejected: the JAX host path recomputes E
    # after a rejection without the electrode's potential (ROADMAP queue C)
    assert len(dts["t"]) == len(dts["j"]) == steps
    np.testing.assert_allclose(dts["t"], dts["j"], rtol=RTOL, atol=0.0)
    cycles = rec["cycles"]
    assert cycles["t"] == cycles["j"]
    field = cycles["t"][t.i_phi]
    assert field["fmg"] >= 1 and field["vcycle"] >= steps
    if t.photoi.enabled:
        assert rec["updates"]["t"] == rec["updates"]["j"]
        assert len(rec["updates"]["j"]) >= steps // 2 + 1
    assert t.global_dt == pytest.approx(j.global_dt, rel=RTOL)
    assert t.global_time == pytest.approx(j.global_time, rel=RTOL)
    assert t.field.lsf_phi_b() == pytest.approx(
        1.0 if name == "user-electrode" else j.field.current_voltage)
    compare_states(j, t)
    rows_j = np.loadtxt(tmp_path / "j_rtest.log", skiprows=1)
    rows_t = np.loadtxt(tmp_path / "t_rtest.log", skiprows=1)
    assert rows_j.shape == rows_t.shape and rows_j.shape[0] >= 3
    np.testing.assert_allclose(rows_t, rows_j, rtol=RTOL, atol=0.0)
    # the electrode is in the state, and the field is enhanced at its tip
    n = t.tree.highest_id
    assert bool((t.cc[t.i_lsf, :n] < 0).any())
    if name == "pulsed":
        assert t.field.current_voltage == 0.0
        assert t.refiner.current_electrode_dx == pytest.approx(
            4 * t.refine_cfg.electrode_dx)
        assert sum(r for _m, _a, r in epochs["t"]) > 64
    elif name != "1d-cathode":
        assert float(t.cc[t.i_electric_fld, :n].max()) > 3 * 1.8e6


@pytest.mark.parametrize("name", ["cart-negative", "cyl-needle-photoi"])
def test_from_jax_state_with_an_electrode(tmp_path, name):
    """The JAX package's state after two steps, loaded through interop (the
    ``lsf`` row is the only state of an electrode): the species boundary
    condition of the electrode, both substeps of a Heun step (each with a
    field solve's level-set operator behind it) and one field solve."""
    cfg, extra, _steps = SLICES[name]
    base = [str(DATA / cfg), "-ndim=2",
            f"-input_data%file={DATA / 'td_air_synthetic.txt'}"] + extra
    j = JSim(argv=base + [f"-output%name={tmp_path / 'j'}"])
    j.run(max_steps=2)
    n = j.tree.highest_id

    def port():
        t = TSim(argv=base + [f"-output%name={tmp_path / 't'}",
                              "-device=cpu"])
        interop.state_from_numpy(t, j.cc, j.fc,
                                 interop.tree_arrays(j.tree), it=j.it,
                                 global_time=j.global_time,
                                 global_dt=j.global_dt)
        return t

    t = port()
    np.testing.assert_array_equal(t.cc.numpy()[t.i_lsf, :n], j.cc[j.i_lsf, :n])
    j._set_electrode_densities()
    t._set_electrode_densities()
    assert_state_close(j.cc[:, :n], t.cc.numpy(), skip={j.i_tmp})
    heun_substeps_both(j, tmp_path, t)
    t = port()
    jcc, jfc = j.field.compute(j.cc.copy(), j.fc.copy(), 0, j.global_time,
                               True)
    tcc, tfc = t.field.compute(t.cc, t.fc, 0, t.global_time, True)
    assert_state_close(jcc[:, :n], tcc.numpy(), skip={j.i_tmp})
    np.testing.assert_allclose(
        tfc.numpy()[t.fc_E, :, :n], jfc[j.fc_E, :, :n], rtol=RTOL,
        atol=RTOL * float(np.abs(jfc[j.fc_E]).max()))


def test_masked_weighted_sum_fails_the_cathode_slice(tmp_path, monkeypatch):
    """The same cathode run with the weighted sum of the previous states
    written only where the mask allows an update: the state leaves the
    tolerance that the run above keeps."""
    real_set = ro.cc_set_interior

    def mask_the_sum(t):
        def masked_set(cc, iv, ids, vals, nc, ndim):
            for lvl in range(1, t.tree.highest_lvl + 1):
                if ids is t.mesh.tb(lvl).d.leaves:
                    old = ro.cc_get_interior(cc, iv, ids, nc, ndim)
                    vals = torch.where(t._level_mask(lvl), vals, old)
            return real_set(cc, iv, ids, vals, nc, ndim)
        monkeypatch.setattr(ro, "cc_set_interior", masked_set)

    j, t, rec, _steps = run_both(tmp_path, monkeypatch, "cart-negative",
                                 before_port_run=mask_the_sum)
    with pytest.raises(AssertionError):
        compare_states(j, t)


def test_rejected_step_restores_the_electrode_field(tmp_path):
    """restore_previous_state recomputes E from the restored potential with
    the electrode's potential in the one-sided gradients beside it: the
    face field is the one the last solve left."""
    cfg, extra, _steps = SLICES["cart-positive"]
    t = TSim(argv=[str(DATA / cfg), "-ndim=2", "-device=cpu",
                   f"-input_data%file={DATA / 'td_air_synthetic.txt'}",
                   f"-output%name={tmp_path / 't'}"] + extra)
    t.run(max_steps=2)
    n_states = t.dt_cfg.num_steps
    t._copy_state(n_states)
    want = t.fc[t.fc_E].clone()
    # without the electrode's potential the faces beside it differ
    t.cc, t.fc = t.field.from_potential(t.cc, t.fc, {"voltage": 0.0})
    assert float((t.fc[t.fc_E] - want).abs().max()) > 1e5
    t._restore_state(n_states, {"voltage": t.field.current_voltage})
    np.testing.assert_allclose(t.fc[t.fc_E].numpy(), want.numpy(),
                               rtol=1e-13, atol=0.0)
