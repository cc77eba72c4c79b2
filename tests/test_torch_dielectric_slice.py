"""The field solver's last branches end to end: the port (CPU, plain
smoother kernels) against the JAX package's host path, float64.

* Dielectrics outside Cartesian 2D: the committed
  afivo_streamer_tpu_torch/data/dielectric_cyl_slice.cfg (a cylindrical
  streamer above an eps = 2 plate, Helmholtz photoionization, 26,944 cells
  on 6 levels) with both signs of the field, dielectric_3d_slice.cfg (an
  eps = 2 slab in 3D with a mobile ion, 80 surfaces) and air_1d_slice.cfg
  with a dielectric on the left.
* The electrode-plus-dielectric pair: electrode_dielectric_cyl_slice.cfg
  (a needle above the plate), cylindrical and Cartesian; a level holds
  both the level set's boundary and extrapolating ghosts of eps, so it
  sweeps with K2 and fills with K3-swap.
* The uniform coarse multigrid: air_cyl_slice.cfg in Cartesian
  coordinates on a 256 x 256-cell level-1 grid (65,536 unknowns).

Each holds the mesh at setup and after every refinement epoch (each
dielectric run has one that removes boxes along the surface), dt of every
attempted step, the counts of FMG cycles and V-cycles of every multigrid
(with photoionization of every Helmholtz mode at every update), the state,
the surface data per surface and the _rtest.log rows: rtol 1e-8 with an
absolute floor of 1e-8 times each variable's largest magnitude, as
tests/test_torch_slice.py. On the coarse grid also the V-cycles of every
level-1 solve.

In 1D the JAX package moves no surface data at refinement
(solvers/surface.py update_after_refinement has 2D and 3D branches only):
a child surface starts at zero and a restored parent keeps its data from
before the refinement, so surface charge is lost. The port copies the one
value both ways; the 1D slice is held against the JAX package with that
copy added, and without it the JAX run loses the charge (ROADMAP queue C).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from afivo_streamer_tpu.solvers.coarse import UniformCoarseMG as JUMG
from afivo_streamer_tpu.solvers.surface import Surfaces as JSurfaces
from afivo_streamer_tpu.driver import Simulation as JSim
from afivo_streamer_tpu_torch import interop
from afivo_streamer_tpu_torch.driver import Simulation as TSim
from afivo_streamer_tpu_torch.solvers.coarse import UniformCoarseMG
from test_torch_electrode import count_field_cycles
from test_torch_slice import (RTOL, assert_state_close, record_dts,
                              record_epochs, record_photoi)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "afivo_streamer_tpu_torch" / "data"
USER = {"j": f"-user%module={ROOT / 'programs' / 'dielectric_2d'}/user.py",
        "t": f"-user%module={DATA.parent / 'programs'}/dielectric_2d.py"}
PHOTOI = ["-photoi%per_steps=2"]
DIEL_1D = ["-ndim=1", "-use_dielectric=t", "-dielectric_type=left",
           "-input_data%mobile_ions=M_plus",
           "-input_data%ion_mobilities=2.2e-4"]
SLICES = {
    "cyl-negative": ("dielectric_cyl_slice.cfg", PHOTOI, 8),
    "cyl-positive": ("dielectric_cyl_slice.cfg",
                     PHOTOI + ["-field_given_by=field 1.8e6"], 8),
    "3d": ("dielectric_3d_slice.cfg", ["-ndim=3"], 6),
    "1d": ("air_1d_slice.cfg", DIEL_1D, 16),
    "pair-cyl": ("electrode_dielectric_cyl_slice.cfg", PHOTOI, 8),
    "pair-cart": ("electrode_dielectric_cyl_slice.cfg",
                  PHOTOI + ["-cylindrical=f"], 8),
    "coarse-256": ("air_cyl_slice.cfg",
                   ["-cylindrical=f", "-coarse_grid_size=256 256"], 4),
}


def jax_1d_surface_copy(monkeypatch):
    """Give the JAX package's surfaces the 1D copy of the port."""
    orig = JSurfaces.update_after_refinement

    def update(self, info):
        if self.tree.ndim != 1:
            return orig(self, info)
        n0 = len(self.surfaces)
        removed = [self.surfaces[self.box_out_to_ix[int(r)]]
                   for r in info.removed if int(r) in self.box_out_to_ix]
        orig(self, info)
        for s in removed:
            self.surfaces[s.ix_parent].sd[:] = s.sd
        for s in self.surfaces[n0:]:
            s.sd[:] = self.surfaces[s.ix_parent].sd
    monkeypatch.setattr(JSurfaces, "update_after_refinement", update)


def count_coarse_cycles(monkeypatch):
    """The V-cycles of every uniform coarse-grid solve of both packages."""
    out = {"j": [], "t": []}
    j_solve, j_vc = JUMG.solve, JUMG._vcycle
    t_solve = UniformCoarseMG.solve_blocks

    def jsolve(self, *args):
        out["j"].append(0)
        return j_solve(self, *args)

    def jvc(self, u, rhs, lvl_i, bvals):
        if lvl_i == 0:
            out["j"][-1] += 1
        return j_vc(self, u, rhs, lvl_i, bvals)

    def tsolve(self, *args):
        P1 = t_solve(self, *args)
        out["t"].append(self.last_vcycles)
        return P1
    monkeypatch.setattr(JUMG, "solve", jsolve)
    monkeypatch.setattr(JUMG, "_vcycle", jvc)
    monkeypatch.setattr(UniformCoarseMG, "solve_blocks", tsolve)
    return out


def run_both(tmp_path, monkeypatch, name, steps=None):
    cfg, extra, n = SLICES[name]
    steps = steps or n
    base = [str(DATA / cfg), "-ndim=2",
            f"-input_data%file={DATA / 'td_air_synthetic.txt'}",
            "-output%dt=5e-14"] + extra
    diel = "dielectric" in cfg or "-use_dielectric=t" in extra
    cycles = count_field_cycles(monkeypatch)
    coarse = count_coarse_cycles(monkeypatch)
    j = JSim(argv=base + ([USER["j"]] if diel else [])
             + [f"-output%name={tmp_path / 'j'}"])
    t = TSim(argv=base + ([USER["t"]] if diel else [])
             + [f"-output%name={tmp_path / 't'}", "-device=cpu"])
    assert t.registry.cc_names == j.registry.cc_names
    for a, b in zip(j.tree.lvl_ids, t.tree.lvl_ids):
        np.testing.assert_array_equal(a, b)
    rec = {"epochs": {"j": [], "t": []}, "dts": {"j": [], "t": []},
           "updates": {"j": [], "t": []}, "cycles": cycles,
           "coarse": coarse}
    for side, sim in (("j", j), ("t", t)):
        record_epochs(sim, rec["epochs"][side])
        record_dts(sim, rec["dts"][side])
    if t.photoi.enabled:
        record_photoi(j, t, rec["updates"])
    j.run(max_steps=steps)
    t.run(max_steps=steps)
    return j, t, rec, steps


def assert_surfaces_close(j, t):
    got = interop.surface_data(t)
    want = {s.id_out: s.sd for s in j.surfaces.active()}
    assert got.keys() == want.keys() and len(want) > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                   atol=RTOL * float(np.abs(want[k]).max()))
    assert t.surfaces.get_integral(t.cc) == pytest.approx(
        j.surfaces.get_integral(1), rel=RTOL)


@pytest.mark.parametrize("name", list(SLICES))
def test_slice_matches_jax(tmp_path, monkeypatch, name):
    if name == "1d":
        jax_1d_surface_copy(monkeypatch)
    j, t, rec, steps = run_both(tmp_path, monkeypatch, name)
    epochs, dts = rec["epochs"], rec["dts"]
    assert len(epochs["t"]) == len(epochs["j"]) == steps // 2
    for (mj, aj, rj), (mt, at, rt) in zip(epochs["j"], epochs["t"]):
        assert (at, rt) == (aj, rj) and len(mt) == len(mj)
        for a, b in zip(mj, mt):
            np.testing.assert_array_equal(a, b)
    assert len(dts["t"]) == len(dts["j"]) >= steps
    np.testing.assert_allclose(dts["t"], dts["j"], rtol=RTOL, atol=0.0)
    assert rec["cycles"]["t"] == rec["cycles"]["j"]
    field = rec["cycles"]["t"][t.i_phi]
    assert field["fmg"] >= 1 and field["vcycle"] >= steps
    if t.photoi.enabled:
        assert rec["updates"]["t"] == rec["updates"]["j"]
        assert len(rec["updates"]["j"]) >= steps // 2 + 1
    assert rec["coarse"]["t"] == rec["coarse"]["j"]
    if name == "coarse-256":
        assert isinstance(t.field.mg.coarse_solver(), UniformCoarseMG)
        assert len(rec["coarse"]["t"]) >= steps and all(
            1 <= c < UniformCoarseMG.MAX_VCYCLES for c in rec["coarse"]["t"])
    else:
        # an epoch removes boxes along the surface
        assert any(r for _m, _a, r in epochs["j"]), "no epoch removed boxes"
        assert rec["coarse"]["t"] == []
        assert_surfaces_close(j, t)
        # the surface holds charge
        assert max(float(np.abs(v[1]).max())
                   for v in interop.surface_data(t).values()) > 0.0
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
    if name.startswith("pair"):
        # a level holds the level set's boundary and extrapolating ghosts
        # of eps: it sweeps with K2 and fills with K3-swap
        mg = t.field.mg
        assert any(mg.smoother(lvl).has_swap and mg.op(lvl).f is not None
                   for lvl in range(1, t.tree.highest_lvl + 1))


def test_jax_1d_surfaces_lose_charge_at_derefinement(tmp_path, monkeypatch):
    """Without the 1D copy the JAX run keeps the stale data of the restored
    parent surface: after the epoch that removes the interface's finest
    boxes its surface charge differs from the port's."""
    j, t, rec, _ = run_both(tmp_path, monkeypatch, "1d")
    assert any(r for _m, _a, r in rec["epochs"]["j"])
    assert rec["dts"]["t"] == pytest.approx(rec["dts"]["j"], rel=RTOL)
    got = t.surfaces.get_integral(t.cc)
    want = j.surfaces.get_integral(1)
    assert got < 0 and abs(got - want) > 0.1 * abs(got)
