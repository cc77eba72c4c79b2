"""The fluid-model variants of the port against the JAX package's host
(NumPy) path, float64, on the committed new-style synthetic table
afivo_streamer_tpu_torch/data/td_air_synthetic_new.txt (written by
data/make_td_table.py):

* the transport tables read from it, with and without the electron energy
  equation (``model%type = ee53``): every column of ``tbl`` and ``ee_tbl``,
  rtol 1e-13;
* the chemistry under ee53, for the standard model and for a reaction list
  with an energy table and the two rate forms in the electron temperature:
  the species, both rate tables, and the rates on random fields and
  energies, rtol 1e-12; the swarm summary to its printed digits;
* one forward-Euler substep (fluxes, then the update) from the same random
  positive state, under ee53 in 1D, cylindrical 2D and 3D, with the source
  factor (with and without ee53) and with a plasma region that cuts the
  domain: every cell-centered variable, every flux and the four time-step
  limits, rtol 1e-12 (with an absolute floor of 1e-12 of each variable's
  largest magnitude);
* the physics of the energy equation on the port alone, the checks of
  tests/test_ee_model.py on the committed table: in a uniform field
  (no seed, a background of 1e13 electrons per m3, to 0.3 ns) the mean
  energy in mid-domain is within 5 % of the table's value at the local
  reduced field, the energy density is >= 0 everywhere, the energy-loss
  limit is active and ``e_energy`` is a species.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from afivo_streamer_tpu.driver import Simulation as JSim
from afivo_streamer_tpu.physics.chemistry import Chemistry as JChem
from afivo_streamer_tpu.physics.gas import Gas as JGas
from afivo_streamer_tpu.physics.transport_data import TransportData as JTD
from afivo_streamer_tpu.utils.config import CFG as JCFG
from afivo_streamer_tpu.utils.table_data import TableDataSettings as JTS

from afivo_streamer_tpu_torch import constants as uc
from afivo_streamer_tpu_torch import interop
from afivo_streamer_tpu_torch.driver import Simulation as TSim
from afivo_streamer_tpu_torch.physics.chemistry import Chemistry as TChem
from afivo_streamer_tpu_torch.physics.gas import Gas as TGas
from afivo_streamer_tpu_torch.physics.transport_data import (
    TransportData as TTD, TD_ENERGY_EV)
from afivo_streamer_tpu_torch.utils.config import CFG as TCFG
from afivo_streamer_tpu_torch.utils.table_data import TableDataSettings as TTS

torch.set_num_threads(1)

DATA = (Path(__file__).resolve().parent.parent / "afivo_streamer_tpu_torch"
        / "data")
OLD_TABLE = DATA / "td_air_synthetic.txt"
NEW_TABLE = DATA / "td_air_synthetic_new.txt"
#: the flags that put a configuration under the energy equation
EE = ["-model%type=ee53", "-input_data%old_style=f",
      f"-input_data%file={NEW_TABLE}"]

REACTIONS = """
reaction_list
-----------------------
e + M -> e + e + M+,field_table,efield_table_alpha
e + M -> M-,energy_table,energy_table_att
e + A+ -> A,c1*(300/Te)**c2,2.0e-13 0.7
e + B+ -> B,(c1*(kB_eV*Te+c2)**2-c3)*c4,3.0e-14 0.5 1.0e-15 2.0
M- + M -> e + M,c1*exp(-(c2/(c3+Td))**2),1.0e-18 50.0 10.0
-----------------------

efield_table_alpha
COMMENT: rate coefficient (m3/s) versus E/N (Td), made up
-----------------------
0.0 0.0
100.0 1.0e-18
500.0 4.0e-16
1500.0 2.0e-15
-----------------------

energy_table_att
COMMENT: rate coefficient (m3/s) versus the mean energy (eV), made up
-----------------------
0.0 3.0e-18
2.0 1.0e-18
6.0 2.0e-19
12.0 1.0e-19
-----------------------
"""


def setups(td_file, ee):
    """(transport data, chemistry) of the JAX package and of the port."""
    out = []
    for CFG, TS, Gas, TD, Chem in ((JCFG, JTS, JGas, JTD, JChem),
                                   (TCFG, TTS, TGas, TTD, TChem)):
        cfg = CFG()
        cfg.update_from_arguments([f"-input_data%file={td_file}",
                                   "-input_data%old_style=f"])
        ts = TS(cfg)
        gas = Gas(cfg)
        td = TD(cfg, gas, ts, ee)
        out.append((td, Chem(gas, td, td.file, ts, ee, cfg)))
    return out


def test_generator_writes_the_committed_tables(tmp_path):
    """data/make_td_table.py reproduces both committed tables byte for
    byte, and the mean-energy block is strictly increasing."""
    spec = importlib.util.spec_from_file_location(
        "make_td_table", DATA / "make_td_table.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert "\n".join(mod.new_style()) == NEW_TABLE.read_text()
    td = mod.FIELDS / (mod.N_GAS * mod.TOWNSEND)
    assert np.all(np.diff(mod.mean_energy(td)) > 0)
    assert np.ptp(mod.mobility(mod.FIELDS)) > 0
    assert np.ptp(mod.diffusion(mod.FIELDS)) > 0


@pytest.mark.parametrize("ee", [False, True], ids=["lfa", "ee53"])
def test_new_style_transport_tables_match(ee):
    """Every column of tbl and ee_tbl, rtol 1e-13."""
    (jtd, _), (ttd, _) = setups(NEW_TABLE, ee)
    assert ttd.has_energy_eV and jtd.has_energy_eV
    assert ttd.max_eV == jtd.max_eV != 20.0
    np.testing.assert_array_equal(ttd.tbl.x, jtd.tbl.x)
    np.testing.assert_allclose(ttd.tbl.rows_cols, jtd.tbl.rows_cols,
                               rtol=1e-13, atol=0.0)
    assert np.ptp(ttd.tbl.rows_cols[:, 0]) > 0  # the mobility varies
    if not ee:
        assert ttd.ee_tbl is None and jtd.ee_tbl is None
        return
    np.testing.assert_array_equal(ttd.ee_tbl.x, jtd.ee_tbl.x)
    assert ttd.ee_tbl.x[0] == 0.0 and ttd.ee_tbl.x[-1] == jtd.max_eV
    assert ttd.ee_tbl.rows_cols.shape == jtd.ee_tbl.rows_cols.shape
    np.testing.assert_allclose(ttd.ee_tbl.rows_cols, jtd.ee_tbl.rows_cols,
                               rtol=1e-13, atol=0.0)


def test_old_style_table_refuses_energy_equation():
    for CFG, TS, Gas, TD in ((JCFG, JTS, JGas, JTD), (TCFG, TTS, TGas, TTD)):
        cfg = CFG()
        cfg.update_from_arguments([f"-input_data%file={OLD_TABLE}",
                                   "-input_data%old_style=t"])
        with pytest.raises(ValueError, match="energy equation"):
            TD(cfg, Gas(cfg), TS(cfg), True)


@pytest.mark.parametrize("reactions", [False, True],
                         ids=["standard-model", "reaction-list"])
@pytest.mark.parametrize("ee", [False, True], ids=["lfa", "ee53"])
def test_chemistry_matches(ee, reactions, tmp_path):
    """Species, both rate tables and the rates at random fields and
    energies, rtol 1e-12; without the energy equation the reaction list's
    energy table and electron-temperature forms are read all the same."""
    td_file = NEW_TABLE
    if reactions:
        td_file = tmp_path / "td_with_reactions.txt"
        td_file.write_text(NEW_TABLE.read_text() + REACTIONS)
    (jtd, jc), (ttd, tc) = setups(td_file, ee)
    assert tc.species_list == jc.species_list
    assert ("e_energy" in tc.species_list) == ee
    if ee:
        assert tc.species_list[-1] == "e_energy"
    assert tc.species_charge == jc.species_charge
    assert [r.rate_type for r in tc.reactions] == \
        [r.rate_type for r in jc.reactions]
    assert [r.lookup_table_index for r in tc.reactions] == \
        [r.lookup_table_index for r in jc.reactions]
    np.testing.assert_array_equal(tc.stoich, jc.stoich)
    for name in ("chemtbl_fld", "chemtbl_ee"):
        a, b = getattr(tc, name), getattr(jc, name)
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_allclose(a.rows_cols, b.rows_cols, rtol=1e-12,
                                   atol=0.0)
    assert tc.chemtbl_ee.x[-1] == jtd.max_eV
    rng = np.random.default_rng(12)
    fields = rng.uniform(0.0, 1300.0, 500)
    energies = rng.uniform(0.0, 1.1 * jtd.max_eV, 500)
    want = jc.get_rates(fields, energy_eV=energies)
    got = tc.get_rates(torch.as_tensor(fields),
                       energy_eV=torch.as_tensor(energies)).numpy()
    assert want.shape == got.shape == (500, len(jc.reactions))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)
    if reactions and not ee:
        # an energy table without the energy equation has no energy to be
        # read at: the swarm summaries do not apply
        with pytest.raises(ValueError, match="energy_eV"):
            tc.get_rates(torch.as_tensor(fields))
        return
    assert tc.get_breakdown_field_td(1e3) == jc.get_breakdown_field_td(1e3)
    jc.write_summary(str(tmp_path / "j_summary.txt"))
    tc.write_summary(str(tmp_path / "t_summary.txt"))
    rows_j = np.loadtxt(tmp_path / "j_summary.txt", skiprows=1)
    rows_t = np.loadtxt(tmp_path / "t_summary.txt", skiprows=1)
    assert rows_j.shape == rows_t.shape == (len(jtd.tbl.x), 8)
    np.testing.assert_allclose(rows_t, rows_j, rtol=1e-8, atol=0.0)


# ---------------------------------------------------------------- substep
SOURCE_FACTOR = ["-fixes%source_factor=flux", "-fixes%write_source_factor=t",
                 "-fixes%source_min_electrons_per_cell=1e-3"]
PLASMA_REGION = ["-plasma_region_enabled=t",
                 "-plasma_region_rmin=0 0.0135",
                 "-plasma_region_rmax=0.002 0.0155"]
SUBSTEP_CASES = {
    "1d-ee53": ("air_1d_slice.cfg", 1, EE),
    "cyl-ee53": ("air_cyl_ee_slice.cfg", 2, EE),
    "3d-ee53": ("air_3d_slice.cfg", 3, EE + ["-refine_max_dx=5e-4"]),
    "cyl-source-factor": ("air_cyl_amr_slice.cfg", 2, SOURCE_FACTOR),
    "cyl-ee53-source-factor": ("air_cyl_ee_slice.cfg", 2,
                               EE + SOURCE_FACTOR),
    "cyl-plasma-region": ("air_cyl_amr_slice.cfg", 2, PLASMA_REGION),
    "cyl-ee53-plasma-region": ("air_cyl_ee_slice.cfg", 2,
                               EE + PLASMA_REGION),
}


def random_positive_state(j, seed):
    """The state of JAX simulation ``j`` with every density (all its time
    copies) a random positive field over 8 decades, the energy density
    0.5-8 eV per electron, the field's norm scaled by 0.5-1.5 per cell and
    its face components by 0.5-1.5 with a random sign, the fluxes random,
    on every box row."""
    rng = np.random.default_rng(seed)
    cc, fc = j.cc.copy(), j.fc.copy()
    n_copies = j.dt_cfg.num_steps + 1
    shape = cc.shape[1:]
    for iv in j.all_densities:
        for c in range(n_copies):
            cc[iv + c] = 10.0 ** rng.uniform(10.0, 18.0, shape)
    if j.i_electron_energy >= 0:
        for c in range(n_copies):
            cc[j.i_electron_energy + c] = (cc[j.i_electron + c]
                                           * rng.uniform(0.5, 8.0, shape))
    cc[j.i_electric_fld] *= rng.uniform(0.5, 1.5, shape)
    fc[j.fc_E] *= (rng.uniform(0.5, 1.5, fc.shape[1:])
                   * rng.choice([-1.0, 1.0], fc.shape[1:]))
    for f in j.fc_flux:
        fc[f] = rng.standard_normal(fc.shape[1:]) * 1e20
    return cc, fc


@pytest.mark.parametrize("case", list(SUBSTEP_CASES))
def test_forward_euler_substep_matches(case, tmp_path):
    cfg, ndim, extra = SUBSTEP_CASES[case]
    base = [str(DATA / cfg), f"-ndim={ndim}",
            f"-input_data%file={OLD_TABLE}"] + extra
    j = JSim(argv=base + [f"-output%name={tmp_path / 'j'}"])
    t = TSim(argv=base + [f"-output%name={tmp_path / 't'}", "-device=cpu"])
    assert t.registry.cc_names == j.registry.cc_names
    assert t.registry.fc_names == j.registry.fc_names
    assert t.flux_species == j.flux_species
    assert t.i_electron_energy == j.i_electron_energy
    assert t.i_srcfac == j.i_srcfac
    n = j.tree.highest_id
    jcc, jfc = random_positive_state(j, seed=len(case))
    interop.state_from_numpy(t, jcc, jfc, interop.tree_arrays(j.tree))
    params = {"voltage": j.field.current_voltage}
    dt = 1e-13
    jcc, jfc, jlim, jdiag = j.fluid.forward_euler(
        jcc, jfc, dt, None, 0.0, 0, [0], [1.0], 1, 1, 2, params)
    tcc, tfc, tlim, tdiag = t.fluid.forward_euler(
        t.cc, t.fc, dt, None, 0.0, 0, [0], [1.0], 1, 1, 2, params)
    np.testing.assert_allclose(tdiag["dt_limits"].numpy(),
                               np.asarray(jdiag["dt_limits"]), rtol=1e-12)
    assert float(tlim) == pytest.approx(float(jlim), rel=1e-12)
    if "ee53" in case:
        assert float(tdiag["dt_limits"][3]) < 1e99
        assert "flux_energy" in t.registry.fc_names
    tcc, tfc = tcc.numpy(), tfc.numpy()
    for iv, name in enumerate(j.registry.cc_names):
        scale = float(np.abs(jcc[iv, :n]).max())
        np.testing.assert_allclose(tcc[iv, :n], jcc[iv, :n], rtol=1e-12,
                                   atol=1e-12 * scale, err_msg=name)
    for f, name in enumerate(j.registry.fc_names):
        scale = float(np.abs(jfc[f, :, :n]).max())
        np.testing.assert_allclose(tfc[f, :, :n], jfc[f, :, :n], rtol=1e-12,
                                   atol=1e-12 * scale, err_msg=name)
    if "source-factor" in case:
        fac = tcc[t.i_srcfac, :n]
        assert 0.0 <= fac.min() and fac.max() <= 1.0 and np.ptp(fac) > 0
    if "plasma-region" in case:
        # outside the region the update is the weighted sum of the
        # previous states alone: some leaf cells kept, some changed
        masks = [t.fluid.mask_provider(lvl) for lvl in range(
            1, t.tree.highest_lvl + 1) if len(t.mesh.tb(lvl).leaves)]
        inside = sum(int(m.sum()) for m in masks)
        assert 0 < inside < sum(m.numel() for m in masks)


# ---------------------------------------------------- physics of the model
@pytest.fixture(scope="module")
def uniform_field_run(tmp_path_factory):
    sim = TSim(argv=[str(DATA / "air_1d_slice.cfg"), "-ndim=1", "-device=cpu",
                     "-seed_density=0", "-background_density=1e13",
                     f"-output%name={tmp_path_factory.mktemp('ee') / 'run'}"]
               + EE)
    sim.run(end_time=3.0e-10)
    return sim


def test_energy_relaxes_to_table(uniform_field_run):
    sim = uniform_field_run
    t = sim.tree
    # sample mid-domain, away from the boundaries
    ids = np.asarray(t.lvl_leaves[t.highest_lvl - 1])
    b, mid = int(ids[len(ids) // 2]), t.nc // 2
    ne = float(sim.cc[sim.i_electron, b, mid])
    en = float(sim.cc[sim.i_electron_energy, b, mid])
    fld = float(sim.cc[sim.i_electric_fld, b, mid])
    mean_eV = en / max(ne, 1.0)
    td = fld * uc.SI_to_Townsend * sim.gas.inverse_number_density
    expect_eV = float(sim.td.tbl.host_col(TD_ENERGY_EV, [td])[0])
    assert ne > 0
    assert abs(mean_eV - expect_eV) < 0.05 * expect_eV, \
        f"mean energy {mean_eV} eV vs table {expect_eV} eV at {td} Td"


def test_energy_nonnegative_and_limits(uniform_field_run):
    sim = uniform_field_run
    n = sim.tree.highest_id
    use = torch.as_tensor(sim.tree.in_use[:n])
    assert float(sim.cc[sim.i_electron_energy, :n][use].min()) >= 0.0
    # the energy-loss restriction (dt_limits[3], "other") must be active
    assert sim.dt_limits[3] < 1e99
    assert "e_energy" in sim.chem.species_list
