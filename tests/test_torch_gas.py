"""Gas dynamics and plasma-gas coupling in the port against the JAX
package's host (NumPy) path, float64 on the CPU:

* the Euler conversions, the wavespeed and the fluxes on random states,
  rtol 1e-13;
* one Heun step of ``GasDynamics.forward_euler`` (both substeps, with the
  fine-to-coarse flux matching of the driver) on 3-level meshes in 1D,
  Cartesian 2D, cylindrical 2D (the axis in the domain) and 3D, from a
  smooth random state with a 5x pressure bump at the gas CFL dt (0.4 of
  its limit), where the state changes by O(1) of its variation: the state,
  the face fluxes and dt_lim, rtol 1e-12;
* ``Coupling.add_fluid_source`` without and with slow heating, with a
  nonzero space charge, and ``update_gas_density``, rtol 1e-12;
* the committed reaction table against data/make_td_table.py, and the
  chemistry with the gas species (species, stoichiometry, rates at random
  fields, derivatives), rtol 1e-12;
* one fluid substep with a per-cell gas density, plain and with the source
  factor and a mobile ion, rtol 1e-12;
* the slices of ``chip_smoke.py`` phases 3r and 3s for 16 steps
  (gas_heating_cyl_slice.cfg plain, with slow heating and from a
  pre-heated channel; gas_channel_cyl_slice.cfg under
  programs/gas_density_2d.py): the same state after setup, the same mesh
  at every epoch, dt at every attempted step, the gas dt limit of every
  gas advance, the FMG cycles of every photoionization update and the
  state at rtol 1e-8; the gas increments over the state after setup
  (``gas_rho``, the momenta, ``gas_e``, ``vibrational_energy``, on the
  interior cells of the leaves that were boxes at setup) nonzero and
  compared against their own scale; the port's state read through
  ``interop`` and a JAX state carried into the port by it.

The JAX package registers ``vibrational_energy`` after it has allocated
its state, so with ``gas%fraction_slow_heating > 0`` its host path stops
with an IndexError at the first coupling (ROADMAP queue C). The port
allocates after the last registration; the tests give the JAX state the
missing row.
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from afivo_streamer_tpu.core import ghostcell as jgc
from afivo_streamer_tpu.core.tree import Tree as JTree, DO_REF, KEEP_REF
from afivo_streamer_tpu.driver import Simulation as JSim
from afivo_streamer_tpu.physics import advance as jadv
from afivo_streamer_tpu.physics import fluid as jfl
from afivo_streamer_tpu.physics.coupling import Coupling as JCoupling
from afivo_streamer_tpu.physics.dt_control import DtConfig as JDt
from afivo_streamer_tpu.physics.gas import Gas as JGas
from afivo_streamer_tpu.physics.gas_dynamics import GasDynamics as JGD
from afivo_streamer_tpu.physics.streamer import Registry as JReg
from afivo_streamer_tpu.utils.config import CFG as JCFG

from afivo_streamer_tpu_torch import interop
from afivo_streamer_tpu_torch.core import ghostcell as tgc
from afivo_streamer_tpu_torch.core import spatial as sp
from afivo_streamer_tpu_torch.core.levels import MeshPlans
from afivo_streamer_tpu_torch.core.tree import Tree as TTree
from afivo_streamer_tpu_torch.driver import Simulation as TSim
from afivo_streamer_tpu_torch.physics import advance as tadv
from afivo_streamer_tpu_torch.physics.coupling import Coupling as TCoupling
from afivo_streamer_tpu_torch.physics.dt_control import DtConfig as TDt
from afivo_streamer_tpu_torch.physics.gas import Gas as TGas
from afivo_streamer_tpu_torch.physics.gas_dynamics import GasDynamics as TGD
from afivo_streamer_tpu_torch.physics.streamer import Registry as TReg
from afivo_streamer_tpu_torch.programs.heated_channel import cell_coords
from afivo_streamer_tpu_torch.utils.config import CFG as TCFG
from afivo_streamer_tpu_torch.utils.table_data import table_from_file
from test_torch_slice import record_dts, record_epochs, record_photoi

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "afivo_streamer_tpu_torch" / "data"
PROGRAMS = DATA.parent / "programs"
TABLE = DATA / "td_air_synthetic_reactions.txt"
NC = 8
RTOL = 1e-8
GEOMS = ["1d", "xyz", "cyl", "3d"]


# ------------------------------------------------------------ unit level
def make_tree(cls, geom):
    """16^ndim cells on [0, 1e-3]^ndim (cylindrical: r from the axis),
    refined twice where a box's corner is below 0.45e-3."""
    ndim = {"1d": 1, "3d": 3}.get(geom, 2)
    t = cls(ndim, NC, [1e-3] * ndim, [16] * ndim,
            coord="cyl" if geom == "cyl" else "xyz")

    def flags(ids):
        out = np.full([len(ids)] + [NC] * ndim, KEEP_REF, np.int64)
        for n, b in enumerate(ids):
            r0 = t.box_r_min(np.asarray([int(b)]))[0] - t.r_base
            if np.all(r0 < 0.45e-3) and t.lvl[int(b)] == t.highest_lvl:
                out[n] = DO_REF
        return out

    t.adjust_refinement(flags, ref_buffer=1)
    t.adjust_refinement(flags, ref_buffer=1)
    return t


class JaxFlux:
    """The JAX fluid model's flux matching alone, as its driver passes it
    to the gas step."""
    _pack = None
    _consistent_plan = jfl.FluidModel._consistent_plan
    consistent_fluxes = jfl.FluidModel.consistent_fluxes

    def __init__(self, tree):
        self.tree = tree


def gas_pair(geom, extra=()):
    """(JAX, port) GasDynamics with their trees and registries."""
    out = []
    for CFG, Tree, Reg, Gas, Dt, GD in ((JCFG, JTree, JReg, JGas, JDt, JGD),
                                        (TCFG, TTree, TReg, TGas, TDt, TGD)):
        cfg = CFG()
        cfg.update_from_arguments(["-gas%dynamics=t", *extra])
        tree = make_tree(Tree, geom)
        reg = Reg()
        if GD is JGD:
            gd = GD(tree, Gas(cfg), reg, Dt(cfg), None)
        else:
            gd = GD(MeshPlans(tree, "cpu"), Gas(cfg), reg, Dt(cfg))
        out.append((gd, tree, reg))
    return out


def smooth_state(gd, tree, n_cc, seed):
    """A smooth random gas state on every cell of every box: density
    within 20 % of air's, velocities of tens of m/s, and a pressure bump
    to 5 times the ambient 1 bar around a random point."""
    rng = np.random.default_rng(seed)
    ndim = tree.ndim
    ids = np.arange(tree.highest_id)
    x = cell_coords(tree, ids) / 1e-3  # [n, cells, ndim] in [0, 1]
    k = rng.uniform(1.0, 3.0, (3 + ndim, ndim))
    ph = rng.uniform(0.0, 2 * np.pi, 3 + ndim)

    def wave(i):
        return np.sin(2 * np.pi * (x * k[i]).sum(-1) + ph[i])
    rho = 1.16 * (1.0 + 0.2 * wave(0))
    vel = [30.0 * wave(1 + d) for d in range(ndim)]
    x0 = rng.uniform(0.2, 0.5, ndim)
    p = 1e5 * (1.0 + 4.0 * np.exp(-((x - x0) ** 2).sum(-1) / 0.02))
    cc = np.zeros((n_cc, tree.highest_id, (NC + 2) ** ndim))
    cc[gd.i_gas_dens] = rho / (28.8 * 1.66053886e-27)
    cc[gd.gas_vars[0]] = rho
    for d in range(ndim):
        cc[gd.gas_vars[1 + d]] = rho * vel[d]
    cc[gd.gas_vars[-1]] = p / 0.4 + 0.5 * rho * sum(v * v for v in vel)
    return cc


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_conversions_match(ndim):
    """to_primitive, to_conservative, max_wavespeed and fluxes on random
    states [n, n_vars, cells], rtol 1e-13 (a few rho <= 0 rows, as in
    padded boxes, stay finite in both)."""
    (jgd, _, _), (tgd, _, _) = gas_pair({1: "1d", 2: "xyz", 3: "3d"}[ndim])
    rng = np.random.default_rng(ndim)
    U = rng.uniform(0.5, 2.0, (64, 2 + ndim, 50))
    U[:, 1:1 + ndim] -= 1.2
    U[:, -1] = 2.5e5 * U[:, -1]
    U[:3, 0] = np.asarray([0.0, -1.0, 0.0])[:, None]
    t = torch.as_tensor(U)
    pairs = [(jgd.to_primitive(U), tgd.to_primitive(t)),
             (jgd.to_conservative(U), tgd.to_conservative(t))]
    P = jgd.to_primitive(U)
    for d in range(ndim):
        pairs.append((jgd.max_wavespeed(P, d),
                      tgd.max_wavespeed(torch.as_tensor(P), d)))
        pairs.append((jgd.fluxes(P, d), tgd.fluxes(torch.as_tensor(P), d)))
    for want, got in pairs:
        assert np.all(np.isfinite(want))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=0.0)


@pytest.mark.parametrize("geom", GEOMS)
def test_forward_euler_heun_matches(geom):
    """Both Heun substeps at 0.4 of the gas dt limit: every gas variable
    and copy, the face fluxes and dt_lim, rtol 1e-12; the step moves the
    state by a sizeable part of its own variation."""
    (jgd, jt, jreg), (tgd, tt, treg) = gas_pair(geom)
    assert jreg.cc_names == treg.cc_names and jreg.fc_names == treg.fc_names
    assert jt.highest_lvl == 3
    cc = smooth_state(jgd, jt, len(jreg.cc_names), seed=len(geom))
    fc = np.zeros((len(jreg.fc_names), jt.ndim, jt.highest_id,
                   (NC + 1) ** jt.ndim))
    # dt from the limit of the initial state
    _, _, lim0 = jgd.forward_euler(cc.copy(), fc.copy(), 0.0, None, 0.0, 0,
                                   [0], [1.0], 1, 1, 2, {})
    dt = 0.4 * float(lim0)
    flux = JaxFlux(jt)

    def jsub(c, f, dt_s, dl, tm, sd, sp_, wp, so, i, n, p):
        c, f, lim = jgd.forward_euler(c, f, dt_s, dl, tm, sd, sp_, wp, so, i,
                                      n, p, fluid=flux)
        return c, f, lim, {}

    def tsub(c, f, dt_s, dl, tm, sd, sp_, wp, so, i, n, p):
        c, f, lim = tgd.forward_euler(c, f, dt_s, dl, tm, sd, sp_, wp, so, i,
                                      n, p)
        return c, f, lim, {}

    jcc, jfc, jlim, _, _ = jadv.advance(cc.copy(), fc.copy(), dt, 0.0,
                                        "heuns_method", jsub, {})
    tcc, tfc, tlim, _, _ = tadv.advance(torch.tensor(cc),
                                        torch.tensor(fc), dt, 0.0,
                                        "heuns_method", tsub, {})
    assert float(tlim) == pytest.approx(float(jlim), rel=1e-12)
    ids = np.nonzero(jt.in_use[:jt.highest_id])[0]
    for m, iv in enumerate(jgd.gas_vars):
        for s in range(2):
            want, got = jcc[iv + s, ids], tcc.numpy()[iv + s, ids]
            scale = np.abs(want).max()
            np.testing.assert_allclose(got, want, rtol=1e-12,
                                       atol=1e-12 * scale)
        # the step changes the interior values by O(1) of their spread
        leaves = np.concatenate([np.asarray(x) for x in jt.lvl_leaves])
        change = np.abs(jcc[iv, leaves] - cc[iv, leaves]).max()
        assert change > 1e-3 * np.ptp(cc[iv, leaves])
    for f_iv in jgd.gas_fluxes:
        want, got = jfc[f_iv][:, ids], tfc.numpy()[f_iv][:, ids]
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("slow", [0.0, 0.3], ids=["fast", "slow-heating"])
def test_coupling_matches(slow):
    """add_fluid_source with a random electron flux, face field and space
    charge (three charged species, one doubly charged), then
    update_gas_density with each package's ghost fill, rtol 1e-12."""
    extra = [f"-gas%fraction_slow_heating={slow}", "-gas%EHD_factor=0.7",
             "-gas%heating_efficiency=0.9", "-gas%vt_relaxation_time=3e-9"]
    (jgd, jt, jreg), (tgd, tt, treg) = gas_pair("cyl", extra)
    species = {}
    for reg in (jreg, treg):
        species[id(reg)] = [reg.add_cc(nm) for nm in ("e", "A_plus", "B_min2")]
    cpl = []
    for (gd, t, reg), Cpl, mesh in ((jgd, jt, jreg), JCoupling, jt), \
            ((tgd, tt, treg), TCoupling, MeshPlans(tt, "cpu")):
        idx = SimpleNamespace(flux_fc=[reg.add_fc("flux_elec")],
                              fc_E=reg.add_fc("electric_fld"))
        cpl.append(Cpl(mesh, gd.gas, gd, idx, reg, species[id(reg)],
                       [-1.0, 1.0, -2.0]))
    assert jreg.cc_names == treg.cc_names
    assert (cpl[0].i_vib >= 0) == (slow > 0) and cpl[0].i_vib == cpl[1].i_vib
    rng = np.random.default_rng(7)
    cc = smooth_state(jgd, jt, len(jreg.cc_names), seed=3)
    for iv in species[id(jreg)]:
        cc[iv] = rng.uniform(0.0, 1e18, cc[iv].shape)
    if slow:
        cc[cpl[0].i_vib] = rng.uniform(0.0, 50.0, cc[0].shape)
    fc = rng.standard_normal((len(jreg.fc_names), 2, jt.highest_id,
                              (NC + 1) ** 2))
    fc[cpl[0].idx.flux_fc[0]] *= 1e24
    fc[cpl[0].idx.fc_E] *= 3e6
    dt = 2e-12
    jcc = cpl[0].add_fluid_source(cc.copy(), fc, dt)
    tcc = cpl[1].add_fluid_source(torch.tensor(cc), torch.tensor(fc),
                                  dt)
    # a sizeable change with a space charge, then the density
    e_iv = jgd.gas_vars[-1]
    assert np.abs(jcc[e_iv] - cc[e_iv]).max() > 1e-3
    assert np.abs(jcc[jgd.gas_vars[1]] - cc[jgd.gas_vars[1]]).max() > 0
    mesh = MeshPlans(tt, "cpu")

    def jfill(c, ivs):
        for lvl in range(1, jt.highest_lvl + 1):
            c = jgc.fill_ghosts_lvl(c, jgc.get_gc_plan(jt, lvl), ivs,
                                    jgc.RB_INTERP, jreg.methods[ivs[0]]["bc"],
                                    {})
        return c

    def tfill(c, ivs):
        for lvl in range(1, tt.highest_lvl + 1):
            tgc.fill_ghosts_lvl(c, mesh.gc(lvl), ivs, tgc.RB_INTERP,
                                treg.methods[ivs[0]]["bc"], {})
        return c
    jcc = cpl[0].update_gas_density(jcc, jfill)
    tcc = cpl[1].update_gas_density(tcc, tfill)
    ids = np.nonzero(jt.in_use[:jt.highest_id])[0]
    for iv in range(len(jreg.cc_names)):
        want, got = jcc[iv, ids], tcc.numpy()[iv, ids]
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max(),
                                   err_msg=jreg.cc_names[iv])


def test_generator_writes_the_reaction_table():
    """data/make_td_table.py reproduces the committed reaction table byte
    for byte: the new-style blocks, the reaction list and its field tables,
    whose ionization rate k N equals the old-style table's alpha v."""
    spec = importlib.util.spec_from_file_location(
        "make_td_table", DATA / "make_td_table.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lines = mod.with_reactions()
    assert "\n".join(lines) == TABLE.read_text()
    assert lines[1:len(mod.new_style())] == mod.new_style()[1:]
    E = mod.FIELDS
    for gas in ("N2", "O2"):
        td, k = table_from_file(str(TABLE),
                                f"efield[Td]_vs_rate_ionization_{gas}")
        np.testing.assert_allclose(td * mod.N_GAS * mod.TOWNSEND, E,
                                   rtol=1e-9, atol=1e-6)
        np.testing.assert_allclose(k * mod.N_GAS, mod.alpha(E)
                                   * mod.mobility(E) * E, rtol=1e-9)


def test_chemistry_with_gas_species_matches(tmp_path):
    """Under a varying gas density the gas components lead the species;
    the reaction list's stoichiometry, rates at random fields and the
    derivatives at random densities (gas columns included), rtol 1e-12."""
    argv = [str(DATA / "gas_heating_cyl_slice.cfg"), "-refine_max_dx=5e-4",
            "-photoi%enabled=f", f"-input_data%file={TABLE}"]
    j = JSim(argv=argv + [f"-output%name={tmp_path / 'j'}"])
    t = TSim(argv=argv + [f"-output%name={tmp_path / 't'}", "-device=cpu"])
    assert t.chem.n_gas_species == j.chem.n_gas_species == 3
    assert t.chem.species_list == j.chem.species_list == [
        "N2", "O2", "M", "e", "N2_plus", "O2_plus", "O2_min"]
    assert t.chem.species_charge == j.chem.species_charge
    assert [r.reaction_type for r in t.chem.reactions] == \
        [r.reaction_type for r in j.chem.reactions] == [1, 1, 2, 3, 3, 3, 3]
    np.testing.assert_array_equal(t.chem.stoich, j.chem.stoich)
    rng = np.random.default_rng(5)
    fields = rng.uniform(0.0, 1000.0, 400)
    want = np.asarray(j.chem.get_rates(fields))
    got = t.chem.get_rates(torch.as_tensor(fields)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)
    dens = rng.uniform(0.0, 1e20, (400, 7))
    dens[:, :3] = 2.4e25 * rng.uniform(0.5, 1.0, (400, 1)) * np.asarray(
        [0.8, 0.2, 1.0])
    for a, b in zip(j.chem.get_derivatives(dens, want),
                    t.chem.get_derivatives(torch.as_tensor(dens),
                                           torch.as_tensor(want))):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-12,
                                   atol=1e-12 * np.abs(a).max())


@pytest.mark.parametrize("extra", [[], [
    "-fixes%source_factor=flux", "-fixes%write_source_factor=t",
    "-input_data%mobile_ions=O2_min", "-input_data%ion_mobilities=2.2e-4"]],
    ids=["plain", "source-factor-mobile-ion"])
def test_fluid_substep_with_varying_density_matches(tmp_path, extra):
    """One fluid substep (fluxes, flux matching, chemistry, photoionization
    source; with the source factor and a mobile ion) from the JAX state of
    the channel slice after 2 steps with M perturbed by up to 10 % on every
    cell, carried into the port by interop: the state and the face fluxes,
    rtol 1e-12."""
    base = [str(DATA / "gas_channel_cyl_slice.cfg"),
            f"-input_data%file={TABLE}", *extra]
    j = JSim(argv=base + [f"-output%name={tmp_path / 'j'}",
                          f"-user%module={ROOT}/programs/gas_density_2d/"
                          "user.py"])
    j.run(max_steps=2)
    t = TSim(argv=base + [f"-output%name={tmp_path / 't'}", "-device=cpu",
                          f"-user%module={PROGRAMS / 'gas_density_2d.py'}"])
    iM = j.registry.cc_names.index("M")
    assert t.fluid.idx.i_gas_dens == j.fluid.idx.i_gas_dens == iM
    rng = np.random.default_rng(11)
    cc = j.cc.copy()
    cc[iM] *= rng.uniform(0.9, 1.1, cc[iM].shape)
    interop.state_from_numpy(t, cc, j.fc, interop.tree_arrays(j.tree),
                             it=j.it, global_time=j.global_time,
                             global_dt=j.global_dt)
    args = (1e-12, None, j.global_time, 0, [0], [1.0], 1, 1, 2,
            {"voltage": j.field.current_voltage})
    jcc, jfc, jlim, _ = j.fluid.forward_euler(cc, j.fc.copy(), *args)
    tcc, tfc, tlim, _ = t.fluid.forward_euler(t.cc, t.fc, *args)
    n = j.tree.highest_id
    ids = np.nonzero(j.tree.in_use[:n])[0]
    for iv, name in enumerate(j.registry.cc_names):
        if name == "tmp":
            continue
        want, got = jcc[iv, ids], tcc.numpy()[iv, ids]
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max(),
                                   err_msg=name)
    for f_iv in t.fluid.idx.flux_fc:
        want, got = jfc[f_iv][:, ids], tfc.numpy()[f_iv][:, ids]
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
    assert float(tlim) == pytest.approx(float(jlim), rel=1e-12)


# ------------------------------------------------------------ the slices
JAX_HEATED = """
import numpy as np
from afivo_streamer_tpu_torch.programs.heated_channel import (
    cell_coords, channel_energy)


def user_initialize(cfg, sim):
    heating = cfg.add_get("channel_heating", 2.0, "")
    radius = cfg.add_get("channel_radius", 5e-4, "")

    def set_ics(s, ids):
        iv = s.gasdyn.gas_vars[s.gasdyn.i_e]
        ids = np.asarray(ids, np.int64)
        s.cc[iv, ids] = channel_energy(s, cell_coords(s.tree, ids), heating,
                                       radius)
    sim.user.initial_conditions = set_ics
"""

SLICES = {
    "heating": ("gas_heating_cyl_slice.cfg", [], None),
    "slow-heating": ("gas_heating_cyl_slice.cfg",
                     ["-gas%fraction_slow_heating=0.3"], None),
    "preheated": ("gas_heating_cyl_slice.cfg", [], "heated_channel"),
    "channel": ("gas_channel_cyl_slice.cfg", [], "gas_density_2d"),
}


def build_pair(tmp_path, name):
    cfg, extra, user = SLICES[name]
    base = [str(DATA / cfg), "-photoi%per_steps=2", "-output%dt=5e-14",
            f"-input_data%file={TABLE}"] + extra
    juser, tuser = [], []
    if user == "heated_channel":
        path = tmp_path / "jax_heated.py"
        path.write_text(JAX_HEATED)
        juser = [f"-user%module={path}"]
        tuser = [f"-user%module={PROGRAMS / 'heated_channel.py'}"]
    elif user == "gas_density_2d":
        juser = [f"-user%module={ROOT}/programs/gas_density_2d/user.py"]
        tuser = [f"-user%module={PROGRAMS / 'gas_density_2d.py'}"]
    j = JSim(argv=base + juser + [f"-output%name={tmp_path / 'j'}"])
    t = TSim(argv=base + tuser + [f"-output%name={tmp_path / 't'}",
                                  "-device=cpu"])
    if j.coupling is not None and j.coupling.i_vib >= j.cc.shape[0]:
        # the row the JAX package does not allocate (queue C)
        j.cc = np.concatenate([j.cc, np.zeros((1,) + j.cc.shape[1:])])
    return j, t


def record_gas_limits(sim, out):
    """Record the gas dt limit of every gas advance of ``sim``."""
    orig = sim._advance_gas

    def wrapped(*args):
        out.append(orig(*args))
        return out[-1]
    sim._advance_gas = wrapped


def kept_leaf_interiors(tree, setup):
    """The interior cells [leaves, cells] of the leaves that were boxes at
    setup with the same level and position (``setup`` holds the tree's
    lvl, ix and in_use arrays then): the increments of the others hold the
    interpolation of new boxes."""
    n0 = len(setup["lvl"])
    leaves = np.concatenate([np.asarray(l) for l in tree.lvl_leaves])
    keep = leaves[leaves < n0]
    keep = keep[setup["in_use"][keep] & (setup["lvl"][keep] == tree.lvl[keep])
                & np.all(setup["ix"][keep] == tree.ix[keep], axis=1)]
    inner = sp.interior_flat(tree.ndim, tree.nc)
    return keep[:, None], inner[None, :]


@pytest.mark.parametrize("name", list(SLICES))
def test_gas_slice_matches_jax(tmp_path, name):
    """16 steps of the slice in both packages: the same mesh at setup and
    after every epoch, dt at every attempted step, the FMG cycles of every
    photoionization update; then every variable of the port's state read
    through interop at rtol 1e-8, and the gas increments against their
    own scale."""
    j, t = build_pair(tmp_path, name)
    assert t.registry.cc_names == j.registry.cc_names
    assert t.registry.fc_names == j.registry.fc_names
    n0 = j.tree.highest_id
    for iv, nm in enumerate(j.registry.cc_names):
        want = j.cc[iv, :n0]
        if nm != "tmp":
            np.testing.assert_allclose(t.cc.numpy()[iv, :n0], want,
                                       rtol=1e-12,
                                       atol=1e-12 * np.abs(want).max())
    setup = {"cc": j.cc.copy(), "lvl": j.tree.lvl[:n0].copy(),
             "ix": j.tree.ix[:n0].copy(), "in_use": j.tree.in_use[:n0].copy()}
    for a, b in zip(j.tree.lvl_ids, t.tree.lvl_ids):
        np.testing.assert_array_equal(a, b)
    epochs, dts, updates = ({"j": [], "t": []} for _ in range(3))
    for key, sim in (("j", j), ("t", t)):
        record_epochs(sim, epochs[key])
        record_dts(sim, dts[key])
    record_photoi(j, t, updates)
    gas_lims = {"j": [], "t": []}
    if t.gasdyn is not None:
        record_gas_limits(j, gas_lims["j"])
        record_gas_limits(t, gas_lims["t"])
    steps = 16
    j.run(max_steps=steps)
    t.run(max_steps=steps)
    assert any(a + r for _m, a, r in epochs["j"]), "no epoch changed"
    assert len(epochs["t"]) == len(epochs["j"]) == steps // 2
    for (mj, aj, rj), (mt, at, rt) in zip(epochs["j"], epochs["t"]):
        assert (at, rt) == (aj, rj) and len(mt) == len(mj)
        for a, b in zip(mj, mt):
            np.testing.assert_array_equal(a, b)
    assert len(dts["t"]) == len(dts["j"]) >= steps
    np.testing.assert_allclose(dts["t"], dts["j"], rtol=RTOL, atol=0.0)
    assert updates["t"] == updates["j"] and len(updates["j"]) >= steps // 2
    assert t.global_time == pytest.approx(j.global_time, rel=RTOL)
    assert len(gas_lims["t"]) == len(gas_lims["j"])
    np.testing.assert_allclose(gas_lims["t"], gas_lims["j"], rtol=RTOL)
    n = j.tree.highest_id
    ids = np.nonzero(j.tree.in_use[:n])[0]
    state = interop.state_to_numpy(t)
    tcc, jcc = state["cc"][:, ids], j.cc[:, ids]
    names = j.registry.cc_names
    for iv, nm in enumerate(names):
        if nm == "tmp":
            continue
        scale = np.abs(jcc[iv]).max()
        np.testing.assert_allclose(tcc[iv], jcc[iv], rtol=RTOL,
                                   atol=RTOL * scale, err_msg=nm)
    if t.gasdyn is None:
        M = jcc[names.index("M")]
        assert M.min() < 0.55 * j.gas.number_density
        return
    gas_names = ["gas_rho", "gas_mom_x", "gas_mom_y", "gas_e"]
    if t.coupling.i_vib >= 0:
        gas_names.append("vibrational_energy")
    rows, cells = kept_leaf_interiors(j.tree, setup)
    assert len(rows) > 100
    for nm in gas_names:
        iv = names.index(nm)
        base = setup["cc"][iv][rows, cells]
        inc_j = j.cc[iv][rows, cells] - base
        inc_t = state["cc"][iv][rows, cells] - base
        scale = np.abs(inc_j).max()
        assert scale > 0, nm
        np.testing.assert_allclose(inc_t, inc_j, rtol=RTOL,
                                   atol=RTOL * scale, err_msg=nm)
    np.testing.assert_allclose(
        interop.state_to_numpy(t)["cc"][names.index("M"), ids],
        jcc[names.index("M")], rtol=1e-12)


def test_interop_carries_the_gas_state(tmp_path):
    """A JAX state with slow heating after 4 steps, carried into the port
    by interop: the gas rows, M and vibrational_energy arrive bit for bit,
    and 2 more steps in both packages agree at rtol 1e-8."""
    j, t = build_pair(tmp_path, "slow-heating")
    j.run(max_steps=4)
    interop.state_from_numpy(t, j.cc, j.fc, interop.tree_arrays(j.tree),
                             it=j.it, global_time=j.global_time,
                             global_dt=j.global_dt,
                             photoi_prev_time=j._photoi_prev_time)
    names = j.registry.cc_names
    n = j.tree.highest_id
    rows = [names.index(nm) for nm in ("M", "gas_rho", "gas_mom_x",
                                       "gas_mom_y", "gas_e",
                                       "vibrational_energy")]
    assert rows[-1] == len(names) - 1
    got = interop.state_to_numpy(t)["cc"]
    np.testing.assert_array_equal(got[rows, :n], j.cc[rows, :n])
    assert np.abs(j.cc[rows[-1], :n]).max() > 0
    j.run(max_steps=6)
    t.run(max_steps=6)
    assert t.global_dt == pytest.approx(j.global_dt, rel=RTOL)
    ids = np.nonzero(j.tree.in_use[:j.tree.highest_id])[0]
    got = interop.state_to_numpy(t)["cc"]
    for iv in rows:
        want = j.cc[iv, ids]
        np.testing.assert_allclose(got[iv, ids], want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())
